"""Launcher of the furthest-point-sampling kernel (csrc/fps.cu).

Replaces garmentnets_tpu/kernels/fps_pallas.py. The plain PyTorch version
of the same function is ops/pointcloud.furthest_point_sampling_plain.
"""
from __future__ import annotations

import ctypes

import torch

from garmentnets_tpu_torch.kernels import _build

# the shared-memory instance's dynamic shared memory: x, y, z and the
# running minimum
MAX_POINTS = 232448 // 16 - 64
REG_THREADS = 512              # threads of the register instance
SMEM_THREADS = 1024            # threads of the shared-memory instance
PPTS = (2, 4, 6, 8, 12, 16)    # points per thread of the register instances


def fps_plan(n: int) -> tuple:
    """(threads, points per thread) of the kernel instance for N = n
    points: the register instance with the fewest points per thread that
    covers n, or (SMEM_THREADS, 0) for the shared-memory instance."""
    for ppt in PPTS:
        if n <= REG_THREADS * ppt:
            return REG_THREADS, ppt
    return SMEM_THREADS, 0


def furthest_point_sampling_cuda(pos: torch.Tensor,
                                 num_samples: int) -> torch.Tensor:
    """pos: [B, N, 3] float32 CUDA -> idx [B, num_samples] int64."""
    _build.require_cuda(pos, "fps pos")
    if pos.dim() != 3 or pos.shape[-1] != 3:
        raise ValueError(f"fps: pos must be [B, N, 3], got {tuple(pos.shape)}")
    B, N, _ = pos.shape
    if not 1 <= N <= MAX_POINTS or num_samples < 1:
        raise ValueError(f"fps: need 1 <= N <= {MAX_POINTS} and "
                         f"num_samples >= 1, got N={N}, M={num_samples}")
    out = torch.empty((B, num_samples), dtype=torch.int64, device=pos.device)
    fn = _build.cuda_fn("fps", "fps_launch", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    with torch.cuda.device(pos.device):
        err = fn(pos.data_ptr(), B, N, num_samples, fps_plan(N)[1],
                 out.data_ptr(), _build.stream_handle(pos))
    _build.check_launch("fps", err)
    return out
