"""Launcher of the gaussian-gradient-magnitude kernel (csrc/ggm.cu).

Replaces garmentnets_tpu/ops/gaussian_pallas.py. The plain PyTorch version
of the same function is ops/gaussian.ggm_plain.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from garmentnets_tpu_torch.kernels import _build

MAX_RADIUS = 8     # taps' radius: gradient_sigma < 2.125 (csrc/ggm.cu)
NARROW_RADIUS = 4  # the default library's radii; wider ones build on use
MAX_WIDTH = 256     # a block holds whole rows of W (csrc/ggm.cu)


def ggm_cuda(volume: torch.Tensor, k0: np.ndarray,
             k1: np.ndarray) -> torch.Tensor:
    """volume [B, D, H, W] float32 CUDA; k0, k1: the 2r+1 gaussian and
    derivative taps in correlation orientation -> |grad| [B, D, H, W]."""
    if volume.dim() != 4:
        raise ValueError(f"ggm: volume must be [B,D,H,W], got "
                         f"{tuple(volume.shape)}")
    radius = (len(k0) - 1) // 2
    if len(k0) != len(k1) or not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"ggm kernel supports 1 <= radius <= {MAX_RADIUS}, "
                         f"got {len(k0)} taps")
    B, D, H, W = volume.shape
    if W > MAX_WIDTH:
        raise ValueError(f"ggm kernel supports W <= {MAX_WIDTH}, got {W}")
    _build.require_cuda(volume, "ggm volume")
    taps0 = (ctypes.c_float * len(k0))(*np.asarray(k0, np.float32).tolist())
    taps1 = (ctypes.c_float * len(k1))(*np.asarray(k1, np.float32).tolist())
    out = torch.empty_like(volume)
    FP = ctypes.POINTER(ctypes.c_float)
    lib = "ggm" if radius <= NARROW_RADIUS else "ggm_wide"
    fn = _build.cuda_fn(lib, "ggm_launch", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, FP, FP, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p])
    with torch.cuda.device(volume.device):
        err = fn(volume.data_ptr(), B, D, H, W, taps0, taps1, radius,
                 out.data_ptr(), _build.stream_handle(volume))
    _build.check_launch("ggm", err)
    return out
