"""Launcher of the fused dense-decode kernel (csrc/dense_decode.cu).

Replaces garmentnets_tpu/ops/dense_decode_pallas.py. The plain PyTorch
version of the same function is ops/dense_decode.dense_decode_plain.
"""
from __future__ import annotations

import ctypes

import torch

from garmentnets_tpu_torch.kernels import _build
from garmentnets_tpu_torch.ops.dense_decode import axis_plan

MAX_WIDTH = 256
MAX_MID = 8


def dense_decode_cuda(z: torch.Tensor, layers, volume_size: int
                      ) -> torch.Tensor:
    """z: [B, D, H, W, C1] float32 CUDA, the coarse layer-0 pre-activations
    (fv @ K0 + b0); layers: (K, b, g, s) float32 tensors on the same
    device, layer 0 first. Returns the [B, S, S, S] float32 field."""
    _build.require_cuda(z, "dense decode z")
    if z.dim() != 5:
        raise ValueError(f"dense decode: z must be [B,D,H,W,C], got "
                         f"{tuple(z.shape)}")
    B, D, H, W, C1 = z.shape
    S = volume_size
    if min(D, H, W) < 2:
        raise ValueError("dense decode: coarse grid dims must be >= 2")
    mids, (k_head, b_head, g_head, s_head) = layers[1:-1], layers[-1]
    if k_head.shape[1] != 1:
        raise ValueError("dense decode kernel supports a scalar head only, "
                         f"got {k_head.shape[1]} output channels")
    widths = [C1] + [k.shape[1] for (k, _, _, _) in mids]
    if len(mids) > MAX_MID or max(widths) > MAX_WIDTH:
        raise ValueError(f"dense decode kernel supports <= {MAX_MID} hidden "
                         f"layers of width <= {MAX_WIDTH}, got {widths}")
    for l, (k, _, _, _) in enumerate(mids):
        if k.shape[0] != widths[l]:
            raise ValueError(f"hidden layer {l}: K is {tuple(k.shape)}, "
                             f"expected {widths[l]} input rows")
    if k_head.shape[0] != widths[-1]:
        raise ValueError("head width does not match the last hidden layer")

    dev = z.device
    f32 = dict(dtype=torch.float32, device=dev)
    aff0 = torch.stack([layers[0][2], layers[0][3]]).to(**f32).contiguous()
    parts = [torch.cat([k.reshape(-1), b, g, s]) for (k, b, g, s) in mids]
    packed = (torch.cat(parts) if parts else torch.zeros(1)).to(
        **f32).contiguous()
    head = torch.cat([k_head[:, 0], b_head, g_head, s_head]).to(
        **f32).contiguous()
    (lo_d, w_d), (lo_h, w_h), (lo_w, w_w) = (
        axis_plan(S, D, dev), axis_plan(S, H, dev), axis_plan(S, W, dev))
    widths_c = (ctypes.c_int * len(widths))(*widths)
    out = torch.empty((B, S, S, S), **f32)

    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.cuda_fn("dense_decode", "dense_decode_launch", [
        P, I, I, I, I, I, P, P, P, P, P, P, P, P, I,
        ctypes.POINTER(ctypes.c_int), P, P, P])
    with torch.cuda.device(dev):
        err = fn(z.data_ptr(), B, D, H, W, S,
                 lo_d.data_ptr(), w_d.data_ptr(), lo_h.data_ptr(),
                 w_h.data_ptr(), lo_w.data_ptr(), w_w.data_ptr(),
                 aff0.data_ptr(), packed.data_ptr(), len(mids), widths_c,
                 head.data_ptr(), out.data_ptr(),
                 _build.stream_handle(z))
    _build.check_launch("dense_decode", err)
    return out
