"""Launcher of the fused set-abstraction kernel (csrc/sa.cu).

Replaces garmentnets_tpu/kernels/sa_pallas.py (sa_fused). The plain
PyTorch version of the same function is
ops/set_abstraction.sa_fused_plain.
"""
from __future__ import annotations

import ctypes

import torch

from garmentnets_tpu_torch.kernels import _build

MAX_WIDTH = 256
MAX_LAYERS = 8
MAX_SLOTS = 64
SLOT_PADS = (8, 16, 32, 64)   # the kernel's neighbour-slot counts


def _pad32(c: int) -> int:
    return -(-c // 32) * 32


def pack_layers(layers, cin0: int, device) -> tuple:
    """(K [cin, cout], b, g, s) per layer -> (one flat f32 buffer, padded
    output widths, real last width). Every output width is zero-padded to a
    multiple of 32: a padded column has zero weights and zero b, g, s, so
    it holds 0 and adds nothing to the next layer."""
    parts, couts = [], []
    cin, cin_p = cin0, cin0
    for l, (k, b, g, s) in enumerate(layers):
        if k.dim() != 2 or k.shape[0] != cin:
            raise ValueError(f"sa layer {l}: K is {tuple(k.shape)}, expected "
                             f"{cin} input rows")
        cout = k.shape[1]
        cout_p = _pad32(cout)
        kp = torch.zeros((cin_p, cout_p), dtype=torch.float32, device=device)
        kp[:cin, :cout] = k
        vecs = torch.zeros((3, cout_p), dtype=torch.float32, device=device)
        vecs[0, :cout], vecs[1, :cout], vecs[2, :cout] = b, g, s
        parts += [kp.reshape(-1), vecs.reshape(-1)]
        couts.append(cout_p)
        cin, cin_p = cout, cout_p
    return torch.cat(parts).contiguous(), couts, cin


def sa_cuda(x: torch.Tensor, pos: torch.Tensor, centers: torch.Tensor,
            idx: torch.Tensor, mask: torch.Tensor, layers) -> torch.Tensor:
    """x [B, N, Cin], pos [B, N, 3], centers [B, M, 3] float32 CUDA;
    idx [B, M, K] int64 in [0, N) and mask [B, M, K] bool; layers:
    (K [cin, cout], b, g, s) float32 tensors on the same device, the first
    with Cin + 3 input rows. Returns [B, M, C_out] float32."""
    _build.require_cuda(x, "sa x")
    _build.require_cuda(pos, "sa pos")
    _build.require_cuda(centers, "sa centers")
    _build.require_cuda(idx, "sa idx", torch.int64)
    _build.require_cuda(mask, "sa mask", torch.bool)
    if x.dim() != 3 or pos.shape != (*x.shape[:2], 3):
        raise ValueError(f"sa: x {tuple(x.shape)} and pos {tuple(pos.shape)} "
                         "must be [B, N, C] and [B, N, 3]")
    B, N, Cin = x.shape
    if idx.dim() != 3 or idx.shape[0] != B or mask.shape != idx.shape:
        raise ValueError(f"sa: idx {tuple(idx.shape)} and mask "
                         f"{tuple(mask.shape)} must both be [B, M, K]")
    M, K = idx.shape[1], idx.shape[2]
    if centers.shape != (B, M, 3):
        raise ValueError(f"sa: centers must be [{B}, {M}, 3], got "
                         f"{tuple(centers.shape)}")
    if not 1 <= K <= MAX_SLOTS:
        raise ValueError(f"sa kernel supports 1 <= K <= {MAX_SLOTS} "
                         f"neighbour slots, got {K}")
    if not 1 <= len(layers) <= MAX_LAYERS or max(
            k.shape[1] for k, _, _, _ in layers) > MAX_WIDTH:
        raise ValueError(f"sa kernel supports 1..{MAX_LAYERS} layers of "
                         f"width <= {MAX_WIDTH}")
    dev = x.device
    kp = next(p for p in SLOT_PADS if p >= K)
    if kp != K:
        # padded slots are invalid: the kernel neither gathers them nor
        # takes them into the max
        idx = torch.cat([idx, idx.new_zeros((B, M, kp - K))], dim=-1)
        mask = torch.cat([mask, mask.new_zeros((B, M, kp - K))], dim=-1)
    params, couts, cout_last = pack_layers(layers, Cin + 3, dev)
    out = torch.empty((B, M, cout_last), dtype=torch.float32, device=dev)

    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.cuda_fn("sa", "sa_launch", [
        P, P, P, P, P, I, I, I, I, I, P, I, ctypes.POINTER(ctypes.c_int), I,
        P, P])
    couts_c = (ctypes.c_int * len(couts))(*couts)
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), pos.data_ptr(), centers.data_ptr(),
                 idx.data_ptr(), mask.data_ptr(), B, N, M, Cin, kp,
                 params.data_ptr(), len(couts), couts_c, cout_last,
                 out.data_ptr(), _build.stream_handle(x))
    _build.check_launch("sa", err)
    return out
