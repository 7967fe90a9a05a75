"""Launcher of the tensor-core dense-decode kernel (csrc/dense_decode_tc.cu).

Replaces garmentnets_tpu/ops/dense_decode_pallas.py at the JAX engine's
three precisions: 'highest' (bf16x6, f32-accurate), 'high' (bf16x3) and
'default' (bf16). The plain PyTorch version of the same function is
ops/dense_decode.dense_decode_plain at the same tier ('highest': f32; the
kernel's own bf16x6 arithmetic is dense_decode_plain(...,
kernel_products=True)).

The wrapper zero-pads every width to NP (64, 128 or 256) and packs each
hidden layer's weights, split into 1-3 bf16 parts, into the shared-memory
image of the kernel's wgmma B operand (`pack_wgmma_weights`), so that the
kernel loads a 32-row chunk with one bulk copy.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from garmentnets_tpu_torch.kernels import _build
from garmentnets_tpu_torch.ops.dense_decode import (
    axis_plan, check_precision, split_bf16_parts)

KC = 32             # weight rows per ring stage (csrc kKc)
MAX_MID = 8
WIDTHS = (64, 128, 256)
SMEM_LIMIT = 232448
PARTS = {"highest": 3, "high": 2, "default": 1}


def padded_width(widths) -> int:
    """The kernel's padded width NP for these layer widths."""
    top = max(widths)
    for np_ in WIDTHS:
        if top <= np_:
            return np_
    raise ValueError(f"dense decode kernel supports widths <= {WIDTHS[-1]},"
                     f" got {list(widths)}")


def core_index(row, k, kgroups: int):
    """Element index of (row, k) in a K-major no-swizzle wgmma operand
    whose 8-row groups hold `kgroups` 8x8 core matrices (csrc
    core_offset, in elements)."""
    return ((row // 8) * kgroups + k // 8) * 64 + (row % 8) * 8 + k % 8


def pack_wgmma_weights(k: torch.Tensor, np_: int, parts: int,
                       rows: int | None = None, kc: int = KC
                       ) -> torch.Tensor:
    """K [cin, cout] f32 -> [rows/kc, parts, np_ * kc] bf16: per kc-row
    chunk of K (zero-padded to [rows, np_], rows = np_ by default), its
    `parts` bf16 parts (split_bf16_parts: hi, then lo or mid and lo), each
    as the kernel's B-operand image: element (n, kk) of chunk c (B = K^T,
    K-major) at core_index(n, kk, kc // 8)."""
    rows = np_ if rows is None else rows
    cin, cout = k.shape
    if cin > rows or cout > np_ or rows % kc or np_ % 8 or kc % 8:
        raise ValueError(f"cannot pack a [{cin}, {cout}] layer at "
                         f"[{rows}, {np_}] in {kc}-row chunks")
    w = torch.zeros(rows, np_, dtype=torch.float32, device=k.device)
    w[:cin, :cout] = k
    out = []
    for part in split_bf16_parts(w, parts):
        # (c, kg, k8, ng, n8) -> (c, ng, kg, n8, k8)
        t = part.reshape(rows // kc, kc // 8, 8, np_ // 8, 8)
        out.append(t.permute(0, 3, 1, 4, 2).reshape(rows // kc, np_ * kc))
    return torch.stack(out, dim=1).contiguous()


def unpack_wgmma_weights(packed: torch.Tensor, np_: int) -> tuple:
    """The inverse of pack_wgmma_weights: every part as [np_, np_]."""
    parts = []
    for i in range(packed.shape[1]):
        t = packed[:, i].reshape(np_ // KC, np_ // 8, KC // 8, 8, 8)
        parts.append(t.permute(0, 2, 4, 1, 3).reshape(np_, np_))
    return tuple(parts)


@dataclass
class PackedDecoder:
    """A decoder's layers laid out for the kernel at one tier."""
    precision: str
    np_: int
    c1: int
    n_mid: int
    aff0: torch.Tensor      # [2, NP] g0, s0
    wts: torch.Tensor       # [n_mid, NP/KC, parts, NP*KC] bf16
    epi: torch.Tensor       # [n_mid, 3, NP] b, g, s
    head: torch.Tensor      # [NP + 3] k, b, g, s


def _pad(v: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros(n, dtype=torch.float32, device=v.device)
    out[:v.numel()] = v.reshape(-1)
    return out


def pack_decoder(layers, precision: str) -> PackedDecoder:
    """Layers (K, b, g, s) f32 tensors, layer 0 first (its K and b are
    applied outside the kernel), scalar head last."""
    precision = check_precision(precision)
    mids, (k_head, b_head, g_head, s_head) = layers[1:-1], layers[-1]
    if k_head.shape[1] != 1:
        raise ValueError("dense decode kernel supports a scalar head only, "
                         f"got {k_head.shape[1]} output channels")
    c1 = layers[0][0].shape[1]
    widths = [c1] + [k.shape[1] for (k, _, _, _) in mids]
    if len(mids) > MAX_MID:
        raise ValueError(f"dense decode kernel supports <= {MAX_MID} hidden "
                         f"layers, got {len(mids)}")
    np_ = padded_width(widths)
    for l, (k, _, _, _) in enumerate(mids):
        if k.shape[0] != widths[l]:
            raise ValueError(f"hidden layer {l}: K is {tuple(k.shape)}, "
                             f"expected {widths[l]} input rows")
    if k_head.shape[0] != widths[-1]:
        raise ValueError("head width does not match the last hidden layer")
    dev = k_head.device
    parts = PARTS[precision]
    aff0 = torch.stack([_pad(layers[0][2], np_), _pad(layers[0][3], np_)])
    if mids:
        wts = torch.stack([pack_wgmma_weights(k.float(), np_, parts)
                           for (k, _, _, _) in mids])
        epi = torch.stack([torch.stack([_pad(b, np_), _pad(g, np_),
                                        _pad(s, np_)])
                           for (_, b, g, s) in mids])
    else:
        wts = torch.zeros(1, 1, 1, 8, dtype=torch.bfloat16, device=dev)
        epi = torch.zeros(1, 3, np_, dtype=torch.float32, device=dev)
    head = torch.cat([_pad(k_head[:, 0], np_), b_head.float().reshape(1),
                      g_head.float().reshape(1), s_head.float().reshape(1)])
    return PackedDecoder(precision, np_, c1, len(mids), aff0.contiguous(),
                         wts.contiguous(), epi.contiguous(),
                         head.contiguous())


def tile_rows(np_: int, parts: int) -> int:
    """Fine voxels per tile of the kernel's instance at padded width np_
    and `parts` bf16 parts, as the library decides it (csrc tile_rows: 64
    where three A parts of 128 rows and a weight ring would not fit in
    shared memory, else 128). Builds the kernel's library."""
    fn = _build.load("dense_decode_tc").dense_decode_tc_tile_rows
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    return fn(np_, parts)


def line_window(S: int, wc: int, rows: int = 128) -> int:
    """The most coarse W columns one `rows`-voxel tile's upsample reads."""
    lo = np.floor(np.arange(S) * (wc - 1) / max(S - 1, 1))
    lo = np.clip(lo, 0, wc - 2).astype(np.int64)
    starts = lo[::rows]
    ends = lo[np.minimum(np.arange(0, S, rows) + rows, S) - 1]
    return int((ends + 2 - starts).max())


def dense_decode_tc_cuda(z: torch.Tensor, packed: PackedDecoder,
                         volume_size: int, d_range=None) -> torch.Tensor:
    """z: [B, D, H, W, C1] float32 CUDA, the coarse layer-0 pre-activations
    (fv @ K0 + b0); packed: pack_decoder's output on the same device;
    d_range: (d_begin, d_count), the strip of D planes to decode (None:
    all S). Returns the [B, d_count, S, S] float32 field, equal bit for
    bit to that slice of the whole field."""
    _build.require_cuda(z, "dense decode z")
    if z.dim() != 5:
        raise ValueError(f"dense decode: z must be [B,D,H,W,C], got "
                         f"{tuple(z.shape)}")
    B, D, H, W, C1 = z.shape
    S = volume_size
    if min(D, H, W) < 2:
        raise ValueError("dense decode: coarse grid dims must be >= 2")
    d_begin, d_count = (0, S) if d_range is None else map(int, d_range)
    if d_begin < 0 or d_count < 1 or d_begin + d_count > S:
        raise ValueError(f"dense decode: D range {d_range} outside "
                         f"0..{S}")
    if C1 != packed.c1:
        raise ValueError(f"dense decode: z has {C1} channels, the layers "
                         f"{packed.c1}")
    for name in ("aff0", "epi", "head"):
        _build.require_cuda(getattr(packed, name), f"dense decode {name}")
    _build.require_cuda(packed.wts, "dense decode weights", torch.bfloat16)
    parts = PARTS[packed.precision]
    win = line_window(S, W, tile_rows(packed.np_, parts))
    smem = _build.load("dense_decode_tc").dense_decode_tc_smem
    smem.argtypes = [ctypes.c_int] * 3
    smem.restype = ctypes.c_longlong
    if smem(packed.np_, parts, win) > SMEM_LIMIT:
        raise ValueError(f"dense decode kernel: a tile reads {win} coarse W "
                         f"columns, more than fit beside width "
                         f"{packed.np_} in shared memory")
    dev = z.device
    (lo_d, w_d), (lo_h, w_h), (lo_w, w_w) = (
        axis_plan(S, D, dev), axis_plan(S, H, dev), axis_plan(S, W, dev))
    out = torch.empty((B, d_count, S, S), dtype=torch.float32, device=dev)

    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.cuda_fn("dense_decode_tc", "dense_decode_tc_launch", [
        P, I, I, I, I, I, I, I, I, P, P, P, P, P, P, P, P, P, P, I, I, I, I,
        P, P])
    with torch.cuda.device(dev):
        err = fn(z.data_ptr(), B, D, H, W, C1, S, d_begin, d_count,
                 lo_d.data_ptr(), w_d.data_ptr(), lo_h.data_ptr(),
                 w_h.data_ptr(), lo_w.data_ptr(), w_w.data_ptr(),
                 packed.aff0.data_ptr(), packed.wts.data_ptr(),
                 packed.epi.data_ptr(), packed.head.data_ptr(),
                 packed.n_mid, packed.np_, parts, win, out.data_ptr(),
                 _build.stream_handle(z))
    _build.check_launch("dense_decode_tc", err)
    return out
