"""Dense-lattice implicit decoding (torch port of garmentnets_tpu/ops/dense_decode.py).

Evaluates an eval-mode PointMLP head at every voxel center of the
volume_size^3 lattice. For a regular lattice the trilinear lookup is
separable, and the first affine layer commutes with interpolation (the
weights sum to 1), so layer 0 runs on the coarse grid before upsampling.

Precision tiers of the hidden layers' products, the JAX engine's own
(`garmentnets_tpu/ops/dense_decode_pallas.py::_mm`):
- 'highest': f32. The card's kernel computes it as bf16x6: both operands
  split into three bf16 parts (`split_bf16_3`) and the six products of
  order 1, 2^-8 and 2^-16 accumulated in f32 (`bf16x6_matmul`, the
  kernel's arithmetic; the CPU path does not use it).
- 'high': bf16x3. Both operands split into a bf16 high part and a bf16
  residual (`split_bf16`); hi*hi + hi*lo + lo*hi, accumulated in f32.
- 'default': hi*hi alone.
The trilinear upsample and the scalar head stay in f32 at every tier.

- `dense_decode_plain`: the separable slab version (two-tap interpolation
  along D, then H, then W, rounded as the kernels round it), the CPU path
  and the kernel's reference.
- `dense_decode`: on a CUDA tensor, the tensor-core kernel at the tier
  (kernels/dense_decode_tc.py, csrc/dense_decode_tc.cu); on a CPU tensor,
  the plain version of the tier.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


PRECISIONS = ("highest", "high", "default")


def check_precision(precision: str) -> str:
    """The tier's canonical name; raises on an unknown one."""
    key = str(precision).lower()
    if key not in PRECISIONS:
        raise ValueError(f"decode_precision must be one of "
                         f"{sorted(PRECISIONS)}, got {precision!r}")
    return key


def split_bf16(x: torch.Tensor):
    """(hi, lo) bf16 with hi = bf16(x) and lo = bf16(x - f32(hi)), both
    rounded to nearest even, as the JAX kernel's `_mm` splits."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(x.dtype)).to(torch.bfloat16)
    return hi, lo


def split_bf16_3(x: torch.Tensor):
    """(hi, mid, lo) bf16: hi = bf16(x), mid = bf16(x - hi),
    lo = bf16(x - hi - mid), each rounded to nearest even; both
    subtractions are exact in f32."""
    hi = x.to(torch.bfloat16)
    r = x - hi.to(x.dtype)
    mid = r.to(torch.bfloat16)
    lo = (r - mid.to(x.dtype)).to(torch.bfloat16)
    return hi, mid, lo


def split_bf16_parts(x: torch.Tensor, parts: int) -> tuple:
    """The first `parts` bf16 parts of x: (hi,), (hi, lo) or
    (hi, mid, lo)."""
    if parts == 3:
        return split_bf16_3(x)
    return split_bf16(x)[:parts]


def bf16x6_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w as the 'highest' kernel computes it: the six products of the
    three-part splits of order 1, 2^-8 and 2^-16, each exact in f32, summed
    in f32 (the three of order 2^-24 and below are dropped); the five small
    ones are summed apart and added to hi @ hi last, as the kernel's second
    accumulator does."""
    x0, x1, x2 = (t.float() for t in split_bf16_3(x))
    w0, w1, w2 = (t.float() for t in split_bf16_3(w))
    return x0 @ w0 + (x0 @ w1 + x1 @ w0 + x0 @ w2 + x1 @ w1 + x2 @ w0)


def tier_matmul(x: torch.Tensor, w: torch.Tensor, precision: str,
                kernel_products: bool = False) -> torch.Tensor:
    """x @ w at a tier. The products of two bf16 values are exact in f32,
    so the bf16 tiers are f32 matmuls of the split parts.
    kernel_products: at 'highest', the kernel's bf16x6 instead of f32."""
    if precision == "highest":
        return bf16x6_matmul(x, w) if kernel_products else x @ w
    xh, xl = (t.float() for t in split_bf16(x))
    wh, wl = (t.float() for t in split_bf16(w))
    if precision == "default":
        return xh @ wh
    return xh @ wh + xh @ wl + xl @ wh


def interp_matrix(s_out: int, s_in: int, dtype=np.float32) -> np.ndarray:
    """[s_out, s_in] align_corners linear interpolation weights."""
    w = np.zeros((s_out, s_in), dtype)
    if s_out == 1:
        w[0, 0] = 1
        return w
    pos = np.arange(s_out) * (s_in - 1) / max(s_out - 1, 1)
    lo = np.clip(np.floor(pos).astype(np.int64), 0, s_in - 1)
    hi = np.minimum(lo + 1, s_in - 1)
    f = (pos - lo).astype(dtype)
    w[np.arange(s_out), lo] += 1 - f
    w[np.arange(s_out), hi] += f
    return w


def eval_layers(mlp: torch.nn.Module) -> list:
    """A PointMLP's eval-mode layers as (K [in, out], b, g, s) with
    h -> g * relu(h @ K + b) + s: BatchNorm on its running statistics
    folded into g = scale / sqrt(var + eps), s = bias - mean * g (identity
    without BatchNorm)."""
    out = []
    for layer in mlp:
        lin = layer[0]
        k = lin.weight.detach().t().contiguous()
        b = lin.bias.detach()
        if len(layer) > 2:
            bn = layer[2]
            g = bn.weight.detach() / torch.sqrt(bn.running_var + bn.eps)
            s = bn.bias.detach() - bn.running_mean * g
        else:
            g = torch.ones_like(b)
            s = torch.zeros_like(b)
        out.append((k, b, g, s))
    return out


def axis_plan(S: int, n: int, device="cpu"):
    """Per-output-index taps of one axis, formed as interp_matrix forms
    them (float64 positions, f32 weights), on `device`: (lo [S] int32 in
    [0, n-2], w [S, 2] f32 = (1 - frac, frac))."""
    pos = (torch.arange(S, dtype=torch.float64, device=device) * (n - 1)
           / max(S - 1, 1))
    lo = torch.clamp(torch.floor(pos), 0, n - 2)
    frac = (pos - lo).to(torch.float32)
    w = torch.stack([1 - frac, frac], dim=-1).contiguous()
    return lo.to(torch.int32), w


def lerp_axis(x: torch.Tensor, dim: int, lo: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """Two-tap interpolation of x along `dim` with one axis's taps:
    w0 * x[lo] + w1 * x[lo + 1], each product and the sum rounded to f32,
    as the kernels compute it."""
    shape = [1] * x.dim()
    shape[dim] = -1
    lo = lo.long()
    return (w[:, 0].reshape(shape) * x.index_select(dim, lo)
            + w[:, 1].reshape(shape) * x.index_select(dim, lo + 1))


def _as_torch_layers(layers, device) -> list:
    return [tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                  for a in lay) for lay in layers]


def coarse_first_layer(feature_volume: torch.Tensor, layers) -> torch.Tensor:
    """Layer 0's affine part on the coarse grid: fv @ K0 + b0."""
    k0, b0 = layers[0][0], layers[0][1]
    return torch.einsum("bdhwc,co->bdhwo", feature_volume, k0) + b0


def dense_decode_plain(feature_volume: torch.Tensor, layers,
                       volume_size: int, precision: str = "highest",
                       kernel_products: bool = False) -> torch.Tensor:
    """Separable slab decode. feature_volume [B, D, H, W, C]; layers:
    (K, b, g, s) per layer (numpy or torch); precision: the tier of the
    hidden layers' products; kernel_products: 'highest' as the card's
    kernel computes it (bf16x6) instead of f32, for checking that kernel.
    Returns [B, S, S, S] for a scalar head, else [B, S, S, S, O]."""
    precision = check_precision(precision)
    dev = feature_volume.device
    layers = _as_torch_layers(layers, dev)
    B, D, H, W, C = feature_volume.shape
    S = volume_size
    slab = next(s for s in (8, 4, 2, 1) if S % s == 0)  # D slices at once
    z = coarse_first_layer(feature_volume, layers)
    g0, s0 = layers[0][2], layers[0][3]
    (lo_d, w_d), plan_h, plan_w = (
        axis_plan(S, D, dev), axis_plan(S, H, dev), axis_plan(S, W, dev))
    out = []
    for d0 in range(0, S, slab):
        # D, then H, then W, the kernels' order of the trilinear taps
        h = lerp_axis(z, 1, lo_d[d0:d0 + slab], w_d[d0:d0 + slab])
        h = lerp_axis(h, 2, *plan_h)
        h = lerp_axis(h, 3, *plan_w)
        h = torch.relu(h) * g0 + s0
        for (k, b, g, s) in layers[1:-1]:
            h = torch.relu(tier_matmul(h, k, precision, kernel_products)
                           + b) * g + s
        k, b, g, s = layers[-1]
        out.append(torch.relu(h @ k + b) * g + s)
    out = torch.cat(out, dim=1)
    return out[..., 0] if out.shape[-1] == 1 else out


def dense_decode(feature_volume: torch.Tensor, layers,
                 volume_size: int, precision: str = "highest",
                 packed=None) -> torch.Tensor:
    """[B, D, H, W, C] -> [B, S, S, S] at a precision tier: for a CUDA
    tensor the tensor-core kernel of the tier, scalar heads only; for a CPU
    tensor the plain slab version of the tier. `packed`: the kernel's
    weights from kernels/dense_decode_tc.pack_decoder for these layers and
    this tier (packed on the fly when None)."""
    precision = check_precision(precision)
    if not feature_volume.is_cuda:
        return dense_decode_plain(feature_volume, layers, volume_size,
                                  precision)
    layers = _as_torch_layers(layers, feature_volume.device)
    z = coarse_first_layer(feature_volume, layers).contiguous()
    from garmentnets_tpu_torch.kernels.dense_decode_tc import (
        dense_decode_tc_cuda, pack_decoder)
    if packed is None:
        packed = pack_decoder(layers, precision)
    return dense_decode_tc_cuda(z, packed, volume_size)
