"""Dense-lattice implicit decoding (torch port of garmentnets_tpu/ops/dense_decode.py).

Evaluates an eval-mode PointMLP head at every voxel center of the
volume_size^3 lattice. For a regular lattice the trilinear lookup is
separable, and the first affine layer commutes with interpolation (the
weights sum to 1), so layer 0 runs on the coarse grid before upsampling.

- `dense_decode_plain`: the separable slab version (D, then H, then W
  interpolation as small matmuls), the CPU path and the kernel's reference.
- `dense_decode`: on a CUDA tensor, the fused hand-written kernel
  (kernels/dense_decode.py, csrc/dense_decode.cu); on a CPU tensor, the
  plain version.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


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


def _slab_plan(S: int, D: int, slab: int):
    """Per-slab D-axis interpolation plan: each output slice interpolates
    exactly 2 adjacent source slices, so a slab of `slab` output slices only
    needs a `win`-wide contiguous source window. Returns
    (d0 [n_slabs] i32 window starts, w_win [n_slabs, slab, win] f32 weights,
    win)."""
    n_slabs = S // slab
    pos = np.arange(S) * (D - 1) / max(S - 1, 1)
    lo = np.clip(np.floor(pos).astype(np.int64), 0, D - 2)  # pair base
    frac = (pos - lo).astype(np.float32)
    slab_base = lo.reshape(n_slabs, slab)
    d0 = slab_base.min(axis=1)
    win = int((slab_base.max(axis=1) + 1 - d0).max()) + 1
    d0 = np.minimum(d0, D - win)
    w_win = np.zeros((n_slabs, slab, win), np.float32)
    for i in range(n_slabs):
        for j in range(slab):
            off = slab_base[i, j] - d0[i]
            w_win[i, j, off] += 1 - frac[i * slab + j]
            w_win[i, j, off + 1] += frac[i * slab + j]
    return d0.astype(np.int32), w_win, win


def axis_plan(S: int, n: int, device="cpu"):
    """Per-output-index taps of one axis, formed as _slab_plan forms them
    (float64 positions, f32 weights), on `device`: (lo [S] int32 in
    [0, n-2], w [S, 2] f32 = (1 - frac, frac))."""
    pos = (torch.arange(S, dtype=torch.float64, device=device) * (n - 1)
           / max(S - 1, 1))
    lo = torch.clamp(torch.floor(pos), 0, n - 2)
    frac = (pos - lo).to(torch.float32)
    w = torch.stack([1 - frac, frac], dim=-1).contiguous()
    return lo.to(torch.int32), w


def _as_torch_layers(layers, device) -> list:
    return [tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                  for a in lay) for lay in layers]


def coarse_first_layer(feature_volume: torch.Tensor, layers) -> torch.Tensor:
    """Layer 0's affine part on the coarse grid: fv @ K0 + b0."""
    k0, b0 = layers[0][0], layers[0][1]
    return torch.einsum("bdhwc,co->bdhwo", feature_volume, k0) + b0


def dense_decode_plain(feature_volume: torch.Tensor, layers,
                       volume_size: int) -> torch.Tensor:
    """Separable slab decode. feature_volume [B, D, H, W, C]; layers:
    (K, b, g, s) per layer (numpy or torch). Returns [B, S, S, S] for a
    scalar head, else [B, S, S, S, O]."""
    dev = feature_volume.device
    layers = _as_torch_layers(layers, dev)
    B, D, H, W, C = feature_volume.shape
    S = volume_size
    slab = next(s for s in (8, 4, 2, 1) if S % s == 0)  # D slices at once
    z = coarse_first_layer(feature_volume, layers)
    g0, s0 = layers[0][2], layers[0][3]
    wh = torch.as_tensor(interp_matrix(S, H), device=dev)
    ww = torch.as_tensor(interp_matrix(S, W), device=dev)
    d0, w_win, win = _slab_plan(S, D, slab)
    w_win = torch.as_tensor(w_win, device=dev)
    out = []
    for i in range(S // slab):
        zz = z[:, int(d0[i]):int(d0[i]) + win]
        h = torch.einsum("sd,bdhwc->bshwc", w_win[i], zz)
        h = torch.einsum("oh,bshwc->bsowc", wh, h)
        h = torch.einsum("ow,bshwc->bshoc", ww, h)
        h = torch.relu(h) * g0 + s0
        for (k, b, g, s) in layers[1:]:
            h = torch.relu(h @ k + b) * g + s
        out.append(h)
    out = torch.cat(out, dim=1)
    return out[..., 0] if out.shape[-1] == 1 else out


def dense_decode(feature_volume: torch.Tensor, layers,
                 volume_size: int) -> torch.Tensor:
    """[B, D, H, W, C] -> [B, S, S, S]: the fused CUDA kernel for a CUDA
    tensor (scalar heads only), the plain slab version for a CPU tensor."""
    if feature_volume.is_cuda:
        from garmentnets_tpu_torch.kernels.dense_decode import (
            dense_decode_cuda)
        layers = _as_torch_layers(layers, feature_volume.device)
        z = coarse_first_layer(feature_volume, layers).contiguous()
        return dense_decode_cuda(z, layers, volume_size)
    return dense_decode_plain(feature_volume, layers, volume_size)
