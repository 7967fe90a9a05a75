"""Marching-cubes vertex normals on the device, with octahedral u8-pair
codes (torch port of garmentnets_tpu/ops/normals.py).

The host C++ kernel's normals are the lerp of the central-difference
gradients at a vertex's edge endpoints, normalized, outward (-grad) under
'ascent'. A vertex lies on a lattice edge, so the trilinear interpolation
of the per-voxel gradient at the vertex reduces to that lerp: the warp,
which already receives every vertex, computes the same normals from the
full-precision WNF and the host kernel skips its normals pass
(PredictEngine(device_normals=True)).

The gradient follows np.gradient at unit spacing (central 0.5 * (up - dn)
inside, one-sided at the borders; the isotropic 1/(S-1) divides out under
normalization). `sample_gradient_normals_oct` computes it at each vertex's
8 lattice corners only: per voxel the same f32 arithmetic as
`dense_gradient`, summed over the corners in the JAX package's order, with
no [B, S, S, S, 3] field (~1.6 GB at B=8, 256^3).

Codes: each unit vector becomes an octahedral pair of bytes, u | v << 8,
carried as its integer value (0..65535; the JAX package bitcasts the same
16 bits into an f16 lane). 16-bit octahedral codes have ~0.5 degree mean
and ~1 degree largest angular error.

Deviations from the host kernel's normals, both far below storage use:
the full-precision field against the host's int8 bricks, and interior
voxels whose neighbour brick was not shipped, where the host falls back
to a one-sided difference.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def dense_gradient(wnf: torch.Tensor) -> torch.Tensor:
    """np.gradient per axis at unit spacing: wnf [B, S, S, S] ->
    [B, S, S, S, 3]."""
    comps = []
    for axis in range(1, 4):
        n = wnf.shape[axis]
        g = 0.5 * (torch.roll(wnf, -1, axis) - torch.roll(wnf, 1, axis))
        g.narrow(axis, 0, 1).copy_(wnf.narrow(axis, 1, 1)
                                   - wnf.narrow(axis, 0, 1))
        g.narrow(axis, n - 1, 1).copy_(wnf.narrow(axis, n - 1, 1)
                                       - wnf.narrow(axis, n - 2, 1))
        comps.append(g)
    return torch.stack(comps, dim=-1)


def _voxel_gradient(flat: torch.Tensor, S: int, ijk) -> torch.Tensor:
    """dense_gradient at the voxels ijk (three [B, V] int64 index tensors)
    of the [B, S^3] field: [B, V, 3]."""
    def at(x, y, z):
        return torch.gather(flat, 1, (x * S + y) * S + z)

    center = at(*ijk)
    comps = []
    for a in range(3):
        i = ijk[a]
        up = list(ijk)
        up[a] = torch.clamp(i + 1, max=S - 1)
        dn = list(ijk)
        dn[a] = torch.clamp(i - 1, min=0)
        v_up, v_dn = at(*up), at(*dn)
        g = 0.5 * (v_up - v_dn)
        g = torch.where(i == 0, v_up - center, g)
        g = torch.where(i == S - 1, center - v_dn, g)
        comps.append(g)
    return torch.stack(comps, dim=-1)


def oct_encode(n: torch.Tensor) -> torch.Tensor:
    """Unit vectors [..., 3] -> octahedral codes [...] int32, u | v << 8."""
    ax = torch.abs(n).sum(dim=-1, keepdim=True)
    p = n[..., :2] / torch.clamp(ax, min=1e-12)
    # lower hemisphere: fold across the diagonal
    sign = torch.where(p >= 0, 1.0, -1.0)
    fold = (1.0 - torch.abs(p.flip(-1))) * sign
    p = torch.where(n[..., 2:3] < 0, fold, p)
    q = torch.clamp(torch.round((p * 0.5 + 0.5) * 255.0), 0, 255).to(
        torch.int32)
    return q[..., 0] | (q[..., 1] << 8)


def sample_gradient_normals_oct(wnf: torch.Tensor,
                                query_points: torch.Tensor,
                                ascent: bool) -> torch.Tensor:
    """The gradient of wnf [B, S, S, S] trilinearly sampled at normalized
    [0, 1] lattice points query_points [B, V, 3], normalized with the
    outward sign (-grad under 'ascent'), as octahedral codes [B, V]
    int32."""
    B, S = wnf.shape[0], wnf.shape[1]
    flat = wnf.reshape(B, -1)
    c = query_points.to(torch.float32) * (S - 1)
    i0 = torch.clamp(torch.floor(c).to(torch.int64), 0, S - 2)
    f = torch.clamp(c - i0.to(torch.float32), 0.0, 1.0)
    acc = torch.zeros(query_points.shape[:2] + (3,), dtype=torch.float32,
                      device=wnf.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((f[..., 0] if dx else 1 - f[..., 0])
                     * (f[..., 1] if dy else 1 - f[..., 1])
                     * (f[..., 2] if dz else 1 - f[..., 2]))
                g8 = _voxel_gradient(flat, S, (i0[..., 0] + dx,
                                               i0[..., 1] + dy,
                                               i0[..., 2] + dz))
                acc = acc + w[..., None] * g8
    n = -acc if ascent else acc
    norm = torch.sqrt((n * n).sum(dim=-1, keepdim=True))
    return oct_encode(n / torch.clamp(norm, min=1e-12))


def _oct_decode(u16: np.ndarray) -> np.ndarray:
    """The octahedral decode of u16 codes [...] -> unit vectors [..., 3]
    float32 (the JAX package's oct_decode_np on the same 16 bits)."""
    u = (u16 & 0xFF).astype(np.float32) / 255.0 * 2.0 - 1.0
    v = (u16 >> 8).astype(np.float32) / 255.0 * 2.0 - 1.0
    z = 1.0 - np.abs(u) - np.abs(v)
    # fold back the lower hemisphere
    t = np.clip(-z, 0.0, None)
    x = u + np.where(u >= 0, -t, t)
    y = v + np.where(v >= 0, -t, t)
    n = np.stack([x, y, z], axis=-1)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    return n.astype(np.float32)


@functools.lru_cache(maxsize=1)
def _oct_table() -> np.ndarray:
    """_oct_decode of all 65536 codes, [65536, 3] float32 (768 KB): a row
    lookup is ~10x faster than decoding ~10^5 codes a garment."""
    return _oct_decode(np.arange(65536, dtype=np.uint16))


def oct_decode_np(codes) -> np.ndarray:
    """Host inverse of oct_encode: integer codes [...] (u16 values, in any
    integer or exactly-integral float dtype) -> unit vectors [..., 3]
    float32."""
    u16 = np.asarray(codes).astype(np.uint16)
    return np.take(_oct_table(), u16, axis=0)
