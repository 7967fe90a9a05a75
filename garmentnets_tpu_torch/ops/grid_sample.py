"""Trilinear volume sampling (torch port of garmentnets_tpu/ops/grid_sample.py).

align_corners=True (query q in [0, 1] maps to voxel coordinate q*(size-1)),
border padding (the sample position is clamped to the volume), query axis 0
indexing the volume's depth axis, and the JAX package's lerp order
(W first, then H, then D).
"""
from __future__ import annotations

import torch


def grid_sample_trilinear(volume: torch.Tensor,
                          query: torch.Tensor) -> torch.Tensor:
    """volume [B, D, H, W, C]; query [B, M, 3] in [0, 1] -> [B, M, C]."""
    B, D, H, W, C = volume.shape
    dims_i = torch.tensor([D - 1, H - 1, W - 1], device=volume.device)
    dims = dims_i.to(volume.dtype)
    q = query.to(volume.dtype) * dims
    q = torch.minimum(torch.clamp(q, min=0.0), dims)
    lo = torch.floor(q)
    frac = q - lo
    lo_i = lo.to(torch.int64)
    hi_i = torch.minimum(lo_i + 1, dims_i)
    flat = volume.reshape(B, D * H * W, C)

    def gather(ix, iy, iz):
        lin = (ix * H + iy) * W + iz                              # [B,M]
        return torch.gather(flat, 1, lin[..., None].expand(-1, -1, C))

    fx, fy, fz = frac[..., 0:1], frac[..., 1:2], frac[..., 2:3]
    x0, y0, z0 = lo_i[..., 0], lo_i[..., 1], lo_i[..., 2]
    x1, y1, z1 = hi_i[..., 0], hi_i[..., 1], hi_i[..., 2]
    c00 = gather(x0, y0, z0) * (1 - fz) + gather(x0, y0, z1) * fz
    c01 = gather(x0, y1, z0) * (1 - fz) + gather(x0, y1, z1) * fz
    c10 = gather(x1, y0, z0) * (1 - fz) + gather(x1, y0, z1) * fz
    c11 = gather(x1, y1, z0) * (1 - fz) + gather(x1, y1, z1) * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx
