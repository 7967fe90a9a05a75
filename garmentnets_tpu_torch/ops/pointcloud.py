"""Point-cloud sampling and grouping (torch port of garmentnets_tpu/ops/pointcloud.py).

- `furthest_point_sampling`: the hand-written CUDA kernel (kernels/fps.py)
  for a CUDA tensor, the plain version below for a CPU tensor.
- `ball_query`: the K nearest points within a radius, with an exact f32
  recheck of the chosen candidates.
- `knn_interpolate`: inverse-squared-distance kNN interpolation.

Dense `[B, N, C]` batches with fixed point counts, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# furthest point sampling
# ---------------------------------------------------------------------------
def furthest_point_sampling_plain(pos: torch.Tensor,
                                  num_samples: int) -> torch.Tensor:
    """Plain PyTorch FPS: pos [B, N, 3] -> idx [B, M] int64.

    Start index 0, running minimum starting at +inf, first-occurrence
    argmax. The squared distance is written out as dx*dx + dy*dy + dz*dz
    (each op rounded on its own) so the CUDA kernel can match it exactly."""
    B, N, _ = pos.shape
    idx = torch.zeros((B, num_samples), dtype=torch.int64, device=pos.device)
    min_d = torch.full((B, N), float("inf"), dtype=pos.dtype,
                       device=pos.device)
    xs, ys, zs = pos[..., 0], pos[..., 1], pos[..., 2]
    rows = torch.arange(B, device=pos.device)
    last = idx[:, 0]
    for i in range(1, num_samples):
        p = pos[rows, last]                                       # [B,3]
        dx = xs - p[:, 0:1]
        dy = ys - p[:, 1:2]
        dz = zs - p[:, 2:3]
        d = dx * dx + dy * dy + dz * dz
        min_d = torch.minimum(min_d, d)
        last = torch.argmax(min_d, dim=-1)
        idx[:, i] = last
    return idx


def furthest_point_sampling(pos: torch.Tensor,
                            num_samples: int) -> torch.Tensor:
    """pos [B, N, 3] -> idx [B, M] int64: the CUDA kernel on the card, the
    plain version on the CPU."""
    if pos.is_cuda:
        from garmentnets_tpu_torch.kernels.fps import (
            furthest_point_sampling_cuda)
        return furthest_point_sampling_cuda(pos.contiguous(), num_samples)
    return furthest_point_sampling_plain(pos, num_samples)


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src [B, N, C], idx [B, ...] int64 -> [B, ..., C] (take_along_axis
    over the point axis)."""
    B, N, C = src.shape
    flat = idx.reshape(B, -1)
    out = torch.gather(src, 1, flat[..., None].expand(-1, -1, C))
    return out.reshape(*idx.shape, C)


def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a|^2 - 2 a.b + |b|^2 in f32: a [B, M, 3], b [B, N, 3] -> [B, M, N].
    The expanded quadratic of the JAX package (its K=3 contraction at
    HIGHEST precision; the engine runs it under core.device.full_f32)."""
    return ((a * a).sum(-1, keepdim=True)
            - 2.0 * torch.bmm(a, b.transpose(1, 2))
            + (b * b).sum(-1)[:, None, :])


# ---------------------------------------------------------------------------
# ball query (fixed-K nearest-within-radius)
# ---------------------------------------------------------------------------
def ball_query(points: torch.Tensor, centers: torch.Tensor, radius: float,
               k: int = 64, chunk: int = 512):
    """K nearest neighbors of each center within `radius`.

    points [B, N, 3], centers [B, M, 3] -> (idx [B, M, K] int64,
    mask [B, M, K] bool). Candidates come from an exact top-k of the
    expanded-quadratic distances, built in M-chunks to bound memory; the
    mask rechecks each chosen candidate's distance exactly in f32."""
    N = points.shape[1]
    r2 = float(np.float32(radius) ** 2)         # the radius squared in f32
    idx_out, mask_out = [], []
    for c in torch.split(centers, chunk, dim=1):
        d2 = _sq_dists(c, points)                                 # [B,c,N]
        _, idx = torch.topk(d2, min(k, N), dim=-1, largest=False)
        if k > N:
            idx = torch.cat([idx, idx[..., :1].expand(*idx.shape[:-1],
                                                      k - N)], dim=-1)
        nbr = gather_rows(points, idx)                            # [B,c,K,3]
        diff = nbr - c[:, :, None, :]
        d2_exact = (diff * diff).sum(-1)
        idx_out.append(idx)
        mask_out.append(d2_exact <= r2)
    return torch.cat(idx_out, dim=1), torch.cat(mask_out, dim=1)


# ---------------------------------------------------------------------------
# kNN inverse-distance interpolation
# ---------------------------------------------------------------------------
def knn_interpolate(src_feat: torch.Tensor, src_pos: torch.Tensor,
                    dst_pos: torch.Tensor, k: int = 3) -> torch.Tensor:
    """src_feat [B, S, C], src_pos [B, S, 3], dst_pos [B, T, 3] ->
    [B, T, C] with weights 1 / max(d^2, 1e-16) over the exact top-k."""
    d2 = _sq_dists(dst_pos, src_pos)                              # [B,T,S]
    kk = min(k, src_pos.shape[1])
    d2k, idx = torch.topk(d2, kk, dim=-1, largest=False)
    w = 1.0 / torch.clamp(d2k, min=1e-16)                         # [B,T,k]
    feats = gather_rows(src_feat, idx)                            # [B,T,k,C]
    num = (w[..., None] * feats).sum(2)
    den = w.sum(2, keepdim=True)
    return num / den
