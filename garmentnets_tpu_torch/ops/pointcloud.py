"""Point-cloud sampling and grouping (torch port of garmentnets_tpu/ops/pointcloud.py).

- `furthest_point_sampling`: the hand-written CUDA kernel (kernels/fps.py)
  for a CUDA tensor, the plain version below for a CPU tensor.
- `ball_query`: the K nearest points within a radius, chosen exactly: a
  candidate set from the expanded-quadratic distances is re-ranked on
  exact f32 differences, ties going to the lower index, so the card and
  the CPU choose the same neighbours.
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
def _exact_sq_dists(nbr: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """nbr [B, M, K, 3], c [B, M, 3] -> |nbr - c|^2 [B, M, K] as
    dx*dx + dy*dy + dz*dz, each operation rounded on its own (the same bits
    on the card and the CPU)."""
    diff = nbr - c[:, :, None, :]
    dx, dy, dz = diff.unbind(-1)
    return dx * dx + dy * dy + dz * dz


def ball_query(points: torch.Tensor, centers: torch.Tensor, radius: float,
               k: int = 64, chunk: int = 512):
    """K nearest neighbors of each center within `radius`.

    points [B, N, 3], centers [B, M, 3] -> (idx [B, M, K] int64,
    mask [B, M, K] bool), slots in order of distance. The 2K nearest
    candidates under the expanded-quadratic distances, built in M-chunks
    to bound memory, are re-ranked by their exact f32 distance, ties to
    the lower index, as one int64 key (the distance's bits above the
    index); the mask checks that distance against the radius. The choice
    is exact unless more than K points lie within the expanded quadratic's
    rounding (~1e-7 relative) of the K-th distance; the cuBLAS and CPU
    products round differently, and torch.topk breaks exact ties in its
    own order on each device, so without the re-rank a tie at the K-th
    slot could pick another neighbour on the card."""
    N = points.shape[1]
    r2 = float(np.float32(radius) ** 2)         # the radius squared in f32
    kk = min(k, N)
    kc = min(2 * k, N)
    idx_out, mask_out = [], []
    for c in torch.split(centers, chunk, dim=1):
        d2 = _sq_dists(c, points)                                 # [B,c,N]
        _, cand = torch.topk(d2, kc, dim=-1, largest=False)
        d2c = _exact_sq_dists(gather_rows(points, cand), c)       # [B,c,kc]
        key = (d2c.view(torch.int32).to(torch.int64) << 32) | cand
        key = torch.topk(key, kk, dim=-1, largest=False).values
        idx = key & 0xFFFFFFFF
        d2k = (key >> 32).to(torch.int32).view(torch.float32)
        if k > N:
            pad = (*idx.shape[:-1], k - N)
            idx = torch.cat([idx, idx[..., :1].expand(pad)], dim=-1)
            d2k = torch.cat([d2k, d2k[..., :1].expand(pad)], dim=-1)
        idx_out.append(idx)
        mask_out.append(d2k <= r2)
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
