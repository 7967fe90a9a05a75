"""PointNet++ set abstraction and feature propagation, dense-batch, eval mode
(torch port of garmentnets_tpu/models/pointnet2.py).

Module names follow the reference Lightning layout (`conv.local_nn` for the
set-abstraction MLP, `nn` for the global SA and FP MLPs) so a reference
state_dict loads as it is.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from garmentnets_tpu_torch.models.mlp import PointMLP
from garmentnets_tpu_torch.ops.pointcloud import (
    ball_query, furthest_point_sampling, gather_rows, knn_interpolate)


class _PointConv(nn.Module):
    """Holds the edge MLP under PyG PointConv's key name (local_nn)."""

    def __init__(self, local_nn: nn.Module):
        super().__init__()
        self.local_nn = local_nn


class SAModule(nn.Module):
    """FPS -> ball query -> MLP over concat(x_j, p_j - p_i) -> masked max."""

    def __init__(self, ratio: float, radius: float,
                 mlp_channels: Sequence[int], max_neighbors: int = 64,
                 batch_norm: bool = True):
        super().__init__()
        self.ratio = ratio
        self.radius = radius
        self.max_neighbors = max_neighbors
        self.conv = _PointConv(PointMLP(mlp_channels, batch_norm))

    def forward(self, x: torch.Tensor, pos: torch.Tensor):
        B, N, _ = pos.shape
        M = int(N * self.ratio)
        idx = furthest_point_sampling(pos, M)                      # [B,M]
        centers = gather_rows(pos, idx)                            # [B,M,3]
        nbr_idx, nbr_mask = ball_query(pos, centers, self.radius,
                                       k=self.max_neighbors)       # [B,M,K]
        # one gather of the combined [x | pos] rows
        C = x.shape[-1]
        nbr = gather_rows(torch.cat([x, pos], dim=-1), nbr_idx)    # [B,M,K,C+3]
        rel = nbr[..., C:] - centers[:, :, None, :]
        h = self.conv.local_nn(torch.cat([nbr[..., :C], rel], dim=-1))
        # masked max over neighbor slots (>= 1 valid: the center itself)
        h = h.masked_fill(~nbr_mask[..., None], float("-inf"))
        return h.amax(dim=2), centers


class GlobalSAModule(nn.Module):
    """Per-point MLP over [x | pos], then a global max pool."""

    def __init__(self, mlp_channels: Sequence[int], batch_norm: bool = True):
        super().__init__()
        self.nn = PointMLP(mlp_channels, batch_norm)

    def forward(self, x: torch.Tensor, pos: torch.Tensor):
        h = self.nn(torch.cat([x, pos], dim=-1))
        return h.amax(dim=1), pos.new_zeros((pos.shape[0], 1, 3))


class FPModule(nn.Module):
    """kNN interpolate -> skip concat -> MLP."""

    def __init__(self, k: int, mlp_channels: Sequence[int],
                 batch_norm: bool = True):
        super().__init__()
        self.k = k
        self.nn = PointMLP(mlp_channels, batch_norm)

    def forward(self, x, pos, x_skip, pos_skip):
        h = knn_interpolate(x, pos, pos_skip, k=self.k)
        h = torch.cat([h, x_skip], dim=-1)
        return self.nn(h), pos_skip
