"""PointNet++ set abstraction and feature propagation, dense-batch (torch
port of garmentnets_tpu/models/pointnet2.py).

Module names follow the reference Lightning layout (`conv.local_nn` for the
set-abstraction MLP, `nn` for the global SA and FP MLPs) so a reference
state_dict loads as it is.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from garmentnets_tpu_torch.kernels.sa_tc import pack_sa_layers
from garmentnets_tpu_torch.models.mlp import PointMLP
from garmentnets_tpu_torch.ops.dense_decode import eval_layers
from garmentnets_tpu_torch.ops.pointcloud import (
    ball_query, furthest_point_sampling, gather_rows, knn_interpolate)
from garmentnets_tpu_torch.ops.set_abstraction import sa_fused


class _PointConv(nn.Module):
    """Holds the edge MLP under PyG PointConv's key name (local_nn)."""

    def __init__(self, local_nn: nn.Module):
        super().__init__()
        self.local_nn = local_nn


class SAModule(nn.Module):
    """FPS -> ball query -> MLP over concat(x_j, p_j - p_i) -> masked max.

    In eval mode the last three steps are ops/set_abstraction.sa_fused (the
    fused CUDA kernel for a CUDA tensor); in training mode, stock ops, the
    MLP's batch statistics taken over the valid neighbour slots only (the
    kernel has no backward, as the JAX package's has none)."""

    def __init__(self, ratio: float, radius: float,
                 mlp_channels: Sequence[int], max_neighbors: int = 64,
                 batch_norm: bool = True):
        super().__init__()
        self.ratio = ratio
        self.radius = radius
        self.max_neighbors = max_neighbors
        self.conv = _PointConv(PointMLP(mlp_channels, batch_norm))
        self._eval_key = None
        self._eval_cache = None

    def folded_layers(self, device: torch.device):
        """The MLP folded for eval mode, (K, b, g, s) per layer, and on the
        card its packed image for the kernel (None on the CPU). Cached until
        a parameter or buffer of the MLP changes: load_state_dict, an
        optimizer step and the training-mode running-statistics update all
        write in place, which bumps the tensors' version counters."""
        mlp = self.conv.local_nn
        key = (str(device), tuple((t.data_ptr(), t._version) for t in
                                  (*mlp.parameters(), *mlp.buffers())))
        if key != self._eval_key:
            layers = eval_layers(mlp)
            packed = (pack_sa_layers(layers, layers[0][0].shape[0])
                      if device.type == "cuda" else None)
            self._eval_cache, self._eval_key = (layers, packed), key
        return self._eval_cache

    def forward(self, x: torch.Tensor, pos: torch.Tensor):
        B, N, _ = pos.shape
        M = int(N * self.ratio)
        idx = furthest_point_sampling(pos, M)                      # [B,M]
        centers = gather_rows(pos, idx)                            # [B,M,3]
        nbr_idx, nbr_mask = ball_query(pos, centers, self.radius,
                                       k=self.max_neighbors)       # [B,M,K]
        if not self.training:
            layers, packed = self.folded_layers(x.device)
            return sa_fused(x, pos, centers, nbr_idx, nbr_mask, layers,
                            packed), centers
        # training mode: stock ops, one gather of the combined [x | pos] rows
        C = x.shape[-1]
        nbr = gather_rows(torch.cat([x, pos], dim=-1), nbr_idx)    # [B,M,K,C+3]
        rel = nbr[..., C:] - centers[:, :, None, :]
        h = self.conv.local_nn(torch.cat([nbr[..., :C], rel], dim=-1),
                               mask=nbr_mask)
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
