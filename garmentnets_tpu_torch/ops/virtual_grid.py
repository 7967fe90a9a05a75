"""Virtual voxel grid index math (torch copy of garmentnets_tpu/ops/virtual_grid.py).

Maps between continuous points in an AABB and integer voxel indices, plus
the flat-index packing used by the scatter-to-volume path.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from garmentnets_tpu_torch.core.device import to_device


@dataclasses.dataclass(frozen=True)
class VirtualGrid:
    lower_corner: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    upper_corner: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    grid_shape: Tuple[int, int, int] = (32, 32, 32)

    def _f32(self, values, like: torch.Tensor) -> torch.Tensor:
        return to_device(values, like.device, torch.float32)

    def get_points_grid_idxs(self, points: torch.Tensor) -> torch.Tensor:
        """Continuous points (..., 3) -> clamped int64 voxel indices.

        Truncating float->int cast (toward zero), then a per-axis clamp to
        [0, grid_shape[i]-1], as the reference's VirtualGrid does."""
        lc = self._f32(self.lower_corner, points)
        uc = self._f32(self.upper_corner, points)
        scales = (self._f32(self.grid_shape, points) - 1) / (uc - lc)
        idxs = ((points - lc) * scales).to(torch.int64)
        hi = to_device(self.grid_shape, points.device, torch.int64) - 1
        return torch.minimum(torch.clamp(idxs, min=0), hi)

    def idxs_to_points(self, idxs: torch.Tensor) -> torch.Tensor:
        """Integer voxel indices (..., 3) -> voxel-center points, computed
        as idx * ((uc - lc) / (G - 1)) + lc in float32."""
        lc = self._f32(self.lower_corner, idxs)
        uc = self._f32(self.upper_corner, idxs)
        scales = (uc - lc) / (self._f32(self.grid_shape, idxs) - 1)
        return idxs.to(torch.float32) * scales + lc

    def flatten_idxs(self, idxs: torch.Tensor) -> torch.Tensor:
        """Pack (..., 3) integer coords into a flat row-major index."""
        g = self.grid_shape
        stride = to_device((g[1] * g[2], g[2], 1), idxs.device, idxs.dtype)
        return (idxs * stride).sum(dim=-1)

    @property
    def num_cells(self) -> int:
        return int(np.prod(self.grid_shape))
