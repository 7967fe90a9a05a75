"""Point -> voxel feature scatter (torch port of garmentnets_tpu/ops/scatter.py)."""
from __future__ import annotations

import torch


def scatter_to_grid(features: torch.Tensor, flat_idx: torch.Tensor,
                    num_cells: int, reduce: str = "max") -> torch.Tensor:
    """Segment-reduce per-point features into flat grid cells.

    features [B, N, C], flat_idx [B, N] int64 in [0, num_cells) ->
    [B, num_cells, C]. Empty cells are 0 (torch_scatter parity)."""
    B, N, C = features.shape
    idx = flat_idx[..., None].expand(-1, -1, C)
    out = features.new_zeros((B, num_cells, C))
    if reduce == "max":
        out.scatter_reduce_(1, idx, features, reduce="amax",
                            include_self=False)
    elif reduce == "sum":
        out.scatter_add_(1, idx, features)
    elif reduce == "mean":
        out.scatter_reduce_(1, idx, features, reduce="mean",
                            include_self=False)
    else:
        raise ValueError(f"unknown reduce {reduce!r}")
    return out
