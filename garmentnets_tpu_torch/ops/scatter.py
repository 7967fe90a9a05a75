"""Point -> voxel feature scatter (torch port of garmentnets_tpu/ops/scatter.py)."""
from __future__ import annotations

import torch


def scatter_to_grid(features: torch.Tensor, flat_idx: torch.Tensor,
                    num_cells: int, reduce: str = "max") -> torch.Tensor:
    """Segment-reduce per-point features into flat grid cells.

    features [B, N, C], flat_idx [B, N] int64 in [0, num_cells) ->
    [B, num_cells, C]. Empty cells are 0 (torch_scatter parity).

    The max starts from -inf, as the JAX package's segment_max does, and
    empty cells are zeroed after it: the gradient of a cell's max is then
    split evenly over the points that tie for it, as JAX splits it. (Into
    a zero-filled output without include_self, a cell whose max is exactly
    0 would also count the fill as a tie and pass on half the gradient.)"""
    B, N, C = features.shape
    idx = flat_idx[..., None].expand(-1, -1, C)
    if reduce == "max":
        out = features.new_full((B, num_cells, C), float("-inf"))
        out = out.scatter_reduce(1, idx, features, reduce="amax")
        return out.masked_fill(out == float("-inf"), 0.0)
    out = features.new_zeros((B, num_cells, C))
    if reduce == "sum":
        return out.scatter_add(1, idx, features)
    if reduce == "mean":
        return out.scatter_reduce(1, idx, features, reduce="mean",
                                  include_self=False)
    raise ValueError(f"unknown reduce {reduce!r}")
