"""Loss reductions (torch port of garmentnets_tpu/models/losses.py).

A batch may carry `_valid_mask` [B]: the JAX trainer pads a partial batch
up to a device-divisible size and marks the real rows there. Every loss
and metric reduction goes through masked_mean, so rows with mask 0 carry
no weight. Under data-parallel training each rank's loss is its share of
the global batch's (`group`), and the shares sum to it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from garmentnets_tpu_torch.parallel.mesh import all_reduce_sum


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor],
                group=None) -> torch.Tensor:
    """Mean of x over all elements, leaving out the batch rows where
    mask == 0. x: [B, ...]; mask: [B] float or bool, or None for a plain
    mean. With a process group, x holds this rank's rows of the global
    batch: the numerator stays local and the denominator is the global
    count, so the ranks' results sum to the global mean and so do their
    gradients."""
    if mask is None:
        if group is None:
            return x.mean()
        return x.sum() / (x.numel() * dist.get_world_size(group))
    mask = mask.to(x.dtype)
    w = mask.reshape(mask.shape + (1,) * (x.dim() - 1))
    elems_per_row = x.numel() // x.shape[0]
    count = all_reduce_sum(mask.sum().detach(), group)
    denom = torch.clamp(count * elems_per_row, min=1.0)
    return (x * w).sum() / denom


def global_value(x: torch.Tensor, group=None) -> torch.Tensor:
    """The global value of a masked_mean share (the sum over the ranks),
    without a gradient: for a choice every rank must make alike."""
    return all_reduce_sum(x.detach(), group)
