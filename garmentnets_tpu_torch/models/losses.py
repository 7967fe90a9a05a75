"""Loss reductions (torch port of garmentnets_tpu/models/losses.py).

A batch may carry `_valid_mask` [B]: the JAX trainer pads a partial batch
up to a device-divisible size and marks the real rows there. Every loss
and metric reduction goes through masked_mean, so rows with mask 0 carry
no weight.
"""
from __future__ import annotations

from typing import Optional

import torch


def masked_mean(x: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of x over all elements, leaving out the batch rows where
    mask == 0. x: [B, ...]; mask: [B] float or bool, or None for a plain
    mean."""
    if mask is None:
        return x.mean()
    mask = mask.to(x.dtype)
    w = mask.reshape(mask.shape + (1,) * (x.dim() - 1))
    elems_per_row = x.numel() // x.shape[0]
    denom = torch.clamp(mask.sum() * elems_per_row, min=1.0)
    return (x * w).sum() / denom
