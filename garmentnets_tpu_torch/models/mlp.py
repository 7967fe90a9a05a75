"""Point MLP with masked batch normalization (torch port of
garmentnets_tpu/models/mlp.py).

Reference components/mlp.py layout: `Seq(Seq(Linear, ReLU, BatchNorm1d))`
per layer, including the last, so the state_dict keys are
`{i}.0.weight`, `{i}.2.running_mean`, ...

In eval mode the BatchNorm runs on its running statistics (eps 1e-5) as
y = (x - mean) * (scale / sqrt(var + eps)) + bias, the JAX package's
formula. In training mode (`module.train()`) it normalizes with the
statistics of the batch, taken over the valid entries of an optional mask
only (the ball query's padded neighbour slots must not move them), and
updates the running statistics in place, as the JAX `MaskedBatchNorm`
does: biased variance for the normalization, the unbiased one into
`running_var`, momentum 0.1. Under data-parallel training the statistics
are the global batch's, as JAX's over a sharded batch
(`set_batch_norm_group`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn

from garmentnets_tpu_torch.parallel.mesh import all_reduce_sum


class PointMLP(nn.Sequential):
    """(Linear -> ReLU -> BatchNorm) per layer over the last axis of [..., C].

    `channels` includes the input width at index 0."""

    def __init__(self, channels: Sequence[int], batch_norm: bool = True):
        layers = []
        for c_in, c_out in zip(channels[:-1], channels[1:]):
            mods = [nn.Linear(c_in, c_out), nn.ReLU()]
            if batch_norm:
                mods.append(nn.BatchNorm1d(c_out))
            layers.append(nn.Sequential(*mods))
        super().__init__(*layers)
        # the process group over which training-mode statistics are taken
        # (set_batch_norm_group); None: this process's batch alone
        self.group = None

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [..., C_in] -> [..., C_out]; mask (read in training mode
        only): bool of shape x.shape[:-1], True where an entry counts in
        the batch statistics."""
        for layer in self:
            x = torch.relu(layer[0](x))
            if len(layer) > 2:
                x = (train_batch_norm(layer[2], x, mask, self.group)
                     if self.training else eval_batch_norm(layer[2], x))
        return x


def eval_batch_norm(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    inv = 1.0 / torch.sqrt(bn.running_var + bn.eps)
    return (x - bn.running_mean) * (inv * bn.weight) + bn.bias


def train_batch_norm(bn: nn.Module, x: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     group=None) -> torch.Tensor:
    """Batch statistics over every axis but the last, over the entries
    where `mask` is True when one is given (n = max(sum(mask), 1)); the
    gradient flows through the batch mean and variance. Updates bn's
    running statistics in place (no gradient): running = 0.9 * running +
    0.1 * batch, with the unbiased var * n / max(n - 1, 1) as the
    variance. With a process group, the statistics are those of the
    ranks' batches together: the sums (and the count, where a mask gives
    it) go through AllReduceSum, the mean first and then the sum of
    squared deviations from it, so every rank normalizes with and stores
    the same values."""
    dims = tuple(range(x.dim() - 1))
    if mask is None and group is None:
        # a Python count: a tensor made from it would wait on the card
        n = float(x[..., 0].numel())
        mean = x.mean(dims)
        var = ((x - mean) ** 2).mean(dims)
        n_less_1 = max(n - 1.0, 1.0)
    elif mask is None:
        n = float(x[..., 0].numel()) * dist.get_world_size(group)
        mean = all_reduce_sum(x.sum(dims), group) / n
        var = all_reduce_sum(((x - mean) ** 2).sum(dims), group) / n
        n_less_1 = max(n - 1.0, 1.0)
    else:
        w = mask.to(x.dtype)[..., None]
        sums = all_reduce_sum(
            torch.cat([(x * w).sum(dims), w.sum().reshape(1)]), group)
        n = torch.clamp(sums[-1], min=1.0)
        mean = sums[:-1] / n
        var = all_reduce_sum((((x - mean) ** 2) * w).sum(dims), group) / n
        n_less_1 = torch.clamp(n - 1.0, min=1.0)
    with torch.no_grad():
        m = bn.momentum
        unbiased = var * n / n_less_1
        bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean)
        bn.running_var.copy_((1 - m) * bn.running_var + m * unbiased)
        bn.num_batches_tracked.add_(1)
    inv = 1.0 / torch.sqrt(var + bn.eps)
    return (x - mean) * (inv * bn.weight) + bn.bias


def set_batch_norm_group(model: nn.Module, group) -> None:
    """Take the training-mode BatchNorm statistics of every PointMLP and
    U-Net BatchNorm of `model` over the ranks of `group` (None: over this
    process's batch alone)."""
    from garmentnets_tpu_torch.models.unet3d import BatchNorm3d
    for m in model.modules():
        if isinstance(m, (PointMLP, BatchNorm3d)):
            m.group = group
