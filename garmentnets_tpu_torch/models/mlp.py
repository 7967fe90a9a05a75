"""Point MLP (torch port of garmentnets_tpu/models/mlp.py), eval mode.

Reference components/mlp.py layout: `Seq(Seq(Linear, ReLU, BatchNorm1d))`
per layer, including the last, so the state_dict keys are
`{i}.0.weight`, `{i}.2.running_mean`, ... The BatchNorm runs on its
running statistics (eps 1e-5) as y = (x - mean) * (scale / sqrt(var + eps))
+ bias, the JAX package's eval formula. Training-mode masked statistics are
not ported yet.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self:
            x = torch.relu(layer[0](x))
            if len(layer) > 2:
                x = eval_batch_norm(layer[2], x)
        return x


def eval_batch_norm(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    inv = 1.0 / torch.sqrt(bn.running_var + bn.eps)
    return (x - bn.running_mean) * (inv * bn.weight) + bn.bias

