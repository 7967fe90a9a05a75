"""Seeded random weights for runs without a trained checkpoint."""
from __future__ import annotations

import torch


@torch.no_grad()
def seeded_init_(model: torch.nn.Module, seed: int) -> None:
    """Overwrite every parameter and BatchNorm running statistic of `model`
    from a torch.Generator seeded with `seed`: uniform(+-1/sqrt(fan_in))
    for Linear/Conv3d weights and biases, norm affines near (1, 0), and
    randomized running statistics (mean 0.2*N(0,1), var 0.5+U(0,1)) so
    eval-mode BatchNorm is not the identity."""
    gen = torch.Generator().manual_seed(seed)

    def uniform(shape, bound):
        return (torch.rand(shape, generator=gen) * 2 - 1) * bound

    for m in model.modules():
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv3d)):
            bound = 1.0 / m.weight[0].numel() ** 0.5
            m.weight.copy_(uniform(m.weight.shape, bound))
            if m.bias is not None:
                m.bias.copy_(uniform(m.bias.shape, bound))
        elif isinstance(m, (torch.nn.GroupNorm,
                            torch.nn.modules.batchnorm._BatchNorm)):
            m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape,
                                                 generator=gen))
            m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.copy_(0.2 * torch.randn(
                    m.running_mean.shape, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(
                    m.running_var.shape, generator=gen))
