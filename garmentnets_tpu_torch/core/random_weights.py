"""Seeded random weights: randomized ones for runs without a trained
checkpoint (seeded_init_), and flax's default initialization for training
(init_like_jax_)."""
from __future__ import annotations

import torch


@torch.no_grad()
def seeded_init_(model: torch.nn.Module, seed: int) -> None:
    """Overwrite every parameter and BatchNorm running statistic of `model`
    from a torch.Generator seeded with `seed`: uniform(+-1/sqrt(fan_in))
    for Linear/Conv3d/ConvTranspose3d weights and biases (fan_in read as
    weight[0].numel()), norm affines near (1, 0), and
    randomized running statistics (mean 0.2*N(0,1), var 0.5+U(0,1)) so
    eval-mode BatchNorm is not the identity."""
    gen = torch.Generator().manual_seed(seed)

    def uniform(shape, bound):
        return (torch.rand(shape, generator=gen) * 2 - 1) * bound

    for m in model.modules():
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv3d,
                          torch.nn.ConvTranspose3d)):
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


# flax's variance_scaling divides the std of a truncated normal by the std
# of the standard normal truncated at +-2
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_like_jax_(model: torch.nn.Module,
                   generator: torch.Generator) -> None:
    """Overwrite `model` with flax's default initializers, as the JAX
    package's training starts from them: Linear and Conv3d weights
    lecun-normal (a normal truncated at +-2 sigma, sigma = 1 /
    (0.87962566 sqrt(fan_in))), biases 0, norm scales 1 and biases 0,
    running mean 0 and variance 1. `generator` is a CPU generator; the
    values do not equal JAX's (the random streams differ), the
    distributions do."""
    for m in model.modules():
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv3d)):
            fan_in = m.weight[0].numel()
            w = torch.empty(m.weight.shape)
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                        generator=generator)
            m.weight.copy_(w / (_TRUNC_STD * fan_in ** 0.5))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (torch.nn.GroupNorm,
                            torch.nn.modules.batchnorm._BatchNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.reset_running_stats()
