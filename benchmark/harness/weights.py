"""Seeded weights, made on the device in one draw.

`seeded_state(spec, seed, device)` fills a state dict of the given names
and shapes from one `torch.rand` of a generator on `device`: a Linear or
convolution weight uniform in +-sqrt(6 / fan_in) (He), its bias in
+-1 / sqrt(fan_in), a norm's scale in 1 +- 0.1 and shift in +-0.1,
BatchNorm running means in +-0.1 and variances in [0.5, 1.5]. The same
seed on the same kind of device gives the same tensors, so the benchmark
can hand them to the port and make them again for the reference.
"""
from __future__ import annotations

import math

import torch


def state_spec(module: torch.nn.Module) -> dict:
    """name -> (shape, dtype) of a module's state dict (build the module
    on the meta device: nothing is allocated)."""
    return {k: (tuple(v.shape), v.dtype) for k, v in
            module.state_dict().items()}


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)


def seeded_state(spec: dict, seed: int, device) -> dict:
    floats = {k: s for k, (s, dt) in spec.items() if dt.is_floating_point}
    total = sum(math.prod(s) for s in floats.values())
    u = torch.rand(total, generator=generator(seed, device),
                   device=device) * 2 - 1          # uniform in [-1, 1)
    out, at = {}, 0
    fan_in = {}
    for k, s in floats.items():
        if len(s) >= 2:
            fan_in[k.rsplit(".", 1)[0]] = math.prod(s[1:])
    for k, (s, dt) in spec.items():
        if k not in floats:
            out[k] = torch.zeros(s, dtype=dt, device=device)
            continue
        n = math.prod(s)
        v = u[at:at + n].reshape(s)
        at += n
        owner, leaf = k.rsplit(".", 1)
        if leaf == "running_mean":
            v = 0.1 * v
        elif leaf == "running_var":
            v = 1.0 + 0.5 * v
        elif owner in fan_in:
            f = fan_in[owner]
            v = v * (math.sqrt(6.0 / f) if leaf == "weight"
                     else 1.0 / math.sqrt(f))
        elif leaf == "weight":
            v = 1.0 + 0.1 * v
        else:
            v = 0.1 * v
        out[k] = v.contiguous()
    return out
