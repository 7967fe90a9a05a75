"""Eval-mode set abstraction: neighbour gather, BN-folded MLP chain, masked
max over the neighbour slots (torch counterpart of
garmentnets_tpu/kernels/sa_pallas.py::sa_fused).

- `sa_fused_plain`: gather + `torch.matmul` chain + masked `amax`, at the
  tier `precision`: 'highest' (f32; the CPU path) or 'high' (bf16x3, the
  JAX kernel's "bf16_3x" `_mm`; the kernel's reference).
- `sa_fused`: on a CUDA tensor, the hand-written tensor-core kernel
  (kernels/sa_tc.py, csrc/sa_tc.cu; bf16x3); on a CPU tensor, the plain
  version in f32.

`layers` are (K [cin, cout], b, g, s) with h -> g * relu(h @ K + b) + s,
as `ops/dense_decode.eval_layers` folds them from a PointMLP.
"""
from __future__ import annotations

import torch

from garmentnets_tpu_torch.ops.dense_decode import tier_matmul
from garmentnets_tpu_torch.ops.pointcloud import gather_rows

PRECISIONS = ("highest", "high")


def sa_fused_plain(x: torch.Tensor, pos: torch.Tensor, centers: torch.Tensor,
                   idx: torch.Tensor, mask: torch.Tensor, layers,
                   precision: str = "highest") -> torch.Tensor:
    """x [B, N, Cin], pos [B, N, 3], centers [B, M, 3], idx/mask [B, M, K]
    -> [B, M, C_out]; a center with no valid slot gives -inf."""
    if precision not in PRECISIONS:
        raise ValueError(f"sa precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    C = x.shape[-1]
    nbr = gather_rows(torch.cat([x, pos], dim=-1), idx)       # [B,M,K,C+3]
    rel = nbr[..., C:] - centers[:, :, None, :]
    h = torch.cat([nbr[..., :C], rel], dim=-1)
    for k, b, g, s in layers:
        h = torch.relu(tier_matmul(h, k, precision) + b) * g + s
    h = h.masked_fill(~mask[..., None], float("-inf"))
    return h.amax(dim=2)


def sa_fused(x: torch.Tensor, pos: torch.Tensor, centers: torch.Tensor,
             idx: torch.Tensor, mask: torch.Tensor, layers,
             packed=None) -> torch.Tensor:
    """The CUDA kernel for a CUDA tensor, the plain f32 version for a CPU
    tensor (same arguments as sa_fused_plain; packed: the layers as
    kernels/sa_tc.pack_sa_layers lays them out, or None to pack them
    here)."""
    if x.is_cuda:
        from garmentnets_tpu_torch.kernels.sa_tc import sa_tc_cuda
        return sa_tc_cuda(x.contiguous(), pos.contiguous(),
                          centers.contiguous(), idx.contiguous(),
                          mask.contiguous(), layers, packed)
    return sa_fused_plain(x, pos, centers, idx, mask, layers)
