"""Launcher of the tensor-core filter gradient of a 3x3x3 convolution at
stride 1 and padding 1 (csrc/conv3d_wgrad.cu): the stage-2 U-Nets'
SwapGradConv3d on a card (models/unet3d.weight_grad).

Replaces no TPU kernel (the JAX U-Net's convolution is lax.conv). The
kernel computes, f32-accurate (bf16x6: each operand split into three
bf16 parts, six of the nine part products),

    dW[co, ci, kd, kh, kw] =
        sum_{n,d,h,w} g[n, co, d, h, w] x[n, ci, d+kd-1, h+kh-1, w+kw-1]

as one GEMM a tap over K = B*D*H*W positions, in chunks of KC positions
that one TMA box covers, split over blocks by a plan made from the shape
alone (`make_plan`: the box, which operand is A and which is shifted by
the tap, the block's tile and the split of K). The
plain PyTorch version on the CPU is models/unet3d.swapped_weight_grad;
`conv3d_wgrad_emulated` repeats the kernel's indexing (chunks, taps,
padding edges, splits, the six part products, the reduction over the
splits) in plain torch, in float64, for the tests, and `wgrad_float64`
is the exact reference.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from garmentnets_tpu_torch.kernels import _build

KC = 32        # positions a chunk (csrc kKc)
ATOM = 64      # channels an operand atom: a 128-byte row of bf16
TAPS = 27
FILL = 3       # a block's fixed cost, in chunks: ring fill and epilogue
# the part products (A part, B part) the kernel keeps, in its order:
# orders 1, 2^-8, 2^-8, 2^-16, 2^-16, 2^-16
PAIRS = ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0))
SMS = 132      # an H100 SXM's multiprocessors (the wrapper asks the card)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _pow2ceil(n: int) -> int:
    return 1 << (n - 1).bit_length()


@dataclass(frozen=True)
class Plan:
    """How the kernel covers one shape. box: (bw, bh, bd, bn), the
    positions of a chunk (w fastest); grid: boxes along w, h, d, n. The
    GEMM's A operand is grad (a_is_x False) or x, padded to mp channels in
    64-channel atoms; B is the other, shifted by each tap (the other way
    where A is x), padded to np_ channels in atoms of bw (64, or 32 where
    that pads less). A block's tile is ma A atoms by na tap-atoms (tap, bw
    channels of B): tiles_m x tiles_n blocks for each of `splits` splits
    of `per_split` chunks."""
    box: tuple
    grid: tuple
    chunks: int
    a_is_x: bool
    mp: int
    np_: int
    bw: int
    ma: int
    tiles_m: int
    tiles_n: int
    splits: int
    per_split: int

    @property
    def na(self) -> int:
        return (1 if self.ma == 2 else 2) * (128 // self.bw)

    @property
    def nb(self) -> int:
        return self.np_ // self.bw

    @property
    def workspace_numel(self) -> int:
        return self.splits * self.mp * TAPS * self.np_


def _b_side(c: int) -> tuple:
    """(padded channels, atom) of c channels as the B operand."""
    bw = 32 if 0 < c % ATOM <= 32 else ATOM
    return _ceil(c, bw) * bw, bw


@functools.lru_cache(maxsize=256)
def make_plan(batch: int, depth: int, height: int, width: int, cin: int,
              cout: int, sms: int = SMS) -> Plan:
    """The box: KC positions, whole rows of w first (sides rounded up to
    powers of two; the TMA zero-fills the overhang). The roles: A the
    operand whose padding costs less product (grad unless that pads more).
    The tile: 128 rows of A where A pads to an even number of atoms, else
    64; a warpgroup's 128 columns of B. The split: the count of splits
    whose blocks fill `sms` multiprocessors in the fewest chunk-steps
    (waves x (chunks a block + FILL)), the fewest such."""
    for name, v in (("batch", batch), ("depth", depth), ("height", height),
                    ("width", width), ("cin", cin), ("cout", cout)):
        if v < 1:
            raise ValueError(f"conv3d wgrad: {name} must be >= 1, got {v}")
    bw = min(KC, _pow2ceil(width))
    bh = min(KC // bw, _pow2ceil(height))
    bd = min(KC // (bw * bh), _pow2ceil(depth))
    bn = KC // (bw * bh * bd)
    grid = (_ceil(width, bw), _ceil(height, bh), _ceil(depth, bd),
            _ceil(batch, bn))
    chunks = math.prod(grid)
    a_is_x = (_ceil(cin, ATOM) * _b_side(cout)[0]
              < _ceil(cout, ATOM) * _b_side(cin)[0])
    ca, cb = (cin, cout) if a_is_x else (cout, cin)
    mp = _ceil(ca, ATOM) * ATOM
    np_, atom = _b_side(cb)
    ma = 2 if mp % (2 * ATOM) == 0 else 1
    na = (1 if ma == 2 else 2) * (128 // atom)
    tiles_m = mp // (ATOM * ma)
    tiles_n = _ceil(TAPS * (np_ // atom), na)
    units = tiles_m * tiles_n
    top = min(chunks, max(1, 4 * sms))
    splits = min(range(1, top + 1), key=lambda s: (
        _ceil(units * s, sms) * (_ceil(chunks, s) + FILL), s))
    per_split = _ceil(chunks, splits)
    return Plan((bw, bh, bd, bn), grid, chunks, a_is_x, mp, np_, atom, ma,
                tiles_m, tiles_n, _ceil(chunks, per_split), per_split)


def tile_atoms(plan: Plan) -> list:
    """[(A atom, tap-atom)] each block computes, block by block
    (blockIdx.x = tm * tiles_n + tn), tap-atoms past the last left out:
    the kernel's cover of the output."""
    n_atoms = TAPS * plan.nb
    out = []
    for tm in range(plan.tiles_m):
        for tn in range(plan.tiles_n):
            out.append([(tm * plan.ma + m, tn * plan.na + a)
                        for m in range(plan.ma) for a in range(plan.na)
                        if tn * plan.na + a < n_atoms])
    return out


def split_parts(t: torch.Tensor, cp: int) -> torch.Tensor:
    """[B, C, D, H, W] float32 -> [3, B, D, H, W, cp]: the three bf16 parts
    (hi, mid, lo, as float32 values) channels-last, zeros at channels >= C;
    both subtractions are exact in f32, as in the kernel's split pass."""
    v = t.float().permute(0, 2, 3, 4, 1)
    v = torch.nn.functional.pad(v, (0, cp - v.shape[-1]))
    hi = v.to(torch.bfloat16).float()
    r = v - hi
    mid = r.to(torch.bfloat16).float()
    lo = (r - mid).to(torch.bfloat16).float()
    return torch.stack([hi, mid, lo])


def chunk_positions(plan: Plan, first: int, count: int) -> torch.Tensor:
    """[count * KC, 4] (n, d, h, w) of chunks first .. first + count - 1,
    each chunk's rows in the TMA box's order (w fastest, then h, d, n)."""
    bw, bh, bd, bn = plan.box
    nbw, nbh, nbd, _ = plan.grid
    c = torch.arange(first, first + count)
    w0 = (c % nbw) * bw
    h0 = (c // nbw % nbh) * bh
    d0 = (c // (nbw * nbh) % nbd) * bd
    n0 = c // (nbw * nbh * nbd) * bn
    r = torch.arange(KC)
    rows = torch.stack([r // (bw * bh * bd), r // (bw * bh) % bd,
                        r // bw % bh, r % bw], dim=1)          # [KC, 4]
    start = torch.stack([n0, d0, h0, w0], dim=1)               # [count, 4]
    return (start[:, None, :] + rows[None]).reshape(-1, 4)


def _gather(parts: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """parts [3, B, D, H, W, C] at positions [R, 4] -> [3, R, C] float64,
    zeros where a position lies outside (the TMA's zero fill)."""
    dims = torch.tensor(parts.shape[1:5])
    inside = ((pos >= 0) & (pos < dims)).all(dim=1)
    p = pos.clamp(min=0) % dims
    got = parts[:, p[:, 0], p[:, 1], p[:, 2], p[:, 3]].double()
    return got * inside[None, :, None]


def conv3d_wgrad_emulated(grad: torch.Tensor, x: torch.Tensor,
                          plan: Plan | None = None) -> torch.Tensor:
    """The kernel's filter gradient in plain torch: grad [B, Cout, D, H, W]
    and x [B, Cin, D, H, W] float32 split into their bf16 parts, the
    chunks of each split gathered as the TMA boxes load them (B shifted by
    each tap, zeros outside the volume), the six part products summed in
    float64 into the split's partial sums [splits, mp, 27, np], then the
    splits added in order and the padding cut off -> [Cout, Cin, 3, 3, 3]
    float64. The card's f32 roundings (each accumulation period's, the
    sum's, the reduction's) are the only difference."""
    B, cout, D, H, W = grad.shape
    cin = x.shape[1]
    if x.shape != (B, cin, D, H, W):
        raise ValueError(f"conv3d wgrad: x {tuple(x.shape)} does not match "
                         f"grad {tuple(grad.shape)}")
    plan = plan or make_plan(B, D, H, W, cin, cout)
    a_op, b_op = (x, grad) if plan.a_is_x else (grad, x)
    ap, bp = split_parts(a_op, plan.mp), split_parts(b_op, plan.np_)
    sign = -1 if plan.a_is_x else 1
    ws = torch.zeros(plan.splits, plan.mp, TAPS, plan.np_,
                     dtype=torch.float64)
    for s in range(plan.splits):
        first = s * plan.per_split
        pos = chunk_positions(plan, first,
                              min(plan.per_split, plan.chunks - first))
        a = _gather(ap, pos)
        for tap in range(TAPS):
            shift = sign * torch.tensor([0, tap // 9 - 1, tap // 3 % 3 - 1,
                                         tap % 3 - 1])
            b = _gather(bp, pos + shift)
            ws[s, :, tap] = sum(a[i].T @ b[j] for i, j in PAIRS)
    out = ws[0].clone()
    for s in range(1, plan.splits):
        out += ws[s]
    if plan.a_is_x:       # [ci, tap, co]
        out = out[:cin, :, :cout].permute(2, 0, 1)
    else:                 # [co, tap, ci]
        out = out[:cout, :, :cin].permute(0, 2, 1)
    return out.reshape(cout, cin, 3, 3, 3)


def wgrad_float64(grad: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The exact reference on any device: the same filter gradient in
    float64, one matmul a tap of the output gradient with the padded
    input's shifted window -> [Cout, Cin, 3, 3, 3] float64."""
    B, cout, D, H, W = grad.shape
    cin = x.shape[1]
    g2 = grad.double().transpose(0, 1).reshape(cout, -1)
    xp = torch.nn.functional.pad(x.double(), (1, 1, 1, 1, 1, 1))
    out = torch.empty(cout, cin, TAPS, dtype=torch.float64,
                      device=grad.device)
    for t in range(TAPS):
        kd, kh, kw = t // 9, t // 3 % 3, t % 3
        xs = xp[:, :, kd:kd + D, kh:kh + H, kw:kw + W]
        out[:, :, t] = g2 @ xs.transpose(0, 1).reshape(cin, -1).T
    return out.reshape(cout, cin, 3, 3, 3)


def conv3d_wgrad_cuda(grad: torch.Tensor, x: torch.Tensor,
                      plan: Plan | None = None) -> torch.Tensor:
    """grad [B, Cout, D, H, W] and x [B, Cin, D, H, W] float32 on one card
    -> the filter gradient [Cout, Cin, 3, 3, 3] of the convolution at
    stride 1 and padding 1 that took x to an output whose gradient is grad
    (one launch of the kernel's four passes; deterministic)."""
    _build.require_cuda(grad, "conv3d wgrad grad")
    x = x.contiguous()
    _build.require_cuda(x, "conv3d wgrad x")
    if grad.dim() != 5 or x.dim() != 5 or x.device != grad.device:
        raise ValueError(f"conv3d wgrad: expected [B, C, D, H, W] tensors "
                         f"on one device, got {tuple(grad.shape)} and "
                         f"{tuple(x.shape)}")
    B, cout, D, H, W = grad.shape
    cin = x.shape[1]
    if x.shape != (B, cin, D, H, W):
        raise ValueError(f"conv3d wgrad: x {tuple(x.shape)} does not match "
                         f"grad {tuple(grad.shape)}")
    dev = grad.device
    if plan is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = make_plan(B, D, H, W, cin, cout, sms)
    vox = B * D * H * W
    a_parts = torch.empty(3 * vox * plan.mp, dtype=torch.bfloat16,
                          device=dev)
    b_parts = torch.empty(3 * vox * plan.np_, dtype=torch.bfloat16,
                          device=dev)
    ws = torch.empty(plan.workspace_numel, dtype=torch.float32, device=dev)
    out = torch.empty((cout, cin, 3, 3, 3), dtype=torch.float32, device=dev)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.cuda_fn("conv3d_wgrad", "conv3d_wgrad_launch",
                        [P, P] + [I] * 9 + [P] * 4 + [I] * 8 + [P])
    with torch.cuda.device(dev):
        err = fn(grad.data_ptr(), x.data_ptr(), B, D, H, W, cout, cin,
                 int(plan.a_is_x), plan.mp, plan.np_, a_parts.data_ptr(),
                 b_parts.data_ptr(), ws.data_ptr(), out.data_ptr(), plan.ma,
                 plan.bw, *plan.box, plan.splits, plan.per_split,
                 _build.stream_handle(grad))
    _build.check_launch("conv3d_wgrad", err)
    return out


def wgrad_flops(batch: int, depth: int, height: int, width: int, cin: int,
                cout: int) -> float:
    """2 * 27 * B * D * H * W * Cin * Cout: the filter gradient's
    operations (once, at f32)."""
    return 2.0 * TAPS * batch * depth * height * width * cin * cout
