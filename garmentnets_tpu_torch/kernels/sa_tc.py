"""Launcher of the tensor-core set-abstraction kernel (csrc/sa_tc.cu).

Replaces garmentnets_tpu/kernels/sa_pallas.py (sa_fused) at its bf16x3
products. The plain PyTorch version of the same function is
ops/set_abstraction.sa_fused_plain(precision="high").

The wrapper cuts the MLP into passes (`plan_passes`): one per hidden layer
(width <= 128) and the last layer's output columns in passes of at most
128, so that a thread's accumulators stay at 64 registers and two blocks
fit on an SM. It pads the first layer's input width to a multiple of 16
and every pass's width to 64 or 128, splits the weights into bf16 hi and
lo and packs them as 16-row K-chunks in the shared-memory image of the
kernel's wgmma B operand (`pack_sa_layers`). The weights stay resident in
a block's shared memory when they fit beside the activations (SA1);
otherwise a ring of stages streams them (SA2; `ring_stages`).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from garmentnets_tpu_torch.kernels import _build
from garmentnets_tpu_torch.kernels.dense_decode_tc import (
    _pad, pack_wgmma_weights)

ROWS = 128                  # neighbour rows per tile (csrc kRows)
WG_ROWS = 64                # rows of one consumer warpgroup
KSTEP = 16                  # K rows per weight chunk (csrc kKStep)
WIDTHS = (64, 128)          # the kernel's padded pass widths
MAX_HIDDEN = 128            # widest hidden layer
MAX_OUT = 256               # widest last layer (in passes of <= 128)
MAX_PASSES = 5
MAX_STAGES = 8
SLOT_PADS = (16, 32, 64)    # the kernel's neighbour-slot counts
SMEM_LIMIT = 232448         # shared memory of one block
SMEM_TWO_BLOCKS = 115712    # of each of two blocks on one SM
BAR_BYTES = 256


@dataclass
class PackedSA:
    """A set-abstraction MLP laid out for the kernel as passes: one per
    hidden layer, then the last layer's output columns in passes of at
    most 128."""
    kp: list                # padded input width of each pass
    np_: list               # padded output width of each pass
    col0: list              # first output column of each last-layer pass
    n_hidden: int           # passes of hidden layers
    cout_last: int          # real output width of the last layer
    wts: torch.Tensor       # per pass [kp/16, 2, np*16] bf16, flattened
    epi: torch.Tensor       # per pass [3, np] b, g, s, flattened

    @property
    def w_bytes(self) -> int:
        return self.wts.numel() * 2

    @property
    def stage_bytes(self) -> int:
        return max(self.np_) * KSTEP * 4


def padded_width(c: int) -> int:
    return next(w for w in WIDTHS if c <= w)


def _pad16(c: int) -> int:
    return -(-c // KSTEP) * KSTEP


def plan_passes(layers, cin0: int) -> list:
    """The kernel's passes over layers (K [cin, cout], b, g, s), the first
    with cin0 input rows: (layer, first column, real width, padded input
    width, padded output width) each. Raises on what the kernel does not
    take."""
    if not 1 <= len(layers) <= MAX_PASSES - 1:
        raise ValueError(f"sa kernel supports 1..{MAX_PASSES - 1} layers, "
                         f"got {len(layers)}")
    passes = []
    cin, kp = cin0, _pad16(cin0)
    for l, (k, _, _, _) in enumerate(layers):
        if k.dim() != 2 or k.shape[0] != cin:
            raise ValueError(f"sa layer {l}: K is {tuple(k.shape)}, expected "
                             f"{cin} input rows")
        cout = k.shape[1]
        last = l + 1 == len(layers)
        if cout > (MAX_OUT if last else MAX_HIDDEN):
            raise ValueError(f"sa kernel supports hidden widths <= "
                             f"{MAX_HIDDEN} and output widths <= {MAX_OUT}, "
                             f"got {cout} at layer {l}")
        if not last:
            passes.append((l, 0, cout, kp, padded_width(cout)))
            cin, kp = cout, padded_width(cout)
            continue
        for c0 in range(0, cout, WIDTHS[-1]):
            n = min(WIDTHS[-1], cout - c0)
            passes.append((l, c0, n, kp, padded_width(n)))
    return passes


def pack_sa_layers(layers, cin0: int) -> PackedSA:
    """Layers (K [cin, cout], b, g, s), the first with cin0 input rows ->
    the kernel's layout. A padded column has zero weights and zero b, g, s,
    so it holds 0 and adds nothing to the next layer."""
    passes = plan_passes(layers, cin0)
    wts, epi = [], []
    for l, c0, n, kp, np_ in passes:
        k, b, g, s = layers[l]
        wts.append(pack_wgmma_weights(k[:, c0:c0 + n].float(), np_, 2,
                                      rows=kp, kc=KSTEP).reshape(-1))
        epi += [_pad(v[c0:c0 + n], np_) for v in (b, g, s)]
    n_hidden = len(layers) - 1
    return PackedSA([p[3] for p in passes], [p[4] for p in passes],
                    [p[1] for p in passes], n_hidden,
                    layers[-1][0].shape[1], torch.cat(wts).contiguous(),
                    torch.cat(epi).contiguous())


def smem_bytes(packed: PackedSA, w_region: int) -> int:
    """csrc sa_tc_smem: barriers, A (two warpgroups x hi, lo), the weights'
    region, the max partials and the row tables."""
    return (BAR_BYTES + 4 * WG_ROWS * max(packed.kp) * 2 + w_region
            + 8 * WIDTHS[-1] * 4 + 3 * ROWS * 4)


def ring_stages(packed: PackedSA) -> int:
    """0 when all the weights fit in shared memory beside the activations
    of two blocks on one SM (resident), else the stage count (2..8) of a
    ring that fits two blocks on an SM, or else one."""
    if smem_bytes(packed, packed.w_bytes) <= SMEM_TWO_BLOCKS:
        return 0
    for budget in (SMEM_TWO_BLOCKS, SMEM_LIMIT):
        stages = min(MAX_STAGES,
                     (budget - smem_bytes(packed, 0)) // packed.stage_bytes)
        if stages >= 2:
            return stages
    raise ValueError(f"sa kernel: input widths {packed.kp} leave no room for "
                     "a weight ring in shared memory")


def sa_tc_cuda(x: torch.Tensor, pos: torch.Tensor, centers: torch.Tensor,
               idx: torch.Tensor, mask: torch.Tensor, layers,
               packed: PackedSA | None = None) -> torch.Tensor:
    """x [B, N, Cin], pos [B, N, 3], centers [B, M, 3] float32 CUDA;
    idx [B, M, K] int64 in [0, N) and mask [B, M, K] bool; layers:
    (K [cin, cout], b, g, s) float32 tensors on the same device, the first
    with Cin + 3 input rows; packed: pack_sa_layers(layers, Cin + 3), made
    here when not given. Returns [B, M, C_out] float32."""
    if x.dim() != 3 or pos.shape != (*x.shape[:2], 3):
        raise ValueError(f"sa: x {tuple(x.shape)} and pos {tuple(pos.shape)} "
                         "must be [B, N, C] and [B, N, 3]")
    B, N, Cin = x.shape
    if idx.dim() != 3 or idx.shape[0] != B or mask.shape != idx.shape:
        raise ValueError(f"sa: idx {tuple(idx.shape)} and mask "
                         f"{tuple(mask.shape)} must both be [B, M, K]")
    M, K = idx.shape[1], idx.shape[2]
    if centers.shape != (B, M, 3):
        raise ValueError(f"sa: centers must be [{B}, {M}, 3], got "
                         f"{tuple(centers.shape)}")
    if not 1 <= K <= SLOT_PADS[-1]:
        raise ValueError(f"sa kernel supports 1 <= K <= {SLOT_PADS[-1]} "
                         f"neighbour slots, got {K}")
    plan_passes(layers, Cin + 3)
    _build.require_cuda(x, "sa x")
    _build.require_cuda(pos, "sa pos")
    _build.require_cuda(centers, "sa centers")
    _build.require_cuda(idx, "sa idx", torch.int64)
    _build.require_cuda(mask, "sa mask", torch.bool)
    if packed is None:
        packed = pack_sa_layers(layers, Cin + 3)
    _build.require_cuda(packed.wts, "sa weights", torch.bfloat16)
    _build.require_cuda(packed.epi, "sa b, g, s")
    stages = ring_stages(packed)
    kp = next(p for p in SLOT_PADS if p >= K)
    if kp != K:
        # padded slots are invalid: the kernel neither gathers them nor
        # takes them into the max
        idx = torch.cat([idx, idx.new_zeros((B, M, kp - K))], dim=-1)
        mask = torch.cat([mask, mask.new_zeros((B, M, kp - K))], dim=-1)
    dev = x.device
    out = torch.empty((B, M, packed.cout_last), dtype=torch.float32,
                      device=dev)

    P, I = ctypes.c_void_p, ctypes.c_int
    IA = ctypes.POINTER(ctypes.c_int)
    fn = _build.cuda_fn("sa_tc", "sa_tc_launch", [
        P, P, P, P, P, I, I, I, I, I, P, P, I, I, IA, IA, IA, I, I, P, P])
    n = len(packed.kp)
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), pos.data_ptr(), centers.data_ptr(),
                 idx.data_ptr(), mask.data_ptr(), B, N, M, Cin, kp,
                 packed.wts.data_ptr(), packed.epi.data_ptr(), n,
                 packed.n_hidden, (ctypes.c_int * n)(*packed.kp),
                 (ctypes.c_int * n)(*packed.np_),
                 (ctypes.c_int * n)(*packed.col0), packed.cout_last, stages,
                 out.data_ptr(), _build.stream_handle(x))
    _build.check_launch("sa_tc", err)
    return out
