"""Where the tensor-core dense decode (csrc/dense_decode_tc.cu) spends its
time inside the kernel, on the card.

    python -m garmentnets_tpu_torch.tools.profile_decode_tc

from the repository's root (it reads chip_smoke.decode_inputs). Builds the
kernel a second time with -DDECODE_TC_PHASES (its own library name, since
the flags are part of the build hash), runs it once per tier
at the main path's shapes (chip_smoke.decode_inputs, B=8, 32^3 -> 128^3,
widths 128-256-256-1), and prints per tier the kernel's time (CUDA events)
and the share of a consumer warpgroup's SM cycles in each phase:
  staging     D/H interpolation of the tile's line window (all consumers)
  upsample    W interpolation, first affine, bf16 split into the A operand
  publish     async-proxy fence and warpgroup barrier before the products
  weights     waiting on the weight ring (inside `products`)
  products    the hidden layers' wgmma, from the first chunk to the last
  epilogue    bias, ReLU, affine and the scalar head
with each phase's share converted to ms of the kernel's time, and one JSON
line with all of it. The timers cost a few percent; the kernel without
them is the one chip_smoke.py times. Needs a CUDA device.
"""
from __future__ import annotations

import ctypes
import json

import torch

PHASES = ("staging", "upsample", "publish", "weights", "products",
          "epilogue", "tile")


def main() -> None:
    import chip_smoke
    from garmentnets_tpu_torch.kernels import _build
    from garmentnets_tpu_torch.kernels.dense_decode_tc import (
        dense_decode_tc_cuda, pack_decoder)
    from garmentnets_tpu_torch.ops.dense_decode import coarse_first_layer

    # a separate library with the timers compiled in: the flags are part of
    # the library's hash, and _LIBS is cleared so that the launcher loads it
    _build.NVCC_FLAGS = _build.NVCC_FLAGS + ("-DDECODE_TC_PHASES",)
    _build._LIBS.pop("dense_decode_tc", None)
    lib = _build.load("dense_decode_tc")
    read = lib.dense_decode_tc_phases
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    fv, layers = chip_smoke.decode_inputs(
        torch.Generator().manual_seed(1), (8, 32, 32, 32), (128, 256, 256, 1),
        dev)
    z = coarse_first_layer(fv, layers).contiguous()
    counts = (ctypes.c_ulonglong * len(PHASES))()
    result = {"device": name, "tiers": {}}
    for tier in ("high", "default"):
        packed = pack_decoder(layers, tier)
        dense_decode_tc_cuda(z, packed, 128)                  # warm-up
        torch.cuda.synchronize()
        if read(counts, 1) != 0:
            raise RuntimeError("resetting the phase counters failed")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dense_decode_tc_cuda(z, packed, 128)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        if read(counts, 0) != 0:
            raise RuntimeError("reading the phase counters failed")
        cyc = dict(zip(PHASES, (int(c) for c in counts)))
        total = cyc["tile"]
        shares = {k: cyc[k] / total for k in PHASES[:-1]}
        shares["products"] -= shares["weights"]   # products net of waits
        shares["other"] = 1.0 - sum(shares.values())
        phase_ms = {k: v * ms for k, v in shares.items()}
        print(f"{name}, tier {tier}: kernel {ms:.3f} ms (timers on); "
              + ", ".join(f"{k} {v:.3f} ms ({100 * shares[k]:.1f}%)"
                          for k, v in phase_ms.items()))
        result["tiers"][tier] = {"kernel_ms": ms, "phase_ms": phase_ms,
                                 "phase_share": shares}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
