"""Where the tensor-core dense decode (csrc/dense_decode_tc.cu) spends its
time inside the kernel, on the card.

    python -m garmentnets_tpu_torch.tools.profile_decode_tc

from the repository's root (it reads chip_smoke.decode_inputs). Builds the
kernel two ways at once (the flags are part of each library's hash): as
the port runs it, and with the phase timers (-DDECODE_TC_PHASES). Runs
each tier at the main path's shapes (chip_smoke.decode_inputs, B=8,
32^3 -> 128^3, widths 128-256-256-1). The timed build must give the port
build's output bit for bit (the timers do not change the arithmetic); it
prints per tier the kernel's time without and with the timers (CUDA
events) and the share of a consumer warpgroup's SM cycles in each phase:
  staging     D/H interpolation of the tile's line window (all consumers)
  upsample    W interpolation, first affine, bf16 split into the A operand
  publish     async-proxy fence and warpgroup barrier before the products
  weights     waiting on the weight ring (inside `products`)
  products    the hidden layers' wgmma, from the first chunk to the last
  epilogue    bias, ReLU, affine, the next layer's split and the scalar head
with each phase's share converted to ms of the timed kernel's time, and
one JSON line with all of it. Needs a CUDA device.
"""
from __future__ import annotations

import ctypes
import json

import torch

PHASES = ("staging", "upsample", "publish", "weights", "products",
          "epilogue", "tile")
TIERS = ("highest", "high", "default")
BUILDS = {"port": (), "port_timed": ("-DDECODE_TC_PHASES",)}   # nvcc flags


def build_variants() -> dict:
    """Every build of BUILDS compiled at once; name -> loaded library."""
    from garmentnets_tpu_torch.kernels import _build
    base = _build.NVCC_FLAGS
    started = {}
    try:
        for name, flags in BUILDS.items():
            _build.NVCC_FLAGS = base + flags
            started[name] = _build._start_build("dense_decode_tc")
    finally:
        _build.NVCC_FLAGS = base
    libs = {}
    for name, (proc, tmp, so) in started.items():
        _build._finish_build("dense_decode_tc", proc, tmp, so)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def time_once(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def main() -> None:
    import chip_smoke
    from garmentnets_tpu_torch.kernels import _build
    from garmentnets_tpu_torch.kernels.dense_decode_tc import (
        dense_decode_tc_cuda, pack_decoder)
    from garmentnets_tpu_torch.ops.dense_decode import coarse_first_layer

    libs = build_variants()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    fv, layers = chip_smoke.decode_inputs(
        torch.Generator().manual_seed(1), (8, 32, 32, 32), (128, 256, 256, 1),
        dev)
    z = coarse_first_layer(fv, layers).contiguous()
    packed = {t: pack_decoder(layers, t) for t in TIERS}
    counts = (ctypes.c_ulonglong * len(PHASES))()
    result = {"device": name, "builds": {}}
    reference = {}                     # tier -> the port build's output
    for build, flags in BUILDS.items():
        # the launcher loads the library through _build's cache
        _build._LIBS["dense_decode_tc"] = libs[build]
        timed = "-DDECODE_TC_PHASES" in flags
        out = result["builds"].setdefault(build, {})
        for tier in TIERS:
            run = lambda: dense_decode_tc_cuda(z, packed[tier], 128)  # noqa
            got = run()                                     # warm-up
            if not torch.equal(reference.setdefault(tier, got), got):
                raise RuntimeError(f"build {build} differs from the port's "
                                   f"at '{tier}'")
            del got
            if not timed:
                ms = sorted(time_once(run) for _ in range(5))[2]
                print(f"{name}, {build}, tier {tier}: kernel {ms:.3f} ms "
                      f"(median of 5)")
                out[tier] = {"kernel_ms": ms}
                continue
            read = libs[build].dense_decode_tc_phases
            read.argtypes = [ctypes.c_void_p, ctypes.c_int]
            read.restype = ctypes.c_int
            if read(counts, 1) != 0:
                raise RuntimeError("resetting the phase counters failed")
            ms = time_once(run)
            if read(counts, 0) != 0:
                raise RuntimeError("reading the phase counters failed")
            cyc = dict(zip(PHASES, (int(c) for c in counts)))
            total = cyc["tile"]
            shares = {k: cyc[k] / total for k in PHASES[:-1]}
            shares["products"] -= shares["weights"]   # net of waits
            shares["other"] = 1.0 - sum(shares.values())
            phase_ms = {k: v * ms for k, v in shares.items()}
            print(f"{name}, {build}, tier {tier}: kernel {ms:.3f} ms (timers "
                  "on); " + ", ".join(
                      f"{k} {v:.3f} ms ({100 * shares[k]:.1f}%)"
                      for k, v in phase_ms.items()))
            out[tier] = {"kernel_ms": ms, "phase_ms": phase_ms,
                         "phase_share": shares}
    _build._LIBS.pop("dense_decode_tc", None)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
