"""Stage 1's hand-written kernels on the card: FPS and the tensor-core set
abstraction, at the main path's shapes.

    python -m garmentnets_tpu_torch.tools.profile_stage1

from the repository's root (it reads chip_smoke's input makers). Prints:
  - FPS: microseconds per pick against N (B=8, 1000 picks, N from 512 to
    8192) and a line fitted through them: the intercept is what a pick
    costs whatever its points (the reduction chain and the barrier), the
    slope what each 1000 points add (the distance, minimum and argmax);
  - SA: the kernel's time (weights packed beforehand, as SAModule caches
    them) at SA1 and SA2 on two point sets: a cube of side 0.35, where
    most neighbour slots are valid (chip_smoke's check data), and the unit
    cube of the main path's inputs, where few are; SA2 also with its weight
    ring at 2, 4 and 8 stages; and the time to pack the weights;
  - one JSON line with all of it.
Times are CUDA-event medians. Needs a CUDA device.
"""
from __future__ import annotations

import json

import numpy as np
import torch


def main() -> None:
    import chip_smoke
    from garmentnets_tpu_torch.kernels import sa_tc
    from garmentnets_tpu_torch.kernels.fps import furthest_point_sampling_cuda

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    result = {"device": name, "fps_us_per_pick": {}, "sa_ms": {}}
    picks = 1000
    for n in (512, 1024, 2048, 3000, 4096, 6000, 8192):
        pos = torch.from_numpy(chip_smoke.fps_points("random", 8, n, n)).to(
            dev)
        ms = chip_smoke.time_ms(
            lambda: furthest_point_sampling_cuda(pos, picks + 1), 10)
        result["fps_us_per_pick"][n] = ms * 1e3 / picks
        print(f"fps N={n}: {ms * 1e3 / picks:.3f} us per pick")
    ns = np.array(list(result["fps_us_per_pick"]), np.float64)
    us = np.array(list(result["fps_us_per_pick"].values()))
    slope, icpt = np.polyfit(ns / 1000, us, 1)
    result["fps_fit"] = {"us_per_pick": float(icpt),
                         "us_per_1000_points": float(slope)}
    print(f"fps fit: {icpt:.3f} us per pick + {slope:.4f} us per 1000 "
          f"points")

    gen = torch.Generator().manual_seed(3)
    ring_stages = sa_tc.ring_stages
    for data in ("cube", "unit"):
        pos = None
        if data == "unit":
            pos = (torch.rand(8, 6000, 3, generator=gen) - 0.5).to(dev)
        for stage, n_pts, m, cin, widths, radius in (
                ("SA1", 6000, 3000, 3, (6, 64, 64, 128), 0.05),
                ("SA2", 3000, 750, 128, (131, 128, 128, 256), 0.1)):
            args = chip_smoke.sa_inputs(gen, 8, n_pts, m, cin, widths,
                                        radius, dev, pos)
            share = float(args[4].float().mean())
            packed = sa_tc.pack_sa_layers(args[-1], cin + 3)
            default = ring_stages(packed)
            for stages in ([default] if default == 0 else [2, 4, 8]):
                sa_tc.ring_stages = lambda _p, s=stages: s
                try:
                    ms = chip_smoke.time_ms(
                        lambda: sa_tc.sa_tc_cuda(*args, packed), 20)
                finally:
                    sa_tc.ring_stages = ring_stages
                key = f"{stage} {data} stages={stages}"
                result["sa_ms"][key] = ms
                print(f"sa {key} (valid slots {share:.4f}): {ms:.3f} ms"
                      + (" (default)" if stages == default else ""))
            pack_ms = chip_smoke.time_ms(
                lambda: sa_tc.pack_sa_layers(args[-1], cin + 3), 10)
            result["sa_ms"][f"{stage} {data} pack"] = pack_ms
            print(f"sa {stage} weight packing: {pack_ms:.3f} ms")
            pos = args[2]
    print(json.dumps(result))


if __name__ == "__main__":
    main()
