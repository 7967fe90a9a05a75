"""The ball query's selection on the card: the exact re-rank against a
single top-k.

    python -m garmentnets_tpu_torch.tools.profile_ball_query [--reps 20]

`ops/pointcloud.ball_query` takes the 2K nearest candidates under the
expanded-quadratic distances and re-ranks them on exact f32 differences,
ties to the lower index. `single_topk` below is the selection it replaced:
one top-k of K under the expanded quadratic, its mask rechecked exactly.
For each selection, on the data kinds of tests/test_torch_cuda.py (random
points, every point two or three times, a lattice of step 1/8 with exact
ties at the 64th neighbour, that lattice moved by ~1e-6) at B=8, 6000
points and 3000 centres (radius 0.35) and 3000 points and 750 centres
(radius 0.4), this prints:
  - the centres whose chosen slots, and whose masked neighbour sets, differ
    between the card and the CPU;
  - device ms a call on random points (CUDA events, the median of --reps,
    the two selections interleaved);
then the device ms of the predict engine's encode with each selection at
the full width of PipelineConfig() (B=8, N=6000, 128^3, seeded random
weights; CUDA events, the median of --reps, interleaved), and one JSON
line. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

from garmentnets_tpu_torch.core.device import full_f32
from garmentnets_tpu_torch.ops.pointcloud import (
    _sq_dists, ball_query, gather_rows)

SHAPES = ((8, 6000, 3000, 0.35), (8, 3000, 750, 0.4))
KINDS = ("random", "duplicates", "lattice", "near_lattice")


def single_topk(points, centers, radius, k=64, chunk=512):
    """The selection before the exact re-rank: the top-k of the
    expanded-quadratic distances (ties in torch.topk's order on each
    device), the mask rechecked in f32."""
    N = points.shape[1]
    r2 = float(np.float32(radius) ** 2)
    idx_out, mask_out = [], []
    for c in torch.split(centers, chunk, dim=1):
        _, idx = torch.topk(_sq_dists(c, points), min(k, N), dim=-1,
                            largest=False)
        diff = gather_rows(points, idx) - c[:, :, None, :]
        idx_out.append(idx)
        mask_out.append((diff * diff).sum(-1) <= r2)
    return torch.cat(idx_out, dim=1), torch.cat(mask_out, dim=1)


def points(kind: str, B: int, N: int) -> torch.Tensor:
    import chip_smoke
    pts = chip_smoke.fps_points("lattice" if kind == "near_lattice"
                                else kind, B, N, N)
    if kind == "near_lattice":
        pts = pts + np.random.RandomState(4).randn(*pts.shape).astype(
            np.float32) * np.float32(1e-6)
    return torch.from_numpy(pts)


def differing(a, b, N):
    """(centres whose slots differ, centres whose masked sets differ)."""
    (ia, ma), (ib, mb) = a, b
    slots = ((ia != ib) | (ma != mb)).any(-1)
    sa = torch.where(ma, ia, N).sort(-1).values
    sb = torch.where(mb, ib, N).sort(-1).values
    return int(slots.sum()), int((sa != sb).any(-1).sum())


def _median_ms(fns: dict, reps: int) -> dict:
    """Median device ms of each callable, interleaved as A B B A."""
    times = {name: [] for name in fns}
    order = list(fns) + list(fns)[::-1]
    for _ in range(reps):
        for name in order:
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            fns[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(t) for name, t in times.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    selections = {"exact_rerank": ball_query, "single_topk": single_topk}
    report = {"device": torch.cuda.get_device_name(0), "sets": [],
              "call_ms": {}, "encode_ms": {}}

    for B, N, M, radius in SHAPES:
        for kind in KINDS:
            pts = points(kind, B, N)
            ctr = pts[:, :M].contiguous()
            for name, fn in selections.items():
                with full_f32():
                    card = [t.cpu() for t in fn(pts.to(dev), ctr.to(dev),
                                                radius)]
                slots, sets = differing(card, fn(pts, ctr, radius), N)
                row = dict(selection=name, kind=kind, N=N, M=M,
                           centres=B * M, slots_differ=slots,
                           sets_differ=sets)
                report["sets"].append(row)
                print(f"{name:13s} {kind:12s} N={N} M={M}: card vs CPU, "
                      f"slots differ at {slots} of {B * M} centres, "
                      f"masked sets at {sets}")
        p = points("random", B, N).to(dev)
        c = p[:, :M].contiguous()
        with full_f32():
            ms = _median_ms({name: (lambda f=fn: f(p, c, radius))
                             for name, fn in selections.items()}, args.reps)
        report["call_ms"][f"N={N},M={M}"] = ms
        print(f"ball query N={N} M={M}, device ms a call: "
              + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))

    from garmentnets_tpu_torch.core.random_weights import seeded_init_
    from garmentnets_tpu_torch.harness.predict_engine import PredictEngine
    from garmentnets_tpu_torch.models import pointnet2
    from garmentnets_tpu_torch.models.pipeline import (
        ConvImplicitWNFPipeline, PipelineConfig)
    cfg = PipelineConfig()
    model = ConvImplicitWNFPipeline(cfg)
    seeded_init_(model, 0)
    engine = PredictEngine(cfg, model.state_dict(), volume_size=128,
                           mc_threads=1)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(8, 6000, 3).astype(np.float32)).to(dev)
    pos = torch.from_numpy((rng.rand(8, 6000, 3) - 0.5).astype(
        np.float32)).to(dev)

    def encode_with(fn):
        def run():
            pointnet2.ball_query = fn
            try:
                engine.encode(x, pos)
            finally:
                pointnet2.ball_query = ball_query
        return run

    runs = {name: encode_with(fn) for name, fn in selections.items()}
    for run in runs.values():                                  # warm-up
        run()
    report["encode_ms"] = _median_ms(runs, args.reps)
    engine.close()
    print("encode, device ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in report["encode_ms"].items()))
    print(json.dumps(report))


if __name__ == "__main__":
    main()
