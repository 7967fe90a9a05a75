"""Where a train step of each stage spends its time, read from the
program's own step-phase spans (core/trace.py).

    python -m garmentnets_tpu_torch.tools.profile_train [--steps 3]
    python -m garmentnets_tpu_torch.tools.profile_train --loader-split \
        [--steps 40]
    torchrun --nproc-per-node 2 -m garmentnets_tpu_torch.tools.profile_train

The steps are harness/training.make_train_fns' train step fed by
batch_to_device, as the trainer runs them. Under torch.profiler they name
their phases `train/batch_to_device`, `train/forward` (forward and loss),
`train/backward` (zero_grad and the backward), `train/all_reduce` (under
a process group) and `train/optimizer` (Adam), and time each but the copy
on the card by CUDA events in stream order (core.trace.device_ms). For
each phase the tool prints its host ms a step (the span on the host) and
its device ms a step. Under torchrun (one card a rank, nccl) every rank
steps its own copy of the batch in one process group, so the step's
gradient all-reduce shows as `train/all_reduce`.

Writes a small synthetic dataset with the port's generator (one garment
instance, 24 grips, 4 views x 1500 points, a 32^3 GT volume) into a
temporary directory, takes one batch per stage at the shipped widths
(stage 1: B=8, 6000 points, PointNet2NOCSConfig(), dropout on; stage 2:
B=24, 6000 volume and 6000 surface queries, PipelineConfig()), builds
each model from flax's default initializers (init_like_jax_), and after
two warm-up steps traces --steps steps. Prints per stage:
  - host and device ms a step of each phase;
  - the device span of each top-level module of the forward (a
    record_function range each, put on by this tool), ms per step;
  - device time by kernel name per step, and the device busy share
    (kernel time over the step's wall time with the profiler on);
  - one JSON line with all of it.

With --loader-split it takes stage 1 instead as tools/e2e_synthetic.py's
acceptance run does (its dataset of 4 instances x 3 grips, its dataset
arguments, 6000 points, B=8, lr 1e-3, a Loader of 2 worker threads) and
traces --steps steps after 10 untraced ones; then as many steps again
with the batches read into memory first, so that no loader thread runs
beside them (in one process, without a group). Prints, both ways, the
phases' host and device ms a step, the host's wait on the loader and the
wall ms a step, and one JSON line.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile, record_function

from garmentnets_tpu_torch.core import trace
from garmentnets_tpu_torch.core.random_weights import init_like_jax_
from garmentnets_tpu_torch.data.dataset import (
    ConvImplicitWNFDataset, Loader, collate)
from garmentnets_tpu_torch.data.synthetic import generate_dataset
from garmentnets_tpu_torch.harness.training import (
    batch_to_device, make_adam, make_train_fns)
from garmentnets_tpu_torch.models import pipeline, pointnet2_nocs
from garmentnets_tpu_torch.parallel.mesh import init_distributed
from garmentnets_tpu_torch.tools import e2e_synthetic
from garmentnets_tpu_torch.tools.profile_encode import _device_ms

N = 6000
WARM_STEPS = 2
SPLIT_SKIP = 10            # untraced steps before the split's traced ones
PHASES = ("train/batch_to_device", "train/forward", "train/backward",
          "train/all_reduce", "train/optimizer")


def _ranged(module: torch.nn.Module, prefix: str) -> None:
    """Put each child module's forward in a record_function range."""
    for name, child in module.named_children():
        def enter(m, args, name=name):
            m._range = record_function(f"{prefix}{name}")
            m._range.__enter__()

        def leave(m, args, out):
            m._range.__exit__(None, None, None)

        child.register_forward_pre_hook(enter)
        child.register_forward_hook(leave)


def _stage(stage: int, root: pathlib.Path, group=None):
    """(model, apply_fn, loss_fn, host batch) of one stage; group: the
    process group the loss's means span."""
    if stage == 1:
        cfg = pointnet2_nocs.PointNet2NOCSConfig()
        model = pointnet2_nocs.PointNet2NOCS(cfg)
        ds = ConvImplicitWNFDataset(zarr_path=str(root), num_pc_sample=N,
                                    volume_size=None,
                                    enable_augumentation=False,
                                    static_epoch_seed=True)
        batch = collate([ds[i] for i in range(8)])

        def apply_fn(b, gen):
            return model(b["x"], b["pos"], generator=gen)

        def loss_fn(out, b):
            return pointnet2_nocs.get_metrics(cfg, out, b, group)[0]
    else:
        cfg = pipeline.PipelineConfig()
        model = pipeline.ConvImplicitWNFPipeline(cfg)
        ds = ConvImplicitWNFDataset(zarr_path=str(root), num_pc_sample=N,
                                    num_volume_sample=N,
                                    num_surface_sample=N, volume_size=32,
                                    enable_augumentation=False,
                                    static_epoch_seed=True)
        batch = collate([ds[i] for i in range(24)])

        def apply_fn(b, gen):
            return model(b)

        def loss_fn(out, b):
            return pipeline.pipeline_loss(cfg, out, b, group)
    init_like_jax_(model, torch.Generator().manual_seed(0))
    if stage == 2:
        model.pointnet2_nocs.requires_grad_(False)
    return model, apply_fn, loss_fn, batch


def _traced_steps(train_step, batches, dev, skip: int,
                  traced: int) -> tuple:
    """`skip` untraced steps, then `traced` steps under torch.profiler, of
    train_step on the host batches that `batches` yields, each copied by
    batch_to_device -> (the profiler, a report: wall and loader-wait ms a
    traced step, and each train/* phase's host and device ms a step)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    wait = 0.0

    def step():
        nonlocal wait
        tw = time.perf_counter()
        batch = next(batches)
        wait += time.perf_counter() - tw
        train_step(batch_to_device(batch, dev), gen)

    for _ in range(skip):
        step()
    torch.cuda.synchronize()
    trace.reset()
    wait = 0.0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(traced):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    host = {e.key: e.cpu_time_total / 1e3 / traced
            for e in prof.key_averages() if e.key.startswith("train/")
            and not str(getattr(e, "device_type", "")).endswith("CUDA")}
    device = {k: ms / traced for k, (ms, _) in trace.device_ms().items()}
    return prof, {"wall_ms": wall * 1e3 / traced,
                  "loader_wait_ms": wait * 1e3 / traced,
                  "phases_ms": {k: (host[k], device.get(k))
                                for k in PHASES if k in host}}


def _phases(report: dict) -> str:
    return ", ".join(
        f"{k[len('train/'):]} {h:.3f} / "
        + ("-" if d is None else f"{d:.3f}")
        for k, (h, d) in report["phases_ms"].items())


def profile_stage(stage: int, root: pathlib.Path, steps: int,
                  group=None) -> dict:
    dev = torch.device("cuda", torch.cuda.current_device())
    model, apply_fn, loss_fn, batch = _stage(stage, root, group)
    model.to(dev)
    _ranged(model, "forward/")
    train_step, _ = make_train_fns(model, apply_fn, loss_fn,
                                   make_adam(model, 1e-4), group)
    prof, report = _traced_steps(train_step, iter(lambda: batch, None), dev,
                                 WARM_STEPS, steps)
    spans, by_name = {}, {}
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        ms = _device_ms(evt) / steps
        if evt.key.startswith("forward/"):
            spans[evt.key] = ms
        elif not evt.key.startswith("train/") and ms > 0:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + ms
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    n, wall_ms = len(batch["x"]), report["wall_ms"]
    print(f"stage {stage}, B={n}: ms per step of each phase (host / "
          f"device): {_phases(report)}")
    print(f"stage {stage}: forward spans on the device (ms per step, "
          f"{steps} traced): "
          + ", ".join(f"{k} {v:.2f}" for k, v in spans.items()))
    print(f"stage {stage}: traced step wall {wall_ms:.2f} ms (profiler "
          f"on), device busy {busy:.2f} ms ({100 * busy / wall_ms:.1f}%)")
    for k, v in top:
        print(f"  {v:9.3f} ms  {k[:90]}")
    return {"batch": n, **report, "forward_spans_ms": spans,
            "device_busy_ms": busy, "top_kernels_ms": dict(top)}


def loader_split(root: pathlib.Path, steps: int) -> dict:
    """Stage 1 as the acceptance run takes it, split by the program's
    spans (see the module's docstring), with the Loader's threads and
    with the batches in memory -> {"loader" / "in memory": report}."""
    dev = torch.device("cuda")
    scale = e2e_synthetic.Scale()
    ds = ConvImplicitWNFDataset(
        zarr_path=str(root), metadata_cache_dir=None, volume_size=None,
        **e2e_synthetic.common_kwargs(scale))
    B, n = scale.batch_size, SPLIT_SKIP + steps
    idxs = np.concatenate([np.arange(len(ds))] * (n * B // len(ds) + 1))
    cfg = pointnet2_nocs.PointNet2NOCSConfig(
        learning_rate=e2e_synthetic.LR)
    model = pointnet2_nocs.PointNet2NOCS(cfg)
    init_like_jax_(model, torch.Generator().manual_seed(0))
    model.to(dev)
    train_step, _ = make_train_fns(
        model, lambda b, gen: model(b["x"], b["pos"], generator=gen),
        lambda out, b: pointnet2_nocs.get_metrics(cfg, out, b)[0],
        make_adam(model, e2e_synthetic.LR))
    report = {}
    for how in ("loader", "in memory"):
        loader = Loader(ds, idxs, B, shuffle=True, drop_last=True,
                        num_workers=2 if how == "loader" else 0)
        it = iter(loader)
        batches = (next(it) for _ in range(n))
        if how == "in memory":
            batches = iter(list(batches))
        report[how] = _traced_steps(train_step, batches, dev, SPLIT_SKIP,
                                    steps)[1]
        it.close()
        r = report[how]
        print(f"stage-1 split, {how}, B={B}, ms a step over {steps} traced "
              f"steps (host / device): {_phases(r)}; loader wait "
              f"{r['loader_wait_ms']:.3f}, wall {r['wall_ms']:.3f}",
              flush=True)
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=None,
                    help="traced steps a stage (3), or split steps (40)")
    ap.add_argument("--loader-split", action="store_true")
    args = ap.parse_args(argv)
    group = None
    if "WORLD_SIZE" in os.environ:
        init_distributed(device="cuda")
        group = dist.group.WORLD
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}")
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp) / "data.zarr"
        if args.loader_split:
            scale = e2e_synthetic.Scale()
            generate_dataset(str(root), num_instances=4,
                             grips_per_instance=scale.grips, volume_size=32,
                             mesh_res=scale.mesh_res,
                             pts_per_view=scale.pts_per_view, seed=0,
                             include_task_space=False)
            report = {"stage1_split": loader_split(root, args.steps or 40)}
        else:
            generate_dataset(str(root), num_instances=1,
                             grips_per_instance=24, volume_size=32,
                             pts_per_view=N // 4, num_views=4, seed=0,
                             include_task_space=False)
            report = {"stages": {str(s): profile_stage(
                s, root, args.steps or 3, group) for s in (1, 2)}}
    print(json.dumps({"device": name, **report}))
    if group is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
