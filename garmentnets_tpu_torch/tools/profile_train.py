"""Where a train step of each stage spends its time on the card.

    python -m garmentnets_tpu_torch.tools.profile_train [--steps 3]
    python -m garmentnets_tpu_torch.tools.profile_train --loader-split \
        [--steps 40]

Writes a small synthetic dataset with the port's generator (one garment
instance, 24 grips, 4 views x 1500 points, a 32^3 GT volume) into a
temporary directory, takes one batch per stage at the shipped widths
(stage 1: B=8, 6000 points, PointNet2NOCSConfig(), dropout on; stage 2:
B=24, 6000 volume and 6000 surface queries, PipelineConfig()), builds
each model from flax's default initializers (init_like_jax_), and after
two warm-up train steps (forward, loss, backward, Adam, as
harness/training.make_train_fns runs them, in full f32) times --steps
steps with CUDA events and traces --steps more with torch.profiler.
Prints per stage:
  - ms per step of each phase (forward and loss, backward, optimizer) by
    CUDA events over --steps more untraced steps;
  - the device span of the loss and of each top-level module of the
    forward (a record_function range each), ms per step;
  - device time by kernel name per step, and the device busy share
    (kernel time over the step's wall time with the profiler on);
  - one JSON line with all of it.

With --loader-split it takes stage 1 instead as tools/e2e_synthetic.py's
acceptance run does (its dataset of 4 instances x 3 grips, its dataset
arguments, 6000 points, B=8, lr 1e-3, a Loader of 2 worker threads, each
batch copied to the card in the step) and splits each of 10 + --steps
steps by CUDA events and the host clock at five marks: before the batch's
host-to-device copy, after it, after the forward and the loss, after the
backward and after Adam; then it takes as many steps again with the
batches read into memory first, so that no loader thread runs beside
them. Prints the mean ms of each part over the last --steps steps, both
ways, and one JSON line.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from garmentnets_tpu_torch.core.device import full_f32
from garmentnets_tpu_torch.core.random_weights import init_like_jax_
from garmentnets_tpu_torch.data.dataset import (
    ConvImplicitWNFDataset, Loader, collate)
from garmentnets_tpu_torch.data.synthetic import generate_dataset
from garmentnets_tpu_torch.harness.training import batch_to_device, make_adam
from garmentnets_tpu_torch.models import pipeline, pointnet2_nocs
from garmentnets_tpu_torch.tools import e2e_synthetic
from garmentnets_tpu_torch.tools.profile_encode import _device_ms

N = 6000


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


def _stage(stage: int, root: pathlib.Path):
    """(model, apply_fn, loss_fn, host batch) of one stage."""
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
            return pointnet2_nocs.get_metrics(cfg, out, b)[0]
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
            return pipeline.pipeline_loss(cfg, out, b)
    init_like_jax_(model, torch.Generator().manual_seed(0))
    if stage == 2:
        model.pointnet2_nocs.requires_grad_(False)
    return model, apply_fn, loss_fn, batch


def profile_stage(stage: int, root: pathlib.Path, steps: int) -> dict:
    dev = torch.device("cuda")
    model, apply_fn, loss_fn, batch = _stage(stage, root)
    model.to(dev).train()
    _ranged(model, "forward/")
    opt = make_adam(model, 1e-4)
    b = batch_to_device(batch, dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def step(events=None):
        def mark(i):
            if events is not None:
                events[i].record()

        with full_f32():
            mark(0)
            with record_function("forward"):
                out = apply_fn(b, gen)
            with record_function("loss"):
                loss = loss_fn(out, b)["loss"]
            opt.zero_grad(set_to_none=True)
            mark(1)
            loss.backward()
            mark(2)
            opt.step()
            mark(3)

    for _ in range(2):                                        # warm-up
        step()
    # the phases by CUDA events on the stream, without the profiler (the
    # autograd engine launches the backward from its own thread, outside
    # any range of this one)
    phase_ms = dict.fromkeys(("forward+loss", "backward", "optimizer"), 0.0)
    for _ in range(steps):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        step(events)
        events[3].synchronize()
        for i, k in enumerate(phase_ms):
            phase_ms[k] += events[i].elapsed_time(events[i + 1]) / steps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    spans, by_name = {}, {}
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        ms = _device_ms(evt) / steps
        if evt.key in ("forward", "loss") or evt.key.startswith("forward/"):
            spans[evt.key] = ms
        elif ms > 0:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + ms
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    n = len(batch["x"])
    print(f"stage {stage}, B={n}: ms per step by CUDA events: "
          + ", ".join(f"{k} {v:.2f}" for k, v in phase_ms.items()))
    print(f"stage {stage}: forward spans on the device (ms per step, "
          f"{steps} traced): "
          + ", ".join(f"{k} {v:.2f}" for k, v in spans.items()))
    print(f"stage {stage}: traced step wall {wall_ms:.2f} ms (profiler "
          f"on), device busy {busy:.2f} ms ({100 * busy / wall_ms:.1f}%)")
    for k, v in top:
        print(f"  {v:9.3f} ms  {k[:90]}")
    return {"batch": n, "phase_ms": phase_ms, "forward_spans_ms": spans,
            "traced_wall_ms": wall_ms,
            "device_busy_ms": busy, "top_kernels_ms": dict(top)}


SPLIT_SKIP = 10            # warm-up steps left out of the split
SPLIT_PARTS = ("copy", "forward and loss", "backward", "Adam", "between",
               "step")


def _split_steps(model, cfg, opt, batches, dev) -> dict:
    """One stage-1 train step (harness/training.make_train_fns's, marked)
    a batch -> {part: [(CUDA events ms, host ms) a step]} over the steps
    after SPLIT_SKIP; `between` runs from a step's Adam to the next
    step's copy (the wait on the batch and the loop)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    marks = []
    for batch in batches:
        m = []

        def mark():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            m.append((ev, time.perf_counter()))

        mark()
        b = batch_to_device(batch, dev)
        mark()
        model.train()
        with full_f32():
            loss = pointnet2_nocs.get_metrics(
                cfg, model(b["x"], b["pos"], generator=gen), b)[0]["loss"]
            mark()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            mark()
            opt.step()
            mark()
        marks.append(m)
    torch.cuda.synchronize()
    out = {k: [] for k in SPLIT_PARTS}
    for m, nxt in zip(marks[SPLIT_SKIP:], marks[SPLIT_SKIP + 1:]):
        pairs = list(zip(m, m[1:])) + [(m[4], nxt[0]), (m[0], nxt[0])]
        for k, (a, b) in zip(SPLIT_PARTS, pairs):
            out[k].append((a[0].elapsed_time(b[0]), (b[1] - a[1]) * 1e3))
    return out


def loader_split(root: pathlib.Path, steps: int) -> dict:
    """Stage 1 as the acceptance run takes it, split (see the module's
    docstring), with the Loader's threads and with the batches in memory
    -> {"loader" / "in memory": {part: (events ms, host ms) a step}}."""
    dev = torch.device("cuda")
    scale = e2e_synthetic.Scale()
    ds = ConvImplicitWNFDataset(
        zarr_path=str(root), metadata_cache_dir=None, volume_size=None,
        **e2e_synthetic.common_kwargs(scale))
    B, n = scale.batch_size, SPLIT_SKIP + steps + 1
    idxs = np.concatenate([np.arange(len(ds))] * (n * B // len(ds) + 1))
    cfg = pointnet2_nocs.PointNet2NOCSConfig(
        learning_rate=e2e_synthetic.LR)
    model = pointnet2_nocs.PointNet2NOCS(cfg)
    init_like_jax_(model, torch.Generator().manual_seed(0))
    model.to(dev)
    opt = make_adam(model, e2e_synthetic.LR)
    report = {}
    for how in ("loader", "in memory"):
        loader = Loader(ds, idxs, B, shuffle=True, drop_last=True,
                        num_workers=2 if how == "loader" else 0)
        it = iter(loader)
        batches = (next(it) for _ in range(n))
        if how == "in memory":
            batches = list(batches)
        parts = _split_steps(model, cfg, opt, batches, dev)
        it.close()
        report[how] = {k: tuple(float(x) for x in np.mean(v, 0))
                       for k, v in parts.items()}
        print(f"stage-1 split, {how}, B={B}, mean ms a step over {steps} "
              "steps (CUDA events / host clock): " + ", ".join(
                  f"{k} {d:.3f} / {h:.3f}"
                  for k, (d, h) in report[how].items()), flush=True)
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=None,
                    help="traced steps a stage (3), or split steps (40)")
    ap.add_argument("--loader-split", action="store_true")
    args = ap.parse_args(argv)
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
            report = {"stages": {str(s): profile_stage(s, root,
                                                       args.steps or 3)
                                 for s in (1, 2)}}
    print(json.dumps({"device": name, **report}))


if __name__ == "__main__":
    main()
