"""Input-pipeline throughput at stage-2 production settings (the port's
copy of tools/bench_input.py).

Answers "is stage-2 training starved of input?": Loader samples/s (zarr
read and decode, view subsampling, volume GT trilinear lookups,
barycentric surface sampling, augmentation; B=24, 6000 points, 6000 volume
and 6000 surface samples) for several num_workers, beside the stage-2
train step's samples/s measured on the device (seeded weights, the
production PipelineConfig, full f32, one fixed loader batch). The dataset
is generated first (its 128^3 winding numbers on the card); its volumes
are Blosc where the host has libblosc or `zstandard`, else zlib
(data/zarrlite.py), and the codec is printed.

Usage:
  python -m garmentnets_tpu_torch.tools.bench_input [num_instances]
"""
from __future__ import annotations

import sys
import tempfile
import time

import numpy as np
import torch

from garmentnets_tpu_torch.core.device import resolve_device
from garmentnets_tpu_torch.core.random_weights import init_like_jax_
from garmentnets_tpu_torch.data import zarrlite
from garmentnets_tpu_torch.data.dataset import ConvImplicitWNFDataset, Loader
from garmentnets_tpu_torch.data.synthetic import generate_dataset
from garmentnets_tpu_torch.harness.training import (
    batch_to_device, make_adam, make_train_fns)
from garmentnets_tpu_torch.models.pipeline import (
    ConvImplicitWNFPipeline, PipelineConfig, pipeline_loss)
from garmentnets_tpu_torch.tools.e2e_synthetic import Scale

WORKERS = (0, 2, 4)
EPOCHS = 3          # timed loader epochs a worker count
STEPS = 5           # timed train steps, after one warm-up step


def loader_rate(ds, batch_size: int, workers: int) -> tuple:
    """(samples/s, samples, seconds) of EPOCHS shuffled epochs, after one
    warm-up batch."""
    loader = Loader(ds, np.arange(len(ds)), batch_size, shuffle=True,
                    num_workers=workers)
    next(iter(loader))
    t0 = time.perf_counter()
    n = 0
    for _ in range(EPOCHS):
        for batch in loader:
            n += len(batch["pos"])
    dt = time.perf_counter() - t0
    return n / dt, n, dt


def volume_read_ms(zp: str, volume_size: int) -> float:
    """Milliseconds one sample's GT volume takes to read and decode, over
    every sample once (the part of a stage-2 sample that the codec sets)."""
    groups = list(zarrlite.open(zp, "r")["samples"].groups())
    t0 = time.perf_counter()
    for _, g in groups:
        g[f"volume/nocs_winding_number_field/{volume_size}"][:]
    return (time.perf_counter() - t0) / len(groups) * 1e3


def step_rate(batch: dict, model_cfg, device) -> float:
    """Seconds a stage-2 train step takes on `batch` on `device`."""
    cfg = model_cfg or PipelineConfig()
    model = ConvImplicitWNFPipeline(cfg)
    init_like_jax_(model, torch.Generator().manual_seed(0))
    model.pointnet2_nocs.requires_grad_(False)
    model.to(device)
    step, _ = make_train_fns(model, lambda b, g: model(b),
                             lambda o, b: pipeline_loss(cfg, o, b),
                             make_adam(model, 1e-3))
    rows = batch_to_device(batch, device)

    def run(n):
        for _ in range(n):
            loss = step(rows)["loss"]
        float(loss)     # waits for the device

    run(1)
    t0 = time.perf_counter()
    run(STEPS)
    return (time.perf_counter() - t0) / STEPS


def main(argv=None, *, scale: Scale = Scale(batch_size=24),
         model_cfg=None, device="cuda") -> dict:
    """Prints the codec, one line a worker count, the volume's read and
    decode time and the device's step line; returns {"codec", "loader":
    {workers: samples/s}, "volume_read_ms", "device", "step_ms",
    "step_samples_per_s"}. scale, model_cfg: the sizes and the
    PipelineConfig (production by default)."""
    argv = sys.argv[1:] if argv is None else argv
    n_inst = int(argv[0]) if argv else 4
    dev = resolve_device(device)
    B = scale.batch_size
    out = {"loader": {}}
    with tempfile.TemporaryDirectory() as tmp:
        zp = f"{tmp}/synth.zarr"
        print(f"generating synthetic dataset ({n_inst} instances)...",
              file=sys.stderr)
        generate_dataset(zp, num_instances=n_inst,
                         grips_per_instance=scale.grips,
                         volume_size=scale.volume_size,
                         mesh_res=scale.mesh_res,
                         pts_per_view=scale.pts_per_view,
                         include_task_space=False, device=dev)
        out["codec"] = zarrlite.open(zp, "r")[
            "samples/00000_00/volume/nocs_winding_number_field/"
            f"{scale.volume_size}"].meta["compressor"]["id"]
        print(f"volume codec: {out['codec']}")
        ds = ConvImplicitWNFDataset(
            zarr_path=zp, metadata_cache_dir=None,
            num_pc_sample=scale.num_points,
            num_volume_sample=scale.num_samples,
            num_surface_sample=scale.num_samples,
            num_mc_surface_sample=0, surface_sample_ratio=0,
            surface_sample_std=0.05, surface_normal_noise_ratio=0,
            surface_normal_std=0.01, enable_augumentation=True,
            random_rot_range=[-180, 180], num_views=4, pc_noise_std=0,
            volume_size=scale.volume_size,
            volume_group="nocs_winding_number_field",
            tsdf_clip_value=None, volume_absolute_value=False,
            include_volume=False, static_epoch_seed=False)
        for workers in WORKERS:
            rate, n, dt = loader_rate(ds, B, workers)
            out["loader"][workers] = rate
            print(f"num_workers={workers}: {rate:7.1f} samples/sec "
                  f"({n} samples in {dt:.2f}s)")
        out["volume_read_ms"] = volume_read_ms(zp, scale.volume_size)
        print(f"volume read and decode: {out['volume_read_ms']:.3f} ms a "
              f"sample of {1e3 / out['loader'][0]:.3f} ms a sample on one "
              "thread")
        # B rows for the step, the samples repeated where fewer
        batch = next(iter(Loader(ds, np.resize(np.arange(len(ds)), B), B)))

    sec = step_rate(batch, model_cfg, dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out.update(device=name, step_ms=sec * 1e3, step_samples_per_s=B / sec)
    print(f"stage-2 train step on {name}: {sec * 1e3:.3f} ms a step of {B} "
          f"samples, {B / sec:7.1f} samples/sec")
    return out


if __name__ == "__main__":
    main()
