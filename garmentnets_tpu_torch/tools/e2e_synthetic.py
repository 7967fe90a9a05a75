"""Production-scale end-to-end run on synthetic data: the acceptance run
(the port's copy of tools/e2e_synthetic.py).

Trains both stages at production shapes (6000 points, 32^3 grid, 128-ch
U-Net, B=8) on a synthetic category until the stage-2 WNF forms a clean
surface, then runs the port's predict and eval CLIs against the trained
checkpoint: the reference workflow (train_pointnet2 -> train_pipeline ->
predict -> eval) at real sizes, with a model whose WNF is meshable.
Reports the losses every 100 steps, the predict CLI's summary and the
eval's chamfer and NOCS keys.

Usage:
  python -m garmentnets_tpu_torch.tools.e2e_synthetic [--out DIR]
      [--instances 4] [--steps1 400] [--steps2 400]

Runs on the card (the dataset's 128^3 winding numbers included,
ops/geometry's device path). Artifacts land under --out (default: a temp
dir): dataset.zarr, s1.ckpt and s2.ckpt (Lightning layout,
core/checkpoint.py), predict_run/ (prediction.zarr, summary.json) and the
eval CLI's run directory. `main` also takes, as keywords and not flags, the
model configurations, the data sizes (`Scale`), the device and the seed,
and returns what it measured.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from garmentnets_tpu_torch.core.builders import (
    pipeline_hparams, pointnet2_hparams)
from garmentnets_tpu_torch.core.checkpoint import (
    load_pointnet2_checkpoint, training_checkpoint)
from garmentnets_tpu_torch.core.config import load_config
from garmentnets_tpu_torch.core.device import resolve_device
from garmentnets_tpu_torch.core.random_weights import init_like_jax_
from garmentnets_tpu_torch.data.dataset import ConvImplicitWNFDataset, Loader
from garmentnets_tpu_torch.data.synthetic import generate_dataset
from garmentnets_tpu_torch.harness import predict
from garmentnets_tpu_torch.harness.training import (
    batch_to_device, make_adam, make_train_fns)
from garmentnets_tpu_torch.models.pipeline import (
    ConvImplicitWNFPipeline, PipelineConfig, pipeline_loss)
from garmentnets_tpu_torch.models.pointnet2_nocs import (
    PointNet2NOCS, PointNet2NOCSConfig, get_metrics)

ROOT = pathlib.Path(__file__).resolve().parents[2]
LR = 1e-3


@dataclasses.dataclass(frozen=True)
class Scale:
    """The run's data and batch sizes: the JAX tool's by default."""
    grips: int = 3
    volume_size: int = 128
    mesh_res: int = 24
    pts_per_view: int = 3000
    num_points: int = 6000
    num_samples: int = 6000     # stage 2's volume and surface samples
    batch_size: int = 8


def common_kwargs(scale: Scale) -> dict:
    """The dataset arguments both stages share."""
    return dict(num_pc_sample=scale.num_points, num_views=4, pc_noise_std=0,
                enable_augumentation=True, random_rot_range=[-180, 180],
                static_epoch_seed=False)


def stage2_kwargs(scale: Scale) -> dict:
    return dict(common_kwargs(scale), num_volume_sample=scale.num_samples,
                num_surface_sample=scale.num_samples,
                volume_size=scale.volume_size,
                volume_group="nocs_winding_number_field")


def train_stage(model_kind: str, zarr_path: str, out_ckpt: str, steps: int,
                batch_size: int, dataset_kwargs: dict, lr: float, *,
                device="cuda", model_cfg=None, seed: int = 0) -> dict:
    """`steps` Adam steps in full f32 of stage 1 (model_kind "pointnet2")
    or of stage 2 on the frozen stage 1 of the checkpoint at model_kind,
    from flax's initializers drawn from a torch.Generator seeded with
    `seed`, over a shuffled Loader of the dataset's indices repeated to
    cover the steps. model_cfg: the PointNet2NOCSConfig or PipelineConfig
    (default: the production one; stage 2 takes its stage-1 part from the
    checkpoint). Writes a training checkpoint to out_ckpt. Returns the
    step losses, the seconds the steps took, the seconds the steps waited
    on the loader, the steps and the batch size."""
    dev = resolve_device(device)
    ds = ConvImplicitWNFDataset(zarr_path=zarr_path, metadata_cache_dir=None,
                                **dataset_kwargs)
    idxs = np.arange(len(ds))
    reps = max(1, (steps * batch_size) // max(len(ds), 1) + 1)
    loader = Loader(ds, np.concatenate([idxs] * reps), batch_size,
                    shuffle=True, num_workers=2, drop_last=True)
    init = torch.Generator().manual_seed(seed)

    if model_kind == "pointnet2":
        cfg = dataclasses.replace(model_cfg or PointNet2NOCSConfig(),
                                  learning_rate=lr)
        model = PointNet2NOCS(cfg)
        init_like_jax_(model, init)
        hparams = pointnet2_hparams(cfg)

        def apply_fn(b, gen):
            return model(b["x"], b["pos"], generator=gen)

        def loss_fn(out, b):
            return get_metrics(cfg, out, b)[0]
    else:
        # harness/train_pipeline.py's way: the stage-1 checkpoint's config
        # and weights into the frozen pointnet2_nocs
        s1_cfg, s1_state = load_pointnet2_checkpoint(model_kind)
        cfg = dataclasses.replace(model_cfg or PipelineConfig(),
                                  pointnet2=s1_cfg, learning_rate=lr)
        model = ConvImplicitWNFPipeline(cfg)
        init_like_jax_(model, init)
        model.pointnet2_nocs.load_state_dict(s1_state)
        model.pointnet2_nocs.requires_grad_(False)
        hparams = pipeline_hparams(cfg)

        def apply_fn(b, gen):
            return model(b)

        def loss_fn(out, b):
            return pipeline_loss(cfg, out, b)

    model.to(dev)
    optimizer = make_adam(model, lr)
    train_step, _ = make_train_fns(model, apply_fn, loss_fn, optimizer)
    dropout = torch.Generator(device=dev).manual_seed(seed)
    batches = iter(loader)
    losses, wait, n = [], 0.0, 0
    t0 = time.perf_counter()
    while n < steps:
        tw = time.perf_counter()
        batch = next(batches, None)
        wait += time.perf_counter() - tw
        if batch is None:
            break
        losses.append(train_step(batch_to_device(batch, dev),
                                 dropout)["loss"])
        n += 1
        if n % 100 == 0:
            print(f"  step {n}: loss {float(losses[-1]):.4f} "
                  f"({n / (time.perf_counter() - t0):.1f} steps/s)",
                  flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    batches.close()
    losses = torch.stack(losses).cpu().tolist()
    torch.save(training_checkpoint(model, hparams, optimizer, 0, n),
               out_ckpt)
    print(f"  trained {n} steps in {seconds:.0f}s, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return {"losses": losses, "seconds": seconds, "loader_wait_s": wait,
            "steps": n, "batch_size": batch_size}


def run_eval_cli(prediction_dir, cwd) -> pathlib.Path:
    """The port's eval CLI (configs/eval_default.yaml as shipped) on a
    predict run, in a process of its own: its metric pool forks, and a
    fork of a process that holds a CUDA context is unsafe
    (harness/parallel_util.py). Returns the eval run directory."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    out = subprocess.run(
        [sys.executable, "-m", "garmentnets_tpu_torch.harness.eval",
         f"main.prediction_output_dir={prediction_dir}"],
        cwd=cwd, env=env, capture_output=True, text=True, check=False)
    if out.returncode != 0:
        raise RuntimeError(f"eval CLI failed:\n{out.stderr[-4000:]}")
    return pathlib.Path(cwd) / out.stdout.strip().splitlines()[-1]


def main(argv=None, *, model_cfgs: Optional[tuple] = None,
         scale: Scale = Scale(), device="cuda", seed: int = 0) -> dict:
    """The acceptance run. model_cfgs: (PointNet2NOCSConfig,
    PipelineConfig) or None for the production widths. Returns the
    dataset's seconds, each stage's train_stage result, the predict run
    and its summary, the eval run and its summary, and the seconds each
    CLI took."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--instances", type=int, default=4)
    ap.add_argument("--steps1", type=int, default=400)
    ap.add_argument("--steps2", type=int, default=400)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    s1_cfg, s2_cfg = model_cfgs or (None, None)

    out = pathlib.Path(args.out or tempfile.mkdtemp(prefix="e2e_synth_"))
    out.mkdir(parents=True, exist_ok=True)
    zp = str(out / "dataset.zarr")
    result = {"out": out, "dataset_s": None}
    if not pathlib.Path(zp).exists():
        print(f"generating {args.instances}x{scale.grips} production-size "
              "samples...", flush=True)
        t0 = time.perf_counter()
        generate_dataset(zp, num_instances=args.instances,
                         grips_per_instance=scale.grips,
                         volume_size=scale.volume_size,
                         mesh_res=scale.mesh_res,
                         pts_per_view=scale.pts_per_view,
                         include_task_space=False, seed=seed, device=dev)
        result["dataset_s"] = time.perf_counter() - t0
        print(f"  dataset in {result['dataset_s']:.0f}s")

    B = scale.batch_size
    print(f"stage-1 training (B={B})...", flush=True)
    result["stage1"] = train_stage(
        "pointnet2", zp, str(out / "s1.ckpt"), args.steps1, B,
        dict(common_kwargs(scale), volume_size=None), LR, device=dev,
        model_cfg=s1_cfg, seed=seed)
    print(f"stage-2 training (B={B}, frozen stage-1)...", flush=True)
    result["stage2"] = train_stage(
        str(out / "s1.ckpt"), zp, str(out / "s2.ckpt"), args.steps2, B,
        stage2_kwargs(scale), LR, device=dev, model_cfg=s2_cfg, seed=seed)

    print(f"predict CLI (B={B})...", flush=True)
    cfg = load_config("predict_default", [
        f"main.checkpoint_path={out / 's2.ckpt'}",
        f"datamodule.zarr_path={zp}",
        "datamodule.metadata_cache_dir=null",
        f"datamodule.batch_size={B}",
        "datamodule.num_workers=2",
        f"datamodule.num_pc_sample={scale.num_points}",
        f"datamodule.volume_size={scale.volume_size}",
        "prediction.subset=train",
        f"prediction.volume_size={scale.volume_size}",
        f"prediction.device={dev}",
    ])
    t0 = time.perf_counter()
    run_dir = predict.main(cfg, run_dir=str(out / "predict_run"))
    result["predict_s"] = time.perf_counter() - t0
    result["predict_run"] = run_dir
    result["predict_summary"] = summ = json.loads(
        (run_dir / "summary.json").read_text())
    print(f"  predict: {summ}")

    print("eval CLI...", flush=True)
    t0 = time.perf_counter()
    eval_dir = run_eval_cli(run_dir, out)
    result["eval_s"] = time.perf_counter() - t0
    result["eval_run"] = eval_dir
    result["eval_summary"] = esumm = json.loads(
        (eval_dir / "summary.json").read_text())
    keep = {k: v for k, v in esumm.items()
            if "chamfer" in k or "nocs_pc_error_dist" in k}
    print(f"  eval summary (chamfer/nocs): {keep}")
    print(f"artifacts: {out}")
    return result


if __name__ == "__main__":
    main()
