"""Stage-1 training CLI (torch port of garmentnets_tpu/harness/
train_pointnet2.py, reference `train_pointnet2.py`).

    python -m garmentnets_tpu_torch.harness.train_pointnet2 <key=value ...>

Reads configs/train_pointnet2_default.yaml. Builds the datamodule and
PointNet2NOCS from flax's default initializers (seeded by `trainer.seed`,
default 0), trains with Adam on the CE binning loss, and writes top-k and
last checkpoints with their hparams, metrics.jsonl, summary.json and the
per-epoch PNGs into the run directory. Trains on the card unless
`trainer.device=cpu`; `trainer.num_devices` must be -1 or 1.
`trainer.seed` also seeds dropout and the train loader's shuffle.
"""
from __future__ import annotations

import pathlib
import sys

import torch

from garmentnets_tpu_torch.core import config as config_mod
from garmentnets_tpu_torch.core.builders import (
    build_pointnet2_config, pointnet2_hparams)
from garmentnets_tpu_torch.core.random_weights import init_like_jax_
from garmentnets_tpu_torch.data.dataset import ConvImplicitWNFDataModule
from garmentnets_tpu_torch.harness.training import make_trainer, run_training
from garmentnets_tpu_torch.models.pointnet2_nocs import (
    PointNet2NOCS, get_metrics)


def main(cfg, run_dir=None) -> pathlib.Path:
    trainer_cfg = cfg["trainer"]
    run_dir = config_mod.make_run_dir(run_dir=run_dir)
    (run_dir / "checkpoints").mkdir(exist_ok=True)
    trainer = make_trainer(cfg, run_dir)

    datamodule = ConvImplicitWNFDataModule(**cfg["datamodule"])
    datamodule.prepare_data()
    model_cfg = build_pointnet2_config(cfg["model"])
    model = PointNet2NOCS(model_cfg)
    init_like_jax_(model, torch.Generator().manual_seed(
        trainer_cfg.get("seed", 0)))
    model.to(trainer.device)
    config_mod.dump_config(cfg, run_dir)

    def apply_fn(batch, generator):
        return model(batch["x"], batch["pos"], generator=generator)

    def loss_fn(out, batch):
        return get_metrics(model_cfg, out, batch)[0]

    vis_fn = None
    vis_per_items = cfg["model"].get("vis_per_items", 0)
    if vis_per_items > 0:
        from garmentnets_tpu_torch.harness.vis_hooks import vis_stage1
        max_vis = cfg["model"].get("max_vis_per_epoch_val", 10)
        bsz = cfg["datamodule"]["batch_size"]

        def vis_fn(model, batch, epoch, step):
            _, nocs_data = get_metrics(
                model_cfg, model(batch["x"], batch["pos"]), batch)
            vis_stage1(trainer.logger, batch, nocs_data, 0, bsz,
                       vis_per_items, max_vis, is_train=False, step=step)

    run_training(cfg, trainer, model, model_cfg.learning_rate, apply_fn,
                 loss_fn, datamodule, pointnet2_hparams(model_cfg), vis_fn)
    return run_dir


def cli() -> None:
    overrides = config_mod.parse_cli(sys.argv[1:])
    cfg = config_mod.load_config("train_pointnet2_default", overrides)
    print(main(cfg))


if __name__ == "__main__":
    cli()
