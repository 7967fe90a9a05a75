"""Stage-2 training CLI (torch port of garmentnets_tpu/harness/
train_pipeline.py, reference `train_pipeline.py`).

    python -m garmentnets_tpu_torch.harness.train_pipeline <key=value ...>

Reads configs/train_pipeline_default.yaml. Loads the stage-1 checkpoint
named by `pointnet2_model.checkpoint_path` (the port's own, or one that
tools/export_checkpoint.py wrote from a JAX checkpoint), builds the
pipeline from its hparams and `conv_implicit_model`, copies the stage-1
weights and statistics into the frozen `pointnet2_nocs` (reference
train_pipeline.py:26-34) and trains the aggregator, the U-Net and the
decoders on the weighted implicit-WNF loss. The checkpoints are pipeline
checkpoints that the predict CLI reads as they are. Device, seed and
resume as in harness/train_pointnet2.py.
"""
from __future__ import annotations

import pathlib
import sys

import torch

from garmentnets_tpu_torch.core import config as config_mod
from garmentnets_tpu_torch.core.builders import (
    build_pipeline_config, pipeline_hparams)
from garmentnets_tpu_torch.core.checkpoint import load_pointnet2_checkpoint
from garmentnets_tpu_torch.core.random_weights import init_like_jax_
from garmentnets_tpu_torch.data.dataset import ConvImplicitWNFDataModule
from garmentnets_tpu_torch.harness.training import (
    make_trainer, run_ranks, run_training)
from garmentnets_tpu_torch.models.pipeline import (
    ConvImplicitWNFPipeline, pipeline_loss)


def main(cfg, run_dir=None) -> pathlib.Path:
    """Train on every rank of the run (harness/training.run_ranks);
    returns the run directory."""
    return pathlib.Path(run_ranks(train, cfg, run_dir))


def train(cfg, run_dir=None) -> pathlib.Path:
    """One rank's training (the whole run without a process group)."""
    trainer_cfg = cfg["trainer"]
    run_dir = config_mod.make_run_dir(run_dir=run_dir)
    (run_dir / "checkpoints").mkdir(exist_ok=True)
    trainer = make_trainer(cfg, run_dir)

    pn2_cfg, s1_state = load_pointnet2_checkpoint(
        cfg["pointnet2_model"]["checkpoint_path"])
    pipe_cfg = build_pipeline_config(cfg["conv_implicit_model"], pn2_cfg)
    model = ConvImplicitWNFPipeline(pipe_cfg)
    init_like_jax_(model, torch.Generator().manual_seed(
        trainer_cfg.get("seed", 0)))
    model.pointnet2_nocs.load_state_dict(s1_state)
    model.pointnet2_nocs.requires_grad_(False)
    model.to(trainer.device)

    datamodule = ConvImplicitWNFDataModule(**cfg["datamodule"])
    datamodule.prepare_data()
    if trainer.rank == 0:
        config_mod.dump_config(cfg, run_dir)

    def apply_fn(batch, generator):
        return model(batch)

    def loss_fn(out, batch):
        return pipeline_loss(pipe_cfg, out, batch, trainer.group)

    vis_fn = None
    conv_cfg = cfg["conv_implicit_model"]
    vis_per_items = conv_cfg.get("vis_per_items", 0)
    if vis_per_items > 0:
        from garmentnets_tpu_torch.harness.vis_hooks import vis_stage2
        max_vis = conv_cfg.get("max_vis_per_epoch_val", 10)
        bsz = cfg["datamodule"]["batch_size"]

        def vis_fn(model, batch, epoch, step):
            vis_stage2(trainer.logger, batch, model(batch), 0, bsz,
                       vis_per_items, max_vis, is_train=False, step=step)

    run_training(cfg, trainer, model, pipe_cfg.learning_rate, apply_fn,
                 loss_fn, datamodule, pipeline_hparams(pipe_cfg), vis_fn)
    return run_dir


def cli() -> None:
    overrides = config_mod.parse_cli(sys.argv[1:])
    cfg = config_mod.load_config("train_pipeline_default", overrides)
    print(main(cfg))


if __name__ == "__main__":
    cli()
