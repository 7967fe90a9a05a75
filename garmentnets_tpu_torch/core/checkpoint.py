"""Checkpoints in the reference's Lightning `.ckpt` format, and the
trainer's top-k-by-val-loss manager.

A checkpoint is a `torch.save` payload holding `state_dict` (the
reference's module names, which the port's modules use) and
`hyper_parameters` (the reference's constructor schema: flat for stage 1,
nested for the pipeline). Released reference checkpoints have this
format, and so do the files that tools/export_checkpoint.py writes from
the JAX package's checkpoints. A training checkpoint adds
`optimizer_states` ([the Adam state_dict]), `epoch` and `global_step`, as
Lightning's ModelCheckpoint writes them. The port reads every checkpoint
with `weights_only=True`: tensors and plain containers only, no code.

TopKCheckpointManager names files `epoch={e}-val_loss={v:.4f}.ckpt`, keeps
the k best by val_loss and rewrites `last.ckpt` each epoch (reference
train_pointnet2.py:47-56, the JAX package's core/checkpoint.py).
"""
from __future__ import annotations

import pathlib
from typing import Any, Optional

import torch

from garmentnets_tpu_torch.core.builders import (
    build_pointnet2_config, clean_hparams, pipeline_config_from_hparams,
    pipeline_hparams)
from garmentnets_tpu_torch.models.pipeline import PipelineConfig


def read_checkpoint(path) -> dict:
    """The checkpoint's payload, read with weights_only=True; a
    checkpoint without hyper_parameters raises."""
    ckpt = torch.load(pathlib.Path(path).expanduser(), map_location="cpu",
                      weights_only=True)
    if not ckpt.get("hyper_parameters"):
        raise ValueError(f"{path}: checkpoint carries no hyper_parameters")
    return ckpt


def _state_dict_on(ckpt: dict, device) -> dict:
    sd = {}
    for k, v in ckpt["state_dict"].items():
        if k.endswith("num_batches_tracked"):
            # tools/export_checkpoint.py writes this BatchNorm counter with
            # shape [1]; the module's buffer has shape []
            v = v.reshape(())
        sd[k] = v.to(device)
    return sd


def load_pipeline_checkpoint(path, device="cpu") -> tuple:
    """-> (PipelineConfig, state_dict with its tensors on `device`)."""
    ckpt = read_checkpoint(path)
    cfg = pipeline_config_from_hparams(dict(ckpt["hyper_parameters"]))
    return cfg, _state_dict_on(ckpt, device)


def load_pointnet2_checkpoint(path, device="cpu") -> tuple:
    """A stage-1 checkpoint (the port's, or one that
    tools/export_checkpoint.py wrote from the JAX package's) ->
    (PointNet2NOCSConfig, state_dict with its tensors on `device`)."""
    ckpt = read_checkpoint(path)
    hp = clean_hparams(dict(ckpt["hyper_parameters"]))
    return build_pointnet2_config(hp), _state_dict_on(ckpt, device)


def save_pipeline_checkpoint(path, cfg: PipelineConfig,
                             state_dict: dict) -> None:
    """Write `state_dict` and cfg's hparams in the same format."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"state_dict": {k: v.detach().cpu()
                               for k, v in state_dict.items()},
                "hyper_parameters": pipeline_hparams(cfg)}, path)


def training_checkpoint(model: torch.nn.Module, hparams: dict,
                        optimizer: torch.optim.Optimizer, epoch: int,
                        global_step: int) -> dict:
    """The payload of a training checkpoint (its tensors stay where they
    are; read_checkpoint maps them to the CPU)."""
    return {
        "state_dict": model.state_dict(),
        "hyper_parameters": hparams,
        "optimizer_states": [optimizer.state_dict()],
        "lr_schedulers": [],
        "epoch": epoch,
        "global_step": global_step,
        "pytorch-lightning_version": "1.3.0",
        "callbacks": {},
    }


def resume_training(path, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer) -> tuple:
    """Load a training checkpoint's weights, statistics and optimizer
    state into `model` and `optimizer` -> (its epoch, its global_step)."""
    ckpt = read_checkpoint(path)
    model.load_state_dict(_state_dict_on(ckpt, "cpu"))
    optimizer.load_state_dict(ckpt["optimizer_states"][0])
    return int(ckpt["epoch"]), int(ckpt["global_step"])


class TopKCheckpointManager:
    """ModelCheckpoint(top-k, monitor=val_loss, save_last) equivalent."""

    def __init__(self, dirpath, k: int = 20, mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.dirpath = pathlib.Path(dirpath)
        self.dirpath.mkdir(parents=True, exist_ok=True)
        self.k = k
        self.mode = mode
        self._saved: list = []

    def save(self, epoch: int, val_loss: float,
             payload: dict) -> pathlib.Path:
        path = self.dirpath / f"epoch={epoch}-val_loss={val_loss:.4f}.ckpt"
        torch.save(payload, path)
        torch.save(payload, self.dirpath / "last.ckpt")
        score = val_loss if self.mode == "min" else -val_loss
        self._saved.append((score, path))
        self._saved.sort(key=lambda t: t[0])
        while len(self._saved) > self.k:
            _, worst = self._saved.pop()
            worst.unlink(missing_ok=True)
        return path

    @property
    def best_path(self) -> Optional[pathlib.Path]:
        return self._saved[0][1] if self._saved else None


def get_checkpoint_df(checkpoint_dir):
    """A pandas DataFrame of the metric-bearing checkpoint file names
    (reference predict.py:30-42): one row per file, its `key=value` parts
    as float columns and `path`; last.ckpt has none and is left out."""
    import pandas as pd
    rows = []
    for path in sorted(pathlib.Path(checkpoint_dir).glob("*.ckpt")):
        row: dict[str, Any] = {}
        try:
            for item in path.stem.split("-"):
                key, _, value = item.partition("=")
                row[key] = float(value)
        except ValueError:
            continue
        row["path"] = str(path.absolute())
        rows.append(row)
    return pd.DataFrame(rows)
