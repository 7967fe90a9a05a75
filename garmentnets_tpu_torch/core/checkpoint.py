"""Pipeline checkpoints in the reference's Lightning `.ckpt` format.

A checkpoint is a `torch.save` payload holding `state_dict` (the
reference's module names, which the port's modules use) and
`hyper_parameters` (the reference's nested constructor schema). Released
reference checkpoints have this format, and so do the files that
tools/export_checkpoint.py writes from the JAX package's checkpoints. The
port reads them with `weights_only=True`: tensors and plain containers
only, no code.
"""
from __future__ import annotations

import pathlib

import torch

from garmentnets_tpu_torch.core.builders import (
    pipeline_config_from_hparams, pipeline_hparams)
from garmentnets_tpu_torch.models.pipeline import PipelineConfig


def load_pipeline_checkpoint(path, device="cpu") -> tuple:
    """-> (PipelineConfig, state_dict with its tensors on `device`)."""
    ckpt = torch.load(pathlib.Path(path).expanduser(), map_location="cpu",
                      weights_only=True)
    hparams = ckpt.get("hyper_parameters")
    if not hparams:
        raise ValueError(f"{path}: checkpoint carries no hyper_parameters")
    cfg = pipeline_config_from_hparams(dict(hparams))
    sd = {}
    for k, v in ckpt["state_dict"].items():
        if k.endswith("num_batches_tracked"):
            # tools/export_checkpoint.py writes this BatchNorm counter with
            # shape [1]; the module's buffer has shape []
            v = v.reshape(())
        sd[k] = v.to(device)
    return cfg, sd


def save_pipeline_checkpoint(path, cfg: PipelineConfig,
                             state_dict: dict) -> None:
    """Write `state_dict` and cfg's hparams in the same format."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"state_dict": {k: v.detach().cpu()
                               for k, v in state_dict.items()},
                "hyper_parameters": pipeline_hparams(cfg)}, path)
