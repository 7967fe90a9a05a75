"""Checkpoint hparams <-> the port's model configs (copy of
garmentnets_tpu/core/builders.py::pipeline_config_from_hparams and
pipeline_hparams, with the key clean-up of
tools/convert_checkpoint.py::_pipeline_hparams_from_torch).

The hparams are the reference's nested constructor schema, as a Lightning
checkpoint's `hyper_parameters` carries them. The port keeps what
inference reads, every model variant included (the aggregator's include
flags, the mc-surface head and its `mc_surface_loss_weight`,
`volume_classification`, `volume_task_space`); the other training-only
keys (learning rate, loss type and the other weights, dropout, symmetry
axis) are accepted and dropped.
"""
from __future__ import annotations

import dataclasses

from garmentnets_tpu_torch.models.pipeline import PipelineConfig
from garmentnets_tpu_torch.models.pointnet2_nocs import PointNet2NOCSConfig

_PN2_KEYS = tuple(f.name for f in dataclasses.fields(PointNet2NOCSConfig))
# logging keys of the reference's Lightning modules, not constructor args
_LOGGING_KEYS = ("vis_per_items", "max_vis_per_epoch_train",
                 "max_vis_per_epoch_val", "batch_size")


def clean_hparams(hparams: dict) -> dict:
    """Drop the logging keys a released reference checkpoint carries, at
    the top level and in `pointnet2_params`."""
    hp = {k: v for k, v in hparams.items() if k not in _LOGGING_KEYS}
    hp["pointnet2_params"] = {
        k: v for k, v in dict(hp.get("pointnet2_params", {})).items()
        if k not in _LOGGING_KEYS}
    return hp


def pipeline_config_from_hparams(hp: dict) -> PipelineConfig:
    """Reference-schema hparams (config/train_pipeline_default.yaml:39-74)
    -> PipelineConfig."""
    hp = clean_hparams(hp)
    pn2 = PointNet2NOCSConfig(**{k: v for k, v in
                                 hp["pointnet2_params"].items()
                                 if k in _PN2_KEYS})
    agg = hp["volume_agg_params"]
    unet = hp["unet3d_params"]
    return PipelineConfig(
        pointnet2=pn2,
        volume_agg_nn_channels=tuple(agg["nn_channels"]),
        volume_agg_batch_norm=agg.get("batch_norm", True),
        grid_shape=tuple(agg.get("grid_shape", (32, 32, 32))),
        reduce_method=agg.get("reduce_method", "max"),
        include_point_feature=agg.get("include_point_feature", True),
        include_confidence_feature=agg.get(
            "include_confidence_feature", True),
        unet_in_channels=unet["in_channels"],
        unet_out_channels=unet["out_channels"],
        unet_f_maps=unet.get("f_maps", 32),
        unet_layer_order=unet.get("layer_order", "gcr"),
        unet_num_groups=unet.get("num_groups", 8),
        unet_num_levels=unet.get("num_levels", 4),
        volume_decoder_channels=tuple(
            hp["volume_decoder_params"]["nn_channels"]),
        surface_decoder_channels=tuple(
            hp["surface_decoder_params"]["nn_channels"]),
        mc_surface_decoder_channels=tuple(
            hp.get("mc_surface_decoder_params",
                   {"nn_channels": (128, 256, 256, 1)})["nn_channels"]),
        decoder_batch_norm=hp["volume_decoder_params"].get(
            "batch_norm", True),
        mc_surface_loss_weight=hp.get("mc_surface_loss_weight", 0.0),
        volume_classification=hp.get("volume_classification", False),
        volume_task_space=hp.get("volume_task_space", False),
    )


def pipeline_hparams(cfg: PipelineConfig) -> dict:
    """PipelineConfig -> the reference's nested hparams schema."""
    return {
        "pointnet2_params": dataclasses.asdict(cfg.pointnet2),
        "volume_agg_params": {
            "nn_channels": list(cfg.volume_agg_nn_channels),
            "batch_norm": cfg.volume_agg_batch_norm,
            "grid_shape": list(cfg.grid_shape),
            "reduce_method": cfg.reduce_method,
            "include_point_feature": cfg.include_point_feature,
            "include_confidence_feature": cfg.include_confidence_feature,
        },
        "unet3d_params": {
            "in_channels": cfg.unet_in_channels,
            "out_channels": cfg.unet_out_channels,
            "f_maps": cfg.unet_f_maps,
            "layer_order": cfg.unet_layer_order,
            "num_groups": cfg.unet_num_groups,
            "num_levels": cfg.unet_num_levels,
        },
        "volume_decoder_params": {
            "nn_channels": list(cfg.volume_decoder_channels),
            "batch_norm": cfg.decoder_batch_norm,
        },
        "surface_decoder_params": {
            "nn_channels": list(cfg.surface_decoder_channels),
            "batch_norm": cfg.decoder_batch_norm,
        },
        "mc_surface_decoder_params": {
            "nn_channels": list(cfg.mc_surface_decoder_channels),
            "batch_norm": cfg.decoder_batch_norm,
        },
        "mc_surface_loss_weight": cfg.mc_surface_loss_weight,
        "volume_classification": cfg.volume_classification,
        "volume_task_space": cfg.volume_task_space,
    }
