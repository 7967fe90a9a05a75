"""Config dicts <-> the port's model configs (copy of
garmentnets_tpu/core/builders.py, with the key clean-up of
tools/convert_checkpoint.py::_pipeline_hparams_from_torch).

The hparams are the reference's constructor schema, as a Lightning
checkpoint's `hyper_parameters` carries them: flat for stage 1, nested
(`pointnet2_params`, `volume_agg_params`, ...) for the pipeline. Every
key is kept, the training ones (learning rate, loss type and weights,
dropout, symmetry axis) included, so a checkpoint's hparams rebuild the
model and its loss. The logging keys of a released reference checkpoint
are dropped.
"""
from __future__ import annotations

from garmentnets_tpu_torch.models.pipeline import PipelineConfig
from garmentnets_tpu_torch.models.pointnet2_nocs import PointNet2NOCSConfig

_PN2_KEYS = ("feature_dim", "batch_norm", "dropout", "sa1_ratio", "sa1_r",
             "sa2_ratio", "sa2_r", "fp3_k", "fp2_k", "fp1_k", "nocs_bins",
             "symmetry_axis", "learning_rate", "nocs_loss_weight",
             "grip_point_loss_weight")
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


def build_pointnet2_config(model_cfg: dict) -> PointNet2NOCSConfig:
    """The `model` block of configs/train_pointnet2_default.yaml, or a
    stage-1 checkpoint's hparams -> PointNet2NOCSConfig (other keys are
    ignored)."""
    return PointNet2NOCSConfig(**{k: model_cfg[k] for k in _PN2_KEYS
                                  if k in model_cfg})


def pointnet2_hparams(cfg: PointNet2NOCSConfig) -> dict:
    return {k: getattr(cfg, k) for k in _PN2_KEYS}


def build_pipeline_config(conv_cfg: dict,
                          pointnet2_cfg: PointNet2NOCSConfig
                          ) -> PipelineConfig:
    """The `conv_implicit_model` block of configs/train_pipeline_default.yaml
    (the reference schema, config/train_pipeline_default.yaml:39-74) and
    the stage-1 config -> PipelineConfig."""
    agg = conv_cfg["volume_agg_params"]
    unet = conv_cfg["unet3d_params"]
    return PipelineConfig(
        pointnet2=pointnet2_cfg,
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
        unet_name=unet.get("name", "UNet3D"),
        volume_decoder_channels=tuple(
            conv_cfg["volume_decoder_params"]["nn_channels"]),
        surface_decoder_channels=tuple(
            conv_cfg["surface_decoder_params"]["nn_channels"]),
        mc_surface_decoder_channels=tuple(
            conv_cfg.get("mc_surface_decoder_params",
                         {"nn_channels": (128, 256, 256, 1)})["nn_channels"]),
        decoder_batch_norm=conv_cfg["volume_decoder_params"].get(
            "batch_norm", True),
        learning_rate=conv_cfg.get("learning_rate", 1e-4),
        loss_type=conv_cfg.get("loss_type", "l2"),
        volume_loss_weight=conv_cfg.get("volume_loss_weight", 1.0),
        surface_loss_weight=conv_cfg.get("surface_loss_weight", 1.0),
        mc_surface_loss_weight=conv_cfg.get("mc_surface_loss_weight", 0.0),
        volume_classification=conv_cfg.get("volume_classification", False),
        volume_task_space=conv_cfg.get("volume_task_space", False),
    )


def pipeline_config_from_hparams(hp: dict) -> PipelineConfig:
    """A pipeline checkpoint's hparams -> PipelineConfig."""
    hp = clean_hparams(hp)
    return build_pipeline_config(
        hp, build_pointnet2_config(hp["pointnet2_params"]))


def pipeline_hparams(cfg: PipelineConfig) -> dict:
    """PipelineConfig -> the reference's nested hparams schema (the JAX
    package's pipeline_hparams); `unet3d_params.name` only where the U-Net
    is not the default UNet3D, so a default checkpoint's hparams are the
    reference's."""
    unet = {"name": cfg.unet_name} if cfg.unet_name != "UNet3D" else {}
    return {
        "pointnet2_params": pointnet2_hparams(cfg.pointnet2),
        "volume_agg_params": {
            "nn_channels": list(cfg.volume_agg_nn_channels),
            "batch_norm": cfg.volume_agg_batch_norm,
            "grid_shape": list(cfg.grid_shape),
            "reduce_method": cfg.reduce_method,
            "include_point_feature": cfg.include_point_feature,
            "include_confidence_feature": cfg.include_confidence_feature,
        },
        "unet3d_params": {
            **unet,
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
        "learning_rate": cfg.learning_rate,
        "loss_type": cfg.loss_type,
        "volume_loss_weight": cfg.volume_loss_weight,
        "surface_loss_weight": cfg.surface_loss_weight,
        "mc_surface_loss_weight": cfg.mc_surface_loss_weight,
        "volume_classification": cfg.volume_classification,
        "volume_task_space": cfg.volume_task_space,
    }
