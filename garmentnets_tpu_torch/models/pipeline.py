"""Stage-2 pipeline: volume aggregation -> 3D U-Net -> implicit WNF decoders,
and its training loss (torch port of garmentnets_tpu/models/pipeline.py).

The frozen stage-1 network always runs in eval mode and without gradients,
also when the pipeline is in training mode: its set abstraction then takes
the fused kernel on the card, its BatchNorm statistics never move and it
gets no gradient (the JAX package stops the gradient there). Submodule
names follow the reference Lightning layout (`pointnet2_nocs`,
`volume_agg.local_nn`, `unet_3d.abstract_3d_unet`, `volume_decoder.mlp`,
`surface_decoder.mlp`, `mc_surface_decoder.mlp`). Every variant of the JAX
`PipelineConfig` is here: the aggregator's include flags, the task-space
volume (`volume_task_space`), the mc-surface (hole) head
(`mc_surface_loss_weight > 0`) and the BCE volume loss
(`volume_classification`). The port alone can also take the residual U-Net
(`unet_name`, pytorch-3dunet's model name: "UNet3D", the default, or
"ResidualUNet3D").
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
import torch.nn as nn

from garmentnets_tpu_torch.models.losses import masked_mean
from garmentnets_tpu_torch.models.mlp import PointMLP
from garmentnets_tpu_torch.models.pointnet2_nocs import (
    PointNet2NOCS, PointNet2NOCSConfig, logits_to_nocs_bins)
from garmentnets_tpu_torch.models.unet3d import ResidualUNet3D, UNet3D
from garmentnets_tpu_torch.ops.grid_sample import grid_sample_trilinear
from garmentnets_tpu_torch.ops.scatter import scatter_to_grid
from garmentnets_tpu_torch.ops.virtual_grid import VirtualGrid


class VolumeFeatureAggregator(nn.Module):
    """Scatter per-point features (+ local offset, sim points, confidence)
    into a [B, D, H, W, C] feature volume."""

    def __init__(self, nn_channels: Sequence[int] = (137, 137, 128),
                 batch_norm: bool = True,
                 grid_shape: Tuple[int, int, int] = (32, 32, 32),
                 reduce_method: str = "max",
                 include_point_feature: bool = True,
                 include_confidence_feature: bool = True):
        super().__init__()
        self.local_nn = PointMLP(nn_channels, batch_norm)
        self.grid = VirtualGrid(grid_shape=tuple(grid_shape))
        self.reduce_method = reduce_method
        self.include_point_feature = include_point_feature
        self.include_confidence_feature = include_confidence_feature

    def forward(self, nocs_data: dict) -> torch.Tensor:
        points = nocs_data["pos"]                                 # [B,N,3]
        idxs = self.grid.get_points_grid_idxs(points)
        feats = [nocs_data["x"]]
        if self.include_point_feature:
            feats += [points - self.grid.idxs_to_points(idxs),
                      nocs_data["sim_points"]]
        if self.include_confidence_feature:
            feats.append(nocs_data["pred_confidence"])
        features = self.local_nn(torch.cat(feats, dim=-1))
        vol = scatter_to_grid(features, self.grid.flatten_idxs(idxs),
                              self.grid.num_cells, self.reduce_method)
        return vol.reshape(points.shape[0], *self.grid.grid_shape,
                           features.shape[-1])


class ImplicitWNFDecoder(nn.Module):
    """Trilinear feature lookup + MLP head.

    The reference decoder feeds query points to F.grid_sample unflipped, so
    with its [B, C, Gx, Gy, Gz] volume the lookup lands at V[qz, qy, qx];
    the query is reversed here to sample the same way."""

    def __init__(self, nn_channels: Sequence[int] = (128, 256, 256, 1),
                 batch_norm: bool = True):
        super().__init__()
        self.mlp = PointMLP(nn_channels, batch_norm)

    def forward(self, features_grid: torch.Tensor,
                query_points: torch.Tensor) -> torch.Tensor:
        """features_grid [B, D, H, W, C]; query [B, M, 3] -> [B, M, C']."""
        sampled = grid_sample_trilinear(features_grid,
                                        query_points.flip(-1))
        return self.mlp(sampled)


UNETS = {"UNet3D": UNet3D, "ResidualUNet3D": ResidualUNet3D}


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    pointnet2: PointNet2NOCSConfig = PointNet2NOCSConfig()
    volume_agg_nn_channels: Tuple[int, ...] = (137, 137, 128)
    volume_agg_batch_norm: bool = True
    grid_shape: Tuple[int, int, int] = (32, 32, 32)
    reduce_method: str = "max"
    include_point_feature: bool = True
    include_confidence_feature: bool = True
    unet_in_channels: int = 128
    unet_out_channels: int = 128
    unet_f_maps: int = 32
    unet_layer_order: str = "gcr"
    unet_num_groups: int = 8
    unet_num_levels: int = 4
    unet_name: str = "UNet3D"
    volume_decoder_channels: Tuple[int, ...] = (128, 256, 256, 1)
    surface_decoder_channels: Tuple[int, ...] = (128, 256, 256, 3)
    mc_surface_decoder_channels: Tuple[int, ...] = (128, 256, 256, 1)
    decoder_batch_norm: bool = True
    # training parameters (reference ctor :152-177); a positive mc-surface
    # weight also adds the hole head
    learning_rate: float = 1e-4
    loss_type: str = "l2"
    volume_loss_weight: float = 1.0
    surface_loss_weight: float = 1.0
    mc_surface_loss_weight: float = 0.0
    volume_classification: bool = False
    volume_task_space: bool = False

    def __post_init__(self):
        if self.unet_name not in UNETS:
            raise ValueError(
                f"conv_implicit_model.unet3d_params.name={self.unet_name!r}:"
                f" expected one of {sorted(UNETS)}")

    @property
    def has_mc_surface_decoder(self) -> bool:
        return self.mc_surface_loss_weight > 0


class ConvImplicitWNFPipeline(nn.Module):
    def __init__(self, cfg: PipelineConfig):
        super().__init__()
        c = self.cfg = cfg
        self.pointnet2_nocs = PointNet2NOCS(c.pointnet2)
        self.volume_agg = VolumeFeatureAggregator(
            c.volume_agg_nn_channels, c.volume_agg_batch_norm, c.grid_shape,
            c.reduce_method, c.include_point_feature,
            c.include_confidence_feature)
        self.unet_3d = UNETS[c.unet_name](
            c.unet_in_channels, c.unet_out_channels, f_maps=c.unet_f_maps,
            layer_order=c.unet_layer_order, num_groups=c.unet_num_groups,
            num_levels=c.unet_num_levels)
        self.volume_decoder = ImplicitWNFDecoder(c.volume_decoder_channels,
                                                 c.decoder_batch_norm)
        self.surface_decoder = ImplicitWNFDecoder(c.surface_decoder_channels,
                                                  c.decoder_batch_norm)
        if c.has_mc_surface_decoder:
            self.mc_surface_decoder = ImplicitWNFDecoder(
                c.mc_surface_decoder_channels, c.decoder_batch_norm)

    def train(self, mode: bool = True):
        """Training mode for everything but the frozen stage 1."""
        super().train(mode)
        self.pointnet2_nocs.train(False)
        return self

    def pointnet2_forward(self, x: torch.Tensor, pos: torch.Tensor) -> dict:
        """Frozen stage 1 (eval mode, no gradient): NOCS bins and
        confidence from the logits."""
        with torch.no_grad():
            result = self.pointnet2_nocs(x, pos)
        pred_nocs, confidence = logits_to_nocs_bins(
            self.cfg.pointnet2, result["per_point_logits"])
        result["nocs_data"] = {
            "x": result["per_point_features"],
            "pos": pred_nocs,
            "sim_points": pos,
            "pred_confidence": confidence,
        }
        return result

    def unet3d_forward(self, nocs_data: dict) -> torch.Tensor:
        """-> feature volume [B, D, H, W, C]."""
        return self.unet_3d(self.volume_agg(nocs_data))

    def volume_decoder_forward(self, feature_volume, query_points):
        return self.volume_decoder(feature_volume, query_points)[..., 0]

    def surface_decoder_forward(self, feature_volume, query_points):
        return self.surface_decoder(feature_volume, query_points)

    def mc_surface_decoder_forward(self, feature_volume, query_points):
        return self.mc_surface_decoder(feature_volume, query_points)

    # task-space variant (reference :279-310) ----------------------------
    @staticmethod
    def get_aabb_scale_offset(aabb: torch.Tensor, padding: float = 0.05):
        """aabb: [B, 2, 3] -> (scale [B], offset [B, 3]) (reference
        :297-310)."""
        nocs_radius = 0.5 - padding
        radius = aabb.abs().amax(dim=1)[:, :2]
        radius_scale = (nocs_radius / radius).amin(dim=1)
        z_length = aabb[:, 1, 2] - aabb[:, 0, 2]
        z_scale = (nocs_radius * 2) / z_length
        scale = torch.minimum(radius_scale, z_scale)
        z_max = aabb[:, 1, 2] * scale
        offset = torch.full((aabb.shape[0], 3), 0.5, dtype=aabb.dtype,
                            device=aabb.device)
        offset[:, 2] = 1 - padding - z_max
        return scale, offset

    def apply_volume_task_space(self, pos: torch.Tensor,
                                cloth_sim_aabb: torch.Tensor,
                                pointnet2_result: dict) -> dict:
        """Replace the predicted NOCS with AABB-normalized sim coords
        (reference :279-295; item 0's scale and offset apply to the whole
        batch, as there)."""
        scale, offset = self.get_aabb_scale_offset(cloth_sim_aabb)
        new_pos = pos * scale[0] + offset[0]
        new_result = dict(pointnet2_result)
        new_result["nocs_data"] = dict(pointnet2_result["nocs_data"],
                                       pos=new_pos)
        return new_result

    # full forward (reference :314-338) ----------------------------------
    def forward(self, batch: dict) -> dict:
        """The training forward: batch holds x, pos [B, N, 3],
        volume_query_points, surf_query_points (and mc_surf_query_points
        for the hole head, cloth_sim_aabb for task space) as tensors."""
        result = self.pointnet2_forward(batch["x"], batch["pos"])
        if self.cfg.volume_task_space:
            result = self.apply_volume_task_space(
                batch["pos"], batch["cloth_sim_aabb"], result)
        feature_volume = self.unet3d_forward(result["nocs_data"])
        out = {
            "pointnet2_result": result,
            "feature_volume": feature_volume,
            "pred_volume_value": self.volume_decoder_forward(
                feature_volume, batch["volume_query_points"]),
            "pred_sim_points": self.surface_decoder_forward(
                feature_volume, batch["surf_query_points"]),
        }
        if self.cfg.has_mc_surface_decoder:
            out["pred_mc_surface_logits"] = self.mc_surface_decoder_forward(
                feature_volume, batch["mc_surf_query_points"])
        return out


def pipeline_loss(cfg: PipelineConfig, result: dict, batch: dict,
                  group=None) -> dict:
    """Weighted volume + surface (+ mc-surface BCE) loss (reference infer
    :405-444): l2 or smooth_l1, or BCE on logits for the volume with
    volume_classification. Rows with batch['_valid_mask'] == 0 carry no
    weight. group: the process group whose ranks share the batch (each
    metric is then this rank's share, models/losses.masked_mean)."""
    mask = batch.get("_valid_mask")

    def criterion(pred, gt):
        if cfg.loss_type == "l2":
            return masked_mean((pred - gt) ** 2, mask, group)
        if cfg.loss_type == "smooth_l1":
            d = (pred - gt).abs()
            return masked_mean(torch.where(d < 1.0, 0.5 * d * d, d - 0.5),
                               mask, group)
        raise ValueError(f"invalid loss_type {cfg.loss_type!r}")

    def bce_logits(logits, target):
        return masked_mean(torch.clamp(logits, min=0) - logits * target
                           + torch.log1p(torch.exp(-logits.abs())), mask,
                           group)

    pred_vol = result["pred_volume_value"]
    gt_vol = batch["gt_volume_value"]
    vol_loss = (bce_logits(pred_vol, gt_vol) if cfg.volume_classification
                else criterion(pred_vol, gt_vol))
    surf_loss = criterion(result["pred_sim_points"], batch["gt_sim_points"])
    losses = {
        "volume_loss": cfg.volume_loss_weight * vol_loss,
        "surface_loss": cfg.surface_loss_weight * surf_loss,
    }
    if cfg.has_mc_surface_decoder:
        losses["mc_surface_loss"] = cfg.mc_surface_loss_weight * bce_logits(
            result["pred_mc_surface_logits"],
            batch["is_query_point_on_surf"])
    metrics = dict(losses)
    metrics["loss"] = sum(losses.values())
    return metrics
