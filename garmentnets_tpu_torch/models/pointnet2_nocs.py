"""Stage-1 network: PointNet++ NOCS canonicalization, with its losses and
metrics (torch port of garmentnets_tpu/models/pointnet2_nocs.py).

SA1(.5, .05, [6,64,64,128]) -> SA2(.25, .1, [131,128,128,256]) ->
GlobalSA([259,256,512,1024]) -> FP3(k1,[1280,256,256]) ->
FP2(k3,[384,256,128]) -> FP1(k3,[131,128,128,128]) -> lin 128->128->
feature_dim->bins*3; global 1024->1024->bins*3. Dropout (rate 0.5, in the
JAX package's four places) is the identity in eval mode; in training mode
it draws from the `generator` passed to forward.

The losses: per-axis cross-entropy over the NOCS bins (with the symmetry
variant, the smaller of the plain and the mirrored loss), or MSE
regression when `nocs_bins` is None (min over the x-mirror with a
symmetry axis). Every reduction skips the batch rows whose
`batch["_valid_mask"]` is 0.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from garmentnets_tpu_torch.models.losses import global_value, masked_mean
from garmentnets_tpu_torch.models.pointnet2 import (
    FPModule, GlobalSAModule, SAModule)
from garmentnets_tpu_torch.ops.virtual_grid import VirtualGrid

DROPOUT_RATE = 0.5


@dataclasses.dataclass(frozen=True)
class PointNet2NOCSConfig:
    feature_dim: int = 128
    batch_norm: bool = True
    dropout: bool = True
    sa1_ratio: float = 0.5
    sa1_r: float = 0.05
    sa2_ratio: float = 0.25
    sa2_r: float = 0.1
    fp3_k: int = 1
    fp2_k: int = 3
    fp1_k: int = 3
    nocs_bins: Optional[int] = 64
    symmetry_axis: Optional[int] = None
    # training parameters, carried in the checkpoint's hparams
    learning_rate: float = 1e-4
    nocs_loss_weight: float = 1.0
    grip_point_loss_weight: float = 1.0

    @property
    def output_dim(self) -> int:
        return 3 if self.nocs_bins is None else self.nocs_bins * 3

    def virtual_grid(self) -> VirtualGrid:
        return VirtualGrid(grid_shape=(self.nocs_bins,) * 3)


def dropout(h: torch.Tensor, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax nn.Dropout at DROPOUT_RATE: keep each entry with probability
    1 - rate and scale it by 1 / (1 - rate); the identity when not
    training. The mask is drawn from `generator`, which must live on h's
    device (None: the default generator of that device)."""
    if not training:
        return h
    keep_prob = 1.0 - DROPOUT_RATE
    keep = torch.rand(h.shape, generator=generator, device=h.device,
                      dtype=h.dtype) < keep_prob
    return torch.where(keep, h / keep_prob, torch.zeros_like(h))


class PointNet2NOCS(nn.Module):
    def __init__(self, cfg: PointNet2NOCSConfig):
        super().__init__()
        c, bn = cfg, cfg.batch_norm
        self.cfg = cfg
        self.sa1_module = SAModule(c.sa1_ratio, c.sa1_r, (6, 64, 64, 128),
                                   batch_norm=bn)
        self.sa2_module = SAModule(c.sa2_ratio, c.sa2_r,
                                   (131, 128, 128, 256), batch_norm=bn)
        self.sa3_module = GlobalSAModule((259, 256, 512, 1024), batch_norm=bn)
        self.fp3_module = FPModule(c.fp3_k, (1024 + 256, 256, 256),
                                   batch_norm=bn)
        self.fp2_module = FPModule(c.fp2_k, (256 + 128, 256, 128),
                                   batch_norm=bn)
        self.fp1_module = FPModule(c.fp1_k, (128 + 3, 128, 128, 128),
                                   batch_norm=bn)
        self.lin1 = nn.Linear(128, 128)
        self.lin2 = nn.Linear(128, c.feature_dim)
        self.lin3 = nn.Linear(c.feature_dim, c.output_dim)
        self.global_lin1 = nn.Linear(1024, 1024)
        self.global_lin2 = nn.Linear(1024, c.output_dim)

    def _dropout(self, h, generator):
        return dropout(h, self.training and self.cfg.dropout, generator)

    def forward(self, x: torch.Tensor, pos: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> dict:
        """x: [B, N, 3] rgb features; pos: [B, N, 3] sim-space points;
        generator: dropout's random source in training mode."""
        sa1_x, sa1_pos = self.sa1_module(x, pos)
        sa2_x, sa2_pos = self.sa2_module(sa1_x, sa1_pos)
        sa3_x, sa3_pos = self.sa3_module(sa2_x, sa2_pos)
        fp3_x, _ = self.fp3_module(sa3_x[:, None], sa3_pos, sa2_x, sa2_pos)
        fp2_x, _ = self.fp2_module(fp3_x, sa2_pos, sa1_x, sa1_pos)
        fp1_x, _ = self.fp1_module(fp2_x, sa1_pos, x, pos)

        # per-point head (the features are taken after dropout)
        h = self._dropout(torch.relu(self.lin1(fp1_x)), generator)
        features = self._dropout(self.lin2(h), generator)
        logits = self.lin3(features)
        # global head: relu only on the input feature (reference :151-157)
        g = self._dropout(torch.relu(sa3_x), generator)
        g = self._dropout(self.global_lin1(g), generator)
        global_logits = self.global_lin2(g)
        return {
            "per_point_features": features,
            "per_point_logits": logits,
            "global_logits": global_logits,
            "global_feature": sa3_x,
        }


# ---------------------------------------------------------------------------
# logits -> predictions, losses and metrics
# ---------------------------------------------------------------------------
def logits_to_nocs_bins(cfg: PointNet2NOCSConfig, logits: torch.Tensor):
    """logits [..., bins*3] -> (pred_nocs [..., 3], confidence [..., 3]):
    the argmax bin's voxel-center point and the per-axis softmax
    probability at that bin."""
    bins = cfg.nocs_bins
    lb = logits.reshape(*logits.shape[:-1], bins, 3)
    bin_idx = torch.argmax(lb, dim=-2)                             # [...,3]
    prob = torch.softmax(lb, dim=-2)
    confidence = torch.gather(prob, -2, bin_idx[..., None, :])[..., 0, :]
    pred = cfg.virtual_grid().idxs_to_points(bin_idx)
    return pred, confidence


def mirror_nocs_points_by_axis(points: torch.Tensor,
                               axis: Optional[int]) -> torch.Tensor:
    """Reflect NOCS points about the plane through 0.5 normal to `axis`
    (reference components/symmetry.py:5-19)."""
    if axis is None:
        return points
    cols = list(points.unbind(-1))
    cols[axis] = -(cols[axis] - 0.5) + 0.5
    return torch.stack(cols, dim=-1)


def _bin_cross_entropy(cfg, logits, gt_points, mask=None, group=None):
    """Per-axis CE over the NOCS bins: logits [..., bins*3], gt [..., 3] in
    [0, 1]."""
    lb = logits.reshape(*logits.shape[:-1], cfg.nocs_bins, 3)
    gt_idx = cfg.virtual_grid().get_points_grid_idxs(gt_points)   # [...,3]
    logp = torch.log_softmax(lb, dim=-2)
    picked = torch.gather(logp, -2, gt_idx[..., None, :])
    return -masked_mean(picked, mask, group)


def get_metrics_bin(cfg: PointNet2NOCSConfig, result: dict, batch: dict,
                    mirror_axis: Optional[int] = None, group=None) -> tuple:
    """CE binning loss and error metrics (reference get_metrics_bin_simple
    :288; with `mirror_axis`, against the mirrored ground truth as in
    get_metrics_bin_symmetry_helper :341) -> (metrics, nocs_data).
    group: the process group whose ranks share the batch (each metric is
    then this rank's share, see models/losses.masked_mean)."""
    gt_nocs = batch["y"]
    gt_grip = batch["nocs_grip_point"]                              # [B,3]
    mask = batch.get("_valid_mask")
    if mirror_axis is not None:
        gt_nocs = mirror_nocs_points_by_axis(gt_nocs, mirror_axis)
        gt_grip = mirror_nocs_points_by_axis(gt_grip, mirror_axis)

    nocs_loss = _bin_cross_entropy(
        cfg, result["per_point_logits"], gt_nocs, mask, group)
    grip_loss = _bin_cross_entropy(
        cfg, result["global_logits"], gt_grip, mask, group)
    pred_nocs, confidence = logits_to_nocs_bins(
        cfg, result["per_point_logits"])
    pred_grip, _ = logits_to_nocs_bins(cfg, result["global_logits"])

    loss = (cfg.nocs_loss_weight * nocs_loss
            + cfg.grip_point_loss_weight * grip_loss)
    metrics = {
        "loss": loss,
        "nocs_loss": nocs_loss,
        "grip_point_loss": grip_loss,
        "nocs_err_dist": masked_mean(
            torch.linalg.norm(pred_nocs - gt_nocs, dim=-1), mask, group),
        "grip_point_err_dist": masked_mean(
            torch.linalg.norm(pred_grip - gt_grip, dim=-1), mask, group),
    }
    nocs_data = {
        "x": result["per_point_features"],
        "pos": pred_nocs,
        "grip_point": pred_grip,
        "pred_confidence": confidence,
    }
    return metrics, nocs_data


def get_metrics_regression(cfg: PointNet2NOCSConfig, result: dict,
                           batch: dict, group=None) -> tuple:
    """MSE regression variant (reference get_metrics_regression :257);
    with a symmetry axis, the smaller of the plain MSE and the MSE against
    the x-mirrored ground truth (MirrorMSELoss mirrors x), the two compared
    over the whole batch under a process group."""
    pred_nocs = result["per_point_logits"]
    pred_grip = result["global_logits"]
    gt_nocs, gt_grip = batch["y"], batch["nocs_grip_point"]
    mask = batch.get("_valid_mask")

    def criterion(pred, gt):
        mse = masked_mean((pred - gt) ** 2, mask, group)
        if cfg.symmetry_axis is None:
            return mse
        gt_m = mirror_nocs_points_by_axis(gt, 0)
        mse_m = masked_mean((pred - gt_m) ** 2, mask, group)
        return torch.where(global_value(mse, group)
                           <= global_value(mse_m, group), mse, mse_m)

    nocs_loss = criterion(pred_nocs, gt_nocs)
    grip_loss = masked_mean((pred_grip - gt_grip) ** 2, mask, group)
    loss = (cfg.nocs_loss_weight * nocs_loss
            + cfg.grip_point_loss_weight * grip_loss)
    metrics = {
        "loss": loss, "nocs_loss": nocs_loss, "grip_point_loss": grip_loss,
        "nocs_err_dist": masked_mean(
            torch.linalg.norm(pred_nocs - gt_nocs, dim=-1), mask, group),
        "grip_point_err_dist": masked_mean(
            torch.linalg.norm(pred_grip - gt_grip, dim=-1), mask, group),
    }
    nocs_data = {
        "x": result["per_point_features"], "pos": pred_nocs,
        "grip_point": pred_grip,
    }
    return metrics, nocs_data


def get_metrics(cfg: PointNet2NOCSConfig, result: dict, batch: dict,
                group=None):
    """Regression, bins, or bins with symmetry: the smaller of the plain
    and the mirrored CE loss, with the metrics and NOCS of the branch it
    came from (reference infer :421-433). group: the process group whose
    ranks share the batch; the two losses are then compared over the
    whole batch, so every rank takes the same branch and the ranks'
    losses sum to the global one."""
    if cfg.nocs_bins is None:
        return get_metrics_regression(cfg, result, batch, group)
    if cfg.symmetry_axis is None:
        return get_metrics_bin(cfg, result, batch, None, group)
    normal_m, normal_d = get_metrics_bin(cfg, result, batch, None, group)
    mirror_m, mirror_d = get_metrics_bin(
        cfg, result, batch, cfg.symmetry_axis, group)
    take_normal = (global_value(normal_m["loss"], group)
                   <= global_value(mirror_m["loss"], group))
    metrics = {k: torch.where(take_normal, normal_m[k], mirror_m[k])
               for k in normal_m}
    nocs_data = {k: torch.where(take_normal, normal_d[k], mirror_d[k])
                 for k in normal_d}
    return metrics, nocs_data


def predict_grip_point_from_pc(pos: torch.Tensor,
                               pred_nocs: torch.Tensor) -> torch.Tensor:
    """The predicted NOCS of each cloud's point nearest the gripper (the
    origin): pos, pred_nocs [B, N, 3] -> [B, 3] (reference
    predict_grip_point_nocs :37-54)."""
    idx = torch.argmin(torch.linalg.norm(pos, dim=-1), dim=-1)      # [B]
    return torch.gather(pred_nocs, 1,
                        idx[:, None, None].expand(-1, 1, 3))[:, 0]
