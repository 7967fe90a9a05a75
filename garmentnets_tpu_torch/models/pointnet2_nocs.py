"""Stage-1 network: PointNet++ NOCS canonicalization, eval-mode forward
(torch port of garmentnets_tpu/models/pointnet2_nocs.py:58-135).

SA1(.5, .05, [6,64,64,128]) -> SA2(.25, .1, [131,128,128,256]) ->
GlobalSA([259,256,512,1024]) -> FP3(k1,[1280,256,256]) ->
FP2(k3,[384,256,128]) -> FP1(k3,[131,128,128,128]) -> lin 128->128->
feature_dim->bins*3; global 1024->1024->bins*3. Dropout is the identity in
eval mode. Losses and metrics wait for the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from garmentnets_tpu_torch.models.pointnet2 import (
    FPModule, GlobalSAModule, SAModule)
from garmentnets_tpu_torch.ops.virtual_grid import VirtualGrid


@dataclasses.dataclass(frozen=True)
class PointNet2NOCSConfig:
    feature_dim: int = 128
    batch_norm: bool = True
    sa1_ratio: float = 0.5
    sa1_r: float = 0.05
    sa2_ratio: float = 0.25
    sa2_r: float = 0.1
    fp3_k: int = 1
    fp2_k: int = 3
    fp1_k: int = 3
    nocs_bins: Optional[int] = 64

    @property
    def output_dim(self) -> int:
        return 3 if self.nocs_bins is None else self.nocs_bins * 3


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

    def forward(self, x: torch.Tensor, pos: torch.Tensor) -> dict:
        """x: [B, N, 3] rgb features; pos: [B, N, 3] sim-space points."""
        sa1_x, sa1_pos = self.sa1_module(x, pos)
        sa2_x, sa2_pos = self.sa2_module(sa1_x, sa1_pos)
        sa3_x, sa3_pos = self.sa3_module(sa2_x, sa2_pos)
        fp3_x, _ = self.fp3_module(sa3_x[:, None], sa3_pos, sa2_x, sa2_pos)
        fp2_x, _ = self.fp2_module(fp3_x, sa2_pos, sa1_x, sa1_pos)
        fp1_x, _ = self.fp1_module(fp2_x, sa1_pos, x, pos)

        features = self.lin2(torch.relu(self.lin1(fp1_x)))
        logits = self.lin3(features)
        # global head: relu only on the input feature (reference :151-157)
        global_logits = self.global_lin2(self.global_lin1(torch.relu(sa3_x)))
        return {
            "per_point_features": features,
            "per_point_logits": logits,
            "global_logits": global_logits,
            "global_feature": sa3_x,
        }


def logits_to_nocs_bins(cfg: PointNet2NOCSConfig, logits: torch.Tensor):
    """logits [..., bins*3] -> (pred_nocs [..., 3], confidence [..., 3]):
    the argmax bin's voxel-center point and the per-axis softmax
    probability at that bin."""
    bins = cfg.nocs_bins
    lb = logits.reshape(*logits.shape[:-1], bins, 3)
    bin_idx = torch.argmax(lb, dim=-2)                             # [...,3]
    prob = torch.softmax(lb, dim=-2)
    confidence = torch.gather(prob, -2, bin_idx[..., None, :])[..., 0, :]
    pred = VirtualGrid(grid_shape=(bins,) * 3).idxs_to_points(bin_idx)
    return pred, confidence
