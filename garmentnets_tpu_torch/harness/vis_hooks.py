"""Per-epoch image logging of training (copy of
garmentnets_tpu/harness/vis_hooks.py on the port's utils/rendering.py).

Renders GT/pred NOCS pairs (with grip overlays and confidence) for stage 1
and NOCS + WNF-slice pairs for stage 2, for the items get_vis_idxs picks,
as PNGs through the run logger (reference networks/pointnet2_nocs.py:203-255
vis_batch, conv_implicit_wnf.py:345-403). Batch and result entries may be
numpy arrays or tensors on any device.
"""
from __future__ import annotations

import numpy as np

from garmentnets_tpu_torch.utils.rendering import (
    get_vis_idxs, render_confidence_pair, render_nocs_pair,
    render_wnf_points_pair)


def _np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def vis_stage1(logger, batch: dict, nocs_data: dict, batch_idx: int,
               batch_size: int, vis_per_items: int, max_vis_per_epoch: int,
               is_train: bool, step: int):
    if vis_per_items <= 0:
        return
    prefix = "train_" if is_train else "val_"
    gt_nocs = _np(batch["y"])
    _, selected, vis_idxs = get_vis_idxs(
        batch_idx, batch_size=batch_size, this_batch_size=gt_nocs.shape[0],
        vis_per_items=vis_per_items, max_vis_per_epoch=max_vis_per_epoch)
    pred_nocs = _np(nocs_data["pos"])
    pos = _np(batch["pos"])
    gt_grip = _np(batch["nocs_grip_point"])
    pred_grip_nn = _np(nocs_data["grip_point"])
    conf = (_np(nocs_data["pred_confidence"])
            if "pred_confidence" in nocs_data else None)
    for i, vis_idx in zip(selected, vis_idxs):
        grip_idx = int(np.argmin(np.linalg.norm(pos[i], axis=1)))
        img = render_nocs_pair(
            gt_nocs[i], pred_nocs[i], gt_grip[i],
            pred_nocs[i][grip_idx], pred_grip_nn[i])
        if conf is not None:
            cimg = render_confidence_pair(gt_nocs[i], pred_nocs[i],
                                          conf[i][:, 0])
            img = np.concatenate([img, cimg], axis=0)
        logger.log_image(f"{prefix}{vis_idx}", img[..., :3], step=step)


def vis_stage2(logger, batch: dict, result: dict, batch_idx: int,
               batch_size: int, vis_per_items: int, max_vis_per_epoch: int,
               is_train: bool, step: int):
    if vis_per_items <= 0:
        return
    prefix = "train_" if is_train else "val_"
    gt_nocs = _np(batch["y"])
    _, selected, vis_idxs = get_vis_idxs(
        batch_idx, batch_size=batch_size, this_batch_size=gt_nocs.shape[0],
        vis_per_items=vis_per_items, max_vis_per_epoch=max_vis_per_epoch)
    pred_nocs = _np(result["pointnet2_result"]["nocs_data"]["pos"])
    pos = _np(batch["pos"])
    gt_grip = _np(batch["nocs_grip_point"])
    q = _np(batch["volume_query_points"])
    gt_v = _np(batch["gt_volume_value"])
    pred_v = _np(result["pred_volume_value"])
    for i, vis_idx in zip(selected, vis_idxs):
        grip_idx = int(np.argmin(np.linalg.norm(pos[i], axis=1)))
        nocs_img = render_nocs_pair(
            gt_nocs[i], pred_nocs[i], gt_grip[i], pred_nocs[i][grip_idx])
        wnf_img = render_wnf_points_pair(q[i], gt_v[i], pred_v[i])
        img = np.concatenate([nocs_img, wnf_img], axis=0)
        logger.log_image(f"{prefix}{vis_idx}", img[..., :3], step=step)
