"""Eval-time 3D visualizations of best/worst samples (the port's copy of
garmentnets_tpu/harness/eval_vis.py).

Capability parity with the reference's wandb.Object3D logging
(eval.py:751-865, 1052-1096): composes the same colored point clouds —
task-space GT/pred meshes + input cloud, NOCS-space GT/pred meshes, NOCS
point clouds with confidence — and writes them as PLY files into the eval run
dir (no wandb in this stack; PLY opens in any mesh viewer).
"""
from __future__ import annotations

import pathlib

import numpy as np

from garmentnets_tpu_torch.utils.rendering import get_wnf_cmap


def write_ply_points(path, points_rgb: np.ndarray):
    """points_rgb: [N, 6] = xyz + rgb(0-255)."""
    path = pathlib.Path(path)
    n = len(points_rgb)
    header = "\n".join([
        "ply", "format ascii 1.0", f"element vertex {n}",
        "property float x", "property float y", "property float z",
        "property uchar red", "property uchar green", "property uchar blue",
        "end_header"])
    xyz = points_rgb[:, :3]
    rgb = np.clip(points_rgb[:, 3:6], 0, 255).astype(np.uint8)
    lines = [header]
    for p, c in zip(xyz, rgb):
        lines.append(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} {c[0]} {c[1]} {c[2]}")
    path.write_text("\n".join(lines) + "\n")


def get_task_mesh_vis(sample_key, samples_group, value_threshold=0.13,
                      value_key="marching_cubes_mesh/"
                                "volume_gradient_magnitude",
                      offset=(0.6, 0, 0), predict_holes=True,
                      volume_task_space=False, **kwargs) -> np.ndarray:
    """GT sim mesh | pred sim mesh | input cloud (reference eval.py:751-801)."""
    g = samples_group[sample_key]
    pred_mc = g["marching_cubes_mesh"]
    pred_verts = pred_mc["verts"][:]
    pred_sim = pred_mc["warp_field"][:]
    gt_mesh = g["gt_mesh"]
    gt_nocs_verts = gt_mesh["cloth_nocs_verts"][:]
    gt_sim_verts = gt_mesh["cloth_verts"][:]
    pc = g["point_cloud"]
    gt_pc = pc["input_points"][:]
    gt_rgb = pc["input_rgb"][:].astype(np.float32)
    if volume_task_space:
        pred_sim, pred_verts = pred_verts, pred_sim
    if predict_holes:
        value = g[value_key][:]
        keep = value > value_threshold
        pred_verts, pred_sim = pred_verts[keep], pred_sim[keep]
    off = np.asarray(offset)
    gt_part = np.concatenate(
        [gt_sim_verts - off, gt_nocs_verts * 255], axis=1)
    pred_part = np.concatenate([pred_sim, pred_verts * 255], axis=1)
    pc_part = np.concatenate([gt_pc + off, gt_rgb], axis=1)
    return np.concatenate(
        [gt_part, pred_part, pc_part], axis=0).astype(np.float32)


def get_nocs_mesh_vis(sample_key, samples_group, value_threshold=0.13,
                      value_key="marching_cubes_mesh/"
                                "volume_gradient_magnitude",
                      offset=(0.5, 0, 0), value_delta=0.1,
                      predict_holes=True, volume_task_space=False,
                      **kwargs) -> np.ndarray:
    """GT nocs mesh | pred nocs mesh colored by gradient magnitude
    (reference eval.py:803-842)."""
    g = samples_group[sample_key]
    pred_verts = g["marching_cubes_mesh/verts"][:]
    if volume_task_space:
        pred_verts = g["marching_cubes_mesh/warp_field"][:]
    gt_nocs_verts = g["gt_mesh/cloth_nocs_verts"][:]
    off = np.asarray(offset)
    gt_part = np.concatenate(
        [gt_nocs_verts - off, gt_nocs_verts * 255], axis=1)
    if predict_holes:
        value = g[value_key][:]
        cmap = get_wnf_cmap(min_value=value_threshold - value_delta,
                            max_value=value_threshold + value_delta)
        colors = cmap(value)[:, :3]
    else:
        colors = np.ones((len(pred_verts), 3), np.float32)
    pred_part = np.concatenate([pred_verts + off, colors * 255], axis=1)
    return np.concatenate([gt_part, pred_part], axis=0).astype(np.float32)


def get_nocs_pc_vis(sample_key, samples_group, offset=(1.0, 0, 0),
                    **kwargs) -> np.ndarray:
    """GT nocs pc | pred nocs pc | confidence pc (reference eval.py:844-865)."""
    g = samples_group[sample_key]
    pc = g["point_cloud"]
    gt = pc["gt_nocs"][:]
    pred = pc["pred_nocs"][:]
    conf = pc["pred_nocs_confidence"][:]
    off = np.asarray(offset)
    return np.concatenate([
        np.concatenate([gt - off, gt * 255], axis=1),
        np.concatenate([pred, gt * 255], axis=1),
        np.concatenate([pred + off, conf * 255], axis=1),
    ], axis=0).astype(np.float32)


VIS_FUNC_DICT = {
    "task_mesh_vis": get_task_mesh_vis,
    "nocs_mesh_vis": get_nocs_mesh_vis,
    "nocs_pc_vis": get_nocs_pc_vis,
}
