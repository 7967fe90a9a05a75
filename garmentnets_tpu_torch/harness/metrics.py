"""Per-sample eval metric functions over prediction.zarr (the port's copy
of garmentnets_tpu/harness/metrics.py).

Capability parity with the reference `eval.py` worker functions (SURVEY.md
§3.4): optimal gradient-threshold decision stump, NOCS PC error (+mirror
variants), grip-point error, symmetric chamfer (nocs/sim, hole-filtered),
hybrid chamfer (NOCS-NN correspondence scored in sim space), mesh Hausdorff,
geodesic-distance-matrix RMS via the heat method.

NN queries use scipy cKDTree on host (same as the reference); libigl calls
are replaced by the numpy/scipy equivalents in ops.geometry, and the mesh
Hausdorff distance is the exact C++ helper (ops/cpp/hausdorff.cpp).
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from garmentnets_tpu_torch.ops.geometry import (
    AABBNormalizer, barycentric_interpolation, mesh_sample_barycentric,
    connected_components, mesh_hausdorff)
from garmentnets_tpu_torch.ops.marching_cubes import delete_invalid_verts
from garmentnets_tpu_torch.ops.geodesic import geodesic_matrix


# ---------------------------------------------------------------------------
def compute_optimal_gradient_treshold(sample_key, samples_group,
                                      precision_weight: float = 0.85,
                                      **kwargs):
    """Decision stump maximizing weighted precision/recall of the on-surface
    classification by gradient magnitude (reference eval.py:58-102)."""
    sample_group = samples_group[sample_key]
    gt_mc = sample_group["gt_marching_cubes_mesh"]
    gt_verts = gt_mc["marching_cube_verts"][:]
    gt_on_surface = gt_mc["is_vertex_on_surface"][:].astype(bool)

    pred_mc = sample_group["marching_cubes_mesh"]
    pred_verts = pred_mc["verts"][:]
    pred_gm = pred_mc["volume_gradient_magnitude"][:]

    nn_idx = cKDTree(gt_verts).query(pred_verts, k=1)[1]
    nn_on = gt_on_surface[nn_idx]

    sorted_idx = np.argsort(pred_gm)
    s = nn_on[sorted_idx]
    false_negative = np.cumsum(s)
    true_positive = np.cumsum(s[::-1])[::-1]
    false_positive = np.cumsum(~s[::-1])[::-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = true_positive / (true_positive + false_positive)
        recall = true_positive / (true_positive + false_negative)
        score = precision * precision_weight + recall * (1 - precision_weight)
    if np.any(np.isfinite(score)):
        threshold = pred_gm[sorted_idx[np.nanargmax(score)]]
    else:
        threshold = pred_gm.min()
    return {"optimal_wnf_gradient_threshold": float(threshold)}


def compute_pc_metrics(sample_key, samples_group, nocs_aabb, **kwargs):
    """NOCS point-cloud error + mirror variants (reference eval.py:105-143)."""
    pc = samples_group[sample_key]["point_cloud"]
    gt_nocs = pc["gt_nocs"][:]
    pred_nocs = pc["pred_nocs"][:]

    normalizer = AABBNormalizer(nocs_aabb)
    gt_nocs = normalizer.inverse(gt_nocs)
    pred_nocs = normalizer.inverse(pred_nocs)

    diff = pred_nocs - gt_nocs
    err_mean = np.mean(np.abs(diff), axis=0)
    err_std = np.std(diff, axis=0)

    mirror_gt = gt_nocs.copy()
    mirror_gt[:, 0] = -mirror_gt[:, 0]
    d = np.linalg.norm(diff, axis=1)
    d_mirror = np.linalg.norm(pred_nocs - mirror_gt, axis=1)
    metrics = {
        "nocs_pc_error_distance": float(np.mean(d)),
        "nocs_pc_mirror_error_distance": float(np.mean(d_mirror)),
        "nocs_pc_min_agg_error_distance": float(
            np.mean(np.minimum(d, d_mirror))),
        "nocs_pc_agg_min_error_distance": float(
            min(np.mean(d), np.mean(d_mirror))),
    }
    for name, vec in (("nocs_pc_diff_std", err_std),
                      ("nocs_pc_error", err_mean)):
        for i, axis in enumerate("xyz"):
            metrics[f"{name}_{axis}"] = float(vec[i])
    return metrics


def compute_grip_point_metrics(sample_key, samples_group, nocs_aabb,
                               **kwargs):
    """Grip-point error for pc-NN and global-head predictions
    (reference eval.py:146-182, incl. its 'distanc' key spellings)."""
    misc = samples_group[sample_key]["misc"]
    normalizer = AABBNormalizer(nocs_aabb)
    gt = normalizer.inverse(misc["gt_nocs_grip_point"][:])
    preds = {
        "pc": normalizer.inverse(misc["pred_nocs_grip_point"][:]),
        "global": normalizer.inverse(
            misc["pred_global_nocs_grip_point"][:]),
    }
    metrics = {}
    for key, pred in preds.items():
        mirror = pred.copy()
        mirror[0] = -mirror[0]
        e = float(np.linalg.norm(pred - gt))
        em = float(np.linalg.norm(mirror - gt))
        metrics[f"grip_point_error_distance_{key}"] = e
        metrics[f"grip_point_mirror_error_distanc_{key}"] = em
        metrics[f"grip_point_min_error_distanc_{key}"] = min(e, em)
    return metrics


def _load_meshes(sample_group, nocs_aabb, volume_task_space):
    pred_mc = sample_group["marching_cubes_mesh"]
    pred_verts = pred_mc["verts"][:]
    pred_faces = pred_mc["faces"][:]
    pred_sim_verts = pred_mc["warp_field"][:]
    gt_mesh = sample_group["gt_mesh"]
    gt_faces = gt_mesh["cloth_faces_tri"][:]
    gt_nocs_verts = gt_mesh["cloth_nocs_verts"][:]
    gt_sim_verts = gt_mesh["cloth_verts"][:]
    if volume_task_space:
        pred_sim_verts, pred_verts = pred_verts, pred_sim_verts
    normalizer = AABBNormalizer(nocs_aabb)
    return {
        "pred_mc_verts": normalizer.inverse(pred_verts),
        "pred_mc_faces": pred_faces,
        "pred_mc_sim_verts": pred_sim_verts,
        "gt_faces": gt_faces,
        "gt_nocs_verts": normalizer.inverse(gt_nocs_verts),
        "gt_sim_verts": gt_sim_verts,
        "normalizer": normalizer,
    }


def _surface_samples(verts, faces, attrs_list, num_samples, seed):
    bc, fi = mesh_sample_barycentric(verts, faces, num_samples, seed=seed)
    return [barycentric_interpolation(bc, a, faces[fi])
            for a in attrs_list] + [bc, fi]


def compute_chamfer(sample_key, samples_group, nocs_aabb,
                    num_points=1e4, value_threshold=0.13,
                    value_key="marching_cubes_mesh/volume_gradient_magnitude",
                    seed=0, predict_holes=True, volume_task_space=False,
                    **kwargs):
    """Symmetric chamfer in nocs/sim space, hole-filtered + raw
    (reference eval.py:185-317)."""
    sample_group = samples_group[sample_key]
    m = _load_meshes(sample_group, nocs_aabb, volume_task_space)
    gt_mc = sample_group["gt_marching_cubes_mesh"]
    gt_mc_verts = m["normalizer"].inverse(gt_mc["marching_cube_verts"][:])
    gt_mc_faces = gt_mc["marching_cube_faces"][:]
    gt_on_surf = gt_mc["is_vertex_on_surface"][:]

    n = int(num_points)
    pred_nocs_pts, pred_sim_pts, pred_bc, pred_fi = _surface_samples(
        m["pred_mc_verts"], m["pred_mc_faces"],
        [m["pred_mc_verts"], m["pred_mc_sim_verts"]], n, seed)
    gt_nocs_pts, gt_sim_pts, _, _ = _surface_samples(
        m["gt_nocs_verts"], m["gt_faces"],
        [m["gt_nocs_verts"], m["gt_sim_verts"]], n, seed)
    surf_v, surf_f = delete_invalid_verts(gt_mc_verts, gt_mc_faces,
                                          gt_on_surf)
    gt_mc_pts, _, _ = _surface_samples(surf_v, surf_f, [surf_v], n, seed)

    def chamfer(pred, gt):
        f = cKDTree(gt).query(pred, k=1)[0].mean()
        b = cKDTree(pred).query(gt, k=1)[0].mean()
        return float(np.mean([f, b]))

    in_data = {
        "nocs_no_hole": (pred_nocs_pts, gt_nocs_pts),
        "sim_no_hole": (pred_sim_pts, gt_sim_pts),
        "nocs_mc": (gt_mc_pts, gt_nocs_pts),
    }
    if predict_holes:
        pred_value = sample_group[value_key][:]
        sample_value = np.squeeze(barycentric_interpolation(
            pred_bc, pred_value[:, None], m["pred_mc_faces"][pred_fi]))
        valid = sample_value > value_threshold
        in_data = {
            "nocs": (pred_nocs_pts[valid], gt_nocs_pts),
            "sim": (pred_sim_pts[valid], gt_sim_pts),
            **in_data,
        }
    return {f"chamfer_symmetrical_{k}": chamfer(p, g)
            for k, (p, g) in in_data.items()}


def compute_hybrid_chamfer(sample_key, samples_group, nocs_aabb,
                           num_points=1e4, value_threshold=0.13,
                           value_key=("marching_cubes_mesh/"
                                      "volume_gradient_magnitude"),
                           seed=0, predict_holes=True,
                           volume_task_space=False, **kwargs):
    """Correspondence via NOCS-NN, scored by sim-space distance
    (reference eval.py:320-455), with pred/mirror/min variants."""
    sample_group = samples_group[sample_key]
    m = _load_meshes(sample_group, nocs_aabb, volume_task_space)
    n = int(num_points)
    pred_nocs_pts, pred_sim_pts, pred_bc, pred_fi = _surface_samples(
        m["pred_mc_verts"], m["pred_mc_faces"],
        [m["pred_mc_verts"], m["pred_mc_sim_verts"]], n, seed)
    gt_nocs_pts, gt_sim_pts, _, _ = _surface_samples(
        m["gt_nocs_verts"], m["gt_faces"],
        [m["gt_nocs_verts"], m["gt_sim_verts"]], n, seed)

    def hybrid(pn, gn, ps, gs):
        f_idx = cKDTree(gn).query(pn, k=1)[1]
        b_idx = cKDTree(pn).query(gn, k=1)[1]
        f = np.linalg.norm(ps - gs[f_idx], axis=1).mean()
        b = np.linalg.norm(gs - ps[b_idx], axis=1).mean()
        return {"hybrid_chamfer_forward": float(f),
                "hybrid_chamfer_backward": float(b),
                "hybrid_chamfer_symmetrical": float(np.mean([f, b]))}

    in_data = {"no_hole": (pred_nocs_pts, gt_nocs_pts,
                           pred_sim_pts, gt_sim_pts)}
    if predict_holes:
        pred_value = sample_group[value_key][:]
        sample_value = np.squeeze(barycentric_interpolation(
            pred_bc, pred_value[:, None], m["pred_mc_faces"][pred_fi]))
        valid = sample_value > value_threshold
        in_data = {"regular": (pred_nocs_pts[valid], gt_nocs_pts,
                               pred_sim_pts[valid], gt_sim_pts),
                   **in_data}

    result = {}
    for category, (pn, gn, ps, gs) in in_data.items():
        out = hybrid(pn, gn, ps, gs)
        pn_m = pn.copy()
        pn_m[:, 0] = -pn_m[:, 0]
        out_m = hybrid(pn_m, gn, ps, gs)
        variants = {"pred": out, "mirror": out_m,
                    "min": {k: min(out[k], out_m[k]) for k in out}}
        for aug, od in variants.items():
            for k, v in od.items():
                result[f"{k}_{category}_{aug}"] = v
    return result


def _largest_cc(verts, faces, extra_verts=None):
    _, labels, sizes = connected_components(faces, len(verts))
    keep = labels == np.argmax(sizes)
    v, f = delete_invalid_verts(verts, faces, keep)
    if extra_verts is not None:
        ev, _ = delete_invalid_verts(extra_verts, faces, keep)
        return v, f, ev
    return v, f


def compute_hausdorff(sample_key, samples_group, nocs_aabb,
                      value_threshold=0.13,
                      value_key=("marching_cubes_mesh/"
                                 "volume_gradient_magnitude"),
                      predict_holes=True, volume_task_space=False,
                      **kwargs):
    """Mesh Hausdorff distances (reference eval.py:458-579)."""
    sample_group = samples_group[sample_key]
    m = _load_meshes(sample_group, nocs_aabb, volume_task_space)
    gt_mc = sample_group["gt_marching_cubes_mesh"]
    gt_mc_verts = m["normalizer"].inverse(gt_mc["marching_cube_verts"][:])
    gt_mc_faces = gt_mc["marching_cube_faces"][:]
    gt_on_surf = gt_mc["is_vertex_on_surface"][:]

    surf_v, surf_f = delete_invalid_verts(
        gt_mc_verts, gt_mc_faces, gt_on_surf)
    valid_gt_mc_verts, valid_gt_mc_faces = _largest_cc(surf_v, surf_f)

    in_data = {
        "nocs_no_hole": (m["gt_nocs_verts"], m["gt_faces"],
                         m["pred_mc_verts"], m["pred_mc_faces"]),
        "sim_no_hole": (m["gt_sim_verts"], m["gt_faces"],
                        m["pred_mc_sim_verts"], m["pred_mc_faces"]),
        "nocs_mc": (m["gt_nocs_verts"], m["gt_faces"],
                    valid_gt_mc_verts, valid_gt_mc_faces),
    }
    if predict_holes:
        pred_value = sample_group[value_key][:]
        on = pred_value > value_threshold
        sv, sf = delete_invalid_verts(m["pred_mc_verts"],
                                      m["pred_mc_faces"], on)
        ssim, _ = delete_invalid_verts(m["pred_mc_sim_verts"],
                                       m["pred_mc_faces"], on)
        cv, cf, csim = _largest_cc(sv, sf, extra_verts=ssim)
        in_data = {
            "nocs": (m["gt_nocs_verts"], m["gt_faces"], cv, cf),
            "sim": (m["gt_sim_verts"], m["gt_faces"], csim, cf),
            **in_data,
        }
    return {f"hausdorff_{k}": mesh_hausdorff(va, fa, vb, fb)
            for k, (va, fa, vb, fb) in in_data.items()}


def compute_geodesic(sample_key, samples_group, nocs_aabb,
                     num_points=100, value_threshold=0.13,
                     value_key=("marching_cubes_mesh/"
                                "volume_gradient_magnitude"),
                     seed=0, predict_holes=True, volume_task_space=False,
                     **kwargs):
    """Geodesic-distance-matrix RMS via the heat method
    (reference eval.py:583-746)."""
    sample_group = samples_group[sample_key]
    m = _load_meshes(sample_group, nocs_aabb, volume_task_space)
    gt_mc = sample_group["gt_marching_cubes_mesh"]
    gt_mc_verts = m["normalizer"].inverse(gt_mc["marching_cube_verts"][:])
    gt_mc_faces = gt_mc["marching_cube_faces"][:]
    gt_on_surf = gt_mc["is_vertex_on_surface"][:]

    surf_v, surf_f = delete_invalid_verts(
        gt_mc_verts, gt_mc_faces, gt_on_surf)
    valid_gt_mc_verts, valid_gt_mc_faces = _largest_cc(surf_v, surf_f)

    rs = np.random.RandomState(seed=seed)
    sel_gt = rs.choice(len(m["gt_nocs_verts"]),
                       min(num_points, len(m["gt_nocs_verts"])),
                       replace=False)
    sel_nocs = m["gt_nocs_verts"][sel_gt]
    sel_pred_nh = cKDTree(m["pred_mc_verts"]).query(sel_nocs, k=1)[1]
    sel_gt_mc = cKDTree(valid_gt_mc_verts).query(sel_nocs, k=1)[1]

    in_data = {
        "gt_nocs": (m["gt_nocs_verts"], m["gt_faces"], sel_gt),
        "gt_sim": (m["gt_sim_verts"], m["gt_faces"], sel_gt),
        "pred_nocs_no_hole": (m["pred_mc_verts"], m["pred_mc_faces"],
                              sel_pred_nh),
        "pred_sim_no_hole": (m["pred_mc_sim_verts"], m["pred_mc_faces"],
                             sel_pred_nh),
        "gt_nocs_mc": (valid_gt_mc_verts, valid_gt_mc_faces, sel_gt_mc),
    }
    rms_pairs = {
        "geodesic_rms_sim_no_hole": ("pred_sim_no_hole", "gt_sim"),
        "geodesic_rms_nocs_no_hole": ("pred_nocs_no_hole", "gt_nocs"),
        "geodesic_rms_nocs_mc": ("gt_nocs_mc", "gt_nocs"),
    }
    if predict_holes:
        pred_value = sample_group[value_key][:]
        on = pred_value > value_threshold
        sv, sf = delete_invalid_verts(m["pred_mc_verts"],
                                      m["pred_mc_faces"], on)
        ssim, _ = delete_invalid_verts(m["pred_mc_sim_verts"],
                                       m["pred_mc_faces"], on)
        cv, cf, csim = _largest_cc(sv, sf, extra_verts=ssim)
        sel_pred = cKDTree(cv).query(sel_nocs, k=1)[1]
        in_data["pred_nocs"] = (cv, cf, sel_pred)
        in_data["pred_sim"] = (csim, cf, sel_pred)
        rms_pairs["geodesic_rms_sim"] = ("pred_sim", "gt_sim")
        rms_pairs["geodesic_rms_nocs"] = ("pred_nocs", "gt_nocs")

    mats = {k: geodesic_matrix(v, f, s) for k, (v, f, s) in in_data.items()}
    return {k: float(np.mean(np.abs(mats[a] - mats[b])))
            for k, (a, b) in rms_pairs.items()}
