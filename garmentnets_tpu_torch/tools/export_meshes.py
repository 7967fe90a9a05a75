"""Export predicted meshes from a prediction.zarr to PLY files (the port's
copy of tools/export_meshes.py).

For every non-null sample this writes the canonical-space marching-cubes
mesh and the task-space (warp-field) mesh, optionally filtered by the
gradient-magnitude threshold the eval harness uses to drop open-boundary
halo faces (reference wnf_to_mesh semantics,
common/marching_cubes_util.py:5-35). Host numpy only; the files are the
JAX tool's bytes.

Usage:
  python -m garmentnets_tpu_torch.tools.export_meshes PREDICTION_ZARR
      OUT_DIR [--threshold 0.13] [--no-filter]
"""
from __future__ import annotations

import argparse
import pathlib

import numpy as np

from garmentnets_tpu_torch.data import zarrlite
from garmentnets_tpu_torch.ops.marching_cubes import delete_invalid_verts


def write_ply_mesh(path, verts: np.ndarray, faces: np.ndarray):
    """Ascii PLY triangle mesh."""
    path = pathlib.Path(path)
    header = "\n".join([
        "ply", "format ascii 1.0",
        f"element vertex {len(verts)}",
        "property float x", "property float y", "property float z",
        f"element face {len(faces)}",
        "property list uchar int vertex_indices",
        "end_header"])
    lines = [header]
    for p in verts:
        lines.append(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}")
    for f in faces:
        lines.append(f"3 {int(f[0])} {int(f[1])} {int(f[2])}")
    path.write_text("\n".join(lines) + "\n")


def export(prediction_zarr: str, out_dir: str, threshold: float = 0.13,
           apply_filter: bool = True) -> list:
    """Write <key>_canonical.ply and <key>_task.ply for each sample with a
    surface left after the filter; NaN-sentinel (null) samples are
    skipped. Returns the paths written."""
    root = zarrlite.open(prediction_zarr, "r")
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for key, g in root["samples"].groups():
        mc = g["marching_cubes_mesh"]
        verts = mc["verts"][:]
        if len(verts) <= 1 or not np.isfinite(verts).all():
            continue  # NaN-sentinel null sample
        faces = mc["faces"][:]
        warp = mc["warp_field"][:]
        if apply_filter:
            ggm = mc["volume_gradient_magnitude"][:]
            keep = ggm > threshold
            verts_f, faces_f = delete_invalid_verts(verts, faces, keep)
            warp_f, _ = delete_invalid_verts(warp, faces, keep)
        else:
            verts_f, faces_f, warp_f = verts, faces, warp
        if len(faces_f) == 0:
            continue
        p1 = out / f"{key}_canonical.ply"
        p2 = out / f"{key}_task.ply"
        write_ply_mesh(p1, verts_f, faces_f)
        write_ply_mesh(p2, warp_f, faces_f)
        written += [p1, p2]
    return written


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("prediction_zarr")
    ap.add_argument("out_dir")
    ap.add_argument("--threshold", type=float, default=0.13)
    ap.add_argument("--no-filter", action="store_true")
    args = ap.parse_args(argv)
    written = export(args.prediction_zarr, args.out_dir,
                     threshold=args.threshold,
                     apply_filter=not args.no_filter)
    print(f"wrote {len(written)} PLY files to {args.out_dir}")
    return written


if __name__ == "__main__":
    main()
