"""Host cost of the predict CLI's zarr writer: compressing one garment's
prediction.zarr arrays at full width, for each codec route this host has.

    python -m garmentnets_tpu_torch.tools.profile_writer [--verts 24000]

Builds the arrays one garment writes (point_cloud at 6000 points with the
[6000, 192] NOCS logits, a marching-cubes mesh of --verts vertices, misc)
from a seed, then times the compression of each (the median of 3) through
Blosc zstd-6 bitshuffle on libblosc, the same through the pure-Python
engine on `zstandard`, and zlib level 5 (what the writer falls back to
without either), on one thread, as the writer runs. Prints a table of ms
per array and route and one JSON line. A host measurement: it names the
host's CPU count, and no number from it is a device number.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import time
import zlib

import numpy as np

from garmentnets_tpu_torch.data import blosc_codec


def garment_arrays(n_verts: int, seed: int = 0) -> dict:
    """One garment's arrays of the prediction schema, seeded."""
    rs = np.random.RandomState(seed)
    n_pts, bins = 6000, 64
    verts = rs.rand(n_verts, 3).astype(np.float32)
    return {
        "point_cloud/pred_nocs": (rs.randint(0, bins, (n_pts, 3))
                                  / np.float32(bins - 1)).astype(np.float32),
        "point_cloud/pred_nocs_confidence": rs.rand(n_pts, 3).astype(
            np.float32),
        "point_cloud/pred_nocs_logits": rs.randn(n_pts, 3 * bins).astype(
            np.float32),
        "point_cloud/input_points": (rs.rand(n_pts, 3) - 0.5).astype(
            np.float32),
        "point_cloud/input_rgb": rs.randint(0, 255, (n_pts, 3)).astype(
            np.uint8),
        "point_cloud/gt_nocs": rs.rand(n_pts, 3).astype(np.float32),
        "marching_cubes_mesh/verts": verts,
        "marching_cubes_mesh/faces": rs.randint(
            0, n_verts, (2 * n_verts, 3)).astype(np.int32),
        "marching_cubes_mesh/normals": rs.randn(n_verts, 3).astype(
            np.float32),
        "marching_cubes_mesh/volume_value": rs.rand(n_verts).astype(
            np.float32),
        "marching_cubes_mesh/volume_gradient_magnitude": rs.rand(
            n_verts).astype(np.float32),
        "marching_cubes_mesh/warp_field": rs.randn(n_verts, 3).astype(
            np.float32),
        "misc/global_feature": rs.randn(1024).astype(np.float32),
    }


def routes() -> dict:
    """The codec routes this host can run: name -> compress(buf, typesize)."""
    out = {}
    if blosc_codec._LIB is not None:
        out["blosc_libblosc"] = lambda b, t: blosc_codec.compress(b, t)
    try:
        blosc_codec._zstd()
        out["blosc_python_zstandard"] = lambda b, t: blosc_codec.compress(
            b, t, force_python=True)
    except ImportError:
        pass
    out["zlib_5"] = lambda b, t: zlib.compress(b, 5)
    return out


def time_ms(fn, reps: int = 3) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--verts", type=int, default=24000)
    args = ap.parse_args()
    arrays = garment_arrays(args.verts)
    result = {"host_cpus": os.cpu_count(), "machine": platform.machine(),
              "verts": args.verts, "ms": {}}
    for route, fn in routes().items():
        ms = {k: time_ms(lambda a=a: fn(a.tobytes(), a.dtype.itemsize))
              for k, a in arrays.items()}
        ms["garment"] = sum(ms.values())
        result["ms"][route] = ms
        for k, v in ms.items():
            print(f"{route:24s} {k:48s} {v:9.2f} ms")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
