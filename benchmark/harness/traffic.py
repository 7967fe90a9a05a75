"""The one traffic generator: reads a traffic file's parameters and makes a
cell's inputs from the seed.

- `train_batches`: a set of distinct training batches (stage 1: clouds
  with their NOCS targets and grip point; stage 2 adds volume samples with
  the garment's winding number and surface samples with their sim-space
  positions), rotated through by the training cells.
"""
from __future__ import annotations

import numpy as np

from benchmark.harness import garment


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for each (seed, stream)."""
    return np.random.default_rng([int(seed) % 2 ** 64, stream])


def _garment(rng, traffic: dict, n: int) -> tuple:
    nocs = garment.surface_points(rng, n, traffic["surface_noise"])
    rot, scale = garment.pose(rng, traffic["scale_range"],
                              traffic["rot_range_deg"])
    return nocs, garment.to_sim(nocs, rot, scale), garment.colours(rng, nocs), (
        rot, scale)


def train_batches(traffic: dict, batch_size: int, seed: int) -> list:
    """A list of `batches` dicts of numpy arrays, every row distinct."""
    rng = rng_for(seed, 3)
    n, nv, ns = (traffic["points"], traffic["volume_samples"],
                 traffic["surface_samples"])
    out = []
    for _ in range(traffic["batches"]):
        rows = []
        for _ in range(batch_size):
            nocs, pos, rgb, (rot, scale) = _garment(rng, traffic, n)
            grip = int(np.argmin(np.linalg.norm(pos, axis=1)))
            row = {"x": rgb, "pos": pos, "y": nocs,
                   "nocs_grip_point": nocs[grip]}
            if nv:
                q = rng.uniform(0.0, 1.0, (nv, 3)).astype(np.float32)
                row["volume_query_points"] = q
                row["gt_volume_value"] = garment.wnf_at(q)
            if ns:
                s = garment.surface_points(rng, ns, 0.0)
                row["surf_query_points"] = s
                row["gt_sim_points"] = garment.to_sim(s, rot, scale)
            rows.append(row)
        out.append({k: np.stack([r[k] for r in rows]) for k in rows[0]})
    return out
