"""The analytic garment the traffic is drawn on: a two-sheet shell pinched
at the top (the field of the repository's earlier `cloth_like_wnf`), its
winding-number field at any point of NOCS space, points on its surface,
and the pose that takes NOCS points into the camera's sim space."""
from __future__ import annotations

import numpy as np

AMP, HALF_W = 0.018, 0.26


def _mid_gap(gx, gz):
    wave = AMP * np.sin(14 * gx + 3 * gz) + 0.75 * AMP * np.sin(9 * gz + 5 * gx)
    return 0.5 + wave, 0.06 * np.clip((0.85 - gz) / 0.7, 0.0, 1.0)


def _inside_xz(gx, gz):
    return ((np.abs(gx - 0.5) < HALF_W + 0.05 * np.sin(6 * gz))
            & (gz > 0.08) & (gz < 0.92))


def wnf_at(points: np.ndarray) -> np.ndarray:
    """The garment's winding-number field at NOCS points [..., 3]."""
    gx, gy, gz = (points[..., i].astype(np.float64) for i in range(3))
    mid, gap = _mid_gap(gx, gz)
    dist = np.minimum(np.abs(gy - (mid + gap)), np.abs(gy - (mid - gap)))
    arg = np.clip((dist - 0.012) * 300.0, -30.0, 30.0)
    wnf = 1.0 / (1.0 + np.exp(arg))
    return np.where(_inside_xz(gx, gz), wnf, 0.0).astype(np.float32)


def surface_points(rng: np.random.Generator, n: int,
                   noise: float) -> np.ndarray:
    """n NOCS points on the two sheets, uniform over the garment's
    outline, with gaussian noise of `noise` along every axis."""
    out = np.empty((0, 3))
    while len(out) < n:
        m = 2 * (n - len(out)) + 64
        gx = rng.uniform(0.5 - HALF_W - 0.05, 0.5 + HALF_W + 0.05, m)
        gz = rng.uniform(0.08, 0.92, m)
        keep = _inside_xz(gx, gz)
        gx, gz = gx[keep], gz[keep]
        mid, gap = _mid_gap(gx, gz)
        side = rng.integers(0, 2, len(gx)) * 2 - 1
        pts = np.stack([gx, mid + side * gap, gz], -1)
        out = np.concatenate([out, pts])
    out = out[:n] + rng.normal(0.0, noise, (n, 3))
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def pose(rng: np.random.Generator, scale_range, rot_deg) -> tuple:
    """A rotation about the vertical axis and a size: (R [3, 3], scale)."""
    a = np.deg2rad(rng.uniform(*rot_deg))
    c, s = np.cos(a), np.sin(a)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return rot, float(rng.uniform(*scale_range))


def to_sim(nocs: np.ndarray, rot: np.ndarray, scale: float) -> np.ndarray:
    """NOCS points -> sim-space points around the origin."""
    return (((nocs.astype(np.float64) - 0.5) * scale) @ rot.T).astype(
        np.float32)


def colours(rng: np.random.Generator, nocs: np.ndarray) -> np.ndarray:
    """RGB in [0, 1]: a print that varies over the garment, plus noise."""
    base = 0.5 + 0.3 * np.sin(np.stack(
        [7 * nocs[:, 0] + 2 * nocs[:, 2], 5 * nocs[:, 2] + 1.0,
         9 * nocs[:, 0] * nocs[:, 2] + 2.0], -1))
    return np.clip(base + rng.normal(0.0, 0.02, base.shape), 0.0,
                   1.0).astype(np.float32)
