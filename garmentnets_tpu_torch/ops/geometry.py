"""Host-side mesh and geometry utilities in numpy (the port's copy of the
numpy parts of garmentnets_tpu/ops/geometry.py that the dataset and the
synthetic data generator call).

AABB normalizers, barycentric surface sampling, area-weighted vertex
normals and the generalized winding number (numpy only; the JAX package's
accelerator path of `winding_number` is not copied). The Hausdorff
distances wait for the port of eval.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# AABB normalizers (reference geometry_util.py:73-129)
# ---------------------------------------------------------------------------
class AABBNormalizer:
    """Center + max-edge scale into the unit cube centered at 0.5."""

    def __init__(self, aabb: np.ndarray):
        center = np.mean(aabb, axis=0)
        edge_lengths = aabb[1] - aabb[0]
        scale = 1.0 / np.max(edge_lengths)
        self.center = center
        self.scale = scale
        self.result_center = np.ones((3,), dtype=aabb.dtype) / 2

    def __call__(self, data):
        return (data - self.center) * self.scale + self.result_center

    def inverse(self, data):
        return (data - self.result_center) / self.scale + self.center


class AABBGripNormalizer:
    """Gripper at origin: z-translate + isotropic fit into padded unit cube."""

    def __init__(self, aabb: np.ndarray, padding: float = 0.05):
        nocs_radius = 0.5 - padding
        radius = np.max(np.abs(aabb), axis=0)[:2]
        radius_scale = np.min(nocs_radius / radius)
        nocs_z = nocs_radius * 2
        z_length = aabb[1, 2] - aabb[0, 2]
        z_scale = nocs_z / z_length
        scale = min(radius_scale, z_scale)
        z_max = aabb[1, 2] * scale
        self.scale = scale
        self.offset = np.array(
            [0.5, 0.5, 1 - padding - z_max], dtype=aabb.dtype)

    def __call__(self, data):
        return data * self.scale + self.offset

    def inverse(self, data):
        return (data - self.offset) / self.scale


def get_aabb(coords: np.ndarray) -> np.ndarray:
    return np.stack([np.min(coords, axis=0), np.max(coords, axis=0)])


def quads2tris(quads: np.ndarray) -> np.ndarray:
    assert quads.ndim == 2 and quads.shape[1] == 4
    tris = np.zeros((quads.shape[0] * 2, 3), dtype=quads.dtype)
    tris[0::2] = quads[:, [0, 1, 2]]
    tris[1::2] = quads[:, [0, 2, 3]]
    return tris


# ---------------------------------------------------------------------------
# barycentric surface sampling (reference geometry_util.py:165-231)
# ---------------------------------------------------------------------------
def barycentric_interpolation(query_coords: np.ndarray, verts: np.ndarray,
                              faces: np.ndarray) -> np.ndarray:
    """Interpolate vertex attributes at barycentric coords.

    query_coords: (M, 3) barycentric weights; faces: (M, 3) vertex indices
    (1:1 with query_coords); verts: (N, C). Returns (M, C).
    Vectorized (the reference loops over channels).
    """
    # (M, 3, C) gather then weighted sum over the 3 face corners
    corner_attrs = verts[faces]  # (M, 3, C)
    return np.einsum("mi,mic->mc", query_coords, corner_attrs).astype(
        verts.dtype, copy=False)


def double_area(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Twice the area of each triangle (igl.doublearea equivalent)."""
    v0 = verts[faces[:, 0]]
    e1 = verts[faces[:, 1]] - v0
    e2 = verts[faces[:, 2]] - v0
    return np.linalg.norm(np.cross(e1, e2), axis=1)


def mesh_sample_barycentric(
        verts: np.ndarray, faces: np.ndarray, num_samples: int,
        seed: Optional[int] = None,
        face_areas: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Area-weighted uniform surface sampling; returns (barycentric, face_idx).

    Bit-compatible with the reference sampler (same RandomState call order:
    choice then uniform-uv fold) so seeded eval metrics reproduce.
    """
    if face_areas is None:
        face_areas = double_area(verts, faces)
    face_areas = face_areas / np.sum(face_areas)
    assert len(face_areas) == len(faces)

    rs = np.random.RandomState(seed=seed)
    selected_face_idx = rs.choice(
        len(faces), size=num_samples, replace=True,
        p=face_areas).astype(faces.dtype)
    barycentric_uv = rs.uniform(0, 1, size=(num_samples, 2))
    not_triangle = np.sum(barycentric_uv, axis=1) >= 1
    barycentric_uv[not_triangle] = 1 - barycentric_uv[not_triangle]

    barycentric_all = np.zeros((num_samples, 3), dtype=barycentric_uv.dtype)
    barycentric_all[:, :2] = barycentric_uv
    barycentric_all[:, 2] = 1 - np.sum(barycentric_uv, axis=1)
    return barycentric_all, selected_face_idx


# ---------------------------------------------------------------------------
# igl replacements (SURVEY.md §2.3 #11)
# ---------------------------------------------------------------------------
def per_vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals (igl.per_vertex_normals default)."""
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    face_n = np.cross(v1 - v0, v2 - v0)  # magnitude = 2*area (area weighting)
    vert_n = np.zeros_like(verts)
    for i in range(3):
        np.add.at(vert_n, faces[:, i], face_n)
    norm = np.linalg.norm(vert_n, axis=1, keepdims=True)
    norm[norm == 0] = 1.0
    return vert_n / norm


# ---------------------------------------------------------------------------
# winding number field (used by the synthetic data generator; the reference
# dataset ships WNF volumes precomputed offline)
# ---------------------------------------------------------------------------
def winding_number(query_points: np.ndarray, verts: np.ndarray,
                   faces: np.ndarray, chunk: int = 2048) -> np.ndarray:
    """Generalized winding number of query points w.r.t. a triangle soup,
    in float64 numpy, returned as float32.

    Solid-angle formula (van Oosterom & Strackee); for an open cloth mesh the
    field is fractional in the interior neighborhood — exactly the WNF the
    reference trains on (README.md:25). The cost is queries x faces: a
    32^3 lattice against ~600 faces takes about a second.
    """
    out = np.zeros(len(query_points), dtype=np.float64)
    a0 = verts[faces[:, 0]]
    b0 = verts[faces[:, 1]]
    c0 = verts[faces[:, 2]]
    for s in range(0, len(query_points), chunk):
        q = query_points[s:s + chunk][:, None, :]  # (Q,1,3)
        a = a0[None] - q
        b = b0[None] - q
        c = c0[None] - q
        la = np.linalg.norm(a, axis=-1)
        lb = np.linalg.norm(b, axis=-1)
        lc = np.linalg.norm(c, axis=-1)
        num = np.einsum("qfi,qfi->qf", a, np.cross(b, c))
        den = (la * lb * lc + np.einsum("qfi,qfi->qf", a, b) * lc
               + np.einsum("qfi,qfi->qf", b, c) * la
               + np.einsum("qfi,qfi->qf", c, a) * lb)
        omega = 2.0 * np.arctan2(num, den)
        out[s:s + chunk] = omega.sum(axis=1) / (4.0 * np.pi)
    return out.astype(np.float32)
