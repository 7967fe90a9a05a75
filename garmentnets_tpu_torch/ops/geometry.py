"""Mesh and geometry utilities (the port's copy of
garmentnets_tpu/ops/geometry.py).

AABB normalizers, test geometry, barycentric surface sampling,
area-weighted vertex normals, connected components, the exact mesh
Hausdorff and point-to-mesh distances (the C++ helper ops/cpp/hausdorff.cpp,
built by kernels/_build.py; a failed build raises), all host numpy, and the
generalized winding number: host numpy in f64 for small fields, stock
torch ops in f32 on a device (the card by default) for large ones.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from garmentnets_tpu_torch.core.device import full_f32, resolve_device
from garmentnets_tpu_torch.kernels import _build


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


def buffer_aabb(aabb: np.ndarray, buffer) -> np.ndarray:
    out = aabb.copy()
    out[0] -= buffer
    out[1] += buffer
    return out


def build_line(length: float = 1.0, num_nodes: int = 50):
    """Straight-line test geometry (reference geometry_util.py:7-13)."""
    verts = np.zeros((num_nodes, 3), dtype=np.float32)
    verts[:, 0] = np.linspace(0, length, num_nodes)
    edges = np.stack([np.arange(num_nodes - 1),
                      np.arange(1, num_nodes)], axis=1).astype(np.uint32)
    return verts, edges


def build_rectangle(width: float = 0.45, height: float = 0.32,
                    width_num_node: int = 23, height_num_node: int = 17):
    """Rectangular cloth grid with uv coords + quad faces (reference
    geometry_util.py:16-67), row-major with rows along the width axis."""
    def xy_to_index(x_idx, y_idx):
        return y_idx * height_num_node + x_idx

    n = width_num_node * height_num_node
    verts = np.zeros((n, 3), np.float32)
    uv = np.zeros((n, 2), np.float32)
    edges, faces = [], []
    for x in range(height_num_node):
        for y in range(width_num_node):
            cur = xy_to_index(x, y)
            verts[cur, 0] = x * height / (height_num_node - 1)
            verts[cur, 1] = y * width / (width_num_node - 1)
            uv[cur, 0] = x / (height_num_node - 1)
            uv[cur, 1] = y / (width_num_node - 1)
            if x + 1 < height_num_node:
                edges.append([cur, xy_to_index(x + 1, y)])
            if y + 1 < width_num_node:
                edges.append([cur, xy_to_index(x, y + 1)])
            if x + 1 < height_num_node and y + 1 < width_num_node:
                faces.append([cur, xy_to_index(x + 1, y),
                              xy_to_index(x + 1, y + 1),
                              xy_to_index(x, y + 1)])
    return (verts, np.asarray(edges, np.uint32),
            np.asarray(faces, np.uint32), uv)


def faces_to_edges(faces) -> np.ndarray:
    """Unique undirected edge list of a polygon soup (reference
    geometry_util.py:69-77)."""
    edges_set = set()
    for face in faces:
        for i in range(1, len(face)):
            edges_set.add(tuple(sorted((int(face[i - 1]), int(face[i])))))
    return np.array(sorted(edges_set), dtype=np.int64)


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


def connected_components(faces: np.ndarray, num_verts: int
                         ) -> Tuple[int, np.ndarray, np.ndarray]:
    """Vertex connected components of a triangle mesh.

    Replaces igl.adjacency_matrix + igl.connected_components
    (reference eval.py:499-501). Returns (num_cc, labels, sizes); isolated
    vertices each form their own component (matching igl).
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components as cc

    if len(faces) == 0:
        labels = np.arange(num_verts)
        return num_verts, labels, np.ones(num_verts, dtype=np.int64)
    rows = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    cols = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    data = np.ones(len(rows), dtype=np.int8)
    adj = coo_matrix((data, (rows, cols)), shape=(num_verts, num_verts))
    n, labels = cc(adj, directed=False)
    sizes = np.bincount(labels, minlength=n)
    return n, labels, sizes


_DP = ctypes.POINTER(ctypes.c_double)
_IP = ctypes.POINTER(ctypes.c_int32)


def hausdorff_lib() -> ctypes.CDLL:
    """The C++ helper ops/cpp/hausdorff.cpp (AABB tree + exact
    closest-point-on-triangle), built by g++ into the package's _build/
    directory at first use; a failed build raises."""
    lib = _build.load("hausdorff")
    if not getattr(lib, "_argtypes_set", False):
        lib.mesh_hausdorff_exact.restype = ctypes.c_double
        lib.mesh_hausdorff_exact.argtypes = [
            _DP, ctypes.c_int64, _IP, ctypes.c_int64,
            _DP, ctypes.c_int64, _IP, ctypes.c_int64]
        lib.points_to_mesh_distances.restype = None
        lib.points_to_mesh_distances.argtypes = [
            _DP, ctypes.c_int64, _DP, ctypes.c_int64, _IP, ctypes.c_int64,
            _DP]
        lib._argtypes_set = True
    return lib


def mesh_hausdorff(va: np.ndarray, fa: np.ndarray,
                   vb: np.ndarray, fb: np.ndarray) -> float:
    """Symmetric Hausdorff distance between two triangle meshes, with
    igl.hausdorff's exact semantics (reference eval.py:569): the max over
    VERTICES of either mesh of the exact point-to-triangle-mesh distance to
    the other (igl's definition — itself a lower bound of the true
    surface-to-surface Hausdorff distance), by the C++ helper."""
    lib = hausdorff_lib()
    va64 = np.ascontiguousarray(va, np.float64)
    vb64 = np.ascontiguousarray(vb, np.float64)
    fa32 = np.ascontiguousarray(fa, np.int32).reshape(-1, 3)
    fb32 = np.ascontiguousarray(fb, np.int32).reshape(-1, 3)
    return float(lib.mesh_hausdorff_exact(
        va64.ctypes.data_as(_DP), len(va64),
        fa32.ctypes.data_as(_IP), len(fa32),
        vb64.ctypes.data_as(_DP), len(vb64),
        fb32.ctypes.data_as(_IP), len(fb32)))


def mesh_hausdorff_sampled(va: np.ndarray, fa: np.ndarray,
                           vb: np.ndarray, fb: np.ndarray,
                           num_samples: int = 20000, seed: int = 0) -> float:
    """Point-sampled approximation of `mesh_hausdorff`: the max over
    (sampled + vertex) points of either mesh of the distance to the other
    mesh's sample set. The JAX package takes it where no g++ toolchain is
    there; the port calls it only by this name."""
    from scipy.spatial import cKDTree

    def point_set(v, f, s):
        if len(f) == 0:
            return v
        bc, fi = mesh_sample_barycentric(v, f, num_samples, seed=s)
        pts = barycentric_interpolation(bc, v, f[fi])
        return np.concatenate([v, pts], axis=0)

    pa = point_set(va, fa, seed)
    pb = point_set(vb, fb, seed + 1)
    d_ab = cKDTree(pb).query(pa, k=1)[0].max()
    d_ba = cKDTree(pa).query(pb, k=1)[0].max()
    return float(max(d_ab, d_ba))


def points_to_mesh_distance(points: np.ndarray, verts: np.ndarray,
                            faces: np.ndarray) -> np.ndarray:
    """Exact distance from each query point to the triangle mesh (AABB
    tree + closest-point-on-triangle, ops/cpp/hausdorff.cpp). Used for
    surface-DEVIATION measurement — point-to-point chamfer between two
    samplings of the same surface floors at the sample spacing,
    point-to-triangle does not."""
    lib = hausdorff_lib()
    points = np.ascontiguousarray(points, np.float64).reshape(-1, 3)
    v64 = np.ascontiguousarray(verts, np.float64)
    f32v = np.ascontiguousarray(faces, np.int32).reshape(-1, 3)
    out = np.empty(len(points), np.float64)
    lib.points_to_mesh_distances(
        points.ctypes.data_as(_DP), len(points),
        v64.ctypes.data_as(_DP), len(v64),
        f32v.ctypes.data_as(_IP), len(f32v),
        out.ctypes.data_as(_DP))
    return out


# ---------------------------------------------------------------------------
# winding number field (used by the synthetic data generator; the reference
# dataset ships WNF volumes precomputed offline)
# ---------------------------------------------------------------------------
# queries x faces above which backend='auto' takes the device path (the JAX
# package's threshold)
WN_DEVICE_FROM = 10 ** 8
# elements of one [chunk, F, 3] intermediate of the device path (256 MiB
# in f32; the solid-angle sum holds about ten such tensors at once)
WN_CHUNK_ELEMENTS = 1 << 26


def winding_number(query_points: np.ndarray, verts: np.ndarray,
                   faces: np.ndarray, chunk: int = 2048,
                   backend: str = "auto", device="cuda") -> np.ndarray:
    """Generalized winding number of query points w.r.t. a triangle soup,
    returned as float32.

    Solid-angle formula (van Oosterom & Strackee); for an open cloth mesh the
    field is fractional in the interior neighborhood — exactly the WNF the
    reference trains on (README.md:25).

    backend: 'numpy' (float64 on the host, `chunk` queries at a time),
    'torch' (float32 stock torch ops on `device`, the card unless the
    caller names the CPU) or 'auto': 'torch' when queries x faces exceeds
    WN_DEVICE_FROM, else 'numpy'. A dense 128^3 lattice against ~2k faces
    is minutes of numpy on one host core; the two paths agree to ~1e-5,
    far below training-GT resolution.
    """
    if backend == "auto":
        backend = ("torch" if len(query_points) * len(faces) > WN_DEVICE_FROM
                   else "numpy")
    if backend == "torch":
        return _winding_number_torch(query_points, verts, faces, device)
    if backend != "numpy":
        raise ValueError(f"winding_number backend must be 'auto', 'numpy' "
                         f"or 'torch', got {backend!r}")
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


def pad_faces(verts: np.ndarray, faces: np.ndarray,
              multiple: int = 1024) -> np.ndarray:
    """The triangles' corners [F', 3, 3] in float32, F' padded up to a
    multiple of `multiple` with repeated-vertex triangles (zero area, zero
    solid angle), as the JAX device path pads them."""
    tri = np.asarray(verts, np.float32)[np.asarray(faces)]
    fpad = (-len(tri)) % multiple
    if fpad:
        tri = np.concatenate(
            [tri, np.broadcast_to(tri[:1, :1], (fpad, 3, 3))])
    return tri


@torch.no_grad()
def _winding_number_torch(query_points, verts, faces, device="cuda",
                          chunk=None) -> np.ndarray:
    """The device path of winding_number (torch counterpart of the JAX
    package's _winding_number_jax): the solid-angle sum in float32 over
    faces padded by pad_faces, `chunk` queries at a time (by default as
    many as keep one [chunk, F, 3] intermediate at WN_CHUNK_ELEMENTS),
    with TF32 off."""
    dev = resolve_device(device)
    tri = torch.from_numpy(pad_faces(verts, faces)).to(dev)
    a0, b0, c0 = tri[:, 0], tri[:, 1], tri[:, 2]
    if chunk is None:
        chunk = max(1, WN_CHUNK_ELEMENTS // (3 * len(tri)))
    q = torch.as_tensor(np.asarray(query_points, np.float32)).to(dev)
    out = torch.empty(len(q), dtype=torch.float32, device=dev)
    with full_f32():
        for s in range(0, len(q), chunk):
            qc = q[s:s + chunk, None, :]                      # [C, 1, 3]
            a = a0[None] - qc                                 # [C, F, 3]
            b = b0[None] - qc
            c = c0[None] - qc
            la = torch.linalg.vector_norm(a, dim=-1)
            lb = torch.linalg.vector_norm(b, dim=-1)
            lc = torch.linalg.vector_norm(c, dim=-1)
            num = (a * torch.linalg.cross(b, c)).sum(-1)
            den = (la * lb * lc + (a * b).sum(-1) * lc
                   + (b * c).sum(-1) * la + (c * a).sum(-1) * lb)
            omega = 2.0 * torch.atan2(num, den)
            out[s:s + chunk] = omega.sum(dim=1) / (4.0 * np.pi)
    return out.cpu().numpy()
