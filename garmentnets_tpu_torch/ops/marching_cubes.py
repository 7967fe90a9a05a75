"""Host marching cubes: ctypes binding of the C++ kernel ops/cpp/marching.cpp
(torch port of garmentnets_tpu/ops/marching_cubes.py; the C++ source is a
copy of the JAX package's).

The library is compiled with g++ into the ignored `_build/` directory at
first use (kernels/_build.py); a failed build raises. There is no
pure-Python fallback. Every extractor raises ValueError when no surface is
produced (the predict harness's NaN-sentinel protocol depends on this).
Entry points: `marching_cubes` (a dense volume), `marching_cubes_active`
(a per-cube list, ops/isosurface.extract_active_cubes),
`marching_cubes_bricks` (int8 bricks with optional straddle masks and
crossing-edge ranks, the engine's path), `wnf_to_mesh` (dense marching
cubes filtered by the gradient magnitude) and `delete_invalid_verts`, the
eval's filter of a mesh to its on-surface vertices.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from garmentnets_tpu_torch.kernels import _build

# the C++ kernel's methods: 'cubes' (procedural, the default), 'tetrahedra'
# (6-tet split) and 'trilinear' (trilinear-topology ambiguity resolution)
METHODS = {"cubes": 0, "tetrahedra": 1, "trilinear": 2}
# corner offset order of the C++ kernel and the device extraction
CUBE_CORNERS = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                         [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]])
_FP = ctypes.POINTER(ctypes.c_float)
_FPP = ctypes.POINTER(_FP)
_I32P = ctypes.POINTER(ctypes.c_int32)
_IPP = ctypes.POINTER(_I32P)
_I64P = ctypes.POINTER(ctypes.c_int64)
_I8P = ctypes.POINTER(ctypes.c_int8)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _lib() -> ctypes.CDLL:
    lib = _build.load("marching")
    if not getattr(lib, "_argtypes_set", False):
        out_args = [_FPP, _I64P, _IPP, _I64P]
        grid = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        lib.extract_isosurface.restype = ctypes.c_int
        lib.extract_isosurface.argtypes = [
            _FP] + grid + [
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_int] + out_args + [_FPP, _FPP]
        lib.extract_isosurface_active.restype = ctypes.c_int
        lib.extract_isosurface_active.argtypes = [
            _I32P, _FP, ctypes.c_int64] + grid + [
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_int] + out_args + [_FPP, _FPP]
        bricks = [ctypes.c_int64] + grid + [
            ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_int] + out_args + [_IPP, _FPP, _FPP]
        lib.extract_isosurface_bricks.restype = ctypes.c_int
        lib.extract_isosurface_bricks.argtypes = [_I32P, _I8P] + bricks
        lib.extract_isosurface_bricks_masked.restype = ctypes.c_int
        lib.extract_isosurface_bricks_masked.argtypes = [
            _I32P, _I8P, _U8P] + bricks
        lib.mt_free.argtypes = [ctypes.c_void_p]
        lib.mt_free.restype = None
        lib._argtypes_set = True
    return lib


def _method(method: str) -> int:
    if method not in METHODS:
        raise ValueError(f"method must be one of {sorted(METHODS)}, got "
                         f"{method!r}")
    return METHODS[method]


def _take(lib, ptr, shape):
    """Copy a C-allocated buffer of `shape` (first dim may be 0) into numpy
    and free it."""
    try:
        n = shape[0]
        arr = np.ctypeslib.as_array(ptr, shape=(max(n, 1),) + shape[1:])
        return arr.copy()[:n]
    finally:
        lib.mt_free(ptr)


def _collect(lib, fn, args, want_values=False, want_normals=False,
             want_ranks=None):
    """Call a C extractor whose trailing arguments are the out-pointers
    (verts, nv, faces, nf[, ranks], values, normals), nullable past nf,
    and copy (verts, faces[, values][, normals][, ranks]) out of it.
    want_ranks is None for an extractor without the ranks slot (all but
    the brick ones)."""
    verts_p, faces_p = _FP(), _I32P()
    values_p, normals_p, ranks_p = _FP(), _FP(), _I32P()
    nv, nf = ctypes.c_int64(), ctypes.c_int64()
    tail = [ctypes.byref(values_p) if want_values else None,
            ctypes.byref(normals_p) if want_normals else None]
    if want_ranks is not None:
        tail.insert(0, ctypes.byref(ranks_p) if want_ranks else None)
    fn(*args, ctypes.byref(verts_p), ctypes.byref(nv), ctypes.byref(faces_p),
       ctypes.byref(nf), *tail)
    n = nv.value
    out = (_take(lib, verts_p, (n, 3)).astype(np.float32),
           _take(lib, faces_p, (nf.value, 3)).astype(np.int64))
    if want_values:
        out += (_take(lib, values_p, (n,)).astype(np.float32),)
    if want_normals:
        out += (_take(lib, normals_p, (n, 3)).astype(np.float32),)
    if want_ranks:
        out += (_take(lib, ranks_p, (n,)),)
    return out


def marching_cubes_active(cube_idx: np.ndarray, corner_vals: np.ndarray,
                          dims, level: float, spacing,
                          gradient_direction: str = "ascent",
                          method: str = "cubes"):
    """Isosurface from a per-cube list (ops/isosurface.extract_active_cubes):
    cube_idx [K] flat C-order voxel index of each cube's origin (-1 =
    padding), corner_vals [K, 8] in CUBE_CORNERS order. Returns (verts,
    faces); raises ValueError when no surface is produced."""
    cube_idx = np.ascontiguousarray(cube_idx, np.int32)
    corner_vals = np.ascontiguousarray(corner_vals, np.float32)
    if corner_vals.shape != (len(cube_idx), 8):
        raise ValueError(f"corner_vals must be [K, 8], got "
                         f"{corner_vals.shape}")
    nx, ny, nz = dims
    lib = _lib()
    verts, faces = _collect(lib, lib.extract_isosurface_active, (
        cube_idx.ctypes.data_as(_I32P), corner_vals.ctypes.data_as(_FP),
        len(cube_idx), nx, ny, nz, ctypes.c_float(level),
        ctypes.c_float(spacing[0]), ctypes.c_float(spacing[1]),
        ctypes.c_float(spacing[2]),
        1 if gradient_direction == "ascent" else 0, _method(method)))
    if len(verts) == 0 or len(faces) == 0:
        raise ValueError("no surface found at given iso level")
    return verts, faces


def marching_cubes_bricks(brick_idx: np.ndarray, brick_vals_q: np.ndarray,
                          dims, level: float, spacing,
                          gradient_direction: str = "ascent",
                          method: str = "cubes",
                          return_ranks: bool = False,
                          return_values: bool = False,
                          return_normals: bool = False,
                          cube_masks=None):
    """Isosurface from int8 bricks (ops/isosurface.extract_active_bricks).

    brick_idx [K] flat index into the (dims/4) block grid (-1 = padding);
    brick_vals_q [K, 64] side-preserving quantized voxel values in local
    C-order, or the [K, 72] masked payload, which is split here.
    cube_masks [K, 8] uint8: the per-brick straddle masks, with which the
    kernel skips its rejection scan (the same cube set). Returns (verts,
    faces[, values][, normals][, ranks]): values the per-vertex
    edge-endpoint max of the dequantized field, normals the unit
    volume-gradient normals, ranks each vertex's index in
    ops/isosurface.extract_crossing_edges' canonical order. Raises
    ValueError when no surface is produced."""
    from garmentnets_tpu_torch.ops.isosurface import (
        VAL_QUANT_SCALE, split_brick_payload)
    brick_idx = np.ascontiguousarray(brick_idx, np.int32)
    if np.shape(brick_vals_q)[-1] == 72 and cube_masks is None:
        # the masked payload passed whole: split it, so the mask bytes are
        # not read as voxel values at the kernel's stride of 64
        brick_vals_q, cube_masks = split_brick_payload(
            np.asarray(brick_vals_q))
    brick_vals_q = np.ascontiguousarray(brick_vals_q, np.int8)
    if brick_vals_q.shape != (len(brick_idx), 64):
        raise ValueError(f"brick_vals_q must be [K, 64] int8 voxel rows (or "
                         f"the [K, 72] masked payload), got "
                         f"{brick_vals_q.shape}")
    ascent = gradient_direction == "ascent"
    if return_ranks and not ascent:
        # the canonical crossing-edge set follows the (v > level) side
        # rule; under 'descent' a corner dequantizing to exactly `level`
        # can put a vertex on an edge outside it
        raise ValueError("return_ranks requires gradient_direction='ascent'")
    if return_ranks and method != "cubes":
        # tetrahedra put vertices on diagonal edges, which have no rank
        raise ValueError("return_ranks requires method='cubes'")
    nx, ny, nz = dims
    lib = _lib()
    head = (brick_idx.ctypes.data_as(_I32P), brick_vals_q.ctypes.data_as(_I8P))
    fn = lib.extract_isosurface_bricks
    if cube_masks is not None:
        cube_masks = np.ascontiguousarray(cube_masks, np.uint8)
        if cube_masks.shape != (len(brick_idx), 8):
            raise ValueError(f"cube_masks must be [K, 8] uint8, got "
                             f"{cube_masks.shape}")
        head += (cube_masks.ctypes.data_as(_U8P),)
        fn = lib.extract_isosurface_bricks_masked
    out = _collect(lib, fn, head + (
        len(brick_idx), nx, ny, nz, ctypes.c_float(level),
        ctypes.c_float(VAL_QUANT_SCALE), ctypes.c_float(spacing[0]),
        ctypes.c_float(spacing[1]), ctypes.c_float(spacing[2]),
        1 if ascent else 0, _method(method)),
        want_values=return_values, want_normals=return_normals,
        want_ranks=return_ranks)
    if len(out[0]) == 0 or len(out[1]) == 0:
        raise ValueError("no surface found at given iso level")
    return out


def _vertex_normals_from_gradient(vol, verts, spacing):
    """Per-vertex normals from the volume gradient (skimage convention)."""
    g = np.gradient(vol.astype(np.float64))
    idx = np.clip(np.round(verts / np.asarray(spacing)).astype(np.int64),
                  0, np.asarray(vol.shape) - 1)
    n = np.stack([gi[idx[:, 0], idx[:, 1], idx[:, 2]] for gi in g], axis=1)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    norm[norm == 0] = 1
    return (n / norm).astype(np.float32)


def marching_cubes(volume: np.ndarray, level: float,
                   spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
                   gradient_direction: str = "ascent"):
    """skimage.measure.marching_cubes-compatible facade over a dense
    volume -> (verts, faces, normals, values). Raises ValueError if `level`
    is outside the volume's value range or no surface is produced."""
    volume = np.ascontiguousarray(volume, np.float32)
    if not (volume.min() < level < volume.max()):
        raise ValueError(f"level {level} not within volume range "
                         f"[{volume.min()}, {volume.max()}]")
    ascent = gradient_direction == "ascent"
    nx, ny, nz = volume.shape
    lib = _lib()
    verts, faces, values = _collect(lib, lib.extract_isosurface, (
        volume.ctypes.data_as(_FP), nx, ny, nz, ctypes.c_float(level),
        ctypes.c_float(spacing[0]), ctypes.c_float(spacing[1]),
        ctypes.c_float(spacing[2]), 1 if ascent else 0, METHODS["cubes"]),
        want_values=True)
    if len(verts) == 0:
        raise ValueError("no surface found at given iso level")
    normals = _vertex_normals_from_gradient(volume, verts, spacing)
    if ascent:
        normals = -normals  # skimage: normals point toward gradient descent
    return verts, faces, normals, values


def wnf_to_mesh(wnf_volume: np.ndarray, iso_surface_level: float = 0.5,
                gradient_threshold: float = 0.25, sigma: float = 0.5):
    """A WNF volume -> its surface-filtered mesh (verts, faces): marching
    cubes at the iso level, then the faces with a vertex whose nearest
    voxel's smoothed gradient magnitude is at most `gradient_threshold`
    are dropped (the open boundary's halo; reference
    common/marching_cubes_util.py:5-35)."""
    import scipy.ndimage as ni
    volume_size = wnf_volume.shape[-1]
    wnf_ggm = ni.gaussian_gradient_magnitude(wnf_volume, sigma=sigma,
                                             mode="nearest")
    voxel_spacing = 1 / (volume_size - 1)
    mc_verts, mc_faces, _, _ = marching_cubes(
        wnf_volume, level=iso_surface_level, spacing=(voxel_spacing,) * 3,
        gradient_direction="ascent")
    nn_idx = np.clip((mc_verts / voxel_spacing).astype(np.int64), 0,
                     volume_size - 1)
    verts_ggm = wnf_ggm[nn_idx[:, 0], nn_idx[:, 1], nn_idx[:, 2]]
    return delete_invalid_verts(mc_verts, mc_faces,
                                verts_ggm > gradient_threshold)


def delete_invalid_verts(mc_verts, mc_faces, is_vert_on_surface):
    """Drop faces touching off-surface verts and reindex (reference
    common/marching_cubes_util.py:38-53)."""
    is_vert_on_surface = np.asarray(is_vert_on_surface, bool)
    is_face_valid = np.ones(len(mc_faces), dtype=bool)
    for i in range(3):
        is_face_valid &= is_vert_on_surface[mc_faces[:, i]]
    raw_valid_faces = mc_faces[is_face_valid]
    raw_valid_vert_idx = np.unique(raw_valid_faces.flatten())
    valid_verts = mc_verts[raw_valid_vert_idx]
    remap = np.zeros(len(mc_verts), dtype=mc_faces.dtype)
    remap[raw_valid_vert_idx] = np.arange(
        len(valid_verts), dtype=mc_faces.dtype)
    return valid_verts, remap[raw_valid_faces]
