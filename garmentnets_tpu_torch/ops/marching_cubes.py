"""Host marching cubes: ctypes binding of the C++ kernel ops/cpp/marching.cpp
(torch port of garmentnets_tpu/ops/marching_cubes.py; the C++ source is a
copy of the JAX package's).

The library is compiled with g++ into the ignored `_build/` directory at
first use (kernels/_build.py); a failed build raises. There is no
pure-Python fallback. `marching_cubes` / `marching_cubes_bricks` raise
ValueError when no surface is produced (the predict harness's NaN-sentinel
protocol depends on this). `delete_invalid_verts` is the eval's filter of
a mesh to its on-surface vertices.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from garmentnets_tpu_torch.kernels import _build

_CUBES = 0  # the C++ kernel's procedural marching-cubes method
_FP = ctypes.POINTER(ctypes.c_float)
_FPP = ctypes.POINTER(_FP)
_IPP = ctypes.POINTER(ctypes.POINTER(ctypes.c_int32))
_I64P = ctypes.POINTER(ctypes.c_int64)


def _lib() -> ctypes.CDLL:
    lib = _build.load("marching")
    if not getattr(lib, "_argtypes_set", False):
        out_args = [_FPP, _I64P, _IPP, _I64P]
        lib.extract_isosurface.restype = ctypes.c_int
        lib.extract_isosurface.argtypes = [
            _FP, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_int] + out_args + [_FPP, _FPP]
        lib.extract_isosurface_bricks.restype = ctypes.c_int
        lib.extract_isosurface_bricks.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int8),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_int] + out_args + [_IPP, _FPP, _FPP]
        lib.mt_free.argtypes = [ctypes.c_void_p]
        lib.mt_free.restype = None
        lib._argtypes_set = True
    return lib


def _take(lib, ptr, shape):
    """Copy a C-allocated buffer of `shape` (first dim may be 0) into numpy
    and free it."""
    try:
        n = shape[0]
        arr = np.ctypeslib.as_array(ptr, shape=(max(n, 1),) + shape[1:])
        return arr.copy()[:n]
    finally:
        lib.mt_free(ptr)


def marching_cubes_bricks(brick_idx: np.ndarray, brick_vals_q: np.ndarray,
                          dims, level: float, spacing,
                          gradient_direction: str = "ascent",
                          return_values: bool = False,
                          return_normals: bool = False):
    """Isosurface from int8 bricks (ops/isosurface.extract_active_bricks).

    brick_idx [K] flat index into the (dims/4) block grid (-1 = padding);
    brick_vals_q [K, 64] side-preserving quantized voxel values in local
    C-order. Returns (verts, faces[, values][, normals]); raises ValueError
    when no surface is produced."""
    from garmentnets_tpu_torch.ops.isosurface import VAL_QUANT_SCALE
    brick_idx = np.ascontiguousarray(brick_idx, np.int32)
    brick_vals_q = np.ascontiguousarray(brick_vals_q, np.int8)
    if brick_vals_q.shape != (len(brick_idx), 64):
        raise ValueError(f"brick_vals_q must be [K, 64] int8, got "
                         f"{brick_vals_q.shape}")
    nx, ny, nz = dims
    lib = _lib()
    verts_p, faces_p = _FP(), ctypes.POINTER(ctypes.c_int32)()
    values_p, normals_p = _FP(), _FP()
    nv, nf = ctypes.c_int64(), ctypes.c_int64()
    lib.extract_isosurface_bricks(
        brick_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        brick_vals_q.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        len(brick_idx), nx, ny, nz, ctypes.c_float(level),
        ctypes.c_float(VAL_QUANT_SCALE), ctypes.c_float(spacing[0]),
        ctypes.c_float(spacing[1]), ctypes.c_float(spacing[2]),
        1 if gradient_direction == "ascent" else 0, _CUBES,
        ctypes.byref(verts_p), ctypes.byref(nv), ctypes.byref(faces_p),
        ctypes.byref(nf), None,
        ctypes.byref(values_p) if return_values else None,
        ctypes.byref(normals_p) if return_normals else None)
    verts = _take(lib, verts_p, (nv.value, 3)).astype(np.float32)
    faces = _take(lib, faces_p, (nf.value, 3)).astype(np.int64)
    out = (verts, faces)
    if return_values:
        out += (_take(lib, values_p, (nv.value,)).astype(np.float32),)
    if return_normals:
        out += (_take(lib, normals_p, (nv.value, 3)).astype(np.float32),)
    if len(verts) == 0 or len(faces) == 0:
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
    verts_p, faces_p = _FP(), ctypes.POINTER(ctypes.c_int32)()
    values_p = _FP()
    nv, nf = ctypes.c_int64(), ctypes.c_int64()
    lib.extract_isosurface(
        volume.ctypes.data_as(_FP), nx, ny, nz, ctypes.c_float(level),
        ctypes.c_float(spacing[0]), ctypes.c_float(spacing[1]),
        ctypes.c_float(spacing[2]), 1 if ascent else 0, _CUBES,
        ctypes.byref(verts_p), ctypes.byref(nv), ctypes.byref(faces_p),
        ctypes.byref(nf), ctypes.byref(values_p), None)
    verts = _take(lib, verts_p, (nv.value, 3)).astype(np.float32)
    faces = _take(lib, faces_p, (nf.value, 3)).astype(np.int64)
    values = _take(lib, values_p, (nv.value,)).astype(np.float32)
    if len(verts) == 0:
        raise ValueError("no surface found at given iso level")
    normals = _vertex_normals_from_gradient(volume, verts, spacing)
    if ascent:
        normals = -normals  # skimage: normals point toward gradient descent
    return verts, faces, normals, values


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
