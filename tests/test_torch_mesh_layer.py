"""The rest of the port's mesh-extraction layer against the JAX package on
the CPU: the per-cube records and their pages, bricks_to_cube_list, the
crossing edges and their numpy mask, marching_cubes_active, the
crossing-edge ranks of marching_cubes_bricks (a bijection onto the crossing
edges, and its two refusals) and wnf_to_mesh.

Integer outputs (indices, counts, int8 values, page bytes, masks, ranks,
faces) are identical, f16 corner values and the crossing points' f32
positions bit-identical, and meshes match exactly (verts, faces, values).
"""
import pathlib
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from scipy.ndimage import gaussian_filter

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from bench import _cloth_like_wnf  # noqa: E402

from garmentnets_tpu.ops import isosurface as jiso  # noqa: E402
from garmentnets_tpu.ops import marching_cubes as jmc  # noqa: E402
from garmentnets_tpu_torch.ops import isosurface as tiso  # noqa: E402
from garmentnets_tpu_torch.ops import marching_cubes as tmc  # noqa: E402


def _random_field(S=32, seed=3):
    """Two smooth random fields and their median as the level."""
    rng = np.random.RandomState(seed)
    vol = np.stack([
        gaussian_filter(rng.rand(S, S, S).astype(np.float32), 3) * 4.0,
        gaussian_filter(rng.rand(S, S, S).astype(np.float32), 2) * 4.0])
    return vol.astype(np.float32), float(np.median(vol))


def _sphere(n=24, r=0.3):
    ax = np.linspace(0, 1, n)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return (0.5 + r - np.sqrt(
        (x - .5) ** 2 + (y - .5) ** 2 + (z - .5) ** 2)).astype(np.float32)


FIELDS = {"sphere24": lambda: (_sphere()[None], 0.5),
          "random32": _random_field,
          "cloth32": lambda: (_cloth_like_wnf(32)[None].astype(np.float32),
                              0.5)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("cap", [8192, 500])
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("field", sorted(FIELDS))
def test_active_cubes_identical(field, quantize, cap):
    vol, level = FIELDS[field]()
    want = [np.asarray(a) for a in jiso.extract_active_cubes(
        jnp.asarray(vol), level, cap, quantize=quantize)]
    got = [a.numpy() for a in tiso.extract_active_cubes(
        _t(vol), level, cap, quantize=quantize)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    if cap == 500:
        assert int(want[2].max()) > cap          # the overflowed case
    np.testing.assert_array_equal(tiso.dequantize_vals(got[1], level),
                                  jiso.dequantize_vals(want[1], level))


def test_active_pages_identical_and_round_trip():
    rng = np.random.RandomState(0)
    B, cap, page = 2, 1024, 256
    base = rng.randint(0, 128 ** 3, size=(B, cap)).astype(np.int32)
    base[0, 700:] = -1
    vals = rng.randint(-127, 128, size=(B, cap, 8)).astype(np.int8)
    want = jiso.pack_active_pages(jnp.asarray(base), jnp.asarray(vals), page)
    got = tiso.pack_active_pages(_t(base), _t(vals), page)
    assert len(got) == len(want) == cap // page
    for g, w in zip(got, want):
        assert g.shape == (B, page, 12) and g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got_base, got_vals = tiso.unpack_active_pages(
        [p.numpy() for p in got], level=0.5)
    np.testing.assert_array_equal(got_base, base)
    np.testing.assert_array_equal(got_vals, jiso.dequantize_vals(vals, 0.5))
    prefix, _ = tiso.unpack_active_pages([p.numpy() for p in got[:2]], 0.5)
    np.testing.assert_array_equal(prefix, base[:, :2 * page])


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_bricks_to_cube_list_identical(field):
    """The host expansion equals JAX's and is the cube set (and dequantized
    corner values) of extract_active_cubes(quantize=True)."""
    vol, level = FIELDS[field]()
    S = vol.shape[1]
    bi, bv, bc = (a.numpy() for a in tiso.extract_active_bricks(
        _t(vol), level, 4096))
    cb, cv, cc = (a.numpy() for a in tiso.extract_active_cubes(
        _t(vol), level, 32768, quantize=True))
    for b in range(len(vol)):
        n = int(bc[b])
        got = tiso.bricks_to_cube_list(bi[b, :n], bv[b, :n], level, S)
        want = jiso.bricks_to_cube_list(bi[b, :n], bv[b, :n], level, S)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        m = int(cc[b])
        order = np.argsort(got[0])
        np.testing.assert_array_equal(got[0][order], cb[b, :m])
        np.testing.assert_array_equal(
            got[1][order], tiso.dequantize_vals(cv[b, :m], level))


@pytest.mark.parametrize("edge_cap", [16384, 600])
@pytest.mark.parametrize("field", sorted(FIELDS))
def test_crossing_edges_identical(field, edge_cap):
    vol, level = FIELDS[field]()
    S = vol.shape[1]
    bi, bv, bc = jiso.extract_active_bricks(jnp.asarray(vol), level, 512)
    want = [np.asarray(a) for a in jiso.extract_crossing_edges(
        jnp.asarray(vol), level, bi, edge_cap)]
    got = [a.numpy() for a in tiso.extract_crossing_edges(
        _t(vol), level, _t(np.asarray(bi)), edge_cap)]
    assert got[0].dtype == np.int32 and got[1].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    if edge_cap == 600:
        assert int(want[0].max()) > edge_cap
    bi, bv = np.asarray(bi), np.asarray(bv)
    for b in range(len(vol)):
        mask = tiso.crossing_edge_mask_np(bi[b], bv[b], level, S)
        np.testing.assert_array_equal(
            mask, jiso.crossing_edge_mask_np(bi[b], bv[b], level, S))
        assert int(mask.sum()) == got[0][b]


@pytest.mark.parametrize("method", ["cubes", "tetrahedra"])
@pytest.mark.parametrize("field", sorted(FIELDS))
def test_marching_cubes_active_identical(field, method):
    vol, level = FIELDS[field]()
    S = vol.shape[1]
    cb, cv, cc = (np.asarray(a) for a in jiso.extract_active_cubes(
        jnp.asarray(vol), level, 32768))
    spacing = (1.0 / (S - 1),) * 3
    for b in range(len(vol)):
        k = int(cc[b])
        args = (cb[b, :k], cv[b, :k].astype(np.float32), (S, S, S), level,
                spacing)
        got = tmc.marching_cubes_active(*args, method=method)
        want = jmc.marching_cubes_active(*args, method=method)
        assert len(got[0]) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        tmc.marching_cubes_active(np.full(2, -1, np.int32),
                                  np.zeros((2, 8), np.float32), (S, S, S),
                                  level, spacing)


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_vertex_ranks_identical_and_bijective(field):
    vol, level = FIELDS[field]()
    S = vol.shape[1]
    bi, bv, bc = (a.numpy() for a in tiso.extract_active_bricks(
        _t(vol), level, 512))
    ec, vert_dev = (a.numpy() for a in tiso.extract_crossing_edges(
        _t(vol), level, _t(bi), 16384))
    spacing = (1.0 / (S - 1),) * 3
    for b in range(len(vol)):
        n = int(bc[b])
        args = (bi[b, :n], bv[b, :n], (S, S, S), level, spacing)
        got = tmc.marching_cubes_bricks(*args, return_ranks=True,
                                        return_values=True,
                                        return_normals=True)
        want = jmc.marching_cubes_bricks(*args, return_ranks=True,
                                         return_values=True,
                                         return_normals=True)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        v, r = got[0], got[-1]
        assert r.dtype == np.int32 and len(v) == ec[b]
        np.testing.assert_array_equal(np.sort(r), np.arange(ec[b]))
        # the ranked crossing point lies on the vertex's lattice edge
        d = np.abs(vert_dev[b][r] * (S - 1) - v / np.asarray(spacing))
        assert d.max() < 1.0
        assert (np.sort(d, axis=1)[:, :2] < 1e-4).all()
        only_ranks = tmc.marching_cubes_bricks(*args, return_ranks=True)
        assert len(only_ranks) == 3
        np.testing.assert_array_equal(only_ranks[2], r)


def test_ranks_refused_under_descent_and_other_methods():
    vol, level = FIELDS["sphere24"]()
    S = vol.shape[1]
    bi, bv, bc = (a.numpy() for a in tiso.extract_active_bricks(
        _t(vol), level, 512))
    n = int(bc[0])
    args = (bi[0, :n], bv[0, :n], (S, S, S), level, (1.0 / (S - 1),) * 3)
    with pytest.raises(ValueError, match="gradient_direction='ascent'"):
        tmc.marching_cubes_bricks(*args, gradient_direction="descent",
                                  return_ranks=True)
    for method in ("tetrahedra", "trilinear"):
        with pytest.raises(ValueError, match="method='cubes'"):
            tmc.marching_cubes_bricks(*args, method=method,
                                      return_ranks=True)
        # without ranks the other methods run, as JAX's do
        got = tmc.marching_cubes_bricks(*args, method=method)
        want = jmc.marching_cubes_bricks(*args, method=method)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="method must be one of"):
        tmc.marching_cubes_bricks(*args, method="lewiner")


def _sharp_sphere(n=24):
    ax = np.linspace(0, 1, n)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    dist = np.sqrt((x - .5) ** 2 + (y - .5) ** 2 + (z - .5) ** 2)
    return (1.0 / (1.0 + np.exp((dist - 0.3) * 200))).astype(np.float32)


@pytest.mark.parametrize("make,kw", [
    (_sharp_sphere, {}),
    (lambda: _cloth_like_wnf(32).astype(np.float32), {}),
    (lambda: _cloth_like_wnf(32).astype(np.float32),
     dict(iso_surface_level=0.4, gradient_threshold=0.1, sigma=1.0))],
    ids=["sphere", "cloth", "cloth_options"])
def test_wnf_to_mesh_identical(make, kw):
    wnf = make()
    got = tmc.wnf_to_mesh(wnf, **kw)
    want = jmc.wnf_to_mesh(wnf, **kw)
    assert len(got[0]) > 100
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
