"""Port point-cloud and grid ops vs the JAX package: ball query, kNN
interpolation, scatter, trilinear sampling and the virtual grid."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from garmentnets_tpu.ops import pointcloud as jpc
from garmentnets_tpu.ops.grid_sample import (
    grid_sample_trilinear as jax_grid_sample)
from garmentnets_tpu.ops.scatter import scatter_to_grid as jax_scatter
from garmentnets_tpu.ops.virtual_grid import VirtualGrid as JaxGrid
from garmentnets_tpu_torch.ops import pointcloud as tpc
from garmentnets_tpu_torch.ops.grid_sample import grid_sample_trilinear
from garmentnets_tpu_torch.ops.scatter import scatter_to_grid
from garmentnets_tpu_torch.ops.virtual_grid import VirtualGrid


@pytest.mark.parametrize("N,M,radius,k", [
    (300, 150, 0.2, 64),     # SA1-like ratio
    (128, 32, 0.4, 64),      # SA2-like ratio
    (40, 20, 0.5, 64),       # k > N: padded with the nearest neighbor
])
@pytest.mark.parametrize("approx", [True, False])
def test_ball_query_neighbor_sets_match_jax(N, M, radius, k, approx):
    """Same valid neighbor set per center (the SA max over K does not see
    slot order), same number of valid slots."""
    rs = np.random.RandomState(N)
    pts = (rs.rand(2, N, 3) - 0.5).astype(np.float32)
    ctr = pts[:, rs.choice(N, M, replace=False)]
    idx, mask = tpc.ball_query(torch.from_numpy(pts), torch.from_numpy(ctr),
                               radius, k=k, chunk=64)
    jidx, jmask = jpc.ball_query(jnp.asarray(pts), jnp.asarray(ctr),
                                 radius, k=k, chunk=64, approx=approx)
    idx, mask = idx.numpy(), mask.numpy()
    jidx, jmask = np.asarray(jidx), np.asarray(jmask)
    assert idx.shape == jidx.shape == (2, M, k)
    np.testing.assert_array_equal(mask.sum(-1), jmask.sum(-1))
    for b in range(2):
        for m in range(M):
            assert (set(idx[b, m][mask[b, m]].tolist())
                    == set(jidx[b, m][jmask[b, m]].tolist()))


@pytest.mark.parametrize("S,T,k", [(50, 200, 3), (1, 30, 1), (20, 40, 3)])
def test_knn_interpolate_matches_jax(S, T, k):
    rs = np.random.RandomState(S + T)
    feat = rs.randn(2, S, 16).astype(np.float32)
    src = rs.rand(2, S, 3).astype(np.float32)
    dst = rs.rand(2, T, 3).astype(np.float32)
    ours = tpc.knn_interpolate(torch.from_numpy(feat), torch.from_numpy(src),
                               torch.from_numpy(dst), k=k).numpy()
    ref = np.asarray(jpc.knn_interpolate(jnp.asarray(feat), jnp.asarray(src),
                                         jnp.asarray(dst), k=k, approx=True))
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("reduce", ["max", "mean", "sum"])
def test_scatter_matches_jax(reduce):
    """Segment reduction with empty cells 0; max is bit-identical, mean and
    sum add in another order (within 1e-5)."""
    rs = np.random.RandomState(0)
    feat = rs.randn(2, 500, 8).astype(np.float32)
    idx = rs.randint(0, 300, size=(2, 500))     # cells 300..511 stay empty
    ours = scatter_to_grid(torch.from_numpy(feat), torch.from_numpy(idx),
                           512, reduce).numpy()
    ref = np.asarray(jax_scatter(jnp.asarray(feat),
                                 jnp.asarray(idx, jnp.int32), 512, reduce))
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=0 if reduce == "max" else 1e-5)
    assert (ours[:, 300:] == 0).all()


def test_grid_sample_matches_jax():
    """Border clamp, align-corners, same lerp order."""
    rs = np.random.RandomState(1)
    vol = rs.randn(2, 5, 6, 7, 4).astype(np.float32)
    q = (rs.rand(2, 100, 3) * 1.4 - 0.2).astype(np.float32)  # some outside
    ours = grid_sample_trilinear(torch.from_numpy(vol),
                                 torch.from_numpy(q)).numpy()
    ref = np.asarray(jax_grid_sample(jnp.asarray(vol), jnp.asarray(q)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("G", [8, 32, 64])
def test_virtual_grid_matches_jax(G):
    """Truncating cast then clamp, and idx * (1/(G-1)) in f32: exact."""
    rs = np.random.RandomState(G)
    pts = (rs.rand(4, 500, 3) * 1.2 - 0.1).astype(np.float32)
    jg = JaxGrid(grid_shape=(G, G, G), batch_size=1)
    tg = VirtualGrid(grid_shape=(G, G, G))
    jidx = np.asarray(jg.get_points_grid_idxs(jnp.asarray(pts)))
    tidx = tg.get_points_grid_idxs(torch.from_numpy(pts))
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    np.testing.assert_array_equal(
        tg.idxs_to_points(tidx).numpy(),
        np.asarray(jg.idxs_to_points(jnp.asarray(jidx))))
    np.testing.assert_array_equal(tg.flatten_idxs(tidx).numpy(),
                                  np.asarray(jg.flatten_idxs(
                                      jnp.asarray(jidx))))


def _ball_query_reference(pts, ctr, radius, k):
    """The K nearest by exact f32 distance (dx*dx + dy*dy + dz*dz), ties to
    the lower index, by a full sort in numpy."""
    B, M = ctr.shape[:2]
    idx = np.zeros((B, M, k), np.int64)
    mask = np.zeros((B, M, k), bool)
    r2 = np.float32(radius) ** 2
    for b in range(B):
        for m in range(M):
            d = pts[b] - ctr[b, m]
            d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
            order = np.lexsort((np.arange(len(d2)), d2))[:k]
            idx[b, m] = order
            mask[b, m] = d2[order] <= r2
    return idx, mask


@pytest.mark.parametrize("kind", ["lattice", "duplicates", "near_lattice"])
def test_ball_query_exact_on_ties(kind):
    """Exact ties at the K-th neighbour (a lattice's distance shells,
    points given two or three times) and near-ties (a lattice moved by
    ~1e-6): the chosen slots are the exact K nearest, ties to the lower
    index, in that order."""
    import chip_smoke
    kind_pts = "lattice" if kind == "near_lattice" else kind
    pts = chip_smoke.fps_points(kind_pts, 2, 1000, 3)
    if kind == "near_lattice":
        pts = pts + np.random.RandomState(4).randn(*pts.shape).astype(
            np.float32) * np.float32(1e-6)
    ctr = np.ascontiguousarray(pts[:, ::9])
    idx, mask = tpc.ball_query(torch.from_numpy(pts), torch.from_numpy(ctr),
                               0.35, k=64, chunk=40)
    ridx, rmask = _ball_query_reference(pts, ctr, 0.35, 64)
    np.testing.assert_array_equal(idx.numpy(), ridx)
    np.testing.assert_array_equal(mask.numpy(), rmask)
