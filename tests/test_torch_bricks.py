"""Port brick extraction, page packing and host marching cubes vs the JAX
package: given the same WNF the brick index/value/count arrays and the packed
pages are byte-identical, and the meshes bit-identical."""
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

LEVEL = 0.5


def _smooth(S, seed, B=2):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(B):
        v = gaussian_filter(rng.rand(S, S, S), 1.0)
        out.append((v - v.min()) / (v.max() - v.min()))
    return np.stack(out).astype(np.float32)


def _cloth(S, B=2):
    w = _cloth_like_wnf(S)
    return np.stack([w, w[:, ::-1].copy()][:B]).astype(np.float32)


CASES = [("smooth16", lambda: _smooth(16, 0), 64),
         ("smooth24", lambda: _smooth(24, 1), 256),
         ("cloth32", lambda: _cloth(32), 512),
         ("cloth32_overflow", lambda: _cloth(32), 64)]


@pytest.mark.parametrize("name,make,cap", CASES, ids=[c[0] for c in CASES])
def test_bricks_and_pages_byte_identical(name, make, cap):
    wnf = make()
    ji, jv, jc = (np.asarray(a) for a in jiso.extract_active_bricks(
        jnp.asarray(wnf), LEVEL, cap))
    ti, tv, tc = tiso.extract_active_bricks(torch.from_numpy(wnf), LEVEL,
                                            cap)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(tc.numpy(), jc)
    assert ti.dtype == torch.int32 and tv.dtype == torch.int8
    page = min(cap, 64)
    jpages = jiso.pack_brick_pages(jnp.asarray(ji), jnp.asarray(jv), page,
                                   counts=jnp.asarray(jc))
    tpages = tiso.pack_brick_pages(ti, tv, page, counts=tc)
    assert len(tpages) == len(jpages)
    for tp, jp in zip(tpages, jpages):
        assert tp.dtype == torch.uint8
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tiso.read_page_counts(tpages[0].numpy()),
                                  jc)
    if name.endswith("overflow"):
        assert jc.max() > cap


def test_quantization_matches_jax():
    """Round half to even and the side-preserving clamp, incl. values that
    sit exactly on the level and on half steps."""
    steps = (np.arange(-300, 301) / 508.0 + LEVEL).astype(np.float32)
    vals = np.concatenate([steps, np.float32([LEVEL, np.nextafter(
        np.float32(LEVEL), np.float32(1)), 0.0, 1.0])])
    ours = tiso._quantize_vals(torch.from_numpy(vals), LEVEL).numpy()
    ref = np.asarray(jiso._quantize_vals(jnp.asarray(vals), LEVEL))
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("name,make,cap", CASES[:3], ids=[c[0] for c in
                                                           CASES[:3]])
def test_brick_meshes_bit_identical(name, make, cap):
    wnf = make()
    S = wnf.shape[1]
    ti, tv, tc = tiso.extract_active_bricks(torch.from_numpy(wnf), LEVEL,
                                            cap)
    pages = tiso.pack_brick_pages(ti, tv, min(cap, 64), counts=tc)
    idx, vals = tiso.unpack_brick_pages([p.numpy() for p in pages],
                                        header=True)
    vals, masks = tiso.split_brick_payload(vals)
    assert masks is None
    spacing = (1.0 / (S - 1),) * 3
    for b in range(len(tc)):
        n = int(tc[b])
        ours = tmc.marching_cubes_bricks(
            idx[b, :n], vals[b, :n], (S, S, S), LEVEL, spacing,
            return_values=True, return_normals=True)
        ref = jmc.marching_cubes_bricks(
            idx[b, :n], vals[b, :n], (S, S, S), LEVEL, spacing,
            return_values=True, return_normals=True)
        assert len(ours) == len(ref) == 4 and len(ours[0]) > 0
        for a, r in zip(ours, ref):
            np.testing.assert_array_equal(a, r)


def test_dense_marching_cubes_bit_identical():
    vol = _smooth(12, 5, B=1)[0]
    ours = tmc.marching_cubes(vol, LEVEL, spacing=(0.1, 0.1, 0.1))
    ref = jmc.marching_cubes(vol, LEVEL, spacing=(0.1, 0.1, 0.1))
    for a, r in zip(ours, ref):
        np.testing.assert_array_equal(a, r)


def test_marching_cubes_raises_without_surface():
    with pytest.raises(ValueError):
        tmc.marching_cubes(np.zeros((8, 8, 8), np.float32), LEVEL)
    idx = np.zeros(1, np.int32)
    with pytest.raises(ValueError):
        tmc.marching_cubes_bricks(idx, np.full((1, 64), -5, np.int8),
                                  (8, 8, 8), LEVEL, (1.0, 1.0, 1.0))
