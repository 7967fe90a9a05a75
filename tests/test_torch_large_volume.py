"""The engine's large-volume option, per-brick straddle masks, against the
JAX package on the CPU.

- The masked brick pages (72-byte payloads, 76-byte records) are
  byte-identical to JAX's extract_active_bricks(with_masks=True) with
  pack_brick_pages(counts=...), at 32^3 and 64^3, and so is an overflowed
  cap.
- Host marching cubes with the masks gives bit-identical verts, faces,
  values and normals to the unmasked kernel; a whole 72-byte payload is
  split by marching_cubes_bricks, any other width refused.
- PredictEngine(cube_masks=None) ships masks exactly from volume_size 192
  on (checked on constructed engines: the CPU does not encode at 192^3).
- The port's engine with cube_masks=True at 32^3 and the JAX engine on the
  same WNF give identical meshes: its encode ships 76-byte records, its
  extract_meshes passes the masks to the kernel.
"""
import pathlib
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from scipy.ndimage import gaussian_filter

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_port_util as pu  # noqa: E402
from bench import _cloth_like_wnf  # noqa: E402

from garmentnets_tpu.harness.predict_engine import (  # noqa: E402
    PredictEngine as JaxEngine)
from garmentnets_tpu.ops import isosurface as jiso  # noqa: E402
from garmentnets_tpu_torch.core.weights import state_dict_from_jax  # noqa: E402
from garmentnets_tpu_torch.harness.predict_engine import PredictEngine  # noqa: E402
from garmentnets_tpu_torch.ops import isosurface as tiso  # noqa: E402
from garmentnets_tpu_torch.ops import marching_cubes as tmc  # noqa: E402

LEVEL = 0.5


def _smooth(S, seed, B=2):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(B):
        v = gaussian_filter(rng.rand(S, S, S), 1.5)
        out.append((v - v.min()) / (v.max() - v.min()))
    return np.stack(out).astype(np.float32)


def _cloth(S):
    w = _cloth_like_wnf(S)
    return np.stack([w, w[:, ::-1].copy()]).astype(np.float32)


CASES = [("smooth32", lambda: _smooth(32, 0), 512),
         ("cloth32", lambda: _cloth(32), 512),
         ("smooth64", lambda: _smooth(64, 1), 4096),
         ("cloth64", lambda: _cloth(64), 1024),
         ("smooth32_overflow", lambda: _smooth(32, 2), 64)]


def _masked(wnf, cap):
    return tiso.extract_active_bricks(torch.from_numpy(wnf), LEVEL, cap,
                                      with_masks=True)


@pytest.mark.parametrize("name,make,cap", CASES, ids=[c[0] for c in CASES])
def test_masked_pages_byte_identical(name, make, cap):
    wnf = make()
    ji, jv, jc = jiso.extract_active_bricks(jnp.asarray(wnf), LEVEL, cap,
                                            with_masks=True)
    ti, tv, tc = _masked(wnf, cap)
    assert tv.shape == (2, cap, 72) and tv.dtype == torch.int8
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    page = min(cap, 256)
    jpages = jiso.pack_brick_pages(ji, jv, page, counts=jc)
    tpages = tiso.pack_brick_pages(ti, tv, page, counts=tc)
    assert len(tpages) == len(jpages)
    assert tpages[0].shape == (2, page + 1, 76)
    for tp, jp in zip(tpages, jpages):
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    if name.endswith("overflow"):
        assert int(tc.max()) > cap
    # the values part is the unmasked extraction's
    _, uv, _ = tiso.extract_active_bricks(torch.from_numpy(wnf), LEVEL, cap)
    np.testing.assert_array_equal(tv[..., :64].numpy(), uv.numpy())


def test_mask_bits_are_the_straddling_cubes():
    """Bit loc of a brick's mask is set iff the cube whose origin is its
    local voxel loc straddles the level (numpy oracle)."""
    wnf = _smooth(16, 3, B=1)
    ti, tv, tc = _masked(wnf, 64)
    inside = wnf[0] > LEVEL
    S, nb = 16, 4
    for row in range(int(tc[0])):
        blk = int(ti[0, row])
        bx, by, bz = blk // (nb * nb), (blk // nb) % nb, blk % nb
        bits = np.unpackbits(tv[0, row, 64:].numpy().view(np.uint8),
                             bitorder="little")
        for loc in range(64):
            x = bx * 4 + (loc >> 4)
            y = by * 4 + ((loc >> 2) & 3)
            z = bz * 4 + (loc & 3)
            want = False
            if max(x, y, z) < S - 1:
                c = inside[x:x + 2, y:y + 2, z:z + 2]
                want = bool(c.any() and not c.all())
            assert bool(bits[loc]) == want, (row, loc)


@pytest.mark.parametrize("name,make,cap", CASES[:4],
                         ids=[c[0] for c in CASES[:4]])
def test_masked_marching_cubes_identical(name, make, cap):
    wnf = make()
    S = wnf.shape[1]
    spacing = (1.0 / (S - 1),) * 3
    ti, tv, tc = _masked(wnf, cap)
    pages = tiso.pack_brick_pages(ti, tv, min(cap, 256), counts=tc)
    idx, payload = tiso.unpack_brick_pages([p.numpy() for p in pages],
                                           header=True)
    vals, masks = tiso.split_brick_payload(payload)
    assert masks.dtype == np.uint8 and masks.shape[-1] == 8
    for b in range(len(tc)):
        n = int(tc[b])
        plain = tmc.marching_cubes_bricks(
            idx[b, :n], vals[b, :n], (S, S, S), LEVEL, spacing,
            return_values=True, return_normals=True)
        masked = tmc.marching_cubes_bricks(
            idx[b, :n], vals[b, :n], (S, S, S), LEVEL, spacing,
            return_values=True, return_normals=True, cube_masks=masks[b, :n])
        whole = tmc.marching_cubes_bricks(
            idx[b, :n], payload[b, :n], (S, S, S), LEVEL, spacing,
            return_values=True, return_normals=True)
        assert len(plain[0]) > 0
        for p, m, w in zip(plain, masked, whole):
            np.testing.assert_array_equal(m, p)
            np.testing.assert_array_equal(w, p)


@pytest.mark.parametrize("width", [63, 65, 68, 71, 73, 128])
def test_other_payload_widths_refused(width):
    idx = np.zeros(2, np.int32)
    with pytest.raises(ValueError, match="brick_vals_q"):
        tmc.marching_cubes_bricks(idx, np.zeros((2, width), np.int8),
                                  (8, 8, 8), LEVEL, (1.0,) * 3)
    with pytest.raises(ValueError, match="record width"):
        tiso.split_brick_payload(np.zeros((2, width), np.int8))


def test_cube_masks_shape_refused():
    idx = np.zeros(2, np.int32)
    with pytest.raises(ValueError, match="cube_masks"):
        tmc.marching_cubes_bricks(idx, np.zeros((2, 64), np.int8),
                                  (8, 8, 8), LEVEL, (1.0,) * 3,
                                  cube_masks=np.zeros((2, 4), np.uint8))


@pytest.fixture(scope="module")
def state():
    from garmentnets_tpu_torch.models.pipeline import (
        ConvImplicitWNFPipeline)
    return ConvImplicitWNFPipeline(pu.torch_cfg()).state_dict()


@pytest.mark.parametrize("vol,option,want", [
    (128, None, False), (188, None, False), (192, None, True),
    (256, None, True), (256, False, False), (64, True, True)])
def test_engine_mask_rule(state, vol, option, want):
    """Constructed engines only (no encode): masks exactly from 192 on
    unless the option says otherwise."""
    eng = PredictEngine(pu.torch_cfg(), state, volume_size=vol,
                        cube_masks=option, mc_threads=1, device="cpu")
    assert eng.cube_masks is want


@pytest.fixture(scope="module")
def masked_engines():
    S = 32
    x = pu.inputs()
    variables = pu.live_head(pu.jax_variables(), x["x"], x["pos"], S)
    teng = PredictEngine(pu.torch_cfg(), state_dict_from_jax(variables),
                         volume_size=S, return_volume=True, cube_masks=True,
                         decode_precision="highest", mc_threads=2,
                         device="cpu")
    jeng = JaxEngine(pu.jax_cfg(), variables, volume_size=S)
    tenc = teng.encode(x["x"], x["pos"])
    yield jeng, teng, tenc
    teng.close()


def test_engine_with_masks_matches_jax_engine(masked_engines):
    """The port's encode ships masked pages of its WNF; the JAX engine's
    extract_meshes on JAX's masked pages of the same WNF gives the same
    meshes as the port's."""
    jeng, teng, tenc = masked_engines
    pages = tenc["active_pages"]
    assert pages[0].shape[-1] == 76
    wnf = tenc["wnf_volume"].numpy()
    ji, jv, jc = jiso.extract_active_bricks(jnp.asarray(wnf), LEVEL,
                                            jeng.brick_cap, with_masks=True)
    jpages = jiso.pack_brick_pages(ji, jv, jeng.brick_page, counts=jc)
    assert (teng.brick_cap, teng.brick_page) == (jeng.brick_cap,
                                                 jeng.brick_page)
    for tp, jp in zip(pages, jpages):
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    ours = teng.extract_meshes(tenc)
    ref = jeng.extract_meshes({"active_pages": jpages, "active_counts": jc})
    assert all(m is not None for m in ours)
    for o, r in zip(ours, ref):
        assert len(o) == len(r) == 4
        for a, b in zip(o, r):
            np.testing.assert_array_equal(a, b)
    # and the same meshes as the engine without masks
    plain = PredictEngine(pu.torch_cfg(), teng.model.state_dict(),
                          volume_size=32, cube_masks=False,
                          decode_precision="highest", mc_threads=1,
                          device="cpu")
    ti, tv, tc = tiso.extract_active_bricks(tenc["wnf_volume"], LEVEL,
                                            plain.brick_cap)
    unmasked = plain.extract_meshes({"active_pages": tiso.pack_brick_pages(
        ti, tv, plain.brick_page, counts=tc)})
    for o, u in zip(ours, unmasked):
        for a, b in zip(o, u):
            np.testing.assert_array_equal(a, b)
