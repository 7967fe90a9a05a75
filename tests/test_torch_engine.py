"""The port's PredictEngine end to end vs the JAX PredictEngine at HIGHEST
precision, on a tiny configuration with the same weights (carried by
core/weights.py): encode outputs within the stage bars, and warp values at
the same f16-rounded mesh vertices within rtol 2e-3 (the JAX engine returns
f16)."""
import pathlib
import sys

import numpy as np
import pytest
import torch
import jax

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_port_util as pu  # noqa: E402

from garmentnets_tpu.harness.predict_engine import (  # noqa: E402
    PredictEngine as JaxEngine)
from garmentnets_tpu_torch.core.weights import state_dict_from_jax  # noqa: E402
from garmentnets_tpu_torch.harness.predict_engine import PredictEngine  # noqa: E402
from garmentnets_tpu_torch.ops.marching_cubes import marching_cubes  # noqa: E402


@pytest.fixture(scope="module")
def engines():
    variables = pu.jax_variables()
    x = pu.inputs()
    jeng = JaxEngine(pu.jax_cfg(), variables, volume_size=pu.VOL,
                     return_volume=True,
                     precision=jax.lax.Precision.HIGHEST)
    teng = PredictEngine(pu.torch_cfg(), state_dict_from_jax(variables),
                         volume_size=pu.VOL, return_volume=True,
                         mc_threads=2, device="cpu")
    jenc = jeng.encode(x["x"], x["pos"])
    tenc = teng.encode(x["x"], x["pos"])
    yield jeng, teng, jenc, tenc
    teng.close()


def test_encode_nocs_identical(engines):
    _, _, jenc, tenc = engines
    np.testing.assert_array_equal(tenc["pred_nocs"].numpy(),
                                  np.asarray(jenc["pred_nocs"]))


@pytest.mark.parametrize("key,tol", [
    ("global_logits", dict(rtol=1e-3, atol=2e-4)),
    ("global_feature", dict(rtol=1e-3, atol=2e-4)),
    ("feature_volume", dict(rtol=1e-3, atol=5e-4)),
    ("wnf_volume", dict(rtol=1e-3, atol=5e-4)),
    ("wnf_ggm", dict(rtol=1e-3, atol=5e-4)),
    # the JAX engine ships these two as f16
    ("per_point_logits", dict(rtol=2e-3, atol=1e-3)),
    ("pred_nocs_confidence", dict(rtol=2e-3, atol=1e-3)),
])
def test_encode_outputs_match(engines, key, tol):
    _, _, jenc, tenc = engines
    ours = tenc[key].numpy()
    ref = np.asarray(jenc[key]).astype(np.float32)
    assert ours.shape == ref.shape
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, **tol)


def test_encode_pages_well_formed(engines):
    """Pages carry the counts header and span the brick cap."""
    _, teng, jenc, tenc = engines
    pages = tenc["active_pages"]
    assert pages[0].shape == (pu.B, teng.brick_page + 1, 68)
    assert sum(p.shape[1] for p in pages) == teng.brick_cap + 1
    np.testing.assert_array_equal(
        pages[0][:, 0, :4].numpy().view(np.int32)[:, 0],
        tenc["active_counts"].numpy())


def test_warp_matches_at_same_vertices(engines):
    jeng, teng, jenc, tenc = engines
    S = pu.VOL
    ax = np.linspace(0, 1, S, dtype=np.float32)
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)
    meshes = []
    for r in (0.3, 0.35):
        vol = np.linalg.norm(g - 0.5, axis=-1).astype(np.float32)
        v, f, _, _ = marching_cubes(vol, r, spacing=(1.0 / (S - 1),) * 3)
        meshes.append((v.astype(np.float16).astype(np.float32), f))
    ours = teng.warp_batch(tenc, meshes)
    ref = jeng.warp_batch(jenc, meshes)
    for o, r, m in zip(ours, ref, meshes):
        assert o["warp_field"].shape == (len(m[0]), 3)
        np.testing.assert_allclose(
            o["warp_field"], r["warp_field"].astype(np.float32),
            rtol=2e-3, atol=1e-3)
        np.testing.assert_allclose(
            o["verts_ggm"], r["verts_ggm"].astype(np.float32),
            rtol=2e-3, atol=1e-3)


def test_warp_skips_garments_without_mesh(engines):
    _, teng, _, tenc = engines
    verts = np.random.RandomState(0).rand(10, 3).astype(np.float32)
    out = teng.warp_batch(tenc, [None, (verts, None)])
    assert out[0] is None and out[1]["warp_field"].shape == (10, 3)
    assert teng.warp_batch(tenc, [None, None]) == [None, None]


def test_extract_meshes_on_engine_pages(engines):
    """extract_meshes on pages of a WNF with a surface: the same meshes as
    marching the bricks directly."""
    _, teng, _, tenc = engines
    from garmentnets_tpu_torch.ops.isosurface import (
        extract_active_bricks, pack_brick_pages)
    S = pu.VOL
    ax = np.linspace(0, 1, S, dtype=np.float32)
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)
    wnf = 1.0 - np.linalg.norm(g - 0.5, axis=-1) / 0.6
    wnf = torch.from_numpy(np.stack([wnf, wnf[::-1].copy()]).astype(
        np.float32))
    base, vals, counts = extract_active_bricks(wnf, 0.5, teng.brick_cap)
    enc = dict(tenc, active_pages=pack_brick_pages(
        base, vals, teng.brick_page, counts=counts))
    meshes = teng.extract_meshes(enc)
    assert all(m is not None and len(m[0]) > 0 and len(m) == 4
               for m in meshes)
    w = teng.warp_batch(enc, meshes)
    assert all(np.isfinite(r["warp_field"]).all() for r in w)


def test_extract_meshes_overflow_falls_back_to_dense_mc(engines):
    """More shipped bricks than the cap: full-volume marching cubes on the
    dense WNF, as in the JAX engine."""
    from garmentnets_tpu_torch.ops.isosurface import (
        extract_active_bricks, pack_brick_pages)
    S = 32
    eng = PredictEngine(pu.torch_cfg(), engines[1].model.state_dict(),
                        volume_size=S, active_cap=512, mc_threads=1,
                        device="cpu")
    assert eng.brick_cap == 64
    ax = np.linspace(0, 1, S, dtype=np.float32)
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)
    wnf = (1.0 - np.linalg.norm(g - 0.5, axis=-1) / 0.8).astype(np.float32)
    wnf_t = torch.from_numpy(np.stack([wnf, wnf]))
    base, vals, counts = extract_active_bricks(wnf_t, 0.5, eng.brick_cap)
    assert int(counts.max()) > eng.brick_cap
    enc = {"active_pages": pack_brick_pages(base, vals, eng.brick_page,
                                            counts=counts),
           "wnf_volume": wnf_t}
    meshes = eng.extract_meshes(enc)
    ref = marching_cubes(wnf, 0.5, spacing=(1.0 / (S - 1),) * 3)
    for m in meshes:
        np.testing.assert_array_equal(m[0], ref[0])          # verts
        np.testing.assert_array_equal(m[1], ref[1])          # faces
        np.testing.assert_array_equal(m[2], ref[3])          # values
        np.testing.assert_array_equal(m[3], ref[2])          # normals


def test_engine_defaults_to_cuda_and_raises_without_it(engines):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    variables_sd = engines[1].model.state_dict()
    with pytest.raises(RuntimeError, match="CUDA"):
        PredictEngine(pu.torch_cfg(), variables_sd, volume_size=pu.VOL)


def test_full_f32_pins_and_restores():
    from garmentnets_tpu_torch.core.device import full_f32
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with full_f32():
            assert torch.get_float32_matmul_precision() == "highest"
            assert not torch.backends.cudnn.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)


@pytest.mark.parametrize("method", ["encode", "warp_dispatch"])
def test_engine_runs_in_full_f32(engines, monkeypatch, method):
    """encode and the warp keep TF32 off even when the caller allows it."""
    _, teng, _, tenc = engines
    seen = []

    class Stop(Exception):
        pass

    def spy(*args, **kwargs):
        seen.append(torch.get_float32_matmul_precision())
        raise Stop

    target = ("pointnet2_forward" if method == "encode"
              else "surface_decoder_forward")
    monkeypatch.setattr(teng.model, target, spy)
    args = ((np.zeros((1, 8, 3), np.float32),) * 2 if method == "encode"
            else (tenc, [(np.zeros((4, 3), np.float32), None)] * 2))
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(Stop):
            getattr(teng, method)(*args)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert seen == ["highest"]
