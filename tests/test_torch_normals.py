"""Device normals (ops/normals.py and PredictEngine(device_normals=True))
against the JAX package on the CPU.

- Octahedral codes: identical to the 16 bits that JAX's oct_encode_f16
  bitcasts into its f16 lane, on the same unit vectors; oct_decode_np
  identical on all 65536 codes, also read back from the float32 lane the
  port's warp buffer carries them in.
- dense_gradient within 1e-6 of JAX's (and of np.gradient).
- sample_gradient_normals_oct on the same WNF and points: codes equal at
  >= 99.9% of the points and within one count per byte elsewhere (XLA may
  contract the trilinear sums into other roundings).
- The engine with device normals against the JAX engine with device
  normals at 32^3 on the same WNF and feature volume: the same verts, host
  normals absent, warp normals within 1 degree.
- The predict CLI with prediction.device_normals=true against the JAX CLI
  on one synthetic dataset: marching_cubes_mesh/normals unit length and
  within 1 degree at every vertex the two meshes share (the meshes agree
  as tests/test_torch_predict.py holds them).
- The server's reply carries the warp's normals, and its CLI passes
  prediction.device_normals to the engine.
"""
import pathlib
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_port_util as pu  # noqa: E402
import test_torch_predict as tpp  # noqa: E402

from garmentnets_tpu.harness.predict import main as jax_predict_main  # noqa: E402
from garmentnets_tpu.harness.predict_engine import (  # noqa: E402
    PredictEngine as JaxEngine)
from garmentnets_tpu.ops import isosurface as jiso  # noqa: E402
from garmentnets_tpu.ops import normals as jn  # noqa: E402
from garmentnets_tpu_torch.core.checkpoint import save_pipeline_checkpoint  # noqa: E402
from garmentnets_tpu_torch.core.weights import state_dict_from_jax  # noqa: E402
from garmentnets_tpu_torch.harness import predict, serve  # noqa: E402
from garmentnets_tpu_torch.harness.predict_engine import PredictEngine  # noqa: E402
from garmentnets_tpu_torch.ops import normals as tn  # noqa: E402

ONE_DEGREE = 1.0


def _angles_deg(a, b):
    d = np.clip(np.sum(a * b, axis=-1), -1.0, 1.0)
    return np.degrees(np.arccos(d))


def _jax_codes(col_f16) -> np.ndarray:
    return np.asarray(col_f16).view(np.uint16).astype(np.int64)


def _unit_vectors():
    rng = np.random.RandomState(0)
    n = rng.randn(20000, 3).astype(np.float32)
    eye = np.eye(3, dtype=np.float32)
    # axes, the equator (z = 0 exactly) and both folds' diagonals
    extra = np.concatenate([eye, -eye, [[1, 1, 0], [-1, 1, 0], [1, -1, 0],
                                        [1, 1, -1e-7], [0, 1, -1],
                                        [-1, 0, -1], [1, 1, -1]]])
    n = np.concatenate([n, extra.astype(np.float32)])
    return n / np.linalg.norm(n, axis=-1, keepdims=True)


def test_oct_codes_identical_to_jax():
    n = _unit_vectors()
    want = _jax_codes(jn.oct_encode_f16(jnp.asarray(n))[..., 0])
    got = tn.oct_encode(torch.from_numpy(n)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_oct_decode_identical_to_jax_on_every_code():
    codes = np.arange(65536, dtype=np.uint16)
    want = jn.oct_decode_np(codes.view(np.float16))
    np.testing.assert_array_equal(tn.oct_decode_np(codes), want)
    # the warp buffer's float32 lane holds each code exactly
    lane = codes.astype(np.float32)
    np.testing.assert_array_equal(lane.astype(np.uint16), codes)
    np.testing.assert_array_equal(tn.oct_decode_np(lane), want)


def test_dense_gradient_matches_jax():
    rng = np.random.RandomState(1)
    vol = rng.rand(2, 9, 10, 11).astype(np.float32)
    got = tn.dense_gradient(torch.from_numpy(vol)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jn.dense_gradient(jnp.asarray(vol))), rtol=0,
        atol=1e-6)
    for b in range(2):
        np.testing.assert_allclose(got[b], np.stack(np.gradient(vol[b]), -1),
                                   rtol=0, atol=1e-6)


def _sphere(S):
    x, y, z = np.mgrid[:S, :S, :S] / (S - 1.0)
    return (1.0 - 2.0 * np.sqrt(
        (x - .5) ** 2 + (y - .5) ** 2 + (z - .55) ** 2)).astype(np.float32)


@pytest.mark.parametrize("ascent", [True, False])
def test_sampled_codes_match_jax(ascent):
    rng = np.random.RandomState(2)
    S = 24
    wnf = np.stack([_sphere(S), 0.45 + 0.1 * rng.rand(S, S, S)
                    ]).astype(np.float32)
    q = rng.rand(2, 4000, 3).astype(np.float16).astype(np.float32)
    q[:, :8] = np.array([[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0, 0.25],
                         [0.5, 0.5, 0.5], [1, 1, 0], [0, 0, 1],
                         [0.25, 1, 1]], np.float32)
    want = _jax_codes(jn.sample_gradient_normals_oct(
        jnp.asarray(wnf), jnp.asarray(q), ascent=ascent)[..., 0])
    got = tn.sample_gradient_normals_oct(torch.from_numpy(wnf),
                                         torch.from_numpy(q), ascent).numpy()
    same = got == want
    assert same.mean() >= 0.999, same.mean()
    diff = np.maximum(np.abs((got & 255) - (want & 255)),
                      np.abs((got >> 8) - (want >> 8)))
    assert diff.max() <= 1, diff.max()


@pytest.fixture(scope="module")
def jax_vars():
    """One JAX init for the module (each user copies before editing)."""
    return pu.jax_variables()


@pytest.fixture(scope="module")
def normal_engines(jax_vars):
    S = 32
    x = pu.inputs()
    variables = pu.live_head(jax_vars, x["x"], x["pos"], S)
    teng = PredictEngine(pu.torch_cfg(), state_dict_from_jax(variables),
                         volume_size=S, device_normals=True,
                         decode_precision="highest", mc_threads=2,
                         device="cpu")
    jeng = JaxEngine(pu.jax_cfg(), variables, volume_size=S,
                     device_normals=True)
    tenc = teng.encode(x["x"], x["pos"])
    yield jeng, teng, tenc
    teng.close()


def test_engine_device_normals_match_jax_engine(normal_engines):
    jeng, teng, tenc = normal_engines
    assert "wnf_volume" in tenc and not teng.cube_masks
    wnf = jnp.asarray(tenc["wnf_volume"].numpy())
    ji, jv, jc = jiso.extract_active_bricks(wnf, 0.5, jeng.brick_cap)
    jenc = {"active_pages": jiso.pack_brick_pages(ji, jv, jeng.brick_page,
                                                  counts=jc),
            "active_counts": jc, "wnf_volume": wnf,
            "feature_volume": jnp.asarray(tenc["feature_volume"].numpy()),
            "wnf_ggm": jnp.asarray(tenc["wnf_ggm"].numpy())}
    ours = teng.extract_meshes(tenc)
    ref = jeng.extract_meshes(jenc)
    tw = teng.warp_batch(tenc, ours)
    jw = jeng.warp_batch(jenc, ref)
    for o, r, a, b in zip(ours, ref, tw, jw):
        assert o is not None and o[3] is None and r[3] is None
        np.testing.assert_array_equal(o[0], r[0])
        np.testing.assert_array_equal(o[1], r[1])
        n = a["normals"]
        assert n.shape == o[0].shape and n.dtype == np.float32
        np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0,
                                   atol=1e-6)
        ang = _angles_deg(n, b["normals"])
        assert ang.max() <= ONE_DEGREE, ang.max()


def test_warp_lane_carries_the_exact_codes(normal_engines):
    """The decoded normals are those of the codes the warp computed."""
    _, teng, tenc = normal_engines
    meshes = teng.extract_meshes(tenc)
    warps = teng.warp_batch(tenc, meshes)
    for b, (m, w) in enumerate(zip(meshes, warps)):
        q = torch.from_numpy(m[0].astype(np.float16).astype(np.float32))
        codes = tn.sample_gradient_normals_oct(
            tenc["wnf_volume"][b:b + 1], q[None], True)[0].numpy()
        np.testing.assert_array_equal(w["normals"], tn.oct_decode_np(codes))


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory, jax_vars):
    from garmentnets_tpu.core.builders import pipeline_hparams
    from garmentnets_tpu.core.checkpoint import save_checkpoint
    from garmentnets_tpu_torch.data.dataset import ConvImplicitWNFDataModule
    from garmentnets_tpu_torch.data.synthetic import generate_dataset
    from tools import export_checkpoint
    d = tmp_path_factory.mktemp("normals_cli")
    zarr = str(d / "data.zarr")
    generate_dataset(zarr, num_instances=4, grips_per_instance=2,
                     volume_size=tpp.VOL, mesh_res=8, pts_per_view=200,
                     seed=0, include_task_space=False)
    dm = ConvImplicitWNFDataModule(zarr_path=zarr, **tpp.DM)
    dm.prepare_data()
    batch = next(iter(dm.test_dataloader()))
    variables = tpp._live_head(jax_vars, batch["x"], batch["pos"])
    msgpack = d / "pipeline.msgpack"
    save_checkpoint(msgpack, {"params": variables["params"],
                              "batch_stats": variables["batch_stats"],
                              "step": 0},
                    hparams=pipeline_hparams(pu.jax_cfg()))
    ckpt = d / "pipeline.ckpt"
    export_checkpoint.main(str(msgpack), str(ckpt))
    setup = {"zarr": zarr, "msgpack": msgpack, "ckpt": ckpt}
    pred = {"device_normals": True}
    runs = {}
    for side, main in (("jax", jax_predict_main), ("torch", predict.main)):
        runs[side] = pathlib.Path(main(tpp._cfg(setup, side, pred=pred),
                                       run_dir=str(d / side)))
    return tpp._arrays(runs["jax"]), tpp._arrays(runs["torch"])


def test_predict_cli_device_normals_match_jax_cli(cli_runs):
    ja, ta = cli_runs
    samples = sorted({k.split("/")[0] for k in ta})
    assert len(samples) == 4
    compared = 0
    for s in samples:
        mc = f"{s}/marching_cubes_mesh/"
        np.testing.assert_array_equal(ta[mc + "faces"], ja[mc + "faces"])
        tv, jv = ta[mc + "verts"], ja[mc + "verts"]
        tnorm, jnorm = ta[mc + "normals"], ja[mc + "normals"]
        assert tnorm.shape == tv.shape and tnorm.dtype == np.float32
        np.testing.assert_allclose(np.linalg.norm(tnorm, axis=-1), 1.0,
                                   atol=1e-6)
        same = np.abs(tv - jv).max(axis=-1) <= 1e-4
        assert same.mean() >= 0.99, same.mean()
        ang = _angles_deg(tnorm[same], jnorm[same])
        assert ang.max() <= ONE_DEGREE, ang.max()
        compared += int(same.sum())
    assert compared > 100


def test_refused_flag_values_name_the_key():
    from garmentnets_tpu_torch.core.config import optional_flag
    assert optional_flag({"prediction": {}}, "prediction.device_normals") \
        is False
    assert optional_flag({"prediction": {"device_normals": None}},
                         "prediction.device_normals") is False
    assert optional_flag({"prediction": {"device_normals": True}},
                         "prediction.device_normals") is True
    with pytest.raises(ValueError, match="prediction.device_normals"):
        optional_flag({"prediction": {"device_normals": 1}},
                      "prediction.device_normals")


@pytest.fixture(scope="module")
def service(tmp_path_factory, jax_vars):
    x = pu.inputs()
    variables = pu.live_head(jax_vars, x["x"], x["pos"], pu.VOL)
    ckpt = tmp_path_factory.mktemp("normals_serve") / "pipeline.ckpt"
    save_pipeline_checkpoint(ckpt, pu.torch_cfg(),
                             state_dict_from_jax(variables))
    svc = serve.PredictService(
        ckpt, batch_size=pu.B, num_points=pu.N, volume_size=pu.VOL,
        batch_window_ms=5.0, device="cpu",
        engine_kwargs={"device_normals": True, "mc_threads": 1,
                       "decode_precision": "highest"})
    yield svc, x
    svc.close()


def test_server_reply_carries_warp_normals(service):
    svc, x = service
    replies = svc.submit(x["x"], x["pos"])
    eng = svc.engine
    enc = eng.encode(x["x"], x["pos"])
    meshes = eng.extract_meshes(enc)
    warps = eng.warp_batch(enc, meshes)
    for r, m, w in zip(replies, meshes, warps):
        assert int(r["ok"]) == 1 and m[3] is None
        np.testing.assert_array_equal(r["verts"], m[0])
        np.testing.assert_array_equal(r["normals"], w["normals"])


def test_server_cli_passes_device_normals(monkeypatch):
    seen = {}

    class Stop(Exception):
        pass

    def fake_service(*args, **kwargs):
        seen.update(kwargs["engine_kwargs"])
        raise Stop

    monkeypatch.setattr(serve, "PredictService", fake_service)
    cfg = {"main": {"checkpoint_path": "unused.ckpt"},
           "prediction": {"device_normals": True}}
    with pytest.raises(Stop):
        serve.main(cfg)
    assert seen["device_normals"] is True
    with pytest.raises(Stop):
        serve.main({"main": {"checkpoint_path": "unused.ckpt"}})
    assert seen["device_normals"] is False
