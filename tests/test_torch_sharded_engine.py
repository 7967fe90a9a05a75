"""The port's PredictEngine on a device mesh, the counterpart of
tests/test_sharding.py's sharded JAX engines, on the CPU.

The port's engine on Mesh(["cpu"] * 4, ("data",)) and on a (2, 4)
("data", "space") mesh of "cpu" entries is held to the JAX engine on
Mesh(jax.devices()[:4], ("data",)) and on make_mesh_2d(2, 4), from the
same numpy inputs and carried weights, at HIGHEST: every encode output
within tests/test_torch_engine.py's bars, and the warp at the same
f16-rounded vertices within rtol 2e-3 / atol 1e-3.

Against its own one-device engine: each data shard equals the one-device
engine run on that shard's rows bit for bit (outputs, brick pages,
meshes and warp), and the one-device engine run on the whole batch within
1e-5 of each output's largest value (CPU 3D convolutions round by the
batch size: the U-Net's output moves by ~1.4e-6 of its largest value
between a batch of 1 and of 4, which is why one-shard-against-whole is
not bit-equal)."""
import pathlib
import sys

import numpy as np
import pytest
import torch
import jax
from jax.sharding import Mesh as JaxMesh

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_port_util as pu  # noqa: E402

from garmentnets_tpu.harness.predict_engine import (  # noqa: E402
    PredictEngine as JaxEngine)
from garmentnets_tpu.parallel.mesh import make_mesh_2d as jax_mesh_2d  # noqa: E402
from garmentnets_tpu_torch.core.weights import state_dict_from_jax  # noqa: E402
from garmentnets_tpu_torch.harness.predict_engine import PredictEngine  # noqa: E402
from garmentnets_tpu_torch.ops.marching_cubes import marching_cubes  # noqa: E402
from garmentnets_tpu_torch.parallel.mesh import Mesh  # noqa: E402

# test_torch_engine.py's bars
TOL = {"global_logits": dict(rtol=1e-3, atol=2e-4),
       "global_feature": dict(rtol=1e-3, atol=2e-4),
       "feature_volume": dict(rtol=1e-3, atol=5e-4),
       "wnf_volume": dict(rtol=1e-3, atol=5e-4),
       "wnf_ggm": dict(rtol=1e-3, atol=5e-4),
       "per_point_logits": dict(rtol=2e-3, atol=1e-3),
       "pred_nocs_confidence": dict(rtol=2e-3, atol=1e-3)}
MESHES = ("data4", "data2_space4")


def _sphere_meshes() -> list:
    """Two sphere meshes with f16-rounded vertices (the warp's queries)."""
    S = pu.VOL
    ax = np.linspace(0, 1, S, dtype=np.float32)
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)
    vol = np.linalg.norm(g - 0.5, axis=-1).astype(np.float32)
    out = []
    for r in (0.3, 0.35):
        v, f, _, _ = marching_cubes(vol, r, spacing=(1.0 / (S - 1),) * 3)
        out.append((v.astype(np.float16).astype(np.float32), f))
    return out


def _cat(enc: dict, key: str) -> torch.Tensor:
    return torch.cat([sh[key] for sh in enc["_shards"]])


@pytest.fixture(scope="module")
def setup():
    variables = pu.jax_variables()
    sd = state_dict_from_jax(variables)
    rng = np.random.RandomState(9)
    x4 = {"x": rng.rand(4, pu.N, 3).astype(np.float32),
          "pos": rng.rand(4, pu.N, 3).astype(np.float32) - 0.5}
    kw = dict(volume_size=pu.VOL, return_volume=True)
    one = PredictEngine(pu.torch_cfg(), sd, decode_precision="highest",
                        device="cpu", mc_threads=2, **kw)
    out = {}
    for name, jmesh, tmesh, x in (
            ("data4", JaxMesh(np.asarray(jax.devices()[:4]), ("data",)),
             Mesh(["cpu"] * 4, ("data",)), x4),
            ("data2_space4", jax_mesh_2d(2, 4),
             Mesh([["cpu"] * 4] * 2, ("data", "space")), pu.inputs())):
        jeng = JaxEngine(pu.jax_cfg(), variables, mesh=jmesh,
                         precision=jax.lax.Precision.HIGHEST, **kw)
        teng = PredictEngine(pu.torch_cfg(), sd, decode_precision="highest",
                             device="cpu", mc_threads=2, mesh=tmesh, **kw)
        tenc = teng.encode(x["x"], x["pos"])
        teng.prefetch(tenc, extra_keys=("pred_nocs",))
        out[name] = dict(jeng=jeng, teng=teng, x=x, tenc=tenc,
                         jenc=jeng.encode(x["x"], x["pos"]),
                         whole=one.encode(x["x"], x["pos"]))
    yield one, out
    one.close()
    for v in out.values():
        v["teng"].close()


@pytest.mark.parametrize("key", sorted(TOL))
@pytest.mark.parametrize("name", MESHES)
def test_sharded_encode_matches_jax_sharded_engine(setup, name, key):
    r = setup[1][name]
    ours = _cat(r["tenc"], key).numpy()
    ref = np.asarray(r["jenc"][key]).astype(np.float32)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, **TOL[key])


@pytest.mark.parametrize("name", MESHES)
def test_sharded_nocs_and_counts_match_jax(setup, name):
    """The NOCS bit for bit; the shipped brick counts on the "data" mesh.
    On a "space" axis the JAX engine ships more bricks than its own
    one-device engine does from the same field (26 against 10 a garment
    here); the port ships the one-device count on every mesh (held by
    test_each_shard_equals_the_one_device_engine_bit_for_bit)."""
    r = setup[1][name]
    np.testing.assert_array_equal(_cat(r["tenc"], "pred_nocs").numpy(),
                                  np.asarray(r["jenc"]["pred_nocs"]))
    if name == "data4":
        np.testing.assert_array_equal(
            _cat(r["tenc"], "active_counts").numpy(),
            np.asarray(r["jenc"]["active_counts"]))


@pytest.mark.parametrize("name", MESHES)
def test_each_shard_equals_the_one_device_engine_bit_for_bit(setup, name):
    one, out = setup
    r = out[name]
    n = r["teng"].n_data
    for i, sh in enumerate(r["tenc"]["_shards"]):
        rows = slice(i * len(r["x"]["x"]) // n,
                     (i + 1) * len(r["x"]["x"]) // n)
        ref = one.encode(r["x"]["x"][rows], r["x"]["pos"][rows])
        for k, v in ref.items():
            if k == "active_pages":
                assert all(torch.equal(a, b) for a, b in zip(sh[k], v))
            else:
                assert torch.equal(sh[k], v), k


@pytest.mark.parametrize("name", MESHES)
def test_sharded_encode_near_the_whole_batch_on_one_device(setup, name):
    r = setup[1][name]
    for key in ("wnf_volume", "wnf_ggm", "feature_volume", "pred_nocs",
                "per_point_logits", "global_feature"):
        ref = r["whole"][key].numpy()
        np.testing.assert_allclose(_cat(r["tenc"], key).numpy(), ref,
                                   rtol=0, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=key)


@pytest.mark.parametrize("name", MESHES)
def test_sharded_host_outputs_in_batch_order(setup, name):
    """host_outputs concatenates the shards' pinned copies: the pages keep
    each garment's count header, the extra keys their rows."""
    r = setup[1][name]
    host = r["teng"].host_outputs(r["tenc"])
    B = len(r["x"]["x"])
    assert host["pred_nocs"].shape == (B, pu.N, 3)
    torch.testing.assert_close(host["pred_nocs"],
                               _cat(r["tenc"], "pred_nocs"), rtol=0, atol=0)
    pages = host["active_pages"]
    assert all(p.shape[0] == B for p in pages)
    np.testing.assert_array_equal(
        pages[0][:, 0, :4].numpy().view(np.int32)[:, 0],
        _cat(r["tenc"], "active_counts").numpy())
    assert r["teng"].encode_done(r["tenc"])


@pytest.mark.parametrize("name", MESHES)
def test_sharded_meshes_and_warp_equal_per_shard_runs(setup, name):
    """extract_meshes and warp_batch walk the shards in batch order and
    give, garment by garment, the one-device engine's results on each
    shard's rows."""
    one, out = setup
    r = out[name]
    teng = r["teng"]
    meshes = teng.extract_meshes(r["tenc"])
    warps = teng.warp_batch(r["tenc"], meshes)
    n, B = teng.n_data, len(r["x"]["x"])
    assert len(meshes) == len(warps) == B
    assert any(m is not None for m in meshes)
    for i in range(n):
        rows = slice(i * B // n, (i + 1) * B // n)
        enc = one.encode(r["x"]["x"][rows], r["x"]["pos"][rows])
        ref_m = one.extract_meshes(enc)
        ref_w = one.warp_batch(enc, ref_m)
        for m, w, rm, rw in zip(meshes[rows], warps[rows], ref_m, ref_w):
            assert (m is None) == (rm is None) == (w is None)
            if m is None:
                continue
            for a, b in zip(m[:3], rm[:3]):
                np.testing.assert_array_equal(a, b)
            for k in rw:
                np.testing.assert_array_equal(w[k], rw[k])


@pytest.mark.parametrize("name", MESHES)
def test_sharded_warp_matches_jax_at_same_vertices(setup, name):
    r = setup[1][name]
    B = len(r["x"]["x"])
    meshes = (_sphere_meshes() * B)[:B]
    ours = r["teng"].warp_batch(r["tenc"], meshes)
    ref = r["jeng"].warp_batch(r["jenc"], meshes)
    for o, w, m in zip(ours, ref, meshes):
        assert o["warp_field"].shape == (len(m[0]), 3)
        for k in ("warp_field", "verts_ggm"):
            np.testing.assert_allclose(o[k], w[k].astype(np.float32),
                                       rtol=2e-3, atol=1e-3, err_msg=k)
