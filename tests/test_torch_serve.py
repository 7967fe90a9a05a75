"""The port's inference server (harness/serve.py) on the CPU.

The same requests go to the JAX PredictService (on the JAX package's
msgpack checkpoint, HIGHEST precision) and to the port's (on that
checkpoint exported by tools/export_checkpoint.py): the ok flags and NOCS
bins must be identical, and meshes and warp values agree within the
tolerances of test_torch_engine.py. The port's service also gets the HTTP
round trip, concurrent clients, resampling, failure isolation, bad
requests, /healthz and a hot reload whose new volume-decoder weights must
reach the decoded WNF.

On a device mesh (the counterpart of tests/test_serve.py's
test_service_with_device_mesh): the port's service on Mesh(["cpu"] * 2,
("data",)) and on a (2, 2) ("data", "space") mesh answers the requests of
two client threads at once; each of its device batches equals, shard by
shard, the one-device engine run on that shard's rows bit for bit, every
served output lies within 1e-5 of its largest value of the one-device
service's on the same requests, and the results match the JAX service on
JAX's 2-device CPU mesh at test_results_match_jax_service's bars.

The tiny pipeline's volume-decoder head is set to relu(z + b) with b
chosen so that about 10% of the voxels of the first request lie above the
iso level, so that marching cubes and the warp have surfaces to work on.
"""
import copy
import dataclasses
import json
import pathlib
import sys
import threading
from urllib.error import HTTPError
from urllib.request import Request, urlopen

import numpy as np
import pytest
import jax

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_port_util as pu  # noqa: E402

from garmentnets_tpu.core.builders import pipeline_hparams  # noqa: E402
from garmentnets_tpu.core.checkpoint import save_checkpoint  # noqa: E402
from garmentnets_tpu.harness import serve as jax_serve  # noqa: E402
from garmentnets_tpu_torch.core.checkpoint import (  # noqa: E402
    load_pipeline_checkpoint, save_pipeline_checkpoint)
from garmentnets_tpu_torch.core.weights import state_dict_from_jax  # noqa: E402
from garmentnets_tpu_torch.harness import serve  # noqa: E402
from garmentnets_tpu_torch.harness.predict_engine import PredictEngine  # noqa: E402
from tools import export_checkpoint  # noqa: E402

BATCH, POINTS = 4, pu.N


def _requests():
    rng = np.random.RandomState(3)

    def req(b, n):
        return (rng.rand(b, n, 3).astype(np.float32),
                (rng.rand(b, n, 3) - 0.5).astype(np.float32))
    # exact size, oversized (subsampled), undersized (repeat-padded)
    return [req(2, POINTS), req(3, 400), req(1, 200)]


def _padded(x, pos):
    """The service's zero-padded batch of one request alone."""
    bx = np.zeros((BATCH, POINTS, 3), np.float32)
    bp = np.zeros((BATCH, POINTS, 3), np.float32)
    for b in range(len(x)):
        bx[b], bp[b] = serve._normalize_cloud(x[b], pos[b], POINTS, seed=b)
    return bx, bp


def _live_head(variables, x, pos, share=0.1, shift=0.0):
    """The volume decoder head as relu(z + b) (identity BatchNorm), with b
    putting `share` of the voxels of (x, pos) above 0.5 (+ shift)."""
    v = copy.deepcopy(variables)
    head = v["params"]["volume_decoder"]["mlp"]
    head["bn_1"]["scale"][:] = 1.0
    head["bn_1"]["bias"][:] = 0.0
    v["batch_stats"]["volume_decoder"]["mlp"]["bn_1"]["mean"][:] = 0.0
    v["batch_stats"]["volume_decoder"]["mlp"]["bn_1"]["var"][:] = 1 - 1e-5
    head["dense_1"]["bias"][:] = 100.0
    probe = PredictEngine(pu.torch_cfg(), state_dict_from_jax(v),
                          volume_size=pu.VOL, return_volume=True,
                          decode_precision="highest", mc_threads=1,
                          device="cpu")
    z = probe.encode(x, pos)["wnf_volume"].numpy() - 100.0
    head["dense_1"]["bias"][:] = 0.5 + shift - np.quantile(z, 1 - share)
    return v


def _write(d, name, variables):
    msgpack = d / f"{name}.msgpack"
    save_checkpoint(msgpack, {"params": variables["params"],
                              "batch_stats": variables["batch_stats"],
                              "step": 0},
                    hparams=pipeline_hparams(pu.jax_cfg()))
    ckpt = d / f"{name}.ckpt"
    export_checkpoint.main(str(msgpack), str(ckpt))
    return msgpack, ckpt


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    req = _requests()[0]
    variables = _live_head(pu.jax_variables(), *_padded(*req))
    moved = _live_head(pu.jax_variables(), *_padded(*req), shift=0.05)
    return {"main": _write(d, "main", variables),
            "moved": _write(d, "moved", moved)}


def _service(ckpt, **kw):
    return serve.PredictService(ckpt, batch_size=BATCH, num_points=POINTS,
                                volume_size=pu.VOL, batch_window_ms=30.0,
                                device="cpu", **kw)


@pytest.fixture(scope="module")
def service(ckpts):
    svc = _service(ckpts["main"][1],
                   engine_kwargs={"decode_precision": "highest"})
    yield svc
    svc.close()


@pytest.fixture(scope="module")
def both_results(ckpts, service):
    jsvc = jax_serve.PredictService(
        ckpts["main"][0], batch_size=BATCH, num_points=POINTS,
        volume_size=pu.VOL, batch_window_ms=30.0,
        engine_kwargs={"precision": jax.lax.Precision.HIGHEST,
                       "warp_bucket": 64})
    try:
        out = [(jsvc.submit(x, pos), service.submit(x, pos))
               for x, pos in _requests()]
    finally:
        jsvc.close()
    # the port's warp at the JAX service's vertices rounded to f16
    warps16 = _warps_at_jax_vertices(service.cfg,
                                     service.engine.model.state_dict(),
                                     [j for j, _ in out])
    return [(j, t, w) for (j, t), w in zip(out, warps16)]


def _warps_at_jax_vertices(cfg, state_dict, jax_results) -> list:
    """The port's warp at each JAX result's vertices rounded to f16 (the
    queries the JAX engine evaluates, its wire format), on a separate
    one-device engine, request by request."""
    eng = PredictEngine(cfg, state_dict, volume_size=pu.VOL,
                        decode_precision="highest", mc_threads=1,
                        device="cpu")
    warps16 = []
    for (x, pos), jres in zip(_requests(), jax_results):
        enc = eng.encode(*_padded(x, pos))
        warps16.append(eng.warp_batch(enc, [
            (j["verts"].astype(np.float16).astype(np.float32), None)
            if int(j["ok"]) else None for j in jres]))
    return warps16


def _check_against_jax(both: list) -> int:
    """(JAX results, the port's results, the port's warps at the JAX
    vertices) of each request at test_results_match_jax_service's bars;
    returns how many garments had a surface."""
    n_ok = 0
    for jres, tres, warps16 in both:
        assert len(jres) == len(tres)
        for j, t, w in zip(jres, tres, warps16):
            assert int(t["ok"]) == int(j["ok"])
            np.testing.assert_array_equal(t["pred_nocs"], j["pred_nocs"])
            np.testing.assert_allclose(t["pred_nocs_confidence"],
                                       j["pred_nocs_confidence"],
                                       rtol=2e-3, atol=1e-3)
            if not int(t["ok"]):
                continue
            n_ok += 1
            np.testing.assert_array_equal(t["faces"], j["faces"])
            np.testing.assert_allclose(t["verts"], j["verts"], rtol=2e-3,
                                       atol=1e-3)
            # normals and values come from the int8-quantized bricks: where
            # the two WNFs (within ~1e-6) straddle a rounding boundary, a
            # brick value moves by one level (1/254), which moves nearby
            # normals by up to ~1e-2; elsewhere they agree within 1e-3
            for k in ("normals", "volume_value"):
                err = np.abs(t[k] - j[k])
                assert err.max() <= 1e-2, k
                assert (err <= 1e-3).mean() >= 0.99, k
            for k in ("warp_field", "verts_ggm"):
                np.testing.assert_allclose(w[k], j[k], rtol=2e-3, atol=1e-3,
                                           err_msg=k)
    return n_ok


def test_results_match_jax_service(both_results):
    """Meshes, normals and volume values as served; the warp field and the
    ggm at the vertices through the port's warp at the f16-rounded JAX
    vertices, the queries the JAX engine evaluates (the served port warp
    equals the port engine's at its own f32 vertices:
    test_submit_matches_engine_on_padded_batch)."""
    assert _check_against_jax(both_results) >= 4   # most have a surface


def test_normalize_cloud_matches_jax():
    rng = np.random.RandomState(0)
    for n in (100, 256, 700):
        x = rng.rand(n, 3).astype(np.float32)
        p = rng.rand(n, 3).astype(np.float32)
        for a, b in zip(serve._normalize_cloud(x, p, 256, seed=2),
                        jax_serve._normalize_cloud(x, p, 256, seed=2)):
            np.testing.assert_array_equal(a, b)


def test_submit_matches_engine_on_padded_batch(service):
    """A request alone equals encode -> extract_meshes -> warp_batch on the
    same normalized, zero-padded batch."""
    x, pos = _requests()[1]
    got = service.submit(x, pos)
    eng = PredictEngine(service.cfg, service.engine.model.state_dict(),
                        volume_size=pu.VOL, decode_precision="highest",
                        mc_threads=1, device="cpu")
    enc = eng.encode(*_padded(x, pos))
    meshes = eng.extract_meshes(enc)
    warps = eng.warp_batch(enc, meshes)
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g["pred_nocs"],
                                      enc["pred_nocs"][i].numpy())
        assert int(g["ok"]) == int(meshes[i] is not None)
        if int(g["ok"]):
            np.testing.assert_array_equal(g["verts"], meshes[i][0])
            np.testing.assert_array_equal(g["faces"], meshes[i][1])
            np.testing.assert_array_equal(g["warp_field"],
                                          warps[i]["warp_field"])


def test_http_roundtrip_and_healthz(service):
    httpd = serve.make_http_server(service, host="127.0.0.1", port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urlopen(url + "/healthz") as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok" and health["batch_size"] == BATCH
        assert health["num_points"] == POINTS
        assert health["device"] == "cpu"
        assert health["requests"] >= 0 and "mc_overlapped" in health
        x, pos = _requests()[0]
        remote = serve.predict_remote(url, x, pos)
        direct = service.submit(x, pos)
        assert len(remote) == len(direct) == 2
        for r, d in zip(remote, direct):
            assert sorted(r) == sorted(d)
            for k in d:
                np.testing.assert_array_equal(r[k], d[k], err_msg=k)
        # a malformed body and wrong shapes come back as 400 with the error
        for body in (b"not an npz", serve.encode_npz(
                {"x": np.zeros((1, 5, 2), np.float32),
                 "pos": np.zeros((1, 5, 2), np.float32)})):
            with pytest.raises(HTTPError) as e:
                urlopen(Request(url + "/predict", data=body))
            assert e.value.code == 400
            assert "error" in json.loads(e.value.read())
        with pytest.raises(HTTPError) as e:
            urlopen(url + "/nothing")
        assert e.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_predict_remote_parses_indices_past_ten(service, monkeypatch):
    """Keys like verts_11 go to item 11, not item 1."""
    flat = {f"ok_{i}": np.int32(i) for i in range(12)}
    flat["count"] = np.int32(12)

    class Resp:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def read(self):
            return serve.encode_npz(flat)

    monkeypatch.setattr("urllib.request.urlopen", lambda req: Resp())
    out = serve.predict_remote("http://unused", np.zeros((1, 2, 3)),
                               np.zeros((1, 2, 3)))
    assert [int(o["ok"]) for o in out] == list(range(12))


def test_concurrent_clients_share_batches(service):
    before = service.stats["batches"]
    x, pos = _requests()[1]
    results, errs = [None] * 3, []

    def client(i):
        try:
            results[i] = service.submit(x[i:i + 1], pos[i:i + 1])[0]
        except Exception as e:  # noqa: BLE001 - asserted below
            errs.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs and not any(t.is_alive() for t in threads)
    assert all(r is not None and r["pred_nocs"].shape == (POINTS, 3)
               for r in results)
    assert service.stats["batches"] - before < 3


def test_resampling_sizes(service):
    for n in (120, 900):
        rng = np.random.RandomState(n)
        (r,) = service.submit(rng.rand(1, n, 3), rng.rand(1, n, 3) - 0.5)
        assert r["pred_nocs"].shape == (POINTS, 3)
        assert r["pred_nocs_confidence"].shape == (POINTS, 3)


def test_batch_failure_isolated(service, monkeypatch):
    def boom(x, pos):
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(service.engine, "encode", boom)
    x, pos = _requests()[2]
    (r,) = service.submit(x, pos, timeout=60)
    assert int(r["ok"]) == 0
    assert b"injected device failure" in bytes(r["error"])
    monkeypatch.undo()
    (r,) = service.submit(x, pos, timeout=60)
    assert "error" not in r


def test_submit_rejects_bad_shapes(service):
    with pytest.raises(ValueError, match=r"\[B, N, 3\]"):
        service.submit(np.zeros((2, 10, 3)), np.zeros((2, 11, 3)))


def test_hot_reload_reaches_the_decoded_wnf(ckpts):
    """After reload_checkpoint the served meshes are those of an engine
    built on the new weights, and not the old ones: the dense decode reads
    the re-folded volume-decoder layers."""
    x, pos = _requests()[0]
    svc = _service(ckpts["main"][1],
                   engine_kwargs={"decode_precision": "high"})
    try:
        old = svc.submit(x, pos)
        svc.reload_checkpoint(ckpts["moved"][1])
        new = svc.submit(x, pos)
        assert svc.stats["reloads"] == 1
        cfg, sd = load_pipeline_checkpoint(ckpts["moved"][1])
        eng = PredictEngine(cfg, sd, volume_size=pu.VOL,
                            decode_precision="high", mc_threads=1,
                            device="cpu")
        meshes = eng.extract_meshes(eng.encode(*_padded(x, pos)))
        moved_any = False
        for o, n, m in zip(old, new, meshes):
            assert int(n["ok"]) == int(m is not None)
            if int(n["ok"]):
                np.testing.assert_array_equal(n["verts"], m[0])
                moved_any |= (not int(o["ok"]) or len(o["verts"]) != len(
                    n["verts"]) or not np.array_equal(o["verts"], n["verts"]))
        assert moved_any
        # another architecture is refused
        other = pathlib.Path(ckpts["main"][1]).with_name("other.ckpt")
        save_pipeline_checkpoint(
            other, dataclasses.replace(cfg, unet_f_maps=16), sd)
        with pytest.raises(ValueError, match="architecture"):
            svc.reload_checkpoint(other)
    finally:
        svc.close()


def test_stats_under_concurrent_submits(service):
    """16 clients with a short switch interval: every garment is served and
    counted once."""
    before = dict(service.stats)
    x, pos = _requests()[0]
    results, errs = [], []
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def client():
            try:
                results.append(service.submit(x[:1], pos[:1])[0])
            except Exception as e:  # noqa: BLE001 - asserted below
                errs.append(e)
        threads = [threading.Thread(target=client) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(prev)
    assert not errs and not any(t.is_alive() for t in threads)
    assert len(results) == 16 and all("error" not in r for r in results)
    assert service.stats["requests"] - before["requests"] == 16
    assert service.stats["garments"] - before["garments"] == 16


def test_cli_config_and_precision(ckpts, monkeypatch):
    """The CLI reads configs/serve_default.yaml as the JAX CLI does and
    builds the service from it unmodified, at its decode_precision 'high';
    an unknown precision name raises."""
    from garmentnets_tpu.core import config as jax_config
    from garmentnets_tpu_torch.core import config
    ov = ["server.port=0", f"main.checkpoint_path={ckpts['main'][1]}",
          "server.device=cpu"]
    cfg = config.load_config("serve_default", config.parse_cli(ov + ["-v"]))
    assert cfg == jax_config.load_config("serve_default", ov).to_container()
    assert cfg["prediction"]["decode_precision"] == "high"
    built = []
    make = serve.make_http_server

    def make_and_stop(service, host, port):
        httpd = make(service, host, port)
        built.append(service.engine.decode_precision)
        httpd.serve_forever = lambda: None   # return instead of serving
        return httpd

    monkeypatch.setattr(serve, "make_http_server", make_and_stop)
    serve.main(cfg)
    assert built == ["high"]
    bogus = config.load_config("serve_default", config.parse_cli(
        ov + ["prediction.decode_precision=bogus"]))
    with pytest.raises(ValueError, match="decode_precision must be one of"):
        serve.main(bogus)


def test_service_checks_card_limits_at_start_up(ckpts, monkeypatch):
    """On a card device the service refuses a point count the FPS kernel
    does not hold, naming server.num_points (the device is faked: the
    check runs on the CPU before anything moves to it)."""
    import torch
    from garmentnets_tpu_torch.harness import predict_engine
    monkeypatch.setattr(predict_engine, "resolve_device",
                        lambda d: torch.device("cuda"))
    with pytest.raises(ValueError, match="server.num_points=20000"):
        serve.PredictService(ckpts["main"][1], batch_size=BATCH,
                             num_points=20000, volume_size=pu.VOL,
                             device="cuda")


# ---------------------------------------------------------------------------
# the service on a device mesh
# ---------------------------------------------------------------------------
SERVE_MESHES = {"data2": (("cpu", "cpu"), ("data",)),
                "data2_space2": ((("cpu", "cpu"), ("cpu", "cpu")),
                                 ("data", "space"))}


def _two_clients(svc) -> list:
    """_requests() from two client threads at once (requests 0 and 2 from
    one, 1 from the other) -> each request's results."""
    results, errs = [None] * 3, []

    def client(ids):
        try:
            for i in ids:
                results[i] = svc.submit(*_requests()[i])
        except Exception as e:  # noqa: BLE001 - asserted below
            errs.append(e)

    threads = [threading.Thread(target=client, args=(ids,))
               for ids in ((0, 2), (1,))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errs and not any(t.is_alive() for t in threads), errs
    return results


@pytest.fixture(scope="module")
def mesh_runs(ckpts, service):
    """Per mesh of SERVE_MESHES: the port's service on it (decode at
    'highest', as `service`), _two_clients' results and the jobs of each
    device batch its dispatcher formed, in order; and the one-device
    `service`'s results on the same requests."""
    from garmentnets_tpu_torch.parallel.mesh import Mesh
    out = {"one": [service.submit(x, pos) for x, pos in _requests()]}
    for name, (devices, axes) in SERVE_MESHES.items():
        svc = _service(ckpts["main"][1], mesh=Mesh(devices, axes),
                       engine_kwargs={"decode_precision": "highest"})
        batches = []
        encode_jobs = svc._encode_jobs

        def record(jobs, encode_jobs=encode_jobs, batches=batches):
            batches.append(list(jobs))
            return encode_jobs(jobs)

        svc._encode_jobs = record
        try:
            out[name] = dict(results=_two_clients(svc), batches=batches,
                             n_data=svc.engine.n_data)
        finally:
            svc.close()
    return out


@pytest.mark.parametrize("name", sorted(SERVE_MESHES))
def test_mesh_service_shards_equal_the_one_device_engine(service, mesh_runs,
                                                         name):
    """Each device batch the mesh service formed (zero-padded to BATCH
    rows), shard by shard: every garment's served result equals the
    one-device engine's encode -> extract_meshes -> warp_batch on that
    shard's rows, bit for bit."""
    run = mesh_runs[name]
    assert sum(map(len, run["batches"])) == 6
    eng = PredictEngine(service.cfg, service.engine.model.state_dict(),
                        volume_size=pu.VOL, decode_precision="highest",
                        mc_threads=1, device="cpu")
    per = BATCH // run["n_data"]
    for jobs in run["batches"]:
        x = np.zeros((BATCH, POINTS, 3), np.float32)
        pos = np.zeros((BATCH, POINTS, 3), np.float32)
        for i, job in enumerate(jobs):
            x[i], pos[i] = job.x, job.pos
        for s in range(run["n_data"]):
            rows = slice(s * per, (s + 1) * per)
            enc = eng.encode(x[rows], pos[rows])
            eng.prefetch(enc, extra_keys=("pred_nocs",
                                          "pred_nocs_confidence"))
            meshes = eng.extract_meshes(enc)
            warps = eng.warp_batch(enc, meshes)
            host = eng.host_outputs(enc)
            for i, job in enumerate(jobs[rows]):
                r, m, w = job.result, meshes[i], warps[i]
                assert "error" not in r, r.get("error")
                np.testing.assert_array_equal(
                    r["pred_nocs"], host["pred_nocs"][i].numpy())
                np.testing.assert_array_equal(
                    r["pred_nocs_confidence"],
                    host["pred_nocs_confidence"][i].numpy())
                assert int(r["ok"]) == int(m is not None)
                if int(r["ok"]):
                    for k, v in zip(("verts", "faces", "volume_value"),
                                    (m[0], m[1], m[2])):
                        np.testing.assert_array_equal(r[k], v, err_msg=k)
                    for k in ("warp_field", "verts_ggm"):
                        np.testing.assert_array_equal(r[k], w[k], err_msg=k)
    eng.close()


@pytest.mark.parametrize("name", sorted(SERVE_MESHES))
def test_mesh_service_near_the_one_device_service(mesh_runs, name):
    """Every served output within 1e-5 of its largest value of the
    one-device service's on the same requests (CPU 3D convolutions round
    by the batch size), with the same ok flags and faces."""
    n_ok = 0
    for got, ref in zip(mesh_runs[name]["results"], mesh_runs["one"]):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert sorted(g) == sorted(r) and int(g["ok"]) == int(r["ok"])
            n_ok += int(r["ok"])
            for k, v in r.items():
                if k == "faces":
                    np.testing.assert_array_equal(g[k], v)
                elif k != "ok":
                    np.testing.assert_allclose(
                        g[k], v, rtol=0, atol=1e-5 * np.abs(v).max(),
                        err_msg=k)
    assert n_ok >= 4


@pytest.fixture(scope="module")
def jax_mesh_results(ckpts):
    """The JAX service on JAX's 2-device CPU mesh, the requests in turn."""
    from jax.sharding import Mesh as JaxMesh
    jsvc = jax_serve.PredictService(
        ckpts["main"][0], batch_size=BATCH, num_points=POINTS,
        volume_size=pu.VOL, batch_window_ms=30.0,
        mesh=JaxMesh(np.asarray(jax.devices()[:2]), ("data",)),
        engine_kwargs={"precision": jax.lax.Precision.HIGHEST,
                       "warp_bucket": 64})
    try:
        return [jsvc.submit(x, pos) for x, pos in _requests()]
    finally:
        jsvc.close()


@pytest.mark.parametrize("name", sorted(SERVE_MESHES))
def test_mesh_service_matches_jax_mesh_service(service, mesh_runs,
                                               jax_mesh_results, name):
    """The port's mesh service against the JAX service on a 2-device
    mesh, at test_results_match_jax_service's bars."""
    warps16 = _warps_at_jax_vertices(service.cfg,
                                     service.engine.model.state_dict(),
                                     jax_mesh_results)
    assert _check_against_jax(list(zip(
        jax_mesh_results, mesh_runs[name]["results"], warps16))) >= 4
