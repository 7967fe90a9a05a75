"""The port's predict CLI (harness/predict.py) against the JAX CLI, and the
JAX eval on both outputs.

Setup: one synthetic dataset (the port's generator), the tiny pipeline of
torch_port_util with seeded JAX variables whose volume-decoder head is
biased so that about 10% of the voxels of the first test batch lie above
the iso level, the JAX msgpack checkpoint and its Lightning export; 16^3,
batch size 2, decode 'highest' on both sides, the port on the CPU.

Both WNFs agree to ~1e-6, but the engines ship int8 brick values: where a
voxel's value lies within that of a rounding boundary, one brick value
differs by one level (1/254) and moves the vertices of the edges at that
voxel. So meshes are held as identical faces, with every vertex within
1e-4 except such moved ones (at most 1% of a mesh, each within one
lattice step); the warp values are compared at the vertices that agree.
The JAX eval of the two outputs agrees within rtol 1e-3 on every metric
of every sample whose mesh agrees, and on the metrics of the others that
do not sample the predicted mesh; a moved vertex changes the area-weighted
surface sampling of eval's chamfer and Hausdorff metrics (about a tenth
of the drawn faces for one vertex), which is bounded separately.
"""
import json
import pathlib
import sys

import numpy as np
import pandas as pd
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_port_util as pu  # noqa: E402

from garmentnets_tpu.core.builders import pipeline_hparams  # noqa: E402
from garmentnets_tpu.core.checkpoint import save_checkpoint  # noqa: E402
from garmentnets_tpu.harness import eval as jeval  # noqa: E402
from garmentnets_tpu.harness import predict as jpredict  # noqa: E402
from garmentnets_tpu_torch.data import zarrlite  # noqa: E402
from garmentnets_tpu_torch.data.dataset import ConvImplicitWNFDataModule  # noqa: E402
from garmentnets_tpu_torch.data.synthetic import generate_dataset  # noqa: E402
from garmentnets_tpu_torch.harness import predict  # noqa: E402
from tools import export_checkpoint  # noqa: E402

VOL = 16
STEP = 1.0 / (VOL - 1)
DM = dict(metadata_cache_dir=None, batch_size=2, num_workers=0,
          num_pc_sample=pu.N, num_volume_sample=0, num_surface_sample=0,
          num_mc_surface_sample=0, surface_sample_ratio=0,
          surface_sample_std=0.05, surface_normal_noise_ratio=0,
          surface_normal_std=0.01, enable_augumentation=True,
          random_rot_range=[-180, 180], num_views=4, pc_noise_std=0,
          volume_size=VOL, volume_group="nocs_winding_number_field",
          tsdf_clip_value=None, volume_absolute_value=False,
          include_volume=False, static_epoch_seed=False,
          dataset_split=[1, 1, 2], split_seed=0)
PRED = dict(subset="test", volume_size=VOL, gradient_sigma=0.5,
            iso_surface_level=0.5, gradient_direction="ascent",
            use_hole_prediction=False, query_chunk=8,
            decode_precision="highest")
# encode outputs the JAX engine ships as f16, and the global outputs
F16_TOL = dict(rtol=2e-3, atol=1e-3)
GLOBAL_TOL = dict(rtol=1e-3, atol=2e-4)


def _live_head(variables, x, pos, share=0.1):
    """The volume decoder head as relu(z + b) (identity BatchNorm), with b
    putting `share` of the voxels of (x, pos) above 0.5."""
    return pu.live_head(variables, x, pos, VOL, share)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("predict")
    zarr = str(d / "data.zarr")
    generate_dataset(zarr, num_instances=4, grips_per_instance=2,
                     volume_size=VOL, mesh_res=8, pts_per_view=200, seed=0,
                     include_task_space=False)
    dm = ConvImplicitWNFDataModule(zarr_path=zarr, **DM)
    dm.prepare_data()
    assert len(dm.test_idxs) == 4           # two batches of two
    batch = next(iter(dm.test_dataloader()))
    variables = _live_head(pu.jax_variables(), batch["x"], batch["pos"])
    msgpack = d / "pipeline.msgpack"
    save_checkpoint(msgpack, {"params": variables["params"],
                              "batch_stats": variables["batch_stats"],
                              "step": 0},
                    hparams=pipeline_hparams(pu.jax_cfg()))
    ckpt = d / "pipeline.ckpt"
    export_checkpoint.main(str(msgpack), str(ckpt))
    return {"dir": d, "zarr": zarr, "msgpack": msgpack, "ckpt": ckpt,
            "runs": {}}


def _cfg(setup, side, pred=None, dm=None):
    ckpt = setup["msgpack"] if side == "jax" else setup["ckpt"]
    p = dict(PRED, **(pred or {}))
    if side == "torch":
        p["device"] = "cpu"
    return {"main": {"checkpoint_path": str(ckpt)}, "prediction": p,
            "logger": {},
            "datamodule": dict(DM, zarr_path=setup["zarr"], **(dm or {}))}


def _run(setup, name, side, **kw) -> pathlib.Path:
    """Run a CLI once per module and name."""
    runs = setup["runs"]
    if name not in runs:
        main = jpredict.main if side == "jax" else predict.main
        runs[name] = pathlib.Path(main(_cfg(setup, side, **kw),
                                       run_dir=str(setup["dir"] / name)))
    return runs[name]


def _arrays(run: pathlib.Path) -> dict:
    """{'<sample>/<group>/<array>': numpy array} of a prediction.zarr."""
    out = {}

    def walk(g, pre):
        for name, node in g.items():
            if isinstance(node, zarrlite.Array):
                out[pre + name] = np.asarray(node)
            else:
                walk(node, pre + name + "/")
    walk(zarrlite.open(str(run / "prediction.zarr"), "r")["samples"], "")
    return out


def _attrs(run: pathlib.Path) -> dict:
    root = zarrlite.open(str(run / "prediction.zarr"), "r")
    return {k: g.attrs.asdict() for k, g in root["samples"].groups()}


@pytest.fixture(scope="module")
def outputs(setup):
    j, t = _run(setup, "jax", "jax"), _run(setup, "torch", "torch")
    return _arrays(j), _arrays(t)


def _moved(ja, ta, sample) -> np.ndarray:
    """Vertices of `sample` that are more than 1e-4 apart."""
    key = f"{sample}/marching_cubes_mesh/verts"
    return np.abs(ja[key] - ta[key]).max(1) > 1e-4


def _samples(arrs) -> list:
    return sorted({k.split("/")[0] for k in arrs})


def test_same_schema_dtypes_and_attrs(setup, outputs):
    ja, ta = outputs
    assert sorted(ja) == sorted(ta)
    assert len(_samples(ta)) == 4
    for k in ja:
        assert ja[k].dtype == ta[k].dtype, k
        assert ja[k].shape == ta[k].shape, k
    assert _attrs(setup["runs"]["jax"]) == _attrs(setup["runs"]["torch"])
    for run in setup["runs"].values():
        root = zarrlite.open(str(run / "prediction.zarr"), "r")
        assert root.attrs.asdict() == {"subset": "test"}
    groups = {"/".join(k.split("/")[1:-1]) for k in ta}
    assert groups == {"marching_cubes_mesh", "point_cloud", "gt_mesh",
                      "gt_marching_cubes_mesh", "misc"}
    meta = json.loads((setup["runs"]["torch"] / "prediction.zarr" /
                       "samples" / _samples(ta)[0] / "point_cloud" /
                       "pred_nocs" / ".zarray").read_text())
    assert meta["compressor"] == {"id": "blosc", "cname": "zstd",
                                  "clevel": 6, "shuffle": 2, "blocksize": 0}


@pytest.mark.parametrize("array", [
    "point_cloud/pred_nocs", "point_cloud/input_points",
    "point_cloud/input_rgb", "point_cloud/gt_nocs",
    "gt_mesh/cloth_verts", "gt_mesh/cloth_nocs_verts",
    "gt_mesh/cloth_faces_tri",
    "gt_marching_cubes_mesh/marching_cube_verts",
    "gt_marching_cubes_mesh/marching_cube_faces",
    "gt_marching_cubes_mesh/is_vertex_on_surface",
    "misc/gt_nocs_grip_point", "misc/pred_nocs_grip_point",
    "misc/pred_global_nocs_grip_point"])
def test_arrays_bit_equal(outputs, array):
    ja, ta = outputs
    for s in _samples(ta):
        np.testing.assert_array_equal(ta[f"{s}/{array}"], ja[f"{s}/{array}"])


@pytest.mark.parametrize("array,tol", [
    ("point_cloud/pred_nocs_confidence", F16_TOL),
    ("point_cloud/pred_nocs_logits", F16_TOL),
    ("misc/pred_global_confidence", GLOBAL_TOL),
    ("misc/global_feature", GLOBAL_TOL)])
def test_encode_outputs_close(outputs, array, tol):
    ja, ta = outputs
    for s in _samples(ta):
        np.testing.assert_allclose(ta[f"{s}/{array}"], ja[f"{s}/{array}"],
                                   **tol)


def test_meshes_match(outputs):
    """Identical faces; vertices within 1e-4 but for those a brick value's
    rounding moved (at most 1% of a mesh, within one lattice step); normals
    and volume values within 1e-3 on at least 99% of the vertices."""
    ja, ta = outputs
    n_verts = 0
    for s in _samples(ta):
        mc = f"{s}/marching_cubes_mesh/"
        assert len(ta[mc + "verts"]) > 100          # a surface, not a stub
        n_verts += len(ta[mc + "verts"])
        np.testing.assert_array_equal(ta[mc + "faces"], ja[mc + "faces"])
        moved = _moved(ja, ta, s)
        assert moved.mean() <= 0.01, moved.sum()
        assert np.abs(ta[mc + "verts"] - ja[mc + "verts"]).max() <= STEP
        for k in ("normals", "volume_value"):
            err = np.abs(ta[mc + k] - ja[mc + k]).reshape(len(moved), -1)
            assert (err.max(1) <= 1e-3).mean() >= 0.99, (s, k)
    assert n_verts > 1000


def test_warp_and_ggm_match_at_agreeing_vertices(outputs):
    """warp_field and volume_gradient_magnitude within rtol 2e-3 (the JAX
    engine ships them as f16) at every vertex whose position agrees."""
    ja, ta = outputs
    for s in _samples(ta):
        keep = ~_moved(ja, ta, s)
        for k in ("warp_field", "volume_gradient_magnitude"):
            key = f"{s}/marching_cubes_mesh/{k}"
            np.testing.assert_allclose(ta[key][keep], ja[key][keep],
                                       **F16_TOL, err_msg=key)


EVAL_CFG = {
    "override_all": {
        "value_threshold":
            "summary/metrics/aggregate/optimal_wnf_gradient_threshold",
        "value_key": "marching_cubes_mesh/volume_gradient_magnitude",
        "predict_holes": True, "volume_task_space": False},
    "eval": {
        "compute_optimal_gradient_treshold":
            {"enabled": True, "precision_weight": 0.75},
        "compute_pc_metrics": {"enabled": True},
        "compute_grip_point_metrics": {"enabled": True},
        "compute_chamfer": {"enabled": True, "num_points": 500, "seed": 0},
        "compute_hybrid_chamfer": {"enabled": True, "num_points": 500,
                                   "seed": 0},
        "compute_geodesic": {"enabled": False, "num_points": 8, "seed": 0},
        "compute_hausdorff": {"enabled": True}},
    "vis": {"samples_per_instance": 0, "num_best": 0, "num_worst": 0,
            "num_normal": 0, "rank_metric": "chamfer_symmetrical_nocs"},
    "logger": {},
}
# eval columns that do not sample the predicted mesh's surface
UNSAMPLED = ("nocs_pc_", "grip_point_", "chamfer_symmetrical_nocs_mc",
             "hausdorff_nocs_mc")


@pytest.fixture(scope="module")
def evals(setup, outputs):
    out = {}
    for side in ("jax", "torch"):
        cfg = dict(EVAL_CFG, main={
            "prediction_output_dir": str(setup["runs"][side]),
            "num_workers": 1})
        run = pathlib.Path(jeval.main(
            cfg, run_dir=str(setup["dir"] / f"eval_{side}")))
        out[side] = (json.loads((run / "summary.json").read_text()),
                     pd.read_csv(run / "all_metrics.csv", index_col=0))
    return out


def _close(a, b, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    both_nan = np.isnan(a) & np.isnan(b)
    return np.all(both_nan | (np.abs(a - b) <= rtol * np.abs(b)))


def test_eval_summary_matches(evals, outputs):
    """The same summary keys. Every per-sample metric within rtol 1e-3 on
    samples whose meshes agree; on a sample with moved vertices the
    metrics that do not sample its surface within rtol 1e-3, the sampled
    ones within 5e-2. Summary values of unsampled metrics and the optimal
    threshold within rtol 1e-3; the others within 1e-3 when no vertex
    moved."""
    (js, jdf), (ts, tdf) = evals["jax"], evals["torch"]
    assert sorted(js) == sorted(ts)
    assert list(jdf.columns) == list(tdf.columns)
    ja, ta = outputs
    samples = _samples(ta)
    any_moved = False
    for i, s in enumerate(samples):
        moved = bool(_moved(ja, ta, s).any())
        any_moved |= moved
        for col in jdf.columns:
            if jdf[col].dtype.kind not in "fi":
                continue
            exact = not moved or col.startswith(UNSAMPLED)
            assert _close(tdf[col].iloc[i], jdf[col].iloc[i],
                          1e-3 if exact else 5e-2), (s, col)
    for k in js:
        if isinstance(js[k], (int, float)):
            exact = (not any_moved or k.startswith(UNSAMPLED)
                     or k in ("optimal_wnf_gradient_threshold",
                              "null_percentage"))
            assert _close(ts[k], js[k], 1e-3 if exact else 5e-2), k
    assert np.isfinite(ts["optimal_wnf_gradient_threshold"])


def test_nan_sentinel_placeholders_identical(setup):
    """An iso level the WNF never reaches: marching cubes fails for every
    garment, and both CLIs write the same NaN placeholders."""
    ja = _arrays(_run(setup, "jax_nan", "jax",
                      pred={"iso_surface_level": 2.0}))
    ta = _arrays(_run(setup, "torch_nan", "torch",
                      pred={"iso_surface_level": 2.0}))
    want = predict.nan_mc_placeholders()
    for s in _samples(ta):
        for k, v in want.items():
            key = f"{s}/marching_cubes_mesh/{k}"
            np.testing.assert_array_equal(ta[key], v)
            np.testing.assert_array_equal(ja[key], ta[key])
            assert ja[key].dtype == ta[key].dtype


def test_no_logits_skips_only_the_logits(setup, outputs):
    _, ta = outputs
    nl = _arrays(_run(setup, "torch_nologits", "torch",
                      pred={"store_pred_nocs_logits": False}))
    assert sorted(nl) == sorted(k for k in ta
                                if not k.endswith("/pred_nocs_logits"))
    for k in nl:
        np.testing.assert_array_equal(nl[k], ta[k], err_msg=k)


def test_batch_size_one_matches_two(setup, outputs):
    """One garment a batch: the same arrays (batch_idx aside) as two."""
    _, ta = outputs
    b1 = _run(setup, "torch_b1", "torch", dm={"batch_size": 1})
    a1 = _arrays(b1)
    assert sorted(a1) == sorted(ta)
    for k in a1:
        if k.split("/")[1] == "marching_cubes_mesh":
            np.testing.assert_allclose(a1[k], ta[k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        elif k.endswith(("pred_nocs", "input_points", "gt_nocs")):
            np.testing.assert_array_equal(a1[k], ta[k], err_msg=k)
        else:
            np.testing.assert_allclose(a1[k], ta[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    attrs1, attrs2 = _attrs(b1), _attrs(setup["runs"]["torch"])
    assert sorted(a["batch_idx"] for a in attrs1.values()) == [0, 1, 2, 3]
    for k in attrs1:
        attrs1[k].pop("batch_idx")
        attrs2[k].pop("batch_idx")
    assert attrs1 == attrs2


def test_logs_stage_times_and_summary(setup, outputs):
    run = setup["runs"]["torch"]
    summary = json.loads((run / "summary.json").read_text())
    assert summary["garments"] == 4
    assert summary["garments_per_sec"] > 0 and summary["elapsed_sec"] > 0
    recs = [json.loads(x) for x in
            (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["prediction_batch_idx"] for r in recs] == [0, 1]
    for r in recs:
        for k in ("encode_ms", "encode_wait_ms", "host_mc_ms",
                  "warp_dispatch_ms", "warp_collect_ms", "writer_ms"):
            assert r[k] >= 0, k
    snap = (run / "config.yaml").read_text()
    assert "prediction_output_dir" not in snap and "device: cpu" in snap


@pytest.mark.parametrize("pred,match", [
    ({"device_normals": "sometimes"}, "prediction.device_normals")])
def test_refuses_unported_options(setup, tmp_path, pred, match):
    """An option value the port cannot honour is refused, naming the key,
    before anything is written (prediction.device_normals=true itself is
    ported: tests/test_torch_normals.py)."""
    with pytest.raises(ValueError, match=match):
        predict.main(_cfg(setup, "torch", pred=pred),
                     run_dir=str(tmp_path / "r"))
    assert not (tmp_path / "r").exists()


def test_hole_prediction_needs_a_head_checkpoint(setup, tmp_path):
    """prediction.use_hole_prediction on a checkpoint without the
    mc-surface head is refused, naming both keys, before anything is
    written."""
    with pytest.raises(ValueError, match="prediction.use_hole_prediction"
                       ".*mc_surface_loss_weight"):
        predict.main(_cfg(setup, "torch",
                          pred={"use_hole_prediction": True}),
                     run_dir=str(tmp_path / "r"))
    assert not (tmp_path / "r").exists()


def test_defaults_to_the_card_without_fallback(setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _cfg(setup, "torch")
    cfg["prediction"].pop("device")
    with pytest.raises(RuntimeError, match="CUDA"):
        predict.main(cfg, run_dir=str(tmp_path / "r"))


def test_card_limits_checked_at_start_up(setup, tmp_path, monkeypatch):
    """On a card device the CLI refuses a point count the FPS kernel does
    not hold before it builds anything (the device is faked: the check
    runs on the CPU)."""
    from garmentnets_tpu_torch.harness import predict_engine
    for mod in (predict, predict_engine):
        monkeypatch.setattr(mod, "resolve_device",
                            lambda d: torch.device("cuda"))
    cfg = _cfg(setup, "torch", dm={"num_pc_sample": 20000})
    with pytest.raises(ValueError, match="datamodule.num_pc_sample=20000"):
        predict.main(cfg, run_dir=str(tmp_path / "r"))
    assert not (tmp_path / "r").exists()
