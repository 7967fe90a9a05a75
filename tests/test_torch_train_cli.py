"""The port's train CLIs (harness/train_pointnet2.py, train_pipeline.py) on
a tiny synthetic dataset, mirroring tests/test_e2e.py, on the CPU:
checkpoint names, top-k and last.ckpt, the per-epoch PNGs, metrics.jsonl
with the JAX trainer's keys, a falling loss and resume; the port's predict
CLI on the stage-2 checkpoint as it is, and the JAX predict CLI on that
checkpoint converted by tools/convert_checkpoint.py (the same outputs, at
tests/test_torch_predict.py's tolerances); a stage-1 checkpoint that
tools/export_checkpoint.py wrote from a JAX-trained one starts the port's
stage 2; a trainer.num_devices that no run can take is refused (several
ranks: tests/test_torch_ddp.py)."""
import json
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_torch_predict import (  # noqa: E402
    F16_TOL, GLOBAL_TOL, PRED, STEP, _arrays, _moved, _samples)

from garmentnets_tpu.core.builders import pipeline_hparams as jax_hparams  # noqa: E402
from garmentnets_tpu.core.checkpoint import load_checkpoint  # noqa: E402
from garmentnets_tpu.harness import predict as jpredict  # noqa: E402
from garmentnets_tpu.harness import train_pointnet2 as jtrain1  # noqa: E402
from garmentnets_tpu.models.pipeline import (  # noqa: E402
    PipelineConfig as JaxPipelineConfig, pipeline_loss as jax_loss)
from garmentnets_tpu_torch.core.checkpoint import (  # noqa: E402
    get_checkpoint_df, load_pipeline_checkpoint, read_checkpoint,
    resume_training)
from garmentnets_tpu_torch.core.weights import state_dict_from_jax  # noqa: E402
from garmentnets_tpu_torch.data.synthetic import generate_dataset  # noqa: E402
from garmentnets_tpu_torch.harness import (  # noqa: E402
    predict, train_pipeline, train_pointnet2)
from garmentnets_tpu_torch.harness.training import make_adam  # noqa: E402
from garmentnets_tpu_torch.models.pipeline import (  # noqa: E402
    ConvImplicitWNFPipeline)
from tools import convert_checkpoint, export_checkpoint  # noqa: E402

DM = dict(
    metadata_cache_dir=None, batch_size=2, num_workers=0,
    num_pc_sample=256, num_volume_sample=0, num_surface_sample=0,
    num_mc_surface_sample=0, surface_sample_ratio=0, surface_sample_std=0.05,
    surface_normal_noise_ratio=0, surface_normal_std=0.01,
    enable_augumentation=True, random_rot_range=[-180, 180], num_views=4,
    pc_noise_std=0, volume_size=16,
    volume_group="nocs_winding_number_field", tsdf_clip_value=None,
    volume_absolute_value=False, include_volume=False,
    static_epoch_seed=False, dataset_split=[1, 1, 1], split_seed=0)
MODEL = dict(feature_dim=32, batch_norm=True, dropout=True, sa1_ratio=0.5,
             sa1_r=0.1, sa2_ratio=0.25, sa2_r=0.2, fp3_k=1, fp2_k=3,
             fp1_k=3, symmetry_axis=None, nocs_bins=8, learning_rate=1e-3,
             nocs_loss_weight=1, grip_point_loss_weight=1)
CONV = {
    "volume_agg_params": {
        "nn_channels": [41, 41, 32], "batch_norm": True,
        "grid_shape": [8, 8, 8], "reduce_method": "max",
        "include_point_feature": True, "include_confidence_feature": True},
    "unet3d_params": {"in_channels": 32, "out_channels": 32, "f_maps": 8,
                      "layer_order": "gcr", "num_groups": 4,
                      "num_levels": 2},
    "volume_decoder_params": {"nn_channels": [32, 32, 1],
                              "batch_norm": True},
    "surface_decoder_params": {"nn_channels": [32, 32, 3],
                               "batch_norm": True},
    "mc_surface_decoder_params": {"nn_channels": [32, 32, 1],
                                  "batch_norm": True},
    "volume_loss_weight": 1.0, "surface_loss_weight": 1.0,
    "mc_surface_loss_weight": 0, "volume_classification": False,
    "volume_task_space": False, "learning_rate": 1e-3, "loss_type": "l2",
}
CKPT_NAME = re.compile(r"epoch=\d+-val_loss=\d+\.\d{4}\.ckpt")


def _trainer(**over):
    t = {"max_epochs": 3, "num_devices": 1, "checkpoint_top_k": 2,
         "resume_from_checkpoint": None, "limit_train_batches": 2,
         "limit_val_batches": 1, "device": "cpu"}
    t.update(over)
    return t


def _records(run) -> list:
    return [json.loads(x) for x in
            (pathlib.Path(run) / "metrics.jsonl").read_text().splitlines()]


def _keys(run) -> set:
    return set().union(*map(set, _records(run)))


@pytest.fixture(scope="module")
def d(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_cli")
    generate_dataset(str(d / "synth.zarr"), num_instances=3,
                     grips_per_instance=2, volume_size=16, mesh_res=8,
                     pts_per_view=400, seed=0, include_task_space=False)
    return d


def _s1_cfg(d, **trainer):
    return {"model": dict(MODEL, vis_per_items=1, max_vis_per_epoch_val=2),
            "trainer": _trainer(**trainer), "logger": {},
            "datamodule": dict(DM, zarr_path=str(d / "synth.zarr"))}


def _s2_cfg(d, s1_ckpt, **trainer):
    return {"pointnet2_model": {"checkpoint_path": str(s1_ckpt)},
            "conv_implicit_model": dict(CONV, vis_per_items=1,
                                        max_vis_per_epoch_val=2),
            "trainer": _trainer(**trainer), "logger": {},
            "datamodule": dict(DM, zarr_path=str(d / "synth.zarr"),
                               num_volume_sample=64, num_surface_sample=64)}


@pytest.fixture(scope="module")
def s1_run(d):
    return train_pointnet2.main(_s1_cfg(d), run_dir=str(d / "s1"))


@pytest.fixture(scope="module")
def s2_run(d, s1_run):
    return train_pipeline.main(
        _s2_cfg(d, s1_run / "checkpoints/last.ckpt", max_epochs=1),
        run_dir=str(d / "s2"))


@pytest.fixture(scope="module")
def jax_s1_run(d):
    """The JAX stage-1 CLI on the same data and configuration, one step."""
    cfg = _s1_cfg(d)
    cfg["model"]["vis_per_items"] = 0
    cfg["trainer"] = {k: v for k, v in _trainer(
        max_epochs=1, limit_train_batches=1).items() if k != "device"}
    return pathlib.Path(jtrain1.main(cfg, run_dir=str(d / "jax_s1")))


def _check_run(run, n_epochs, k):
    ckpts = sorted(p.name for p in (run / "checkpoints").glob("epoch=*"))
    assert len(ckpts) == min(n_epochs, k)
    assert all(CKPT_NAME.fullmatch(c) for c in ckpts), ckpts
    assert (run / "checkpoints/last.ckpt").exists()
    assert list((run / "media").glob("val_*.png"))
    # top-k keeps the k smallest epoch val_losses
    val = sorted(r["val_loss"] for r in _records(run) if "epoch" in r)
    df = get_checkpoint_df(run / "checkpoints")
    np.testing.assert_allclose(sorted(df["val_loss"]),
                               [round(v, 4) for v in val[:k]])
    summary = json.loads((run / "summary.json").read_text())
    assert summary["best_checkpoint"] == df.sort_values(
        "val_loss")["path"].iloc[0]


def test_stage1_cli_outputs(s1_run):
    _check_run(s1_run, 3, 2)
    losses = [r["train_loss"] for r in _records(s1_run)
              if "train_loss" in r]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    ckpt = read_checkpoint(s1_run / "checkpoints/last.ckpt")
    assert ckpt["epoch"] == 2 and ckpt["global_step"] == 3
    assert ckpt["hyper_parameters"] == dict(MODEL, symmetry_axis=None)
    assert len(ckpt["optimizer_states"]) == 1


def test_metrics_keys_equal_jax_trainer(s1_run, s2_run, jax_s1_run):
    """Stage 1: the JAX CLI's own keys. Stage 2: the JAX trainer's fixed
    keys and the JAX pipeline_loss's, each as train_ and val_."""
    jkeys = _keys(jax_s1_run)
    assert _keys(s1_run) == jkeys
    fixed = {k for k in jkeys if not k.startswith(("train_", "val_"))}
    res = {"pred_volume_value": np.zeros((1, 2), np.float32),
           "pred_sim_points": np.zeros((1, 2, 3), np.float32)}
    batch = {"gt_volume_value": np.zeros((1, 2), np.float32),
             "gt_sim_points": np.zeros((1, 2, 3), np.float32)}
    loss_keys = set(jax_loss(JaxPipelineConfig(), res, batch))
    assert _keys(s2_run) == fixed | {"val_loss"} | {
        f"{p}{k}" for p in ("train_", "val_") for k in loss_keys}


def test_stage2_cli_outputs_and_frozen_stage1(s1_run, s2_run):
    _check_run(s2_run, 1, 2)
    s1 = read_checkpoint(s1_run / "checkpoints/last.ckpt")["state_dict"]
    s2 = read_checkpoint(s2_run / "checkpoints/last.ckpt")
    for k, v in s1.items():
        assert torch.equal(s2["state_dict"]["pointnet2_nocs." + k], v), k
    # the frozen stage 1 has no optimizer state
    n_trainable = sum(not k.startswith("pointnet2_nocs.") for k, v in
                      s2["state_dict"].items() if v.is_floating_point()
                      and "running" not in k)
    assert len(s2["optimizer_states"][0]["state"]) == n_trainable


def test_resume_restores_optimizer_and_step(d, s1_run):
    """resume_training loads the weights, statistics and Adam state as
    saved; the CLI goes on at the next epoch and step."""
    path = s1_run / "checkpoints/last.ckpt"
    ckpt = read_checkpoint(path)
    model = train_pointnet2.PointNet2NOCS(
        train_pointnet2.build_pointnet2_config(ckpt["hyper_parameters"]))
    opt = make_adam(model, 1e-3)
    assert resume_training(path, model, opt) == (2, 3)
    for k, v in ckpt["state_dict"].items():
        assert torch.equal(model.state_dict()[k], v), k
    saved = ckpt["optimizer_states"][0]["state"]
    for i, st in opt.state_dict()["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(st[k], saved[i][k]), (i, k)
    run = train_pointnet2.main(
        _s1_cfg(d, max_epochs=4, resume_from_checkpoint=str(path)),
        run_dir=str(d / "s1_resumed"))
    recs = _records(run)
    assert [r["_step"] for r in recs if "train_loss" in r] == [3]
    assert [r["epoch"] for r in recs if "epoch" in r] == [3]
    again = read_checkpoint(run / "checkpoints/last.ckpt")
    assert (again["epoch"], again["global_step"]) == (3, 4)
    assert all(int(st["step"]) == 4 for st in
               again["optimizer_states"][0]["state"].values())


@pytest.fixture(scope="module")
def predictions(d, s2_run):
    """The port's predict CLI on the stage-2 last.ckpt as it is, and the
    JAX predict CLI on that checkpoint converted by
    tools/convert_checkpoint.py; decode 'highest' on both sides."""
    ckpt = s2_run / "checkpoints/last.ckpt"
    convert_checkpoint.main(str(ckpt), str(d / "s2.msgpack"))
    dm = dict(DM, zarr_path=str(d / "synth.zarr"))
    runs = {}
    for side, main, path in (("torch", predict.main, ckpt),
                             ("jax", jpredict.main, d / "s2.msgpack")):
        pred = dict(PRED, device="cpu") if side == "torch" else dict(PRED)
        runs[side] = pathlib.Path(main(
            {"main": {"checkpoint_path": str(path)}, "prediction": pred,
             "logger": {}, "datamodule": dm},
            run_dir=str(d / f"pred_{side}")))
    return _arrays(runs["jax"]), _arrays(runs["torch"])


def test_predict_on_trained_checkpoint_matches_jax(s2_run, predictions):
    """The same arrays; identical NOCS, inputs and ground truth; encode
    outputs within the JAX engine's f16 tolerance; meshes (where the
    briefly trained field has a surface) with identical faces and all but
    1% of the vertices within 1e-4."""
    cfg, _ = load_pipeline_checkpoint(s2_run / "checkpoints/last.ckpt")
    assert cfg.learning_rate == 1e-3 and cfg.loss_type == "l2"
    ja, ta = predictions
    assert sorted(ja) == sorted(ta) and len(_samples(ta)) == 2
    for k in ja:
        assert ja[k].dtype == ta[k].dtype and ja[k].shape == ta[k].shape, k
    for s in _samples(ta):
        for a in ("point_cloud/pred_nocs", "point_cloud/input_points",
                  "point_cloud/gt_nocs", "misc/pred_nocs_grip_point",
                  "misc/pred_global_nocs_grip_point"):
            np.testing.assert_array_equal(ta[f"{s}/{a}"], ja[f"{s}/{a}"])
        for a, tol in (("point_cloud/pred_nocs_confidence", F16_TOL),
                       ("point_cloud/pred_nocs_logits", F16_TOL),
                       ("misc/global_feature", GLOBAL_TOL)):
            np.testing.assert_allclose(ta[f"{s}/{a}"], ja[f"{s}/{a}"],
                                       **tol)
        mc = f"{s}/marching_cubes_mesh/"
        np.testing.assert_array_equal(ta[mc + "faces"], ja[mc + "faces"])
        if len(ta[mc + "verts"]) > 1:
            assert _moved(ja, ta, s).mean() <= 0.01
            assert np.abs(ta[mc + "verts"] - ja[mc + "verts"]).max() <= STEP


def test_stage2_from_jax_trained_stage1_export(d, jax_s1_run):
    """tools/export_checkpoint.py on the JAX CLI's last.ckpt starts the
    port's stage 2; its frozen stage 1 holds the JAX weights exactly."""
    export_checkpoint.main(str(jax_s1_run / "checkpoints/last.ckpt"),
                           str(d / "jax_s1.ckpt"))
    run = train_pipeline.main(
        _s2_cfg(d, d / "jax_s1.ckpt", max_epochs=1, limit_train_batches=1),
        run_dir=str(d / "s2_from_jax"))
    state, _ = load_checkpoint(jax_s1_run / "checkpoints/last.ckpt")
    ref = state_dict_from_jax({"params": state["params"],
                               "batch_stats": state["batch_stats"]})
    sd = read_checkpoint(run / "checkpoints/last.ckpt")["state_dict"]
    for k, v in ref.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(sd["pointnet2_nocs." + k], v), k
    assert [r["epoch"] for r in _records(run) if "epoch" in r] == [0]


def test_pipeline_hparams_equal_jax():
    from garmentnets_tpu_torch.core.builders import pipeline_hparams
    from torch_port_util import jax_cfg, torch_cfg
    assert pipeline_hparams(torch_cfg()) == jax_hparams(jax_cfg())


@pytest.mark.parametrize("key,value,error", [
    ("num_devices", 0, ValueError), ("num_devices", -3, ValueError)])
def test_more_than_one_device_is_refused(d, key, value, error):
    """A device count that no run can take is refused, naming the key
    (two ranks on the CPU run: tests/test_torch_ddp.py)."""
    with pytest.raises(error, match=f"trainer.{key}={value}"):
        train_pointnet2.main(_s1_cfg(d, **{key: value}),
                             run_dir=str(d / f"refused_{value}"))


def test_missing_card_raises(d):
    """trainer.device defaults to the card; without one the CLI raises
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _s1_cfg(d)
    del cfg["trainer"]["device"]
    with pytest.raises(RuntimeError, match="CUDA"):
        train_pointnet2.main(cfg, run_dir=str(d / "no_card"))


def test_model_state_layout_is_the_predict_layout(s2_run):
    """The stage-2 checkpoint's state_dict loads strictly into the
    pipeline the predict CLI builds from its hparams."""
    cfg, sd = load_pipeline_checkpoint(s2_run / "checkpoints/last.ckpt")
    ConvImplicitWNFPipeline(cfg).load_state_dict(sd, strict=True)
