"""The port's three repository tools against the JAX package's, on the CPU
at the tiny width of torch_port_util:

- tools/e2e_synthetic.py (the acceptance run), 1 instance x 2 grips at
  16^3, 3 steps a stage, B=2: both checkpoints (the frozen stage 1 carried
  into stage 2), the printed lines, the prediction.zarr's schema, and the
  JAX eval (garmentnets_tpu.harness.eval) on a copy of that prediction
  giving the port's eval CLI's all_metrics.csv, all_metrics_agg.csv and
  summary.json to the byte, as tests/test_torch_eval.py holds them: the
  slice held against JAX as a whole;
- tools/export_meshes.py on that prediction.zarr with one sample turned
  into the predict CLI's NaN sentinel: the port's tool and the JAX tool's
  `export` write the same PLY files to the byte, filtered and with
  --no-filter, and both skip the sentinel;
- tools/bench_input.py: its main at a tiny size prints its schema.
"""
import contextlib
import importlib.util
import io
import pathlib
import re
import shutil
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_port_util as pu  # noqa: E402

from garmentnets_tpu.core import config as jconfig  # noqa: E402
from garmentnets_tpu.harness import eval as jeval  # noqa: E402
from garmentnets_tpu_torch.core.checkpoint import (  # noqa: E402
    load_pipeline_checkpoint, load_pointnet2_checkpoint, read_checkpoint)
from garmentnets_tpu_torch.data import zarrlite  # noqa: E402
from garmentnets_tpu_torch.harness.predict import (  # noqa: E402
    nan_mc_placeholders)
from garmentnets_tpu_torch.tools import (  # noqa: E402
    bench_input, e2e_synthetic, export_meshes)

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS = 3
SCALE = e2e_synthetic.Scale(grips=2, volume_size=pu.VOL, mesh_res=8,
                            pts_per_view=200, num_points=pu.N,
                            num_samples=128, batch_size=2)
EVAL_OUTPUTS = ("all_metrics.csv", "all_metrics_agg.csv", "summary.json")


def _jax_tool(name: str):
    """A module of the repository's tools/ directory (the JAX tools)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The port's acceptance run at the tiny width; its result and what
    it printed."""
    d = tmp_path_factory.mktemp("e2e")
    cfg = pu.torch_cfg()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        result = e2e_synthetic.main(
            ["--out", str(d), "--instances", "1", "--steps1", str(STEPS),
             "--steps2", str(STEPS)], model_cfgs=(cfg.pointnet2, cfg),
            scale=SCALE, device="cpu")
    return dict(result, printed=printed.getvalue(), dir=d)


def test_trains_both_stages_and_writes_checkpoints(run):
    """Each stage takes its steps with finite losses and writes a
    Lightning-layout checkpoint at lr 1e-3; stage 2 carries stage 1's
    weights and statistics unchanged and has no optimizer state for them."""
    cfg = pu.torch_cfg()
    for stage in ("stage1", "stage2"):
        r = run[stage]
        assert r["steps"] == STEPS and r["batch_size"] == SCALE.batch_size
        assert len(r["losses"]) == STEPS and np.isfinite(r["losses"]).all()
        assert r["seconds"] > 0 and r["loader_wait_s"] >= 0
    s1_cfg, s1 = load_pointnet2_checkpoint(run["dir"] / "s1.ckpt")
    assert s1_cfg == cfg.pointnet2.__class__(
        **dict(cfg.pointnet2.__dict__, learning_rate=1e-3))
    s2_cfg, s2 = load_pipeline_checkpoint(run["dir"] / "s2.ckpt")
    assert s2_cfg.learning_rate == 1e-3
    assert s2_cfg.volume_decoder_channels == cfg.volume_decoder_channels
    for k, v in s1.items():
        assert torch.equal(s2["pointnet2_nocs." + k], v), k
    ckpt = read_checkpoint(run["dir"] / "s2.ckpt")
    assert ckpt["global_step"] == STEPS
    n_trainable = sum(not k.startswith("pointnet2_nocs.") for k, v in
                      ckpt["state_dict"].items() if v.is_floating_point()
                      and "running" not in k)
    assert len(ckpt["optimizer_states"][0]["state"]) == n_trainable


def test_prints_the_jax_tools_lines(run):
    out = run["printed"]
    for line in ("generating 1x2 production-size samples...",
                 "stage-1 training (B=2)...",
                 "stage-2 training (B=2, frozen stage-1)...",
                 "predict CLI (B=2)...", "eval CLI...",
                 f"artifacts: {run['dir']}"):
        assert line in out.splitlines(), line
    assert len(re.findall(rf"trained {STEPS} steps in \d+s, loss "
                          r"[\d.]+ -> [\d.]+", out)) == 2
    assert "  predict: {'garments': 2" in out
    assert "  eval summary (chamfer/nocs): {'nocs_pc_error_distance'" in out


def test_prediction_has_the_predict_clis_schema(run):
    """The predict CLI over the train subset: every garment, the five
    sample groups with their arrays, Blosc metadata, `subset` train."""
    assert run["predict_summary"]["garments"] == 2
    root = zarrlite.open(str(run["predict_run"] / "prediction.zarr"), "r")
    assert root.attrs.asdict() == {"subset": "train"}
    groups = list(root["samples"].groups())
    assert [k for k, _ in groups] == ["00000_00", "00000_01"]
    mc_names = set(nan_mc_placeholders())
    for _, g in groups:
        assert {k for k, _ in g.groups()} == {
            "marching_cubes_mesh", "point_cloud", "gt_mesh",
            "gt_marching_cubes_mesh", "misc"}
        assert {k for k, _ in g["marching_cubes_mesh"].arrays()} == mc_names
        assert {"pred_nocs", "pred_nocs_confidence", "pred_nocs_logits",
                "input_points", "input_rgb", "gt_nocs"} <= {
                    k for k, _ in g["point_cloud"].arrays()}
        assert g["point_cloud/pred_nocs"].meta["compressor"]["id"] in (
            "blosc", "zlib")
        verts = g["marching_cubes_mesh/verts"][:]
        assert verts.dtype == np.float32 and verts.shape[1] == 3


@pytest.fixture(scope="module")
def jax_eval(run):
    """The JAX eval, configs/eval_default.yaml as the port's eval CLI ran
    it (one worker), on a copy of the predict run."""
    copy = run["dir"] / "jax_predict_run"
    shutil.copytree(run["predict_run"], copy)
    cfg = jconfig.load_config("eval_default", [
        f"main.prediction_output_dir={copy}", "main.num_workers=1"])
    return pathlib.Path(jeval.main(cfg, run_dir=str(run["dir"] / "jax_ev")))


@pytest.mark.parametrize("output", EVAL_OUTPUTS)
def test_eval_equals_jax_eval(run, jax_eval, output):
    assert run["eval_summary"]["null_percentage"] == 0.0
    assert ((run["eval_run"] / output).read_bytes()
            == (jax_eval / output).read_bytes())


@pytest.fixture(scope="module")
def nulled(run):
    """A copy of the prediction.zarr whose first sample is the predict
    CLI's NaN sentinel (no surface)."""
    path = run["dir"] / "nulled.zarr"
    shutil.copytree(run["predict_run"] / "prediction.zarr", path)
    mc = zarrlite.open(str(path), "r+")["samples/00000_00/marching_cubes_mesh"]
    for name, value in nan_mc_placeholders().items():
        mc.array(name, value)
    return path


@pytest.mark.parametrize("apply_filter", [True, False])
def test_export_meshes_bytes_equal_jax(run, nulled, apply_filter):
    jtool = _jax_tool("export_meshes")
    out = run["dir"] / f"ply_{apply_filter}"
    t = export_meshes.export(str(nulled), str(out / "torch"),
                             apply_filter=apply_filter)
    j = jtool.export(str(nulled), str(out / "jax"),
                     apply_filter=apply_filter)
    assert [p.name for p in t] == [p.name for p in j] == [
        "00000_01_canonical.ply", "00000_01_task.ply"]
    for a, b in zip(t, j):
        assert a.read_bytes() == b.read_bytes(), a.name
    header, body = t[0].read_text().split("end_header\n")
    n_verts = int(re.search(r"element vertex (\d+)", header).group(1))
    faces = np.loadtxt(io.StringIO(body), skiprows=n_verts, dtype=np.int64)
    assert faces.ndim == 2 and (faces[:, 0] == 3).all()
    assert 0 <= faces[:, 1:].min() and faces[:, 1:].max() < n_verts


def test_export_meshes_cli(run, nulled, capsys):
    out = run["dir"] / "ply_cli"
    written = export_meshes.main([str(nulled), str(out), "--no-filter"])
    assert len(written) == 2
    assert capsys.readouterr().out == f"wrote 2 PLY files to {out}\n"


def test_bench_input_prints_its_schema(capsys):
    res = bench_input.main(
        ["1"], scale=e2e_synthetic.Scale(**dict(SCALE.__dict__,
                                                batch_size=3)),
        model_cfg=pu.torch_cfg(), device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"volume codec: (blosc|zlib)", lines[0])
    for line, w in zip(lines[1:4], bench_input.WORKERS):
        assert re.fullmatch(rf"num_workers={w}: +[\d.]+ samples/sec "
                            r"\(\d+ samples in [\d.]+s\)", line), line
    assert re.fullmatch(r"volume read and decode: [\d.]+ ms a sample of "
                        r"[\d.]+ ms a sample on one thread", lines[4])
    assert re.fullmatch(r"stage-2 train step on cpu: [\d.]+ ms a step of 3 "
                        r"samples, +[\d.]+ samples/sec", lines[5])
    assert len(lines) == 6
    assert set(res) == {"codec", "loader", "volume_read_ms", "device",
                        "step_ms", "step_samples_per_s"}
    assert sorted(res["loader"]) == list(bench_input.WORKERS)
    assert all(v > 0 for v in res["loader"].values())
