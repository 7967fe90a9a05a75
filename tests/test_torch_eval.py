"""The port's eval CLI (harness/eval.py) and its host modules against the
JAX package's, on the CPU.

Three predictions are written by the port's predict CLI over one synthetic
dataset of the port's generator (task-space volumes included), at the tiny
width of torch_port_util with seeded port weights and a volume-decoder head
that puts ~10% of the voxels above the iso level: the plain model, the
mc-surface (hole) head with prediction.use_hole_prediction, and the
task-space model. Each prediction directory is copied twice; the JAX eval
runs on one copy and the port's on the other (each writes its summary into
its copy's prediction.zarr). all_metrics.csv, all_metrics_agg.csv,
summary.json and every summary/metrics array must be equal to the bit, NaN
in the same places, and the vis PLY files byte-equal:

- the default config with all seven metrics enabled (small num_points);
- the hole prediction with value_key=.../is_on_surface_logits and a float
  value_threshold of 0;
- volume_task_space=true, the port's eval on two workers.

Each eval helper the metrics call (delete_invalid_verts,
connected_components, the exact C++ mesh_hausdorff, geodesic_matrix) and
the built-in viridis table are held against the JAX function, the table
also against matplotlib.
"""
import copy
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_port_util as pu  # noqa: E402
from test_torch_predict import DM, EVAL_CFG, PRED  # noqa: E402

from garmentnets_tpu.harness import eval as jeval  # noqa: E402
from garmentnets_tpu_torch.core.checkpoint import save_pipeline_checkpoint  # noqa: E402
from garmentnets_tpu_torch.core.random_weights import seeded_init_  # noqa: E402
from garmentnets_tpu_torch.data import zarrlite  # noqa: E402
from garmentnets_tpu_torch.data.dataset import ConvImplicitWNFDataModule  # noqa: E402
from garmentnets_tpu_torch.data.synthetic import generate_dataset  # noqa: E402
from garmentnets_tpu_torch.harness import eval as teval  # noqa: E402
from garmentnets_tpu_torch.harness import predict  # noqa: E402
from garmentnets_tpu_torch.models.pipeline import ConvImplicitWNFPipeline  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
VOL = PRED["volume_size"]
ALL_METRICS = copy.deepcopy(EVAL_CFG)
ALL_METRICS["eval"]["compute_geodesic"]["enabled"] = True
# the three eval runs: (prediction, eval overrides, the port's workers)
EVALS = {
    "default": ("plain", {}, 1),
    "holes": ("holes", {"override_all": {
        "value_key": "marching_cubes_mesh/is_on_surface_logits",
        "value_threshold": 0.0}}, 1),
    "task_space": ("task_space", {"override_all": {
        "volume_task_space": True}}, 2),
}
VIS = {"samples_per_instance": 1, "num_best": 1, "num_worst": 1,
       "num_normal": 4, "rank_metric": "chamfer_symmetrical_nocs",
       "task_mesh_vis": {"offset": [0.6, 0, 0]},
       "nocs_mesh_vis": {"offset": [0.3, 0, 0], "value_delta": 0.1},
       "nocs_pc_vis": {"offset": [0.5, 0, 0]}}


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) else v
    return out


@pytest.fixture(scope="module")
def predictions(tmp_path_factory):
    """{name: predict run dir} of the port's CLI for the plain, hole and
    task-space checkpoints."""
    d = tmp_path_factory.mktemp("eval")
    zarr = str(d / "data.zarr")
    generate_dataset(zarr, num_instances=4, grips_per_instance=2,
                     volume_size=VOL, mesh_res=8, pts_per_view=200, seed=0,
                     include_task_space=True)
    dm = ConvImplicitWNFDataModule(zarr_path=zarr, **DM)
    dm.prepare_data()
    batch = next(iter(dm.test_dataloader()))
    aabb = dm.val_dataset.cloth_sim_aabb
    runs = {}
    for name, over in (("plain", {}), ("holes", pu.VARIANTS["holes"]),
                       ("task_space", pu.VARIANTS["task_space"])):
        cfg = pu.torch_cfg(**over)
        model = ConvImplicitWNFPipeline(cfg)
        seeded_init_(model, 3)
        sd = pu.live_head_state(
            cfg, model.state_dict(), batch["x"], batch["pos"], VOL,
            task_aabb=aabb if cfg.volume_task_space else None)
        if cfg.has_mc_surface_decoder:
            # the hole head as the live volume decoder minus 0.5: its
            # logits change sign on the meshes' vertices
            for k in [k for k in sd if k.startswith("volume_decoder.")]:
                sd["mc_surface_decoder." + k.split(".", 1)[1]] = sd[k]
            last = len(cfg.mc_surface_decoder_channels) - 2
            sd[f"mc_surface_decoder.mlp.{last}.2.running_mean"] = \
                sd[f"volume_decoder.mlp.{last}.2.running_mean"] + 0.5
        ckpt = d / f"{name}.ckpt"
        save_pipeline_checkpoint(ckpt, cfg, sd)
        runs[name] = pathlib.Path(predict.main({
            "main": {"checkpoint_path": str(ckpt)},
            "prediction": dict(PRED, device="cpu",
                               use_hole_prediction=name == "holes"),
            "logger": {}, "datamodule": dict(DM, zarr_path=zarr)},
            run_dir=str(d / f"predict_{name}")))
    return d, runs


@pytest.fixture(scope="module")
def evals(predictions):
    """{eval name: {"jax" | "torch": eval run dir}}, each side on its own
    copy of the prediction."""
    d, runs = predictions
    out = {}
    for name, (pred, over, workers) in EVALS.items():
        out[name] = {}
        for side, main, n in (("jax", jeval.main, 1),
                              ("torch", teval.main, workers)):
            copy_dir = d / f"{name}_{side}_prediction"
            shutil.copytree(runs[pred], copy_dir)
            cfg = _merge(ALL_METRICS, over)
            cfg["main"] = {"prediction_output_dir": str(copy_dir),
                           "num_workers": n}
            if name == "default":
                cfg["vis"] = VIS
            out[name][side] = (pathlib.Path(main(
                cfg, run_dir=str(d / f"{name}_{side}_eval"))), copy_dir)
    return out


def test_predictions_carry_the_variant_outputs(predictions):
    """Every garment has a surface; the hole run writes is_on_surface
    (bool, logits > 0) and is_on_surface_logits (f32) at every vertex, the
    others neither."""
    _, runs = predictions
    for name, run in runs.items():
        root = zarrlite.open(str(run / "prediction.zarr"), "r")
        groups = list(root["samples"].groups())
        assert len(groups) == 4
        for _, g in groups:
            mc = g["marching_cubes_mesh"]
            n = len(mc["verts"][:])
            assert n > 20 and np.isfinite(mc["verts"][:]).all()
            assert ("is_on_surface" in mc) == (name == "holes")
            if name == "holes":
                logits = mc["is_on_surface_logits"][:]
                on = mc["is_on_surface"][:]
                assert logits.dtype == np.float32 and on.dtype == bool
                assert logits.shape == on.shape == (n,)
                np.testing.assert_array_equal(on, logits > 0)


@pytest.mark.parametrize("name", sorted(EVALS))
@pytest.mark.parametrize("output", ["all_metrics.csv", "all_metrics_agg.csv",
                                    "summary.json"])
def test_eval_outputs_bit_equal(evals, name, output):
    j, t = (evals[name][s][0] / output for s in ("jax", "torch"))
    assert t.read_bytes() == j.read_bytes()


def _summary_arrays(prediction_dir: pathlib.Path) -> dict:
    out = {}

    def walk(g, pre):
        for key, node in g.items():
            if isinstance(node, zarrlite.Array):
                out[pre + key] = np.asarray(node)
            else:
                walk(node, pre + key + "/")
    walk(zarrlite.open(str(prediction_dir / "prediction.zarr"),
                       "r")["summary"], "")
    return out


@pytest.mark.parametrize("name", sorted(EVALS))
def test_summary_arrays_bit_equal(evals, name):
    j = _summary_arrays(evals[name]["jax"][1])
    t = _summary_arrays(evals[name]["torch"][1])
    assert sorted(t) == sorted(j)
    assert "metrics/per_sample/sample_keys" in t
    for k in j:
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(EVALS))
def test_every_metric_ran(evals, name):
    """All seven metric functions gave finite values on some sample (the
    hole logits' and the task-space runs included) and the port's
    timings.json names each."""
    run = evals[name]["torch"][0]
    summary = json.loads((run / "summary.json").read_text())
    for key in ("optimal_wnf_gradient_threshold", "nocs_pc_error_distance",
                "grip_point_error_distance_pc", "chamfer_symmetrical_nocs",
                "hybrid_chamfer_symmetrical_regular_pred",
                "geodesic_rms_nocs", "hausdorff_nocs"):
        assert np.isfinite(summary[key]), key
    assert summary["null_percentage"] == 0.0
    timings = json.loads((run / "timings.json").read_text())
    assert set(teval.METRIC_FUNC_DICT) <= set(timings)
    assert timings["samples"] == 4 and timings["null_samples"] == 0


def test_vis_ply_files_byte_equal(evals):
    j, t = (evals["default"][s][0] / "vis" for s in ("jax", "torch"))
    names = sorted(p.name for p in t.iterdir())
    assert names == sorted(p.name for p in j.iterdir())
    assert len(names) == 3 * 4      # three vis functions, every sample
    for n in names:
        assert (t / n).read_bytes() == (j / n).read_bytes(), n


# ---- the helpers of the metrics against the JAX functions ----
def _mesh(seed, n_faces=300, n_verts=200):
    rs = np.random.RandomState(seed)
    verts = rs.rand(n_verts, 3)
    faces = rs.randint(0, n_verts, (n_faces, 3)).astype(np.int32)
    return verts, faces


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_delete_invalid_verts_matches_jax(seed):
    from garmentnets_tpu.ops.marching_cubes import delete_invalid_verts as j
    from garmentnets_tpu_torch.ops.marching_cubes import (
        delete_invalid_verts as t)
    verts, faces = _mesh(seed)
    on = np.random.RandomState(seed + 10).rand(len(verts)) > 0.3
    for a, b in zip(t(verts, faces, on), j(verts, faces, on)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_connected_components_matches_jax(seed):
    from garmentnets_tpu.ops.geometry import connected_components as j
    from garmentnets_tpu_torch.ops.geometry import connected_components as t
    _, faces = _mesh(seed, n_faces=60)
    for faces_ in (faces, faces[:0]):
        a, b = t(faces_, 200), j(faces_, 200)
        assert a[0] == b[0] and a[0] > 1
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mesh_hausdorff_exact_matches_jax(seed):
    """The port's C++ build of the same source gives the JAX package's
    exact distances to the bit (the JAX loader built its library, not its
    sampled fallback)."""
    from garmentnets_tpu.ops import geometry as jg
    from garmentnets_tpu_torch.ops import geometry as tg
    assert jg._load_hausdorff_lib() is not None
    va, fa = _mesh(seed)
    vb, fb = _mesh(seed + 5)
    assert tg.mesh_hausdorff(va, fa, vb, fb) == jg.mesh_hausdorff(
        va, fa, vb, fb)
    pts = np.random.RandomState(seed).rand(50, 3)
    np.testing.assert_array_equal(tg.points_to_mesh_distance(pts, va, fa),
                                  jg.points_to_mesh_distance(pts, va, fa))


def test_sampled_hausdorff_is_the_jax_fallback(monkeypatch):
    """mesh_hausdorff_sampled is the JAX function's no-toolchain branch,
    which the port reaches only by that name."""
    from garmentnets_tpu.ops import geometry as jg
    from garmentnets_tpu_torch.ops import geometry as tg
    va, fa = _mesh(0)
    vb, fb = _mesh(5)
    exact = tg.mesh_hausdorff(va, fa, vb, fb)
    monkeypatch.setattr(jg, "_load_hausdorff_lib", lambda: None)
    sampled = tg.mesh_hausdorff_sampled(va, fa, vb, fb, num_samples=500)
    assert sampled == jg.mesh_hausdorff(va, fa, vb, fb, num_samples=500)
    assert sampled != exact


def test_hausdorff_build_failure_raises(tmp_path, monkeypatch):
    """A hausdorff.cpp that does not compile raises, naming the library,
    and leaves no library behind (no sampled fallback)."""
    from garmentnets_tpu_torch.kernels import _build
    from garmentnets_tpu_torch.ops import geometry as tg
    (tmp_path / "ops" / "cpp").mkdir(parents=True)
    (tmp_path / "ops" / "cpp" / "hausdorff.cpp").write_text("not c++\n")
    monkeypatch.setattr(_build, "PKG_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_LIBS", {})
    va, fa = _mesh(0)
    with pytest.raises(RuntimeError, match="building hausdorff failed"):
        tg.mesh_hausdorff(va, fa, va, fa)
    assert not any((tmp_path / "_build").glob("*.so"))


@pytest.mark.parametrize("n_src", [1, 5, 70])
def test_geodesic_matrix_matches_jax(n_src):
    from garmentnets_tpu.ops.geodesic import geodesic_matrix as j
    from garmentnets_tpu_torch.ops.geodesic import geodesic_matrix as t
    from garmentnets_tpu_torch.ops.geometry import build_rectangle
    from garmentnets_tpu_torch.ops.geometry import quads2tris
    verts, _, quads, _ = build_rectangle(width_num_node=12,
                                         height_num_node=9)
    faces = quads2tris(quads.astype(np.int64))
    sel = np.random.RandomState(n_src).choice(len(verts), n_src,
                                              replace=False)
    a, b = t(verts, faces, sel), j(verts, faces, sel)
    assert a.shape == (n_src, n_src)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fn,args", [
    ("buffer_aabb", (np.array([[0.0, 1, 2], [3, 4, 5]]), 0.25)),
    ("build_line", (2.0, 7)),
    ("build_rectangle", (0.4, 0.3, 5, 4)),
    ("faces_to_edges", ([[0, 1, 2], [2, 1, 3], [3, 4, 0, 2]],))])
def test_geometry_helpers_match_jax(fn, args):
    from garmentnets_tpu.ops import geometry as jg
    from garmentnets_tpu_torch.ops import geometry as tg
    a, b = getattr(tg, fn)(*args), getattr(jg, fn)(*args)
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


# ---- the viridis table and the rendering module ----
VIRIDIS_INPUTS = {
    "in_range_f64": np.linspace(0, 1, 1001),
    "in_range_f32": np.random.RandomState(0).rand(997).astype(np.float32),
    "out_of_range": np.array([-1e9, -0.5, -1e-12, 1 + 1e-12, 1.5, 1e9,
                              np.inf, -np.inf]),
    "nan": np.array([np.nan, 0.5, np.nan]),
    "edges": np.array([0.0, 1.0, 1 / 256, 255 / 256, 0.5]),
    "integers": np.arange(-3, 262),
    "image": np.random.RandomState(1).randn(7, 9),
}


@pytest.mark.parametrize("name", sorted(VIRIDIS_INPUTS))
def test_viridis_matches_matplotlib_and_jax(name):
    from matplotlib import colormaps
    from garmentnets_tpu.utils import rendering as jr
    from garmentnets_tpu_torch.utils import rendering as tr
    x = VIRIDIS_INPUTS[name]
    ours = tr.viridis(x)
    for ref in (colormaps["viridis"](x), jr._viridis(x)):
        assert ours.dtype == ref.dtype and ours.shape == ref.shape
        np.testing.assert_array_equal(ours, ref)
    assert tr.viridis(0.25) == colormaps["viridis"](0.25)


def test_viridis_table_is_matplotlibs():
    from matplotlib import colormaps
    from garmentnets_tpu_torch.utils.rendering import VIRIDIS_RGB
    cm = colormaps["viridis"]
    np.testing.assert_array_equal(VIRIDIS_RGB, cm(np.arange(cm.N))[:, :3])


def test_rendering_matches_jax():
    from garmentnets_tpu.utils import rendering as jr
    from garmentnets_tpu_torch.utils import rendering as tr
    rs = np.random.RandomState(0)
    pts, vals = rs.rand(300, 3), rs.rand(300) * 2 - 0.5
    wnf = rs.randn(16, 16)
    for fn, args, kw in (
            ("render_wnf", (wnf,), {"img_size": 32}),
            ("render_wnf_points", (pts, vals), {"img_size": 32}),
            ("render_points_confidence", (pts, vals), {"img_size": 32}),
            ("render_nocs_pair", (pts, pts[::-1], pts[0], pts[1]),
             {"img_size": 32}),
            ("render_wnf_pair", (wnf, -wnf), {"img_size": 32})):
        np.testing.assert_array_equal(getattr(tr, fn)(*args, **kw),
                                      getattr(jr, fn)(*args, **kw),
                                      err_msg=fn)
    assert jr.get_vis_idxs(2, 4, vis_per_items=2, max_vis_per_epoch=9) == \
        tr.get_vis_idxs(2, 4, vis_per_items=2, max_vis_per_epoch=9)


def test_other_colormaps_name_matplotlib(monkeypatch):
    from garmentnets_tpu_torch.utils import rendering as tr
    assert tr.get_wnf_cmap()(np.array([0.5])).shape == (1, 4)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert tr.get_colormap("viridis") is tr.viridis
    with pytest.raises(ImportError, match="matplotlib"):
        tr.get_wnf_cmap("magma")


# ---- parallel_map ----
def test_parallel_map_processes_equal_serial(predictions, capsys):
    """The metrics over the samples in 2 fork workers give the frame of one
    worker, and the process mode is printed once."""
    from garmentnets_tpu_torch.harness import metrics, parallel_util
    from garmentnets_tpu_torch.harness.parallel_util import parallel_map
    _, runs = predictions
    root = zarrlite.open(str(runs["plain"] / "prediction.zarr"), "r")
    samples = root["samples"]
    keys = pd.Series([k for k, _ in samples.groups()] + ["missing"])
    nocs_aabb = np.array([[0.0, 0, 0], [1, 1, 1]], np.float32)

    def f(k):
        return metrics.compute_chamfer(k, samples, nocs_aabb,
                                       num_points=200, predict_holes=False)

    assert parallel_util.pool_mode() == "processes"
    parallel_util.MODES.discard("processes")
    serial = parallel_map(f, keys, num_workers=1)
    procs = [parallel_map(f, keys, num_workers=2, mode="process")
             for _ in range(2)]
    for df in procs:
        pd.testing.assert_frame_equal(df[["result"]], serial[["result"]])
        assert type(df.error.iloc[-1]) is type(serial.error.iloc[-1])
    assert pd.isna(serial.result.iloc[-1])
    assert capsys.readouterr().out.count("parallel_map: processes") == 1


# ---- the CLI re-executes the port's module, with the JAX package absent ----
_SHIM = "raise ImportError('blocked: {}')\n"
# runs cli() with os.execve wrapped to print the module it re-executes
_REEXEC_SPY = """
import os, sys
real = os.execve
def spy(path, argv, env):
    print("exec", *argv[1:3], flush=True)
    real(path, argv, env)
os.execve = spy
from garmentnets_tpu_torch.harness import eval
assert "jax" not in sys.modules
eval.cli()
"""


def test_cli_reexecs_the_ports_module(predictions, tmp_path):
    """cli() pins BLAS by re-executing `python -m` of the port's own eval
    module; run with jax and garmentnets_tpu shadowed by packages that
    raise on import, it writes the eval's outputs from the port's module."""
    _, runs = predictions
    pred = tmp_path / "prediction"
    shutil.copytree(runs["plain"], pred)
    shim = tmp_path / "shim"
    for name in ("jax", "jaxlib", "flax", "garmentnets_tpu"):
        (shim / name).mkdir(parents=True)
        (shim / name / "__init__.py").write_text(_SHIM.format(name))
    env = {k: v for k, v in os.environ.items()
           if k not in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                        "MKL_NUM_THREADS", "VECLIB_MAXIMUM_THREADS",
                        "NUMEXPR_NUM_THREADS", "_GARMENTNETS_BLAS_PINNED")}
    env["PYTHONPATH"] = f"{shim}{os.pathsep}{ROOT}"
    out = subprocess.run(
        [sys.executable, "-c", _REEXEC_SPY,
         f"main.prediction_output_dir={pred}", "main.num_workers=1",
         "eval.compute_chamfer.num_points=100",
         "eval.compute_hybrid_chamfer.num_points=100"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "exec -m garmentnets_tpu_torch.harness.eval"
    run = pathlib.Path(lines[-1])
    run = run if run.is_absolute() else tmp_path / run
    snap = (run / "config.yaml").read_text()
    assert "garmentnets_tpu_torch/harness/eval.py" in snap
    assert json.loads((run / "summary.json").read_text())
    assert teval.MODULE == "garmentnets_tpu_torch.harness.eval"
