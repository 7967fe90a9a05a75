"""Import isolation of the port: every module of garmentnets_tpu_torch and
chip_smoke.py imports with jax, garmentnets_tpu and the repository's
tools/ blocked, builds nothing at import time, and chip_smoke.py exits
non-zero without a CUDA device.
The server and its config loader import without pyyaml, which only the
CLI's config loading needs."""
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "garmentnets_tpu",
             "tools"):
    sys.modules[name] = None
import garmentnets_tpu_torch
mods = ["chip_smoke"] + [m.name for m in pkgutil.walk_packages(
    garmentnets_tpu_torch.__path__, "garmentnets_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
leaked = sorted(k for k, v in sys.modules.items()
                if v is not None and k.split(".")[0] in
                ("jax", "jaxlib", "flax", "garmentnets_tpu", "tools"))
assert not leaked, leaked
from garmentnets_tpu_torch.kernels import _build
assert not _build._LIBS, "a library was built at import time"
assert set(EXPECTED) <= set(mods), sorted(set(EXPECTED) - set(mods))
print(len(mods))
"""

# modules of the predict, serve, predict-CLI, eval, training,
# large-volume and multi-device slices, and the repository tools' copies,
# that must be among them
EXPECTED = [
    "garmentnets_tpu_torch." + m for m in (
        "harness.predict_engine", "harness.serve", "harness.predict",
        "harness.eval", "harness.metrics", "harness.parallel_util",
        "harness.eval_vis", "ops.geodesic", "ops.marching_cubes",
        "utils.rendering",
        "core.builders", "core.checkpoint", "core.config", "core.device",
        "core.weights", "core.logging", "core.trace", "kernels.sa_tc",
        "kernels.fps", "kernels.ggm", "kernels.dense_decode_tc",
        "ops.set_abstraction", "ops.geometry", "models.pointnet2",
        "data.blosc_codec", "data.zarrlite", "data.dataset",
        "data.synthetic", "utils.cache", "models.losses",
        "harness.training", "harness.train_pointnet2",
        "harness.train_pipeline", "harness.vis_hooks", "ops.normals",
        "ops.isosurface", "models.unet3d", "parallel.mesh",
        "tools.e2e_synthetic", "tools.export_meshes", "tools.bench_input",
        "tools.profile_unet3d", "kernels.conv3d_wgrad")]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", f"EXPECTED = {EXPECTED!r}\n" + _BLOCKED_IMPORT],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 60


def test_port_sources_name_no_jax_import():
    """No source file of the port imports jax, flax, the JAX package or
    the repository's tools/ (the JAX tools)."""
    bad = []
    for f in list((ROOT / "garmentnets_tpu_torch").rglob("*.py")) + [
            ROOT / "chip_smoke.py"]:
        for line in f.read_text().splitlines():
            s = line.strip()
            if (s.startswith(("import ", "from ")) and s.split()[1].split(
                    ".")[0] in ("jax", "jaxlib", "flax", "garmentnets_tpu",
                                "tools")):
                bad.append(f"{f.name}: {s}")
    assert not bad, bad


def test_chip_smoke_fails_without_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


_NO_YAML = r"""
import sys
sys.modules["yaml"] = None
from garmentnets_tpu_torch.harness import serve
from garmentnets_tpu_torch.core import config
try:
    config.load_config("serve_default")
except ImportError as e:
    assert "pyyaml" in str(e), e
    print("named")
"""


def test_serve_imports_without_yaml_and_cli_names_it():
    out = subprocess.run([sys.executable, "-c", _NO_YAML], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "named"


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repository, the script exits non-zero and prints no result."""
    import shutil
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
