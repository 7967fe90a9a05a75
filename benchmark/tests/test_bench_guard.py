"""The run refuses JAX and the JAX package, compared by top-level name."""
import subprocess
import sys
import types

import pytest

from benchmark.harness import cell, guard, manifest


def test_top_level_names_are_compared_whole():
    assert guard.forbidden_loaded({"garmentnets_tpu_torch": 1,
                                   "garmentnets_tpu_torch.ops": 1}) == []
    assert guard.forbidden_loaded({"garmentnets_tpu.ops.x": 1}) == [
        "garmentnets_tpu"]
    assert guard.forbidden_loaded({"jax.numpy": 1, "flax": 1,
                                   "jaxlib.xla": 1}) == ["flax", "jax",
                                                         "jaxlib"]


def test_a_planted_jax_package_import_fails_the_run(monkeypatch):
    monkeypatch.setitem(sys.modules, "garmentnets_tpu",
                        types.ModuleType("garmentnets_tpu"))
    with pytest.raises(cell.ForbiddenModules):
        cell._guard("in a test")


def test_the_port_passes_the_guard():
    import garmentnets_tpu_torch.harness.serve  # noqa: F401
    import garmentnets_tpu_torch.harness.training  # noqa: F401
    cell._guard("in a test")


def test_the_harness_loads_nothing_forbidden():
    code = ("import sys; sys.path.insert(0, '.');"
            "import benchmark.drivers.train, benchmark.tools.readings;"
            "import benchmark.harness.cell;"
            "import garmentnets_tpu_torch.harness.serve;"
            "from benchmark.harness import guard;"
            "print(guard.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=manifest.ROOT, check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_without_a_card_exits_non_zero_and_prints_nothing():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card exit cannot show here")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "train1-b8",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=manifest.ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
