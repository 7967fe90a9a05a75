"""Both train CLIs launched by torchrun on the CPU, held to the same CLI's
spawned two-rank run.

`python -m torch.distributed.run --standalone --nproc_per_node 2 -m
garmentnets_tpu_torch.harness.train_pointnet2 <overrides>` (then
train_pipeline on that run's last.ckpt), with trainer.device=cpu (gloo)
and trainer.num_devices=2, one epoch of one step on a small synthetic set
(tests/test_torch_ddp.py's cli_runs data; tests/test_torch_train_cli.py's
configurations as dotted overrides of configs/train_*_default.yaml), each
launch under a subprocess timeout. Under torchrun the CLI joins
torchrun's group (harness/training.run_ranks: init_distributed from the
environment) and takes rank 0's run directory on every rank
(`_shared_run_dir`): one run directory, one checkpoint set, one
metrics.jsonl and summary.json.

The reference is the same command without torchrun: the CLI spawns its
two ranks itself (run_ranks' other branch). The epoch's train loss of the
two launches agrees within rtol 1e-6, and so does every tensor of their
last.ckpt (the weights after the step and Adam's moments, which hold the
gradients summed across the ranks), stage 2 of both on the torchrun
stage 1's last.ckpt. Every launch of the `runs` fixture runs the CLI
module through tests/torch_seeded_cli.py, which seeds the train split's
random draws by the sample index (the datamodule draws them from fresh
entropy every epoch), so that the two launches read the same rows; only
the failing launch runs the CLI module itself. A rank that raises under
torchrun (stage 2 on a checkpoint that does not exist) makes the launch
exit non-zero. Each launch runs in a session of its own and is killed
with all its processes, the ranks included, at TIMEOUT_S.
"""
import json
import os
import pathlib
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_torch_train_cli import _records, _s1_cfg, _s2_cfg  # noqa: E402

from garmentnets_tpu_torch.data.synthetic import generate_dataset  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
CLIS = {1: "garmentnets_tpu_torch.harness.train_pointnet2",
        2: "garmentnets_tpu_torch.harness.train_pipeline"}
TRAINER = dict(num_devices=2, max_epochs=1, limit_train_batches=1)


def overrides(cfg: dict, prefix: str = "") -> list:
    """A configuration as dotted key=value overrides, each value as JSON
    (which the config loader reads as YAML)."""
    out = []
    for k, v in cfg.items():
        if isinstance(v, dict) and v:
            out += overrides(v, f"{prefix}{k}.")
        else:
            out.append(f"{prefix}{k}={json.dumps(v)}")
    return out


def start(cli: str, over: list, cwd: pathlib.Path, torchrun: bool,
          seeded: bool = True):
    """The CLI module `cli` with these overrides from `cwd`: under torchrun
    (two ranks) or as a plain process; through tests/torch_seeded_cli.py
    when `seeded`."""
    cwd.mkdir()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "tests"), os.environ.get("PYTHONPATH", "")]))
    if torchrun:
        # each rank's CPU threads as run_ranks gives its spawned ranks
        # (the host's cores over the world size; torchrun would give 1),
        # so that both launches sum in the same order
        env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // 2))
    launcher = ([sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc_per_node", "2"] if torchrun
                else [sys.executable])
    module = ["-m", "torch_seeded_cli", cli] if seeded else ["-m", cli]
    return subprocess.Popen(launcher + module + over, cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)


def finish(proc) -> tuple:
    """(returncode, stdout, stderr); at TIMEOUT_S the launch's whole
    process group (the launcher and its ranks, which hold its pipes) is
    killed, and the returncode is None."""
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        return None, out, err
    return proc.returncode, out, err


def check_finished(rc, err: str, what) -> None:
    assert rc is not None, f"{what}: past its {TIMEOUT_S} s timeout"
    assert rc == 0, (what, err[-4000:])


def run_dirs(cwd: pathlib.Path) -> list:
    """The run directories a launch from `cwd` made (the CLIs' default
    outputs/<date>/<time>)."""
    return sorted(p for p in cwd.glob("outputs/*/*") if p.is_dir())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Stage 1 by torchrun and spawned, side by side; then stage 2 of both
    on the torchrun stage 1's last.ckpt. {stage: {kind: [run dirs]}}."""
    d = tmp_path_factory.mktemp("torchrun")
    generate_dataset(str(d / "synth.zarr"), num_instances=3,
                     grips_per_instance=2, volume_size=16, mesh_res=8,
                     pts_per_view=400, seed=0, include_task_space=False)
    out = {"d": d}
    ckpt = None
    for stage in (1, 2):
        cfg = (_s1_cfg(d, **TRAINER) if stage == 1
               else _s2_cfg(d, ckpt, **TRAINER))
        over = overrides(cfg)
        procs = {kind: start(CLIS[stage], over, d / f"{kind}{stage}",
                             kind == "torchrun")
                 for kind in ("torchrun", "spawned")}
        done = {kind: finish(proc) for kind, proc in procs.items()}
        for kind, (rc, _, err) in done.items():
            check_finished(rc, err, (kind, stage))
        out[stage] = {kind: run_dirs(d / f"{kind}{stage}") for kind in procs}
        ckpt = out[stage]["torchrun"][0] / "checkpoints/last.ckpt"
    return out


def _train_losses(run: pathlib.Path) -> list:
    return [r["train_loss"] for r in _records(run) if "train_loss" in r]


@pytest.mark.parametrize("stage", [1, 2])
def test_torchrun_writes_one_run_from_rank_zero(runs, stage):
    """One run directory (rank 0's, shared through _shared_run_dir) with
    one top-k checkpoint and last.ckpt, one epoch record in metrics.jsonl
    and one summary."""
    dirs = runs[stage]["torchrun"]
    assert len(dirs) == len(runs[stage]["spawned"]) == 1, dirs
    run = dirs[0]
    names = sorted(p.name for p in (run / "checkpoints").glob("*.ckpt"))
    assert len(names) == 2 and "last.ckpt" in names, names
    lines = (run / "metrics.jsonl").read_text().splitlines()
    assert sum('"epoch": 0' in line for line in lines) == 1
    summary = json.loads((run / "summary.json").read_text())
    assert summary["global_step"] == 1


@pytest.mark.parametrize("stage", [1, 2])
def test_torchrun_loss_equals_the_spawned_ranks(runs, stage):
    """The epoch's train loss of the torchrun launch within rtol 1e-6 of
    the spawned two-rank run's on the same data, seed and configuration."""
    got = _train_losses(runs[stage]["torchrun"][0])
    want = _train_losses(runs[stage]["spawned"][0])
    assert len(got) == len(want) == 1 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("stage", [1, 2])
def test_torchrun_checkpoint_equals_the_spawned_ranks(runs, stage):
    """Every tensor of the torchrun launch's last.ckpt within rtol 1e-6 of
    the spawned two-rank run's (atol 1e-6 of the tensor's largest entry):
    the weights and statistics after the step, and Adam's first and
    second moments, which are the ranks' summed gradient and its square.
    The loss above is taken before any gradient is exchanged; these are
    taken after the all-reduce and the optimizer step."""
    def tensors(run):
        ckpt = torch.load(run / "checkpoints/last.ckpt", weights_only=True)
        out = {f"state_dict.{k}": v for k, v in ckpt["state_dict"].items()}
        for i, st in ckpt["optimizer_states"][0]["state"].items():
            out.update({f"adam.{i}.{k}": v for k, v in st.items()})
        return out
    got = tensors(runs[stage]["torchrun"][0])
    want = tensors(runs[stage]["spawned"][0])
    assert set(got) == set(want) and any(k.startswith("adam.") for k in got)
    for k, v in want.items():
        v = v.double().numpy()
        np.testing.assert_allclose(got[k].double().numpy(), v, rtol=1e-6,
                                   atol=1e-6 * np.abs(v).max(), err_msg=k)


def test_torchrun_rank_error_fails_the_launch(runs):
    """Stage 2 on a stage-1 checkpoint that does not exist: both ranks
    raise, and the torchrun launch exits non-zero naming the file."""
    d = runs["d"]
    over = overrides(_s2_cfg(d, d / "missing.ckpt", **TRAINER))
    rc, _, err = finish(start(CLIS[2], over, d / "torchrun_bad", True,
                              seeded=False))
    assert rc is not None, f"past its {TIMEOUT_S} s timeout"
    assert rc != 0
    assert "missing.ckpt" in err
