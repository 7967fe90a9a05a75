"""Data-parallel training of the port on two gloo ranks on the CPU, held to
the JAX package's trainer on a 2-device mesh.

A global batch of 3 rows is padded to 4 by repeating row 0, as JAX's
Trainer._prep pads it (`_valid_mask` 0 on the padded row), and each rank
keeps 2 rows. JAX runs the step's value_and_grad over the padded batch
sharded on make_mesh(2) (the computation of its make_train_fns'
train_step); the port's ranks run make_train_fns over the process group
(tests/torch_ddp_util.py, started as a subprocess under a timeout, which
spawns the ranks). Bars are tests/test_torch_train.py's: the loss within
rtol 1e-5, each gradient within 1e-4 of its largest JAX entry, the
running statistics within rtol 1e-5 / atol 1e-6 at stage 2; at stage 1
(dropout off) the same or SPREAD_FACTOR times JAX's own change under a
1e-6 jitter, whichever is larger. After two Adam steps the ranks'
parameters are bit-equal. With datamodule.shard_by_process=true the two
ranks' train loaders read every train index once an epoch between them,
each rank takes its batch whole (a global batch of 2 x B), and the step's
loss and gradients equal one process's step on the two batches
concatenated, at the stage-2 bars above or, where larger, SPREAD_FACTOR
times that one process's own change under a 1e-6 jitter (the ranks run
on fewer threads, so their CPU reductions round in other orders); an
eval batch that ends uneven
across the ranks is padded with `_valid_mask` 0 and gives one process's
loss on the real rows. The train CLIs run with
trainer.num_devices=2 on trainer.device=cpu: one checkpoint set, written
by rank 0, that loads into the predict layout; a run whose ranks raise
exits non-zero.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_port_util as pu  # noqa: E402
from test_torch_train import (  # noqa: E402
    SPREAD_FACTOR, STAT_TOL, _atol, _jitter, _numpy_tree)
from test_torch_train_cli import _s1_cfg, _s2_cfg  # noqa: E402

from garmentnets_tpu.models import pipeline as jax_pipe  # noqa: E402
from garmentnets_tpu.models import pointnet2_nocs as jax_nocs  # noqa: E402
from garmentnets_tpu.parallel import mesh as jax_mesh  # noqa: E402
from garmentnets_tpu_torch.core.checkpoint import (  # noqa: E402
    load_pipeline_checkpoint)
from garmentnets_tpu_torch.core.weights import (  # noqa: E402
    numpy_state_from_jax, state_dict_from_jax)
from garmentnets_tpu_torch.core.random_weights import seeded_init_  # noqa: E402
from garmentnets_tpu_torch.data.synthetic import generate_dataset  # noqa: E402
from garmentnets_tpu_torch.harness.training import (  # noqa: E402
    batch_to_device, make_adam, make_train_fns)
from garmentnets_tpu_torch.models import pipeline as torch_pipe  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
B = 3           # the global batch; padded to 4, 2 rows a rank
M = 23          # query points a row
STEPS = 2


def _start(scenario: str, d: pathlib.Path) -> subprocess.Popen:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT), str(ROOT / "tests"), env.get("PYTHONPATH", "")])
    return subprocess.Popen(
        [sys.executable, "-m", "torch_ddp_util", scenario, str(d)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _finish(proc: subprocess.Popen, timeout: float = 180):
    """(returncode, stdout, stderr) of a started scenario; killed and
    failed at its timeout."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        pytest.fail(f"torch_ddp_util ran past its {timeout} s timeout")
    return proc.returncode, out, err


def _run(scenario: str, d: pathlib.Path, timeout: float = 180):
    return _finish(_start(scenario, d), timeout)


def _start_ranks(inputs: dict, d: pathlib.Path) -> subprocess.Popen:
    """Start the `steps` scenario on these inputs (the JAX reference is
    computed while the ranks run)."""
    torch.save(inputs, d / "inputs.pt")
    return _start("steps", d)


def _ranks(proc: subprocess.Popen, d: pathlib.Path) -> list:
    """Each rank's record of a started `steps` scenario."""
    rc, _, err = _finish(proc)
    assert rc == 0, err[-4000:]
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


def _padded(batch: dict) -> dict:
    padded, real_b = jax_mesh.pad_batch_to(batch, 4)
    mask = np.zeros(4, np.float32)
    mask[:real_b] = 1
    return dict(padded, _valid_mask=mask)


def _jax_step(f, params, batch):
    """value_and_grad of f over the batch sharded on make_mesh(2)."""
    mesh = jax_mesh.make_mesh(2)
    step = jax.jit(jax.value_and_grad(f, has_aux=True))
    (loss, mut), grads = step(jax_mesh.replicate_tree(params, mesh),
                              jax_mesh.shard_batch(_padded(batch), mesh))
    return float(loss), numpy_state_from_jax({
        "params": _numpy_tree(grads),
        "batch_stats": _numpy_tree(mut["batch_stats"])})


@pytest.fixture(scope="module")
def variables():
    return pu.jax_variables()


@pytest.fixture(scope="module")
def stage2(variables, tmp_path_factory):
    rng = np.random.RandomState(21)
    x = pu.inputs(seed=5)
    batch = {"x": np.concatenate([x["x"], x["x"][:1] * 0.5]),
             "pos": np.concatenate([x["pos"], x["pos"][:1] * 0.9]),
             "volume_query_points": rng.rand(B, M, 3).astype(np.float32),
             "gt_volume_value": rng.rand(B, M).astype(np.float32),
             "surf_query_points": rng.rand(B, M, 3).astype(np.float32),
             "gt_sim_points": rng.randn(B, M, 3).astype(np.float32)}
    d = tmp_path_factory.mktemp("ddp_s2")
    proc = _start_ranks({"kind": "stage2", "cfg": pu.torch_cfg(),
                         "state": state_dict_from_jax(variables),
                         "batch": batch, "steps": STEPS}, d)
    jcfg = pu.jax_cfg()
    jm = jax_pipe.ConvImplicitWNFPipeline(jcfg)

    def f(params, batch):
        out, mut = jm.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            batch, train=True, mutable=["batch_stats"])
        return jax_pipe.pipeline_loss(jcfg, out, batch)["loss"], mut

    loss, ref = _jax_step(f, variables["params"], batch)
    return dict(loss=loss, ref=ref, ranks=_ranks(proc, d), batch=batch)


@pytest.fixture(scope="module")
def stage1(variables, tmp_path_factory):
    rng = np.random.RandomState(22)
    x = pu.inputs(seed=6)
    batch = {"x": np.concatenate([x["x"], x["x"][:1] * 0.5]),
             "pos": np.concatenate([x["pos"], x["pos"][:1] * 0.9]),
             "y": rng.rand(B, pu.N, 3).astype(np.float32),
             "nocs_grip_point": rng.rand(B, 3).astype(np.float32)}
    jcfg = dataclasses.replace(pu.jax_cfg().pointnet2, dropout=False)
    jm = jax_nocs.PointNet2NOCS(jcfg)
    params = variables["params"]["pointnet2_nocs"]
    stats = variables["batch_stats"]["pointnet2_nocs"]
    d = tmp_path_factory.mktemp("ddp_s1")
    tcfg = dataclasses.replace(pu.torch_cfg().pointnet2, dropout=False)
    proc = _start_ranks({"kind": "stage1", "cfg": tcfg,
                         "state": state_dict_from_jax(
                             {"params": params, "batch_stats": stats}),
                         "batch": batch, "steps": STEPS}, d)

    def f(params, batch):
        out, mut = jm.apply({"params": params, "batch_stats": stats},
                            batch["x"], batch["pos"], train=True,
                            mutable=["batch_stats"])
        return jax_nocs.get_metrics(jcfg, out, batch)[0]["loss"], mut

    loss, ref = _jax_step(f, params, batch)
    spread = {"loss": 0.0}
    for p2, b2 in ((params, dict(batch, x=_jitter(batch["x"], 1))),
                   (_jitter(params, 2), batch)):
        loss2, ref2 = _jax_step(f, p2, b2)
        spread["loss"] = max(spread["loss"], abs(loss2 - loss))
        for k, v in ref2.items():
            spread[k] = max(spread.get(k, 0.0),
                            float(np.abs(v - ref[k]).max()))
    return dict(loss=loss, ref=ref, spread=spread, ranks=_ranks(proc, d))


def test_ranks_take_padded_rows(stage2):
    """Rank 0 holds rows 0-1 and rank 1 holds row 2 and a copy of row 0,
    masked out."""
    r0, r1 = (r["rows"] for r in stage2["ranks"])
    x = stage2["batch"]["x"]
    np.testing.assert_array_equal(r0["x"].numpy(), x[:2])
    np.testing.assert_array_equal(r1["x"].numpy(), np.stack([x[2], x[0]]))
    assert r0["_valid_mask"].tolist() == [1.0, 1.0]
    assert r1["_valid_mask"].tolist() == [1.0, 0.0]


def test_stage2_step_matches_jax_two_devices(stage2):
    ref = stage2["ref"]
    for r in stage2["ranks"]:
        np.testing.assert_allclose(r["loss"], stage2["loss"], rtol=1e-5)
        assert set(r["grads"]) and not any(
            k.startswith("pointnet2_nocs.") for k in r["grads"])
        for name, g in r["grads"].items():
            np.testing.assert_allclose(
                g.numpy(), ref[name], rtol=0, err_msg=name,
                atol=1e-4 * np.abs(ref[name]).max())
        for name, b in r["stats"].items():
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(b.numpy(), ref[name],
                                           **STAT_TOL, err_msg=name)


def test_stage1_step_matches_jax_two_devices(stage1):
    ref, spread = stage1["ref"], stage1["spread"]
    for r in stage1["ranks"]:
        assert abs(r["loss"] - stage1["loss"]) <= max(
            1e-5 * abs(stage1["loss"]), SPREAD_FACTOR * spread["loss"])
        for name, g in r["grads"].items():
            np.testing.assert_allclose(g.numpy(), ref[name], rtol=0,
                                       err_msg=name, atol=_atol(
                                           ref[name], spread[name], 1e-4))
        for name, b in r["stats"].items():
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(b.numpy(), ref[name], rtol=0,
                                           err_msg=name, atol=_atol(
                                               ref[name], spread[name],
                                               1e-5))


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_replicas_stay_bit_equal(request, stage):
    """The summed gradients, the statistics and, after each of two Adam
    steps, every parameter are the same bits on both ranks; at stage 2 the
    frozen stage 1 does not move."""
    r0, r1 = request.getfixturevalue(stage)["ranks"]
    for name in r0["grads"]:
        assert torch.equal(r0["grads"][name], r1["grads"][name]), name
    for name in r0["stats"]:
        assert torch.equal(r0["stats"][name], r1["stats"][name]), name
    assert len(r0["params"]) == STEPS
    for p0, p1 in zip(r0["params"], r1["params"]):
        for name in p0:
            assert torch.equal(p0[name], p1[name]), name
    if stage == "stage2":
        first, last = r0["params"][0], r0["params"][-1]
        moved = [n for n in first if not torch.equal(first[n], last[n])]
        assert moved and not any(n.startswith("pointnet2_nocs.")
                                 for n in moved)


# the sharded loaders' datamodule: 4 instances x 2 grips, all in train
SHARD_DM = dict(
    metadata_cache_dir=None, batch_size=2, num_workers=0,
    num_pc_sample=pu.N, num_volume_sample=M, num_surface_sample=M,
    num_mc_surface_sample=0, surface_sample_ratio=0, surface_sample_std=0.05,
    surface_normal_noise_ratio=0, surface_normal_std=0.01,
    enable_augumentation=True, random_rot_range=[-180, 180], num_views=4,
    pc_noise_std=0, volume_size=16, volume_group="nocs_winding_number_field",
    tsdf_clip_value=None, volume_absolute_value=False, include_volume=False,
    static_epoch_seed=False, dataset_split=[1, 0, 0], split_seed=0,
    shard_by_process=True)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Two gloo ranks with shard_by_process=true (torch_ddp_util `shard`),
    and one process's eval step on the uneven rows' real ones and train
    step on the ranks' batches concatenated."""
    d = tmp_path_factory.mktemp("ddp_shard")
    zarr = d / "synth.zarr"
    generate_dataset(str(zarr), num_instances=4, grips_per_instance=2,
                     volume_size=16, mesh_res=8, pts_per_view=100, seed=0,
                     include_task_space=False)
    cfg = pu.torch_cfg()
    model = torch_pipe.ConvImplicitWNFPipeline(cfg)
    seeded_init_(model, 4)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    dm = dict(SHARD_DM, zarr_path=str(zarr))
    torch.save({"dm": dm, "cfg": cfg, "state": state}, d / "inputs.pt")
    rc, _, err = _run("shard", d)
    assert rc == 0, err[-4000:]
    ranks = [torch.load(d / f"shard{r}.pt", weights_only=False)
             for r in range(2)]

    real = {k: np.concatenate([ranks[0]["batch"][k][:2],
                               ranks[1]["batch"][k][:1]])
            for k in ranks[0]["batch"]}
    both = {k: np.concatenate([r["batch"][k] for r in ranks])
            for k in ranks[0]["batch"]}
    eval_loss, loss, grads = _one_process_step(cfg, state, real, both)
    # the spread: how far the one-process gradients move when the input
    # colours, or the weights, are jittered by 1e-6 (relative)
    names = {n for n, _ in model.named_parameters()}
    jittered = {k: torch.from_numpy(v) for k, v in _jitter(
        {k: v.numpy() for k, v in state.items()}, 2).items()}
    jittered = {k: jittered[k] if k in names else v
                for k, v in state.items()}
    spread = dict.fromkeys(grads, 0.0)
    for s, b in ((state, dict(both, x=_jitter(both["x"], 1))),
                 (jittered, both)):
        moved = _one_process_step(cfg, s, real, b)[2]
        spread = {n: max(spread[n], float((moved[n] - g).abs().max()))
                  for n, g in grads.items()}
    return dict(ranks=ranks, loss=loss, grads=grads, spread=spread,
                eval_loss=eval_loss, train=sorted(range(8)))


def _one_process_step(cfg, state: dict, real: dict, both: dict) -> tuple:
    """One process from `state`: the eval loss on the rows `real`, then
    the train step's loss and gradients on the rows `both`."""
    model = torch_pipe.ConvImplicitWNFPipeline(cfg)
    model.load_state_dict(state)
    model.pointnet2_nocs.requires_grad_(False)
    train_step, eval_step = make_train_fns(
        model, lambda b, gen: model(b),
        lambda o, b: torch_pipe.pipeline_loss(cfg, o, b),
        make_adam(model, 1e-3))
    eval_loss = float(eval_step(batch_to_device(real, "cpu"))["loss"])
    loss = float(train_step(batch_to_device(both, "cpu"))["loss"])
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return eval_loss, loss, grads


def test_shard_by_process_reads_every_index_once(sharded):
    """Each rank's loader is sharded and reads its own half of the 8 train
    garments in 2 batches of 2; together the ranks read each index once
    an epoch."""
    r0, r1 = sharded["ranks"]
    assert r0["sharded"] and r1["sharded"]
    assert r0["n_batches"] == r1["n_batches"] == 2
    assert not set(r0["seen"]) & set(r1["seen"])
    assert sorted(r0["seen"] + r1["seen"]) == sharded["train"]


def test_shard_by_process_global_batch_is_world_times_b(sharded):
    """A train step takes each rank's batch whole: 2 real rows a rank,
    4 in the global batch, and the step's loss and summed gradients are
    one process's on the concatenated batches: each gradient within 1e-4
    of its largest entry, or SPREAD_FACTOR times the one-process
    gradient's own change under a 1e-6 jitter of the input colours or the
    weights, where that is larger (the ranks run on fewer threads than
    the one process, so their reductions round in other orders)."""
    for r in sharded["ranks"]:
        assert r["mask"].tolist() == [1.0, 1.0] and r["n_rows"] == 4
        np.testing.assert_allclose(r["loss"], sharded["loss"], rtol=1e-5)
        assert set(r["grads"]) == set(sharded["grads"])
        for name, g in r["grads"].items():
            ref = sharded["grads"][name].numpy()
            np.testing.assert_allclose(
                g.numpy(), ref, rtol=0, err_msg=name,
                atol=_atol(ref, sharded["spread"][name], 1e-4))


def test_shard_by_process_pads_uneven_eval_rows(sharded):
    """Rank 0 holds 2 rows and rank 1 one: rank 1 pads to 2 rows with its
    row 0, masked out, and the global eval loss is one process's on the 3
    real rows."""
    r0, r1 = sharded["ranks"]
    assert r0["eval_mask"].tolist() == [1.0, 1.0]
    assert r1["eval_mask"].tolist() == [1.0, 0.0]
    for r in (r0, r1):
        assert r["n_eval"] == 3
        np.testing.assert_allclose(r["eval_loss"], sharded["eval_loss"],
                                   rtol=1e-5)


def test_a_failing_rank_fails_the_run(tmp_path):
    """Rank 1 raises while rank 0 waits at a collective: the run exits
    non-zero with rank 1's error, well inside its timeout."""
    rc, _, err = _run("fail", tmp_path, timeout=120)
    assert rc != 0
    assert "rank 1 fails on purpose" in err


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both train CLIs with trainer.num_devices=2 on the CPU, one epoch
    each, on a small synthetic set."""
    d = tmp_path_factory.mktemp("ddp_cli")
    generate_dataset(str(d / "synth.zarr"), num_instances=3,
                     grips_per_instance=2, volume_size=16, mesh_res=8,
                     pts_per_view=400, seed=0, include_task_space=False)
    runs = {}
    for stage in (1, 2):
        trainer = dict(num_devices=2, max_epochs=1, limit_train_batches=1)
        cfg = (_s1_cfg(d, **trainer) if stage == 1 else
               _s2_cfg(d, runs[1] / "checkpoints/last.ckpt", **trainer))
        spec_dir = d / f"spec{stage}"
        spec_dir.mkdir()
        torch.save({"stage": stage, "cfg": cfg,
                    "run_dir": str(d / f"s{stage}")}, spec_dir / "train.pt")
        rc, out, err = _run("train", spec_dir)
        assert rc == 0, err[-4000:]
        runs[stage] = pathlib.Path(out.strip().splitlines()[-1])
    return d, runs


@pytest.mark.parametrize("stage", [1, 2])
def test_cli_two_ranks_write_one_checkpoint_set(cli_runs, stage):
    """One epoch: one top-k checkpoint and last.ckpt, one epoch record in
    metrics.jsonl and one summary (rank 0's alone)."""
    _, runs = cli_runs
    run = runs[stage]
    names = sorted(p.name for p in (run / "checkpoints").glob("*.ckpt"))
    assert len(names) == 2 and "last.ckpt" in names, names
    lines = (run / "metrics.jsonl").read_text().splitlines()
    assert sum('"epoch": 0' in line for line in lines) == 1
    assert (run / "summary.json").exists()


def test_cli_two_ranks_checkpoint_loads_for_predict(cli_runs):
    _, runs = cli_runs
    cfg, state = load_pipeline_checkpoint(
        runs[2] / "checkpoints/last.ckpt")
    assert cfg.volume_decoder_channels[-1] == 1
    assert any(k.startswith("pointnet2_nocs.") for k in state)


def test_cli_rank_error_fails_the_run(cli_runs):
    """Stage 2 on a stage-1 checkpoint that does not exist: the ranks
    raise and the CLI run exits non-zero, naming the missing file."""
    d, _ = cli_runs
    spec_dir = d / "spec_bad"
    spec_dir.mkdir()
    cfg = _s2_cfg(d, d / "missing.ckpt", num_devices=2, max_epochs=1)
    torch.save({"stage": 2, "cfg": cfg, "run_dir": str(d / "s_bad")},
               spec_dir / "train.pt")
    rc, _, err = _run("train", spec_dir, timeout=120)
    assert rc != 0
    assert "missing.ckpt" in err
