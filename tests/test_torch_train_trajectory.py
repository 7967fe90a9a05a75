"""Stage-1 training of the port held to the JAX package's over a trajectory,
on the CPU.

Both trainers start from the same weights (the JAX init of each seed,
carried by core/weights.state_dict_from_jax) and take the same numpy
batches: one seeded Loader over a small synthetic set with the acceptance
run's dataset arguments (tools/e2e_synthetic.py: 4 views, no point noise,
augmentation with rotations in [-180, 180] degrees, fresh draws each
epoch), materialized once and fed to garmentnets_tpu.harness.training.
make_train_fns's train_step and to the port's (harness/training.py).

The bar, fixed from JAX's own spread before any port number was read: run
JAX from SEEDS (3 init seeds) and take the mean loss of every WINDOW-step
window. A window's bar is 1.5 x (max - min of JAX's three means), and at
least 2% of the mean of JAX's three means (chip_smoke.window_bars, which
holds the card to the CPU by the same rule). In every window from step
WINDOW on (the first window holds the fastest fall, where a one-step lag
is a large difference), each seed's port mean must lie within the bar of
JAX's mean for the same seed.

- tier 1: TIER1, a small stage-1 configuration (8 bins, radii 0.2 and
  0.4), 32 points, B=8, dropout off, the shipped learning rate 1e-4
  (configs/train_pointnet2_default.yaml), 60 steps;
- `slow`: LONG, the production PointNet2NOCSConfig() (64 bins, radii 0.05
  and 0.1) at 1000 points, B=8, dropout on, the acceptance run's learning
  rate 1e-3, 300 steps: a printed study
  (`python -m pytest -m slow -k trajectory -s`). With dropout on, the two
  packages draw their masks from different random streams, so a seed's
  two runs are independent draws and the bar above would be a coin flip;
  the study prints both packages' window means, each seed's and the
  seeds' mean, beside the bar, and asserts only that both learn.

The training state carried across (core/weights.training_state_from_jax):
JAX's whole state after K steps of seed 0 (parameters, statistics,
optax's mu, nu and count), loaded into the port's model and
torch.optim.Adam, then one more step of the port on batch K, dropout off.
Its loss, every gradient and every updated statistic are held to JAX's
step computed in float64 (jax_float64) at tests/test_torch_train.py's
stage-1 step bars: rtol 1e-5 on the loss, 1e-4 of a gradient's largest
entry, 1e-5 of a statistic's; or SPREAD_FACTOR times the float64 step's
own change under a 1e-6 jitter of the input colours or the weights, where
that is larger. JAX's own float32 step on the CPU is no steady reference
here: the step is ill-conditioned at this state, both packages' float32
gradients stray from the float64 step (JAX's by up to most of a
tensor's largest entry, the port's by up to a tenth of it), and JAX's by an
amount that changes with the host and with how its step is compiled
(the slow test_carried_step_at_lr_1e3_against_float64 prints how far,
and shows JAX's float64 step and the port's agree within 1e-6). With the
float64 gradients (rounded to float32) fed to both Adam steps, the
parameters within 1e-7 absolute plus 1e-7 relative
(test_adam_matches_optax's bars). With dropout on, the same step with the
masks JAX draws, put in place of the port's own draws, matches JAX's
float64 step within 1e-6 (test_carried_step_with_jax_dropout_masks).
"""
import contextlib
import dataclasses
import pathlib
import sys
import types

import flax.linen.stochastic as flax_stochastic
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_torch_train import (  # noqa: E402
    SPREAD_FACTOR, _atol, _jitter, _numpy_tree)

from garmentnets_tpu.harness import training as jax_training  # noqa: E402
from garmentnets_tpu.models import mlp as jax_mlp  # noqa: E402
from garmentnets_tpu.models import pointnet2 as jax_p2  # noqa: E402
from garmentnets_tpu.models import pointnet2_nocs as jax_nocs  # noqa: E402
from chip_smoke import (  # noqa: E402
    B, CARRY_REL, TRAJ_SEEDS as SEEDS, TRAJ_WINDOW as WINDOW, carried_state,
    carried_step, stage1_batches, step_ratios, window_bars, window_means)
from garmentnets_tpu_torch.core.weights import (  # noqa: E402
    numpy_state_from_jax, state_dict_from_jax, training_state_from_jax)
from garmentnets_tpu_torch.data.synthetic import generate_dataset  # noqa: E402
from garmentnets_tpu_torch.harness.training import (  # noqa: E402
    batch_to_device, make_adam, make_train_fns)
from garmentnets_tpu_torch.models import pointnet2 as port_p2  # noqa: E402
from garmentnets_tpu_torch.models import pointnet2_nocs as nocs  # noqa: E402

K = 5                   # JAX steps before the state is carried across


@dataclasses.dataclass(frozen=True)
class Study:
    n_points: int
    steps: int
    dropout: bool
    lr: float
    cfg: dict               # PointNet2NOCSConfig overrides
    dataset: dict           # generate_dataset arguments


TIER1 = Study(n_points=32, steps=60, dropout=False, lr=1e-4,
              cfg=dict(nocs_bins=8, sa1_r=0.2, sa2_r=0.4),
              dataset=dict(num_instances=2, grips_per_instance=2,
                           volume_size=16, mesh_res=8, pts_per_view=200))
LONG = Study(n_points=1000, steps=300, dropout=True, lr=1e-3, cfg={},
             dataset=dict(num_instances=4, grips_per_instance=3,
                          volume_size=16, mesh_res=24, pts_per_view=3000))


def batches(study: Study, path: pathlib.Path) -> list:
    """study.steps batches (chip_smoke.stage1_batches) over a synthetic
    set written to `path`."""
    generate_dataset(str(path), include_task_space=False, device="cpu",
                     **study.dataset)
    return stage1_batches(path, study.n_points, study.steps)


def jax_fns(study: Study):
    """The JAX model's config and make_train_fns(...) at study's config."""
    cfg = jax_nocs.PointNet2NOCSConfig(dropout=study.dropout, **study.cfg)
    model = jax_nocs.PointNet2NOCS(cfg)
    init = jax.jit(lambda rng, b: model.init(rng, b["x"], b["pos"],
                                             train=False))

    def apply_fn(v, b, train, mutable, rngs):
        return model.apply(v, b["x"], b["pos"], train=train,
                           mutable=mutable, rngs=rngs)

    fns = jax_training.make_train_fns(
        init, apply_fn, lambda o, b: jax_nocs.get_metrics(cfg, o, b)[0],
        study.lr)
    return cfg, model, fns


def _host(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def jax_run(fns, seed: int, data: list, keep=()):
    """One JAX trajectory from the init of `seed` -> (the initial
    variables, the step losses, {step: the state after that many steps}
    for each step in keep)."""
    init_state, train_step, _ = fns
    rng, init_rng = jax.random.split(jax.random.PRNGKey(seed))
    state = init_state(init_rng, data[0])
    init = _host({"params": state["params"],
                  "batch_stats": state["batch_stats"]})
    losses, kept = [], {}
    for i, batch in enumerate(data):
        if i in keep:
            kept[i] = _host(state)
        rng, step_rng = jax.random.split(rng)
        state, metrics = train_step(state, batch, step_rng)
        losses.append(float(metrics["loss"]))
    if len(data) in keep:
        kept[len(data)] = _host(state)
    return init, losses, kept


def port_model(study: Study):
    cfg = nocs.PointNet2NOCSConfig(dropout=study.dropout, **study.cfg)
    return cfg, nocs.PointNet2NOCS(cfg)


def port_run(study: Study, seed: int, init: dict, data: list) -> list:
    """The port's trajectory from the JAX init `init` -> the step losses."""
    cfg, model = port_model(study)
    model.load_state_dict(state_dict_from_jax(init))
    train_step, _ = make_train_fns(
        model, lambda b, g: model(b["x"], b["pos"], generator=g),
        lambda o, b: nocs.get_metrics(cfg, o, b)[0],
        make_adam(model, study.lr))
    gen = torch.Generator().manual_seed(seed)
    return [float(train_step(batch_to_device(b, "cpu"), gen)["loss"])
            for b in data]


def study_runs(study: Study, tmp: pathlib.Path) -> dict:
    data = batches(study, tmp / "synth.zarr")
    fns = jax_fns(study)
    out = {"data": data, "fns": fns, "jax": [], "port": []}
    for seed in SEEDS:
        keep = (K,) if seed == SEEDS[0] else ()
        init, losses, kept = jax_run(fns[2], seed, data, keep)
        out["jax"].append(losses)
        if keep:
            out["kept"] = kept
        out["port"].append(port_run(study, seed, init, data))
    return out


def report(study: Study, runs: dict) -> tuple:
    """(JAX's and the port's window means [seeds, windows], the bars),
    printed as a table."""
    jm = np.stack([window_means(x) for x in runs["jax"]])
    pm = np.stack([window_means(x) for x in runs["port"]])
    bars = window_bars(jm)
    print(f"\nstage-1 trajectory, {study.n_points} points, B={B}, dropout "
          f"{study.dropout}, {study.steps} steps: mean loss of each "
          f"{WINDOW}-step window, seeds {SEEDS}")
    for w in range(jm.shape[1]):
        print(f"steps {w * WINDOW:4d}-{(w + 1) * WINDOW - 1:4d}: JAX "
              f"{np.round(jm[:, w], 4).tolist()} port "
              f"{np.round(pm[:, w], 4).tolist()} |diff| "
              f"{np.round(np.abs(pm[:, w] - jm[:, w]), 4).tolist()} bar "
              f"{bars[w]:.4f}")
    return jm, pm, bars


def check_trajectory(study: Study, runs: dict) -> None:
    jm, pm, bars = report(study, runs)
    assert np.isfinite(jm).all() and np.isfinite(pm).all()
    for means in (jm, pm):
        assert (means[:, -1] < means[:, 0]).all(), means
    diff = np.abs(pm - jm)[:, 1:]
    bad = np.argwhere(diff > bars[None, 1:])
    assert not len(bad), [
        (SEEDS[s], f"window {w + 1}", float(pm[s, w + 1]),
         float(jm[s, w + 1]), float(bars[w + 1])) for s, w in bad]


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """These small steps gain little from more threads, and the suite runs
    several workers on the host's cores at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tier1(tmp_path_factory):
    return study_runs(TIER1, tmp_path_factory.mktemp("trajectory"))


def test_stage1_trajectory_matches_jax(tier1):
    check_trajectory(TIER1, tier1)


@pytest.mark.slow
def test_stage1_trajectory_long_study(tmp_path):
    """The long study at LONG's size: each package's window means printed,
    each seed's and the seeds' mean, beside the bar; both packages learn."""
    jm, pm, bars = report(LONG, study_runs(LONG, tmp_path))
    print("seeds' mean of each window (JAX, port, |diff| / bar): " + "; ".join(
        f"{a:.4f} {b:.4f} {abs(a - b) / c:.3f}"
        for a, b, c in zip(jm.mean(0), pm.mean(0), bars)))
    assert np.isfinite(jm).all() and np.isfinite(pm).all()
    for means in (jm, pm):
        assert (means[:, -1] < means[:, 0]).all(), means


def test_chip_smoke_carried_step_in_float64(tmp_path):
    """chip_smoke's carried step (phase_train_trajectory holds the card's
    to the CPU's) at TIER1's size on the CPU: from the state of two steps,
    a float64 step whose gradients are float64, FPS and the ball query
    given float32 positions and put back after it, and two runs on 2 and
    1 threads within CARRY_REL of each other."""
    cfg, _ = port_model(TIER1)
    data = batches(dataclasses.replace(TIER1, steps=3), tmp_path / "s.zarr")
    state = carried_state("cpu", cfg, data[:2])
    fps, bq = port_p2.furthest_point_sampling, port_p2.ball_query
    step_cfg = dataclasses.replace(cfg, dropout=False)
    first = carried_step("cpu", step_cfg, state, data[2])
    torch.set_num_threads(1)
    second = carried_step("cpu", step_cfg, state, data[2])
    torch.set_num_threads(2)
    assert (port_p2.furthest_point_sampling, port_p2.ball_query) == (fps, bq)
    assert all(g.dtype == torch.float64 for g in first[1].values())
    assert np.isfinite(first[0]) and first[1] and first[2]
    assert step_ratios(first, second, (), CARRY_REL)[0] <= 1.0


# ---------------------------------------------------------------------------
# one step from a carried state, against JAX's step in float64
# ---------------------------------------------------------------------------
STAGE1_MODULES = ("sa1", "sa2", "sa3", "fp3", "fp2", "fp1")
F64_AGREE = 1e-6    # the two float64 steps, of each tensor's largest entry


@contextlib.contextmanager
def jax_float64():
    """JAX's stage-1 step in float64 throughout, the JAX package unedited:
    x64 on; MaskedBatchNorm's float32 casts (garmentnets_tpu/models/mlp.py)
    read as float64, through a view of jax.numpy put in that module's
    place; FPS and the ball query choose on the positions rounded to
    float32, as port_step's float64 step does, so that both packages'
    float64 steps pick the neighbours of their float32 steps."""
    view = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                    if not k.startswith("__")})
    view.float32 = jnp.float64
    saved = (jax_mlp.jnp, jax_p2.furthest_point_sampling, jax_p2.ball_query)
    fps, bq = saved[1:]
    jax_mlp.jnp = view
    jax_p2.furthest_point_sampling = lambda pos, n, **kw: fps(
        pos.astype(jnp.float32), n, **kw)
    jax_p2.ball_query = lambda p, c, r, **kw: bq(
        p.astype(jnp.float32), c.astype(jnp.float32), r, **kw)
    try:
        with jax.enable_x64(True):
            yield
    finally:
        jax_mlp.jnp, jax_p2.furthest_point_sampling, jax_p2.ball_query = saved


def jax_step_fn(study: Study):
    """JAX's stage-1 step in training mode, dropout off, compiled once a
    dtype: run(params, stats, batch, dtype) -> (loss, reference-layout
    {name: gradient or updated statistic}, the gradient tree, {module: its
    output}). Call it with float64 inside jax_float64() only."""
    cfg = jax_nocs.PointNet2NOCSConfig(dropout=False, **study.cfg)
    model = jax_nocs.PointNet2NOCS(cfg)

    def f(params, stats, b):
        out, mut = model.apply({"params": params, "batch_stats": stats},
                               b["x"], b["pos"], train=True,
                               capture_intermediates=True,
                               mutable=["batch_stats", "intermediates"])
        return jax_nocs.get_metrics(cfg, out, b)[0]["loss"], mut

    step = jax.jit(jax.value_and_grad(f, has_aux=True))

    def run(params, stats, batch, dtype=np.float32):
        cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: np.asarray(a, dtype), t)
        (loss, mut), grads = step(cast(params), cast(stats), cast(batch))
        grads = _numpy_tree(grads)
        ref = numpy_state_from_jax({
            "params": grads, "batch_stats": _numpy_tree(mut["batch_stats"])})
        outs = {m: np.asarray(mut["intermediates"][m]["__call__"][0][0])
                for m in STAGE1_MODULES}
        return float(loss), ref, grads, outs
    return run


def jax_float64_reference(study: Study, state: dict, batch: dict) -> tuple:
    """JAX's step in float64 at `state` on `batch`, and how far it moves
    under a 1e-6 jitter of the input colours or of the weights -> (loss,
    reference-layout {name: array}, the gradient tree, spread)."""
    run = jax_step_fn(study)
    stats = state["batch_stats"]
    with jax_float64():
        loss, ref, grads, _ = run(state["params"], stats, batch, np.float64)
        spread = {"loss": 0.0}
        for p2, b2 in ((state["params"], dict(batch, x=_jitter(batch["x"],
                                                               1))),
                       (_jitter(state["params"], 2), batch)):
            loss2, ref2, _, _ = run(p2, stats, b2, np.float64)
            spread["loss"] = max(spread["loss"], abs(loss2 - loss))
            for k, v in ref2.items():
                spread[k] = max(spread.get(k, 0.0),
                                float(np.abs(v - ref[k]).max()))
    return loss, ref, grads, spread


def test_carried_training_state_steps_as_jax(tier1):
    """JAX's state after K steps, carried into the port's model and Adam,
    takes step K + 1 as JAX's float64 step does: the loss, the gradients
    and the statistics at the stage-1 step bars; the parameters after
    both Adam steps on the same gradients within 1e-7 absolute plus 1e-7
    relative."""
    study = TIER1
    state, batch = tier1["kept"][K], tier1["data"][K]
    assert int(state["step"]) == K
    loss, ref, jax_grads, spread = jax_float64_reference(study, state, batch)
    jax_grads = jax.tree_util.tree_map(lambda a: a.astype(np.float32),
                                       jax_grads)

    cfg, model = port_model(study)
    optimizer = make_adam(model, study.lr)
    sd, opt_sd = training_state_from_jax(state, model, optimizer)
    model.load_state_dict(sd)
    optimizer.load_state_dict(opt_sd)
    names = {id(p): n for n, p in model.named_parameters()}
    for p in optimizer.param_groups[0]["params"]:
        st = optimizer.state[p]
        assert float(st["step"]) == K, names[id(p)]
        assert st["exp_avg"].abs().max() > 0, names[id(p)]

    got = {}
    orig_step = optimizer.step

    def step_on_jax_grads():
        got["grads"] = {n: p.grad.clone()
                        for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(np.array(ref[n], np.float32))
        return orig_step()

    optimizer.step = step_on_jax_grads
    train_step, _ = make_train_fns(
        model, lambda b, g: model(b["x"], b["pos"], generator=g),
        lambda o, b: nocs.get_metrics(cfg, o, b)[0], optimizer)
    port_loss = float(train_step(batch_to_device(batch, "cpu"))["loss"])

    assert abs(port_loss - loss) <= max(1e-5 * abs(loss),
                                        SPREAD_FACTOR * spread["loss"])
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), ref[name], rtol=0,
                                   err_msg=name,
                                   atol=_atol(ref[name], spread[name], 1e-4))
    for name, b in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), ref[name], rtol=0,
                                       err_msg=name, atol=_atol(
                                           ref[name], spread[name], 1e-5))

    tx = optax.adam(study.lr)
    params = jax.tree_util.tree_map(jnp.asarray, state["params"])
    updates, _ = tx.update(jax_grads, state["opt_state"], params)
    want = numpy_state_from_jax({
        "params": _numpy_tree(optax.apply_updates(params, updates)),
        "batch_stats": state["batch_stats"]})
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   rtol=1e-7, atol=1e-7, err_msg=name)
        assert float(optimizer.state[p]["step"]) == K + 1


def test_carried_step_with_jax_dropout_masks(tier1, monkeypatch):
    """Dropout on: JAX's step K + 1 in float64 (jax_float64) with the masks
    flax's Dropout draws, recorded as it draws them, and the port's step
    in float64 with those masks in place of its own draws agree within
    F64_AGREE of each tensor's largest entry, in the loss and every
    gradient: the port drops the same tensors, in the same order, with
    the same scale. (The two packages' random streams differ, so this is
    the only per-step check of dropout; its rate and its own draws are
    test_torch_train.py's test_dropout_rate_scale_and_seed.)"""
    study = dataclasses.replace(TIER1, dropout=True)
    state, batch = tier1["kept"][K], tier1["data"][K]
    cfg = jax_nocs.PointNet2NOCSConfig(dropout=True, **study.cfg)
    model = jax_nocs.PointNet2NOCS(cfg)
    random = flax_stochastic.random

    def f(params, stats, b):
        drawn = []

        def bernoulli(*a, **kw):
            drawn.append(random.bernoulli(*a, **kw))
            return drawn[-1]

        flax_stochastic.random = types.SimpleNamespace(bernoulli=bernoulli)
        try:
            out, _ = model.apply(
                {"params": params, "batch_stats": stats}, b["x"], b["pos"],
                train=True, mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(7)})
        finally:
            flax_stochastic.random = random
        return jax_nocs.get_metrics(cfg, out, b)[0]["loss"], tuple(drawn)

    f64 = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64),
        (state["params"], state["batch_stats"], batch))
    with jax_float64():
        (loss, masks), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
            *f64)
    ref = numpy_state_from_jax({"params": _numpy_tree(grads),
                                "batch_stats": state["batch_stats"]})
    masks = [torch.from_numpy(np.array(m)) for m in masks]
    assert len(masks) == 4 and all(0.45 < float(m.double().mean()) < 0.55
                                   for m in masks)
    replayed = iter(masks)

    def dropout(h, training, generator=None):
        keep = next(replayed) if training else None
        return h if keep is None else torch.where(
            keep, h / (1 - nocs.DROPOUT_RATE), torch.zeros_like(h))

    monkeypatch.setattr(nocs, "dropout", dropout)
    port_loss, grad, _ = port_step(study, state, batch, torch.float64,
                                   dropout=True)
    assert next(replayed, None) is None
    worst = max(float(np.abs(g - ref[n]).max() / np.abs(ref[n]).max())
                for n, g in grad.items())
    print(f"\ndropout on, JAX's masks: loss JAX {float(loss):.12f} port "
          f"{port_loss:.12f}; worst gradient error / the tensor's largest "
          f"entry {worst:.3e}")
    assert abs(port_loss - float(loss)) <= F64_AGREE * abs(float(loss))
    for name, g in grad.items():
        np.testing.assert_allclose(g, ref[name], rtol=0, err_msg=name,
                                   atol=F64_AGREE * np.abs(ref[name]).max())


# ---------------------------------------------------------------------------
# the step at the acceptance run's learning rate: both packages' float32
# steps against JAX's float64 step
# ---------------------------------------------------------------------------
# (study, JAX steps before the compared step): TIER1's carried state as
# tier 1 takes it (lr 1e-4); TIER1 at the acceptance run's rate; LONG's
# production widths at the first window where the long study's seed 0
# left the bar (steps 100-119)
CARRIED = {"tier1": (TIER1, K),
           "small": (dataclasses.replace(TIER1, lr=1e-3), K),
           "production": (dataclasses.replace(LONG, steps=100), 100)}


def port_step(study: Study, state: dict, batch: dict, dtype,
              dropout: bool = False) -> tuple:
    """The port's stage-1 step (training mode, dropout as `dropout` says)
    at `state` on `batch` in `dtype` -> (loss, {name: gradient}, {module:
    its output}). FPS and the ball query choose on the positions in
    float32."""
    cfg, m = port_model(dataclasses.replace(study, dropout=dropout))
    m.load_state_dict(state_dict_from_jax(state))
    m.to(dtype).train()
    out = {}
    for name in STAGE1_MODULES:
        getattr(m, f"{name}_module").register_forward_hook(
            lambda mod, a, o, name=name: out.__setitem__(
                name, o[0].detach().double().numpy()))
    tb = {k: torch.from_numpy(v).to(dtype) for k, v in batch.items()}
    bq, fps = port_p2.ball_query, port_p2.furthest_point_sampling
    port_p2.ball_query = lambda p, c, r, **kw: bq(p.float(), c.float(), r,
                                                  **kw)
    port_p2.furthest_point_sampling = lambda p, n: fps(p.float(), n)
    try:
        loss = nocs.get_metrics(cfg, m(tb["x"], tb["pos"]), tb)[0]["loss"]
    finally:
        port_p2.ball_query, port_p2.furthest_point_sampling = bq, fps
    loss.backward()
    return float(loss.detach()), {n: p.grad.double().numpy()
                         for n, p in m.named_parameters()}, out


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(CARRIED))
def test_carried_step_at_lr_1e3_against_float64(case, tmp_path):
    """At the acceptance run's lr 1e-3 (and at tier 1's state), after some
    steps (dropout as the study has it), one step (dropout off) of each
    package in float32
    against JAX's step in float64 (jax_float64). First the witness: the
    port's step in float64 (port_step) agrees with JAX's float64 step
    within F64_AGREE of each tensor's largest entry, in the loss, every
    module's output and every gradient. Then, module by module, each
    package's float32 error against JAX's float64 step is printed (of the
    tensor's largest entry); the port's float32 gradients must be the
    nearer, in the worst tensor and in at least 90% of the tensors."""
    study, steps = CARRIED[case]
    data = batches(dataclasses.replace(study, steps=steps + 1),
                   tmp_path / "synth.zarr")
    _, _, fns = jax_fns(study)
    _, _, kept = jax_run(fns, SEEDS[0], data[:steps], keep=(steps,))
    state, batch = kept[steps], data[steps]
    run = jax_step_fn(study)
    j32_loss, j32, _, j32_out = run(state["params"], state["batch_stats"],
                                    batch)
    with jax_float64():
        j64_loss, j64, _, j64_out = run(state["params"],
                                        state["batch_stats"], batch,
                                        np.float64)
    p32_loss, p32, p32_out = port_step(study, state, batch, torch.float32)
    p64_loss, p64, p64_out = port_step(study, state, batch, torch.float64)

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    witness = {**{f"output {m}": rel(p64_out[m], j64_out[m])
                  for m in STAGE1_MODULES},
               **{n: rel(g, j64[n]) for n, g in p64.items()},
               "loss": abs(p64_loss - j64_loss) / abs(j64_loss)}
    worst_w = max(witness, key=witness.get)
    print(f"\n{case}: JAX's state after {steps} steps at lr {study.lr}, "
          f"{study.n_points} points; the port's float64 step against "
          f"JAX's: worst {witness[worst_w]:.3e} ({worst_w}); losses JAX "
          f"f32 {j32_loss:.7f}, port f32 {p32_loss:.7f}, JAX f64 "
          f"{j64_loss:.7f}")
    print("  largest error against JAX float64 / the tensor's largest "
          "entry (JAX f32, port f32); outputs: " + ", ".join(
              f"{m} {rel(j32_out[m], j64_out[m]):.3e} "
              f"{rel(p32_out[m], j64_out[m]):.3e}" for m in STAGE1_MODULES))
    err = {n: (rel(j32[n], g), rel(p32[n], g))
           for n, g in j64.items() if n in p32}
    worst = sorted(err.items(), key=lambda kv: -kv[1][0])
    for n, (ej, ep) in worst[:8]:
        print(f"  gradient {n}: {ej:.3e} {ep:.3e}")
    nearer = sum(ep <= ej for ej, ep in err.values())
    print(f"  worst gradient: JAX {worst[0][1][0]:.3e}, port "
          f"{max(ep for _, ep in err.values()):.3e}; the port nearer in "
          f"{nearer} of {len(err)} tensors")
    assert len(err) == len(p32)
    assert witness[worst_w] <= F64_AGREE, (worst_w, witness[worst_w])
    assert max(ep for _, ep in err.values()) < worst[0][1][0]
    assert nearer >= 0.9 * len(err)
