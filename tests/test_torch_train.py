"""Training of the port against the JAX package on the CPU.

Inputs come from numpy seeds; weights are carried from the JAX variables
of torch_port_util by core/weights.state_dict_from_jax. Tolerances:

- masked BatchNorm train step against MaskedBatchNorm: output and
  gradients within rtol 1e-5 / atol 1e-5, running statistics within
  rtol 1e-5 / atol 1e-6;
- every loss variant against the JAX loss on the same logits: each metric
  within rtol 1e-6 / atol 1e-6, the gradient of the loss within 1e-5 of
  its largest entry;
- one stage-2 train step at the tiny configuration against
  jax.value_and_grad of the JAX model with mutable batch_stats: the loss
  within rtol 1e-5, each parameter's gradient within 1e-4 of that
  tensor's largest JAX gradient, the updated running statistics within
  rtol 1e-5 / atol 1e-6; the stage-1 part of the state stays bit-equal
  through the Adam step;
- stage 1 (dropout off), module by module in training mode: output and
  statistics within 1e-5 of their largest entry, gradients within 1e-4;
  and the whole stage-1 step, the same bars. Where a tensor is
  ill-conditioned, the bar is instead SPREAD_FACTOR times how far JAX's
  own result moves when its inputs or weights are jittered by 1e-6
  (relative): a train-mode step at B=2 is chaotic at rounding level,
  and that jitter moves JAX's own stage-1 gradients by more than 1e-4
  of a tensor's largest entry;
- torch.optim.Adam against optax.adam over 3 steps on identical
  gradients: parameters within 1e-7 absolute plus 1e-7 relative.

With only a few steps Adam turns rounding-level gradient differences into
+-lr flips, so the port is held to JAX on gradients at one state, and Adam
is tested apart on identical gradients.
"""
import copy
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_port_util as pu  # noqa: E402

from garmentnets_tpu.models import mlp as jax_mlp  # noqa: E402
from garmentnets_tpu.models import pipeline as jax_pipe  # noqa: E402
from garmentnets_tpu.models import pointnet2_nocs as jax_nocs  # noqa: E402
from garmentnets_tpu.ops.scatter import (  # noqa: E402
    scatter_to_grid as jax_scatter)
from garmentnets_tpu_torch.core import weights  # noqa: E402
from garmentnets_tpu_torch.core.random_weights import init_like_jax_  # noqa: E402
from garmentnets_tpu_torch.core.weights import (  # noqa: E402
    numpy_state_from_jax, state_dict_from_jax)
from garmentnets_tpu_torch.harness.training import (  # noqa: E402
    make_adam, make_train_fns)
from garmentnets_tpu_torch.models import pipeline as pipe  # noqa: E402
from garmentnets_tpu_torch.models import pointnet2_nocs as nocs  # noqa: E402
from garmentnets_tpu_torch.models.mlp import PointMLP  # noqa: E402
from garmentnets_tpu_torch.ops.scatter import scatter_to_grid  # noqa: E402

BN_TOL = dict(rtol=1e-5, atol=1e-5)
STAT_TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# masked BatchNorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_masked_batch_norm_train_step_matches_jax(masked):
    """A 2-layer PointMLP in training mode on [3, 5, 7, 4] inputs, with the
    ball query's kind of mask (valid slots first, at least one a row) or
    none: output, gradients of a weighted sum with respect to the input
    and every parameter, and the running statistics."""
    rng = np.random.RandomState(3)
    x = rng.randn(3, 5, 7, 4).astype(np.float32)
    mask = None
    if masked:
        mask = np.arange(7)[None, None, :] < rng.randint(1, 8, (3, 5, 1))
    jm = jax_mlp.PointMLP((4, 6, 5))
    variables = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                            train=False))
    variables = {k: pu._randomize(v, rng) for k, v in variables.items()}
    wout = rng.randn(3, 5, 7, 5).astype(np.float32)

    def f(params, x):
        y, mut = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          x, mask=None if mask is None else jnp.asarray(mask),
                          train=True, mutable=["batch_stats"])
        return jnp.sum(y * wout), (y, mut)

    (_, (y_ref, mut)), (g_par, g_x) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(variables["params"], jnp.asarray(x))

    sd, ref = {}, {}
    weights._put_mlp(sd, "m", variables["params"],
                     variables["batch_stats"])
    weights._put_mlp(ref, "m", _numpy_tree(g_par),
                     _numpy_tree(mut["batch_stats"]))
    m = PointMLP((4, 6, 5))
    m.load_state_dict({k[2:]: _t(v) for k, v in sd.items()})
    m.train()
    xt = _t(x).requires_grad_(True)
    y = m(xt, mask=None if mask is None else _t(mask))
    (y * _t(wout)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               **BN_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), **BN_TOL)
    for name, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref["m." + name],
                                   **BN_TOL, err_msg=name)
    for name, b in m.named_buffers():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(b.numpy(), ref["m." + name],
                                       **STAT_TOL, err_msg=name)


def test_masked_batch_norm_ignores_invalid_slots():
    """Values in the masked-out slots change neither the valid outputs
    nor the running statistics; the count is max(sum(mask), 1)."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 6, 8, 3).astype(np.float32))
    mask = torch.from_numpy(rng.rand(2, 6, 8) < 0.5)
    mask[:, :, 0] = True
    outs, stats = [], []
    for fill in (0.0, 1e3):
        torch.manual_seed(0)
        m = PointMLP((3, 4))
        m.train()
        xf = x.masked_fill(~mask[..., None], fill)
        outs.append(m(xf, mask=mask)[mask])
        stats.append(torch.cat([m[0][2].running_mean, m[0][2].running_var]))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    torch.testing.assert_close(stats[0], stats[1], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def _stage1_result(rng, bins, B=3, N=40):
    dim = 3 if bins is None else bins * 3
    return {"per_point_logits": rng.randn(B, N, dim).astype(np.float32),
            "global_logits": rng.randn(B, dim).astype(np.float32),
            "per_point_features": rng.randn(B, N, 5).astype(np.float32)}


LOSSES = {
    "bin": dict(nocs_bins=8),
    "bin_symmetry": dict(nocs_bins=8, symmetry_axis=0),
    "bin_symmetry_z": dict(nocs_bins=8, symmetry_axis=2),
    "regression": dict(nocs_bins=None),
    "regression_mirror": dict(nocs_bins=None, symmetry_axis=0),
    "weighted": dict(nocs_bins=8, nocs_loss_weight=0.5,
                     grip_point_loss_weight=2.0),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_stage1_loss_matches_jax(name):
    """get_metrics on the same logits, with a batch row masked out: every
    metric and the NOCS predictions, and the loss's gradient."""
    over = LOSSES[name]
    rng = np.random.RandomState(len(name))
    res = _stage1_result(rng, over["nocs_bins"])
    batch = {"y": rng.rand(3, 40, 3).astype(np.float32),
             "nocs_grip_point": rng.rand(3, 3).astype(np.float32),
             "_valid_mask": np.array([1, 0, 1], np.float32)}
    jcfg = jax_nocs.PointNet2NOCSConfig(**over)
    tcfg = nocs.PointNet2NOCSConfig(**over)

    def jloss(r):
        return jax_nocs.get_metrics(jcfg, r, batch)[0]["loss"]

    jm, jd = jax_nocs.get_metrics(jcfg, res, batch)
    jg = jax.grad(jloss)(res)
    tres = {k: _t(v).requires_grad_(True) for k, v in res.items()}
    tm, td = nocs.get_metrics(tcfg, tres, {k: _t(v)
                                           for k, v in batch.items()})
    tm["loss"].backward()
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert sorted(td) == sorted(jd)
    np.testing.assert_array_equal(td["pos"].detach().numpy(),
                                  np.asarray(jd["pos"]))
    for k in ("per_point_logits", "global_logits"):
        ref = np.asarray(jg[k])
        np.testing.assert_allclose(tres[k].grad.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=k)


PIPE_LOSSES = {
    "l2": {}, "smooth_l1": dict(loss_type="smooth_l1"),
    "bce_volume": dict(volume_classification=True),
    "mc_surface": dict(mc_surface_loss_weight=0.7, volume_loss_weight=2.0,
                       surface_loss_weight=0.3),
}


@pytest.mark.parametrize("name", sorted(PIPE_LOSSES))
def test_pipeline_loss_matches_jax(name):
    """pipeline_loss on the same predictions (|d| on both sides of 1 for
    smooth_l1, logits of both signs for the BCE), a row masked out."""
    over = PIPE_LOSSES[name]
    rng = np.random.RandomState(len(name) + 10)
    res = {"pred_volume_value": 2 * rng.randn(3, 30).astype(np.float32),
           "pred_sim_points": 2 * rng.randn(3, 30, 3).astype(np.float32),
           "pred_mc_surface_logits": 3 * rng.randn(3, 20, 1).astype(
               np.float32)}
    batch = {"gt_volume_value": rng.rand(3, 30).astype(np.float32),
             "gt_sim_points": rng.randn(3, 30, 3).astype(np.float32),
             "is_query_point_on_surf": (rng.rand(3, 20, 1) > 0.5).astype(
                 np.float32),
             "_valid_mask": np.array([1, 1, 0], np.float32)}
    jcfg = jax_pipe.PipelineConfig(**over)
    tcfg = pipe.PipelineConfig(**over)
    jm = jax_pipe.pipeline_loss(jcfg, res, batch)
    jg = jax.grad(lambda r: jax_pipe.pipeline_loss(jcfg, r, batch)["loss"])(
        res)
    tres = {k: _t(v).requires_grad_(True) for k, v in res.items()}
    tm = pipe.pipeline_loss(tcfg, tres, {k: _t(v) for k, v in batch.items()})
    tm["loss"].backward()
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    for k, p in tres.items():
        ref = np.asarray(jg[k])
        if p.grad is None:
            assert not ref.any(), k
            continue
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=k)


def test_mirror_and_grip_point_match_jax():
    rng = np.random.RandomState(5)
    p = rng.rand(2, 9, 3).astype(np.float32)
    for axis in (None, 0, 1, 2):
        np.testing.assert_array_equal(
            nocs.mirror_nocs_points_by_axis(_t(p), axis).numpy(),
            np.asarray(jax_nocs.mirror_nocs_points_by_axis(
                jnp.asarray(p), axis)))
    pos = rng.randn(2, 9, 3).astype(np.float32)
    np.testing.assert_array_equal(
        nocs.predict_grip_point_from_pc(_t(pos), _t(p)).numpy(),
        np.asarray(jax_nocs.predict_grip_point_from_pc(pos, p)))


def test_scatter_max_gradient_splits_ties_as_jax():
    """Cells whose max ties between points (and cells whose max is exactly
    0): the gradient of a weighted sum is split evenly over the tied
    points, as JAX's segment_max splits it."""
    rng = np.random.RandomState(6)
    feats = rng.randint(-2, 3, (2, 40, 3)).astype(np.float32)
    idx = rng.randint(0, 12, (2, 40))
    w = rng.randn(2, 16, 3).astype(np.float32)
    ref_out = jax_scatter(jnp.asarray(feats), jnp.asarray(idx), 16)
    ref_g = jax.grad(lambda f: jnp.sum(jax_scatter(
        f, jnp.asarray(idx), 16) * w))(jnp.asarray(feats))
    f = _t(feats).requires_grad_(True)
    out = scatter_to_grid(f, _t(idx), 16)
    (out * _t(w)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref_out))
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(ref_g), rtol=0,
                               atol=1e-6)
    assert (np.asarray(ref_g) % 1 != 0).any()       # ties were split


# ---------------------------------------------------------------------------
# one train step of each stage against jax.value_and_grad
# ---------------------------------------------------------------------------
def _compare_step(model, ref_loss, loss, jax_grads, jax_stats):
    """Loss, each parameter's gradient and the running statistics of a
    port train step against the JAX step's."""
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-5)
    ref = numpy_state_from_jax({"params": jax_grads,
                                "batch_stats": jax_stats})
    n = 0
    for name, p in model.named_parameters():
        g = np.asarray(ref[name])
        if p.grad is None:
            assert not p.requires_grad and not g.any(), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=1e-4 * np.abs(g).max(), err_msg=name)
        n += 1
    for name, b in model.named_buffers():
        if name.endswith("running_mean") or name.endswith("running_var"):
            np.testing.assert_allclose(b.numpy(), ref[name], **STAT_TOL,
                                       err_msg=name)
    return n


def _numpy_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def variables():
    return pu.jax_variables()


STAGE1_MODULES = ("sa1", "sa2", "sa3", "fp3", "fp2", "fp1")
# how many times JAX's own spread (see _atol) the port may differ by
SPREAD_FACTOR = 10


def _jitter(tree, seed: int):
    """Every float of a numpy tree times (1 + 1e-6 N(0, 1)): about the
    rounding of an f32 dot product of a hundred terms, the size of the
    differences between two implementations that sum in other orders."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (a * (1 + 1e-6 * rng.randn(*np.shape(a)))).astype(
            np.float32) if np.asarray(a).dtype == np.float32 else a, tree)


def _atol(ref, spread, rel):
    """The tolerance on one tensor: rel of its largest entry, or
    SPREAD_FACTOR times the most that JAX's own result moved when its
    inputs or its weights were jittered (_jitter), whichever is larger."""
    return max(rel * np.abs(ref).max(), SPREAD_FACTOR * spread)


@pytest.fixture(scope="module")
def stage1(variables):
    """The JAX stage 1 (dropout off) in training mode at pu.inputs(): its
    parameters and statistics, the JAX step's loss, gradients and updated
    statistics on a batch with random ground truth, and the spread of each
    (the largest change of each tensor when the input colours, or all the
    weights, are jittered)."""
    rng = np.random.RandomState(11)
    x = pu.inputs()
    batch = {"x": x["x"], "pos": x["pos"],
             "y": rng.rand(pu.B, pu.N, 3).astype(np.float32),
             "nocs_grip_point": rng.rand(pu.B, 3).astype(np.float32),
             "_valid_mask": np.ones(pu.B, np.float32)}
    jcfg = dataclasses.replace(pu.jax_cfg().pointnet2, dropout=False)
    jm = jax_nocs.PointNet2NOCS(jcfg)
    params = variables["params"]["pointnet2_nocs"]
    stats = variables["batch_stats"]["pointnet2_nocs"]

    def f(params, batch):
        out, mut = jm.apply({"params": params, "batch_stats": stats},
                            batch["x"], batch["pos"], train=True,
                            mutable=["batch_stats"])
        return jax_nocs.get_metrics(jcfg, out, batch)[0]["loss"], mut

    step = jax.jit(jax.value_and_grad(f, has_aux=True))

    def run(params, batch):
        (loss, mut), grads = step(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
        return float(loss), numpy_state_from_jax({
            "params": _numpy_tree(grads),
            "batch_stats": _numpy_tree(mut["batch_stats"])})

    loss, ref = run(params, batch)
    spread = {"loss": 0.0}
    for p2, b2 in ((params, dict(batch, x=_jitter(batch["x"], 1))),
                   (_jitter(params, 2), batch)):
        loss2, ref2 = run(p2, b2)
        spread["loss"] = max(spread["loss"], abs(loss2 - loss))
        for k, v in ref2.items():
            spread[k] = max(spread.get(k, 0.0),
                            float(np.abs(v - ref[k]).max()))
    return dict(params=params, stats=stats, batch=batch, loss=loss,
                ref=ref, spread=spread)


def _stage1_model(stage1):
    tcfg = dataclasses.replace(pu.torch_cfg().pointnet2, dropout=False)
    model = nocs.PointNet2NOCS(tcfg)
    model.load_state_dict(state_dict_from_jax(
        {"params": stage1["params"], "batch_stats": stage1["stats"]}))
    return model.train()


def _pooled_near_ties(module, args, rel=1e-4) -> torch.Tensor:
    """The maxima a set abstraction pools over its neighbour slots whose
    two largest values lie within rel * max|value| of each other, but are
    not equal, in the port's forward: the pooled max's gradient jumps
    between the two there."""
    mod = copy.deepcopy(module)
    seen = {}
    mod.conv.local_nn.register_forward_hook(
        lambda m, a, kw, o: seen.update(h=o, mask=kw["mask"]),
        with_kwargs=True)
    with torch.no_grad():
        mod(*args)
    h = seen["h"].masked_fill(~seen["mask"][..., None], float("-inf"))
    top2 = h.topk(2, dim=2).values
    gap = top2[:, :, 0] - top2[:, :, 1]
    return (gap > 0) & (gap < rel * h[torch.isfinite(h)].abs().max())


def _module_inputs(name: str) -> tuple:
    """Seeded inputs of one stage-1 module at the tiny configuration's
    shapes: zero-mean N(0, 1) features (so no BatchNorm channel of the
    module starts near-dead) and uniform points."""
    rng = np.random.RandomState(sum(map(ord, name)))
    B = pu.B

    def feat(n, c):
        return rng.randn(B, n, c).astype(np.float32)

    def pts(n):
        return (rng.rand(B, n, 3) - 0.5).astype(np.float32)

    n1, n2 = pu.N // 2, pu.N // 8
    return {"sa1": (feat(pu.N, 3), pts(pu.N)),
            "sa2": (feat(n1, 128), pts(n1)),
            "sa3": (feat(n2, 256), pts(n2)),
            "fp3": (feat(1, 1024), np.zeros((B, 1, 3), np.float32),
                    feat(n2, 256), pts(n2)),
            "fp2": (feat(n2, 256), pts(n2), feat(n1, 128), pts(n1)),
            "fp1": (feat(n1, 128), pts(n1), feat(pu.N, 3), pts(pu.N)),
            }[name]


@pytest.mark.parametrize("name", STAGE1_MODULES)
def test_stage1_module_train_vjp_matches_jax(stage1, name):
    """Each stage-1 module in training mode with the tiny configuration's
    weights, on seeded inputs (_module_inputs) and a seeded output
    cotangent, 0 at the SA's pooled near-ties (where the max's gradient
    jumps between two slots at rounding level): the output and the
    running statistics within 1e-5 of their largest entry, every
    parameter's and input's gradient within 1e-4 of that tensor's largest
    JAX gradient; or within SPREAD_FACTOR times JAX's own change when the
    module's inputs, or its weights, are jittered, where that is larger.
    The spread covers a BatchNorm channel that is nearly dead after its
    ReLU (a few entries above 0 in a batch of two clouds): its gradient
    moves with each entry that rounding lifts over the ReLU's 0."""
    from garmentnets_tpu.models import pointnet2 as jax_p2
    jmods = {
        "sa1": jax_p2.SAModule(0.5, pu.SA1_R, (6, 64, 64, 128)),
        "sa2": jax_p2.SAModule(0.25, pu.SA2_R, (131, 128, 128, 256)),
        "sa3": jax_p2.GlobalSAModule((259, 256, 512, 1024)),
        "fp3": jax_p2.FPModule(1, (1280, 256, 256)),
        "fp2": jax_p2.FPModule(3, (384, 256, 128)),
        "fp1": jax_p2.FPModule(3, (131, 128, 128, 128))}
    # the arguments that carry a gradient: features, and the FP's skip
    diff = {"sa1": [0], "sa2": [0], "sa3": [0], "fp3": [0, 2],
            "fp2": [0, 2], "fp1": [0, 2]}[name]
    args = list(_module_inputs(name))
    module = getattr(_stage1_model(stage1), f"{name}_module")
    targs = [torch.from_numpy(a.copy()) for a in args]
    ct = np.random.RandomState(len(name)).randn(
        *module(*[t.clone() for t in targs])[0].shape).astype(np.float32)
    if name in ("sa1", "sa2"):
        ct[_pooled_near_ties(module, targs).numpy()] = 0.0
    module = getattr(_stage1_model(stage1), f"{name}_module")

    def vjp(args, params):
        def f(p, *d):
            a = list(args)
            for i, v in zip(diff, d):
                a[i] = v
            o, mut = jmods[name].apply(
                {"params": p, "batch_stats": stage1["stats"][name]}, *a,
                train=True, mutable=["batch_stats"])
            return o[0], mut

        out, vjp_fn, mut = jax.vjp(f, params, *[args[i] for i in diff],
                                   has_aux=True)
        g = vjp_fn(jnp.asarray(ct))
        res = {"out": np.asarray(out)}
        weights._put_mlp(res, "m", _numpy_tree(g[0]["mlp"]),
                         _numpy_tree(mut["batch_stats"]["mlp"]))
        res.update({f"in{i}": np.asarray(g[1 + k])
                    for k, i in enumerate(diff)})
        return res

    params = stage1["params"][name]
    ref = vjp(args, params)
    spread = dict.fromkeys(ref, 0.0)
    for moved in (vjp([_jitter(a, 1) if i in diff else a
                       for i, a in enumerate(args)], params),
                  vjp(args, _jitter(params, 2))):
        spread = {k: max(spread[k], float(np.abs(moved[k] - v).max()))
                  for k, v in ref.items()}

    for i in diff:
        targs[i].requires_grad_(True)
    out = module(*targs)[0]
    (out * torch.from_numpy(ct)).sum().backward()
    got = {"out": out.detach().numpy()}
    mlp = module.conv.local_nn if name in ("sa1", "sa2") else module.nn
    got.update({"m." + k: p.grad.numpy()
                for k, p in mlp.named_parameters()})
    got.update({"m." + k: b.numpy() for k, b in mlp.named_buffers()
                if not k.endswith("num_batches_tracked")})
    got.update({f"in{i}": targs[i].grad.numpy() for i in diff})
    assert set(got) <= set(ref)
    for k, v in got.items():
        rel = 1e-4 if k.startswith("in") or k.endswith(
            ("weight", "bias")) else 1e-5
        np.testing.assert_allclose(v, ref[k], rtol=0, err_msg=k,
                                   atol=_atol(ref[k], spread[k], rel))


def test_stage1_train_step_matches_jax(stage1):
    """The whole stage-1 step end to end: the loss within rtol 1e-5, every
    parameter's gradient within 1e-4 of its largest JAX entry, the running
    statistics within 1e-5 of their largest entry; or within
    SPREAD_FACTOR times JAX's own change when the input colours or the
    weights are jittered, where that is larger. A train-mode step at B=2
    is ill-conditioned: FP3's BatchNorm normalizes the two clouds' global
    features, and pooled maxima have near-ties."""
    model = _stage1_model(stage1)
    tb = {k: _t(v) for k, v in stage1["batch"].items()}
    loss = nocs.get_metrics(model.cfg, model(tb["x"], tb["pos"]), tb)[0][
        "loss"]
    loss.backward()
    ref, spread = stage1["ref"], stage1["spread"]
    assert abs(float(loss.detach()) - stage1["loss"]) <= max(
        1e-5 * abs(stage1["loss"]), SPREAD_FACTOR * spread["loss"])
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name], rtol=0,
                                   err_msg=name, atol=_atol(
                                       ref[name], spread[name], 1e-4))
    for name, b in model.named_buffers():
        if name.endswith("running_mean") or name.endswith("running_var"):
            np.testing.assert_allclose(b.numpy(), ref[name], rtol=0,
                                       err_msg=name, atol=_atol(
                                           ref[name], spread[name], 1e-5))


def test_stage2_train_step_matches_jax(variables):
    """One pipeline step: the JAX stage 1 gives zero gradients and keeps
    its statistics; the port's takes no gradient, and its weights and
    statistics stay bit-equal through make_train_fns' Adam step."""
    rng = np.random.RandomState(12)
    x = pu.inputs()
    M = 23
    batch = {"x": x["x"], "pos": x["pos"],
             "volume_query_points": rng.rand(pu.B, M, 3).astype(np.float32),
             "gt_volume_value": rng.rand(pu.B, M).astype(np.float32),
             "surf_query_points": rng.rand(pu.B, M, 3).astype(np.float32),
             "gt_sim_points": rng.randn(pu.B, M, 3).astype(np.float32),
             "_valid_mask": np.ones(pu.B, np.float32)}
    jcfg = pu.jax_cfg()
    jm = jax_pipe.ConvImplicitWNFPipeline(jcfg)

    def f(params, batch):
        out, mut = jm.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            batch, train=True, mutable=["batch_stats"])
        return jax_pipe.pipeline_loss(jcfg, out, batch)["loss"], mut

    (ref_loss, mut), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        variables["params"], {k: jnp.asarray(v) for k, v in batch.items()})

    tcfg = pu.torch_cfg()
    model = pipe.ConvImplicitWNFPipeline(tcfg)
    model.load_state_dict(state_dict_from_jax(variables))
    model.pointnet2_nocs.requires_grad_(False)
    stage1 = {k: v.clone() for k, v in
              model.pointnet2_nocs.state_dict().items()}
    optimizer = make_adam(model, 1e-3)
    out = {}

    def apply_fn(b, gen):
        return model(b)

    def loss_fn(o, b):
        out["loss"] = pipe.pipeline_loss(tcfg, o, b)["loss"]
        return {"loss": out["loss"]}

    train_step, _ = make_train_fns(model, apply_fn, loss_fn, optimizer)
    snapshot = {}
    orig_step = optimizer.step

    def step_after_snapshot():
        # the gradients and statistics the step computed, before Adam
        snapshot["grads"] = {n: None if p.grad is None else p.grad.clone()
                             for n, p in model.named_parameters()}
        return orig_step()

    optimizer.step = step_after_snapshot
    train_step({k: _t(v) for k, v in batch.items()})
    assert not model.pointnet2_nocs.training and model.volume_agg.training
    for name, p in model.named_parameters():
        p.grad = snapshot["grads"][name]
    n = _compare_step(model, ref_loss, out["loss"], _numpy_tree(grads),
                      _numpy_tree(mut["batch_stats"]))
    assert n == len([p for p in model.parameters() if p.requires_grad]) > 0
    for k, v in model.pointnet2_nocs.state_dict().items():
        assert torch.equal(v, stage1[k]), k


def test_adam_matches_optax():
    """Three steps on identical gradients: optax.adam(lr) and the port's
    make_adam within 1e-7 absolute plus 1e-7 relative (about one f32 ulp
    of these parameters; the two round the same update differently)."""
    rng = np.random.RandomState(13)
    p0 = {"a": rng.randn(7, 5).astype(np.float32),
          "b": rng.randn(11).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) * 10 ** -i
              for k, v in p0.items()} for i in range(3)]
    tx = optax.adam(1e-3)
    params, state = {k: jnp.asarray(v) for k, v in p0.items()}, None
    state = tx.init(params)
    model = torch.nn.Module()
    for k, v in p0.items():
        setattr(model, k, torch.nn.Parameter(_t(v)))
    opt = make_adam(model, 1e-3)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, params)
        params = optax.apply_updates(params, upd)
        for k, v in g.items():
            getattr(model, k).grad = _t(v)
        opt.step()
    for k in p0:
        np.testing.assert_allclose(getattr(model, k).detach().numpy(),
                                   np.asarray(params[k]), rtol=1e-7,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# dropout, initializer, SA cache, learning
# ---------------------------------------------------------------------------
def test_dropout_rate_scale_and_seed():
    h = torch.ones(200, 500)
    a = nocs.dropout(h, True, torch.Generator().manual_seed(1))
    b = nocs.dropout(h, True, torch.Generator().manual_seed(1))
    c = nocs.dropout(h, True, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(a.unique().tolist()) == {0.0, 2.0}          # kept: x / 0.5
    assert abs(float((a == 0).float().mean()) - 0.5) < 0.01
    assert nocs.dropout(h, False, None) is h
    cfg = nocs.PointNet2NOCSConfig(nocs_bins=8, sa1_r=0.2, sa2_r=0.4,
                                   feature_dim=16)
    model = nocs.PointNet2NOCS(cfg)
    x = pu.inputs()
    xt, pt = _t(x["x"]), _t(x["pos"])
    model.eval()
    with torch.no_grad():
        e1 = model(xt, pt, torch.Generator().manual_seed(1))
        e2 = model(xt, pt, torch.Generator().manual_seed(2))
    torch.testing.assert_close(e1["per_point_logits"],
                               e2["per_point_logits"], rtol=0, atol=0)


def test_init_like_jax_statistics():
    """flax's lecun-normal: std 1/sqrt(fan_in) and |w| <= 2 sigma of the
    untruncated normal (sigma = 1/(0.8796 sqrt(fan_in))), as flax's own
    initializer draws on the same shape; zero biases, unit norm scales,
    running statistics 0 and 1."""
    model = pipe.ConvImplicitWNFPipeline(pu.torch_cfg())
    init_like_jax_(model, torch.Generator().manual_seed(0))
    lin = model.pointnet2_nocs.global_lin1.weight.detach().numpy()
    ref = np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), (1024, 1024)))
    sigma = 1 / (0.87962566103423978 * 32)
    assert abs(lin.std() - ref.std()) < 0.01 * ref.std()
    assert abs(lin.std() - 1 / 32) < 0.01 / 32
    assert np.abs(lin).max() <= 2 * sigma * (1 + 1e-6)
    assert abs(lin.mean()) < 0.01 / 32
    conv = model.unet_3d.abstract_3d_unet.encoders[0].basic_module \
        .SingleConv1.conv.weight.detach().numpy()
    fan_in = conv[0].size
    assert abs(conv.std() * fan_in ** 0.5 - 1) < 0.05
    for name, t in model.state_dict().items():
        if name.endswith("bias") or name.endswith("running_mean"):
            assert not t.any(), name
        elif name.endswith("running_var"):
            assert bool((t == 1).all()), name
    for m in model.modules():
        if isinstance(m, (torch.nn.GroupNorm, torch.nn.BatchNorm1d)):
            assert bool((m.weight == 1).all())


def test_sa_eval_after_optimizer_step_uses_stepped_weights():
    """The set abstraction's folded-layer cache is keyed by the tensors'
    version counters: after a train step (batch statistics, Adam),
    eval mode folds the new weights, as a fresh module loaded with them."""
    cfg = nocs.PointNet2NOCSConfig(nocs_bins=8, sa1_r=0.2, sa2_r=0.4,
                                   feature_dim=16, dropout=False)
    torch.manual_seed(0)
    model = nocs.PointNet2NOCS(cfg)
    x = pu.inputs()
    xt, pt = _t(x["x"]), _t(x["pos"])
    model.eval()
    with torch.no_grad():
        before = model.sa1_module(xt, pt)[0]
    opt = make_adam(model, 1e-2)
    model.train()
    model(xt, pt)["per_point_logits"].square().mean().backward()
    opt.step()
    model.eval()
    fresh = nocs.PointNet2NOCS(cfg)
    fresh.load_state_dict(model.state_dict())
    fresh.eval()
    with torch.no_grad():
        after = model.sa1_module(xt, pt)[0]
        ref = fresh.sa1_module(xt, pt)[0]
    assert torch.equal(after, ref)
    assert not torch.equal(after, before)


def _memorize(ds_batch, steps):
    cfg = nocs.PointNet2NOCSConfig(feature_dim=32, nocs_bins=8,
                                   dropout=False, sa1_r=0.15, sa2_r=0.3,
                                   learning_rate=1e-3)
    model = nocs.PointNet2NOCS(cfg)
    init_like_jax_(model, torch.Generator().manual_seed(0))
    opt = make_adam(model, cfg.learning_rate)
    train_step, _ = make_train_fns(
        model, lambda b, g: model(b["x"], b["pos"], generator=g),
        lambda o, b: nocs.get_metrics(cfg, o, b)[0], opt)
    return [float(train_step(ds_batch)["loss"]) for _ in range(steps)]


def test_stage1_learns(tmp_path):
    """As tests/test_convergence.py: the train loss on 4 memorized samples
    of the synthetic set falls below 0.2x its start (measured here: about
    0.05x after 60 steps)."""
    from garmentnets_tpu_torch.data.dataset import (
        ConvImplicitWNFDataset, collate)
    from garmentnets_tpu_torch.data.synthetic import generate_dataset
    path = tmp_path / "synth.zarr"
    generate_dataset(str(path), num_instances=2, grips_per_instance=2,
                     volume_size=16, mesh_res=8, pts_per_view=400)
    ds = ConvImplicitWNFDataset(
        zarr_path=str(path), num_pc_sample=256, volume_size=None,
        enable_augumentation=False, static_epoch_seed=True)
    batch = {k: torch.from_numpy(v) for k, v in
             collate([ds[i] for i in range(4)]).items()}
    losses = _memorize(batch, 60)
    start, end = np.mean(losses[:5]), np.mean(losses[-5:])
    assert np.isfinite(end)
    assert end < 0.2 * start, (start, end, losses[::10])
