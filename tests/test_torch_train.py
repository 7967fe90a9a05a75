"""Training of the port against the JAX package on the CPU.

Inputs come from numpy seeds; weights are carried from the JAX variables
of torch_port_util by core/weights.state_dict_from_jax.

Train-mode steps (the masked BatchNorm, each stage-1 module's VJP, the
whole stage-1 step, one stage-2 step) are held to JAX's step computed in
float64 (torch_port_util.jax_float64; its docstring says why float64 is
the reference), each test in two cases:

- float64: the port's step in float64 within F64_REL (1e-9) of each
  tensor's largest entry, in every output, gradient, running statistic
  and the loss: the exact parity check;
- float32: the port's float32 step within rel of the float64 step's
  largest entry, or SPREAD_FACTOR times the float64 step's own change
  under a 1e-6 jitter of the inputs or of the weights where that is
  larger (torch_port_util._atol): rel is 1e-4 for gradients, 1e-5 for
  outputs and statistics, and 1e-5 for every tensor of the masked
  BatchNorm; the loss within rtol 1e-5. JAX's own float32 step is only
  printed (its distance from float64). The stage-2 step's stage 1 stays
  bit-equal through the Adam step.

test_planted_faults_fail_the_float32_bars shows that these bars still
catch real faults. Other tolerances:

- every loss variant against the JAX loss on the same logits: each metric
  within rtol 1e-6 / atol 1e-6, the gradient of the loss within 1e-5 of
  its largest entry;
- torch.optim.Adam against optax.adam over 3 steps on identical
  gradients: parameters within 1e-7 absolute plus 1e-7 relative.

With only a few steps Adam turns rounding-level gradient differences into
+-lr flips, so the port is held to JAX on gradients at one state, and Adam
is tested apart on identical gradients.
"""
import contextlib
import copy
import dataclasses
import functools
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


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# masked BatchNorm
# ---------------------------------------------------------------------------
BN_REL = 1e-5       # the float32 step's bar, of each tensor's largest entry


def _bn_case(masked: bool) -> dict:
    """A 2-layer PointMLP's inputs on [3, 5, 7, 4], with the ball query's
    kind of mask (valid slots first, at least one a row) or none, its JAX
    variables (norm parameters and statistics randomized) and the output
    cotangent."""
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
    return dict(x=x, mask=mask, variables=variables, wout=wout)


def _jax_bn_step(case: dict, params, x, dtype) -> dict:
    """JAX's step in `dtype` (float64 inside pu.jax_float64 only): the
    output, the gradients of sum(y * wout) with respect to the input and
    every parameter, and the running statistics, in the port's layout."""
    jm = jax_mlp.PointMLP((4, 6, 5))
    mask = case["mask"]
    stats = pu.as_dtype(case["variables"]["batch_stats"], dtype)
    wout = np.asarray(case["wout"], dtype)

    def f(params, x):
        y, mut = jm.apply({"params": params, "batch_stats": stats},
                          x, mask=None if mask is None else jnp.asarray(mask),
                          train=True, mutable=["batch_stats"])
        return jnp.sum(y * wout), (y, mut)

    (_, (y, mut)), (g_par, g_x) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(pu.as_dtype(params, dtype),
                                         np.asarray(x, dtype))
    out = {}
    weights._put_mlp(out, "m", pu._numpy_tree(g_par),
                     pu._numpy_tree(mut["batch_stats"]))
    out = {k[2:]: v for k, v in out.items()
           if not k.endswith("num_batches_tracked")}
    out.update(out=np.asarray(y), x_grad=np.asarray(g_x))
    return out


@functools.lru_cache(maxsize=None)
def _bn_reference(masked: bool) -> tuple:
    """(case, JAX's float64 step, its spread under a 1e-6 jitter of the
    input or of the parameters, JAX's float32 step)."""
    case = _bn_case(masked)
    params, x = case["variables"]["params"], case["x"]

    def run(params, x, dtype):
        return _jax_bn_step(case, params, x, dtype)

    ref, spread = pu.float64_reference(run, (params, x), (
        (params, pu._jitter(x, 1)), (pu._jitter(params, 2), x)))
    return case, ref, spread, run(params, x, np.float32)


def _port_bn_step(case: dict, dtype) -> dict:
    """The port's PointMLP step in `dtype`, in _jax_bn_step's layout."""
    sd = {}
    weights._put_mlp(sd, "m", case["variables"]["params"],
                     case["variables"]["batch_stats"])
    m = PointMLP((4, 6, 5))
    m.load_state_dict({k[2:]: _t(v) for k, v in sd.items()})
    m.to(dtype).train()
    xt = _t(case["x"]).to(dtype).requires_grad_(True)
    mask = case["mask"]
    y = m(xt, mask=None if mask is None else _t(mask))
    (y * _t(case["wout"]).to(dtype)).sum().backward()
    out = {"out": y.detach().numpy(), "x_grad": xt.grad.numpy()}
    out.update({k: p.grad.numpy() for k, p in m.named_parameters()})
    out.update({k: b.numpy() for k, b in m.named_buffers()
                if not k.endswith("num_batches_tracked")})
    return out


@pytest.mark.parametrize("masked,dtype", [
    (False, "float32"), (True, "float32"), (False, "float64"),
    (True, "float64")], ids=["False", "True", "False-float64",
                             "True-float64"])
def test_masked_batch_norm_train_step_matches_jax(masked, dtype):
    """A 2-layer PointMLP in training mode on [3, 5, 7, 4] inputs, masked
    or not: output, gradients of a weighted sum with respect to the input
    and every parameter, and the running statistics, held to JAX's step in
    float64 (pu.jax_float64). In float64 the port's within pu.F64_REL of
    each tensor's largest entry; in float32 within BN_REL of it, or
    SPREAD_FACTOR times the float64 step's own change under a 1e-6
    jitter where that is larger. JAX's own float32 step is printed."""
    case, ref, spread, j32 = _bn_reference(masked)
    got = _port_bn_step(case, getattr(torch, dtype))
    assert set(got) == set(ref)
    pu.check_against_float64(got, ref, spread, dtype,
                             f"masked BN, mask {masked}", j32, rel=BN_REL)


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
# one train step of each stage against JAX's step in float64
# ---------------------------------------------------------------------------
def _port_step_values(model, loss) -> dict:
    """A port step's loss, every parameter's gradient and every updated
    running statistic, as float64 numpy."""
    out = {"loss": float(loss.detach())}
    out.update({n: p.grad.double().numpy()
                for n, p in model.named_parameters() if p.grad is not None})
    out.update({n: b.double().numpy() for n, b in model.named_buffers()
                if n.endswith(("running_mean", "running_var"))})
    return out


@pytest.fixture(scope="module")
def variables():
    return pu.jax_variables()


STAGE1_MODULES = ("sa1", "sa2", "sa3", "fp3", "fp2", "fp1")


def jax_step(f, stats):
    """JAX's train step f(params, stats, batch) -> (loss, mutated
    variables), jitted: run(params, batch, dtype) -> {name: gradient or
    updated statistic, "loss"} in the port's layout, every input cast to
    `dtype` (float64 inside pu.jax_float64 only)."""
    step = jax.jit(jax.value_and_grad(f, has_aux=True))

    def run(params, batch, dtype):
        (loss, mut), grads = step(pu.as_dtype(params, dtype),
                                  pu.as_dtype(stats, dtype),
                                  pu.as_dtype(batch, dtype))
        out = numpy_state_from_jax({
            "params": pu._numpy_tree(grads),
            "batch_stats": pu._numpy_tree(mut["batch_stats"])})
        out["loss"] = float(loss)
        return out
    return run


@pytest.fixture(scope="module")
def stage1(variables):
    """The JAX stage 1 (dropout off) in training mode at pu.inputs(): its
    parameters and statistics, a batch with random ground truth, JAX's
    step on it in float64 (loss, gradients, updated statistics) and the
    spread of each (the largest change of each tensor when the input
    colours, or all the weights, are jittered), and JAX's float32 step."""
    rng = np.random.RandomState(11)
    x = pu.inputs()
    batch = {"x": x["x"], "pos": x["pos"],
             "y": rng.rand(pu.B, pu.N, 3).astype(np.float32),
             "nocs_grip_point": rng.rand(pu.B, 3).astype(np.float32),
             "_valid_mask": np.ones(pu.B, np.float32)}
    jcfg = dataclasses.replace(pu.jax_cfg().pointnet2, dropout=False)
    params = variables["params"]["pointnet2_nocs"]
    stats = variables["batch_stats"]["pointnet2_nocs"]
    jm = jax_nocs.PointNet2NOCS(jcfg)

    def f(params, stats, batch):
        out, mut = jm.apply({"params": params, "batch_stats": stats},
                            batch["x"], batch["pos"], train=True,
                            mutable=["batch_stats"])
        return jax_nocs.get_metrics(jcfg, out, batch)[0]["loss"], mut

    run = jax_step(f, stats)
    ref, spread = pu.float64_reference(run, (params, batch), (
        (params, dict(batch, x=pu._jitter(batch["x"], 1))),
        (pu._jitter(params, 2), batch)))
    return dict(params=params, stats=stats, batch=batch, ref=ref,
                spread=spread, j32=run(params, batch, np.float32))


def _stage1_model(stage1, dtype=torch.float32):
    tcfg = dataclasses.replace(pu.torch_cfg().pointnet2, dropout=False)
    model = nocs.PointNet2NOCS(tcfg)
    model.load_state_dict(state_dict_from_jax(
        {"params": stage1["params"], "batch_stats": stage1["stats"]}))
    return model.to(dtype).train()


def _in_dtype(dtype: str):
    """The port's side of a step in `dtype`: pu.port_float64 in float64."""
    return (pu.port_float64() if dtype == "float64"
            else contextlib.nullcontext())


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


# the arguments of each stage-1 module that carry a gradient: features,
# and the FP's skip
MODULE_DIFF = {"sa1": [0], "sa2": [0], "sa3": [0], "fp3": [0, 2],
               "fp2": [0, 2], "fp1": [0, 2]}
_MODULE_REFS = {}


def _module_reference(stage1, name: str) -> dict:
    """One stage-1 module's seeded inputs, output cotangent (0 at the SA's
    pooled near-ties of the port's float32 forward, where the max's
    gradient jumps between two slots at rounding level), JAX's VJP in
    float64, its spread and JAX's float32 VJP; computed once a module."""
    if name in _MODULE_REFS:
        return _MODULE_REFS[name]
    from garmentnets_tpu.models import pointnet2 as jax_p2
    jmod = {
        "sa1": lambda: jax_p2.SAModule(0.5, pu.SA1_R, (6, 64, 64, 128)),
        "sa2": lambda: jax_p2.SAModule(0.25, pu.SA2_R, (131, 128, 128, 256)),
        "sa3": lambda: jax_p2.GlobalSAModule((259, 256, 512, 1024)),
        "fp3": lambda: jax_p2.FPModule(1, (1280, 256, 256)),
        "fp2": lambda: jax_p2.FPModule(3, (384, 256, 128)),
        "fp1": lambda: jax_p2.FPModule(3, (131, 128, 128, 128))}[name]()
    diff = MODULE_DIFF[name]
    args = list(_module_inputs(name))
    module = getattr(_stage1_model(stage1), f"{name}_module")
    targs = [torch.from_numpy(a.copy()) for a in args]
    ct = np.random.RandomState(len(name)).randn(
        *module(*[t.clone() for t in targs])[0].shape).astype(np.float32)
    if name in ("sa1", "sa2"):
        ct[_pooled_near_ties(module, targs).numpy()] = 0.0

    def vjp(args, params, dtype):
        args = [np.asarray(a, dtype) for a in args]
        stats = pu.as_dtype(stage1["stats"][name], dtype)

        def f(p, *d):
            a = list(args)
            for i, v in zip(diff, d):
                a[i] = v
            o, mut = jmod.apply({"params": p, "batch_stats": stats}, *a,
                                train=True, mutable=["batch_stats"])
            return o[0], mut

        out, vjp_fn, mut = jax.vjp(f, pu.as_dtype(params, dtype),
                                   *[args[i] for i in diff], has_aux=True)
        g = vjp_fn(jnp.asarray(ct, dtype))
        res = {"out": np.asarray(out)}
        weights._put_mlp(res, "m", pu._numpy_tree(g[0]["mlp"]),
                         pu._numpy_tree(mut["batch_stats"]["mlp"]))
        res.update({f"in{i}": np.asarray(g[1 + k])
                    for k, i in enumerate(diff)})
        return res

    params = stage1["params"][name]
    ref, spread = pu.float64_reference(vjp, (args, params), (
        ([pu._jitter(a, 1) if i in diff else a for i, a in enumerate(args)],
         params), (args, pu._jitter(params, 2))))
    _MODULE_REFS[name] = dict(args=args, ct=ct, ref=ref, spread=spread,
                              j32=vjp(args, params, np.float32))
    return _MODULE_REFS[name]


@pytest.mark.parametrize("name,dtype", [
    (n, d) for d in pu.DTYPES for n in STAGE1_MODULES],
    ids=[n + ("" if d == "float32" else f"-{d}")
         for d in pu.DTYPES for n in STAGE1_MODULES])
def test_stage1_module_train_vjp_matches_jax(stage1, name, dtype):
    """Each stage-1 module in training mode with the tiny configuration's
    weights, on seeded inputs (_module_inputs) and a seeded output
    cotangent (_module_reference), held to JAX's VJP in float64: in
    float64 every tensor within pu.F64_REL of its largest entry; in
    float32 the output and the running statistics within STAT_REL of
    their largest entry, every parameter's and input's gradient within
    GRAD_REL; or within SPREAD_FACTOR times the float64 VJP's own change
    when the module's inputs, or its weights, are jittered, where that is
    larger. The spread covers a BatchNorm channel that is nearly dead
    after its ReLU (a few entries above 0 in a batch of two clouds): its
    gradient moves with each entry that a 1e-6 change lifts over the
    ReLU's 0."""
    r = _module_reference(stage1, name)
    diff = MODULE_DIFF[name]
    dt = getattr(torch, dtype)
    module = getattr(_stage1_model(stage1, dt), f"{name}_module")
    targs = [torch.from_numpy(a.copy()).to(dt) for a in r["args"]]
    for i in diff:
        targs[i].requires_grad_(True)
    with _in_dtype(dtype):
        out = module(*targs)[0]
    (out * torch.from_numpy(r["ct"]).to(dt)).sum().backward()
    got = {"out": out.detach().double().numpy()}
    mlp = module.conv.local_nn if name in ("sa1", "sa2") else module.nn
    got.update({"m." + k: p.grad.double().numpy()
                for k, p in mlp.named_parameters()})
    got.update({"m." + k: b.double().numpy() for k, b in mlp.named_buffers()
                if not k.endswith("num_batches_tracked")})
    got.update({f"in{i}": targs[i].grad.double().numpy() for i in diff})
    pu.check_against_float64(got, r["ref"], r["spread"], dtype,
                             f"stage-1 module {name}", r["j32"])


@pytest.mark.parametrize("dtype", pu.DTYPES)
def test_stage1_train_step_matches_jax(stage1, dtype):
    """The whole stage-1 step end to end, held to JAX's step in float64:
    in float64 the loss, every gradient and every running statistic
    within pu.F64_REL of the tensor's largest entry; in float32 the loss
    within rtol LOSS_REL, every gradient within GRAD_REL of its largest
    entry, the running statistics within STAT_REL; or within
    SPREAD_FACTOR times the float64 step's own change when the input
    colours or the weights are jittered, where that is larger. A
    train-mode step at B=2 is ill-conditioned: FP3's BatchNorm normalizes
    the two clouds' global features, and pooled maxima have near-ties."""
    pu.check_against_float64(port_stage1_step(stage1, dtype),
                             stage1["ref"], stage1["spread"], dtype,
                             "stage-1 step", stage1["j32"])


def port_stage1_step(stage1, dtype: str, detach: str = None) -> dict:
    """The port's stage-1 step in `dtype` on stage1's batch, in
    _port_step_values' layout; the parameter named `detach`, where given,
    is cut off from the graph (a planted fault)."""
    dt = getattr(torch, dtype)
    model = _stage1_model(stage1, dt)
    if detach:
        model.get_parameter(detach).requires_grad_(False)
    tb = {k: _t(v).to(dt) for k, v in stage1["batch"].items()}
    with _in_dtype(dtype):
        loss = nocs.get_metrics(model.cfg, model(tb["x"], tb["pos"]),
                                tb)[0]["loss"]
    loss.backward()
    return _port_step_values(model, loss)


def _stage2_batch() -> dict:
    rng = np.random.RandomState(12)
    x = pu.inputs()
    M = 23
    return {"x": x["x"], "pos": x["pos"],
            "volume_query_points": rng.rand(pu.B, M, 3).astype(np.float32),
            "gt_volume_value": rng.rand(pu.B, M).astype(np.float32),
            "surf_query_points": rng.rand(pu.B, M, 3).astype(np.float32),
            "gt_sim_points": rng.randn(pu.B, M, 3).astype(np.float32),
            "_valid_mask": np.ones(pu.B, np.float32)}


@pytest.fixture(scope="module")
def stage2(variables):
    """JAX's pipeline step (the frozen stage 1 in eval mode) on
    _stage2_batch() in float64, its spread under a 1e-6 jitter of the
    input colours or of the weights, and JAX's float32 step."""
    batch = _stage2_batch()
    jcfg = pu.jax_cfg()
    jm = jax_pipe.ConvImplicitWNFPipeline(jcfg)

    def f(params, stats, batch):
        out, mut = jm.apply({"params": params, "batch_stats": stats},
                            batch, train=True, mutable=["batch_stats"])
        return jax_pipe.pipeline_loss(jcfg, out, batch)["loss"], mut

    run = jax_step(f, variables["batch_stats"])
    params = variables["params"]
    ref, spread = pu.float64_reference(run, (params, batch), (
        (params, dict(batch, x=pu._jitter(batch["x"], 1))),
        (pu._jitter(params, 2), batch)))
    return dict(batch=batch, ref=ref, spread=spread,
                j32=run(params, batch, np.float32))


def port_stage2_step(variables, batch: dict, dtype: str) -> tuple:
    """One pipeline step of the port in `dtype` through make_train_fns
    (Adam at 1e-3, the stage 1 frozen) -> (the model after the step, the
    step's values: loss, the gradients before Adam, the updated running
    statistics; a snapshot of the stage 1's state before the step)."""
    dt = getattr(torch, dtype)
    tcfg = pu.torch_cfg()
    model = pipe.ConvImplicitWNFPipeline(tcfg)
    model.load_state_dict(state_dict_from_jax(variables))
    model.to(dt)
    model.pointnet2_nocs.requires_grad_(False)
    stage1 = {k: v.clone() for k, v in
              model.pointnet2_nocs.state_dict().items()}
    optimizer = make_adam(model, 1e-3)
    out = {}

    def loss_fn(o, b):
        out["loss"] = pipe.pipeline_loss(tcfg, o, b)["loss"]
        return {"loss": out["loss"]}

    train_step, _ = make_train_fns(model, lambda b, gen: model(b), loss_fn,
                                   optimizer)
    snapshot = {}
    orig_step = optimizer.step

    def step_after_snapshot():
        # the gradients and statistics the step computed, before Adam
        snapshot["grads"] = {n: None if p.grad is None else p.grad.clone()
                             for n, p in model.named_parameters()}
        return orig_step()

    optimizer.step = step_after_snapshot
    with _in_dtype(dtype):
        train_step({k: _t(v).to(dt) for k, v in batch.items()})
    for name, p in model.named_parameters():
        p.grad = snapshot["grads"][name]
    return model, _port_step_values(model, out["loss"]), stage1


@pytest.mark.parametrize("dtype", pu.DTYPES)
def test_stage2_train_step_matches_jax(variables, stage2, dtype):
    """One pipeline step held to JAX's step in float64 (the bars of
    test_stage1_train_step_matches_jax): the JAX stage 1 gives zero
    gradients and keeps its statistics; the port's takes no gradient,
    and its weights and statistics stay bit-equal through
    make_train_fns' Adam step."""
    model, got, stage1 = port_stage2_step(variables, stage2["batch"], dtype)
    assert not model.pointnet2_nocs.training and model.volume_agg.training
    n_grads = len([p for p in model.parameters() if p.requires_grad])
    assert n_grads > 0 and n_grads == len(
        [k for k in got if k in dict(model.named_parameters())])
    for name, p in model.named_parameters():
        if p.grad is None:
            assert not p.requires_grad and not stage2["ref"][name].any()
    pu.check_against_float64(got, stage2["ref"], stage2["spread"], dtype,
                             "stage-2 step", stage2["j32"],
                             frozen="pointnet2_nocs.")
    for k, v in model.pointnet2_nocs.state_dict().items():
        assert torch.equal(v, stage1[k]), k


def _unbiased_variance_bn(bn, x, mask=None, group=None):
    """models/mlp.train_batch_norm (one process) with a planted fault: the
    normalization divides by the unbiased variance."""
    dims = tuple(range(x.dim() - 1))
    w = (torch.ones_like(x[..., :1]) if mask is None
         else mask.to(x.dtype)[..., None])
    n = torch.clamp(w.sum(dims)[0], min=1.0)
    mean = (x * w).sum(dims) / n
    unbiased = (((x - mean) ** 2) * w).sum(dims) / torch.clamp(n - 1.0,
                                                              min=1.0)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean)
        bn.running_var.copy_((1 - m) * bn.running_var + m * unbiased)
    return (x - mean) * (bn.weight / torch.sqrt(unbiased + bn.eps)) + bn.bias


def _eps_bn(train_batch_norm):
    """train_batch_norm with a planted fault: eps 1e-3, not 1e-5."""
    def bn_fn(bn, x, mask=None, group=None):
        saved, bn.eps = bn.eps, 1e-3
        try:
            return train_batch_norm(bn, x, mask, group)
        finally:
            bn.eps = saved
    return bn_fn


def _moved_scatter_argmax(scatter_to_grid):
    """ops/scatter.scatter_to_grid with a planted fault: in the first cell
    of batch row 0 that holds two or more points, every channel takes its
    smallest point's value instead of its largest (the argmax moved to
    another point)."""
    def scatter(features, flat_idx, num_cells, reduce="max"):
        out = scatter_to_grid(features, flat_idx, num_cells, reduce)
        counts = torch.bincount(flat_idx[0], minlength=num_cells)
        cell = int(torch.nonzero(counts >= 2)[0, 0])
        points = torch.nonzero(flat_idx[0] == cell)[:, 0]
        out = out.clone()
        out[0, cell] = features[0, points].amin(0)
        return out
    return scatter


@pytest.mark.parametrize("fault", [
    "unbiased_variance-False", "unbiased_variance-True", "eps_1e-3-False",
    "eps_1e-3-True", "scatter_argmax", "detached_parameter-float32",
    "detached_parameter-float64"])
def test_planted_faults_fail_the_float32_bars(request, monkeypatch, fault):
    """The float32 bars of the steps above still catch real faults: the
    port's masked BatchNorm (models/mlp.py patched in this test only)
    with the unbiased variance in its normalization, or with eps 1e-3,
    masked or not, fails test_masked_batch_norm_train_step_matches_jax's
    bar in some tensor; the stage-2 step with one scatter-max cell's
    argmax moved (models/pipeline.py's scatter_to_grid patched) fails
    test_stage2_train_step_matches_jax's; a stage-1 parameter cut off
    from the graph (no gradient) fails test_stage1_train_step_matches_jax
    in float32 and in float64."""
    from garmentnets_tpu_torch.models import mlp as port_mlp
    if fault.startswith("detached_parameter"):
        stage1, dtype = request.getfixturevalue("stage1"), fault[19:]
        name = "fp3_module.nn.0.0.weight"
        got = port_stage1_step(stage1, dtype, detach=name)
        assert name not in got
        with pytest.raises(AssertionError, match=name):
            pu.check_against_float64(got, stage1["ref"], stage1["spread"],
                                     dtype, f"stage-1 step, {name} cut off")
        return
    if fault == "scatter_argmax":
        stage2 = request.getfixturevalue("stage2")
        monkeypatch.setattr(pipe, "scatter_to_grid",
                            _moved_scatter_argmax(pipe.scatter_to_grid))
        _, got, _ = port_stage2_step(request.getfixturevalue("variables"),
                                     stage2["batch"], "float32")
        with pytest.raises(AssertionError):
            pu.check_against_float64(got, stage2["ref"], stage2["spread"],
                                     "float32", "stage-2 step, argmax moved",
                                     frozen="pointnet2_nocs.")
        return
    kind, masked = fault.rsplit("-", 1)
    monkeypatch.setattr(port_mlp, "train_batch_norm",
                        _unbiased_variance_bn if kind == "unbiased_variance"
                        else _eps_bn(port_mlp.train_batch_norm))
    case, ref, spread, _ = _bn_reference(masked == "True")
    got = _port_bn_step(case, torch.float32)
    with pytest.raises(AssertionError):
        pu.check_against_float64(got, ref, spread, "float32",
                                 f"masked BN with {fault}", rel=BN_REL)


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
