"""Shared fixtures of the port's parity tests (tests/test_torch_*.py).

One tiny pipeline configuration, built on both sides: the JAX package's
`PipelineConfig` and the port's, with JAX-initialized weights whose norm
parameters and running statistics are randomized from a numpy seed, and
carried to the port through garmentnets_tpu_torch/core/weights.py. Its
model variants (`VARIANTS`) are overrides of the same configuration.

The reference of a train-mode step is JAX's step computed in float64
(`jax_float64`). A float32 train step is ill-conditioned at rounding
level: a pre-activation within rounding of 0 takes the ReLU's other side,
a scatter-max cell or a pooled max picks the other of two near-equal
entries, and BatchNorm's mean and variance over a small batch are sums
that cancel. So two float32 implementations that sum in other orders,
JAX's included, may differ by more than a bar set from rounding alone,
while the same step in float64 agrees between the packages to ~1e-15 of a
tensor's largest entry. The port's steps are held twice against JAX's
float64 step: the port's float64 step within F64_REL of each tensor's
largest entry (the exact parity check), and the port's float32 step at a
bar of `_atol` (rel of the float64 step's largest entry, or SPREAD_FACTOR
times the float64 step's own change under a 1e-6 `_jitter`, whichever is
larger).

`jax_float64` runs the JAX package's step in float64 without editing it:
x64 on; the explicit `jnp.float32` of garmentnets_tpu/models/mlp.py's
MaskedBatchNorm (its casts of the input, the count and 1.0 before the
rsqrt) read as float64 through a view of jax.numpy put in that module's
place; garmentnets_tpu/ops/virtual_grid.py's voxel-centre points (its
`_float_dtype`, np.float32: the stage-2 aggregator's grid points and the
NOCS bins' centres) computed in float64; FPS and the ball query of
garmentnets_tpu/models/pointnet2.py choosing on the positions rounded to
float32. `port_float64` does the last two for the port
(garmentnets_tpu_torch/ops/virtual_grid.py, models/pointnet2.py), so that
both packages' float64 steps pick the neighbours of their float32 steps.
The grid points must be float64 on both sides: left in float32, a jitted
JAX step keeps them at float64 precision where XLA fuses them with the
float64 ops that follow (XLA may skip a rounding to a narrower type), and
the stage-2 gradients of an eager and a jitted float64 step then differ
by ~3e-7 of their largest entry. No other module on the stage-1 or
stage-2 step casts to float32 on the CPU: ops/pointcloud.py's float32 is
the Pallas FPS probe, which the CPU backend skips, and the scatter-max,
grid_sample and the U-Net follow their inputs' dtype.
"""
import contextlib
import copy
import types

import numpy as np

B, N = 2, 256
BINS, FEAT = 8, 128
SA1_R, SA2_R = 0.2, 0.4
GRID, VOL = 16, 16

TINY = dict(volume_agg_nn_channels=(FEAT + 9, 64, 32),
            grid_shape=(GRID, GRID, GRID), unet_in_channels=32,
            unet_out_channels=32, unet_f_maps=8, unet_num_levels=2,
            unet_num_groups=4, volume_decoder_channels=(32, 16, 1),
            surface_decoder_channels=(32, 16, 3))
# the inference variants of the JAX PipelineConfig, as overrides of TINY:
# an include flag off drops its channels from the aggregator's first width
VARIANTS = {
    "holes": dict(mc_surface_loss_weight=1.0,
                  mc_surface_decoder_channels=(32, 16, 1)),
    "task_space": dict(volume_task_space=True),
    "no_point_feature": dict(include_point_feature=False,
                             volume_agg_nn_channels=(FEAT + 3, 64, 32)),
    "no_confidence_feature": dict(include_confidence_feature=False,
                                  volume_agg_nn_channels=(FEAT + 6, 64, 32)),
    "classification": dict(volume_classification=True),
}
# a sim-space AABB [2, 3] for the task-space variant (the clouds of
# inputs() lie in [-0.5, 0.5]^3)
TASK_AABB = np.array([[-0.5, -0.55, -0.6], [0.52, 0.5, 0.45]], np.float32)


def jax_cfg(**over):
    from garmentnets_tpu.models.pipeline import PipelineConfig
    from garmentnets_tpu.models.pointnet2_nocs import PointNet2NOCSConfig
    return PipelineConfig(pointnet2=PointNet2NOCSConfig(
        feature_dim=FEAT, nocs_bins=BINS, sa1_r=SA1_R, sa2_r=SA2_R),
        **dict(TINY, **over))


def torch_cfg(**over):
    from garmentnets_tpu_torch.models.pipeline import PipelineConfig
    from garmentnets_tpu_torch.models.pointnet2_nocs import (
        PointNet2NOCSConfig)
    return PipelineConfig(pointnet2=PointNet2NOCSConfig(
        feature_dim=FEAT, nocs_bins=BINS, sa1_r=SA1_R, sa2_r=SA2_R),
        **dict(TINY, **over))


def inputs(seed=42):
    rng = np.random.RandomState(seed)
    return {
        "x": rng.rand(B, N, 3).astype(np.float32),
        "pos": (rng.rand(B, N, 3).astype(np.float32) - 0.5),
        "sq": rng.rand(B, 17, 3).astype(np.float32),
    }


def _randomize(tree, rng, path=()):
    """Biases, norm scales and BN running stats drawn from `rng` (init
    leaves them at 0/1, which would hide a wrong mapping)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng, path + (k,))
            continue
        v = np.asarray(v)
        norm = any(p.startswith(("bn_", "gn_")) for p in path)
        if norm and k in ("scale", "var"):
            v = (0.5 + rng.rand(*v.shape)).astype(v.dtype)
        elif k in ("bias", "mean"):
            v = (0.1 * rng.randn(*v.shape)).astype(v.dtype)
        out[k] = v
    return out


def jax_variables(seed=0, cfg=None):
    """Numpy variables tree {"params", "batch_stats"} of the tiny JAX
    pipeline (or of the JAX configuration `cfg`)."""
    import jax
    import jax.numpy as jnp
    from garmentnets_tpu.models.pipeline import ConvImplicitWNFPipeline
    x = inputs()
    batch = {"x": jnp.asarray(x["x"]), "pos": jnp.asarray(x["pos"]),
             "volume_query_points": jnp.asarray(x["sq"]),
             "surf_query_points": jnp.asarray(x["sq"]),
             "mc_surf_query_points": jnp.asarray(x["sq"]),
             "cloth_sim_aabb": jnp.broadcast_to(TASK_AABB, (B, 2, 3))}
    model = ConvImplicitWNFPipeline(cfg or jax_cfg())
    variables = jax.jit(lambda key: model.init(key, batch, train=False))(
        jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed + 7)
    return {k: _randomize(jax.tree_util.tree_map(np.asarray, v), rng)
            for k, v in variables.items()}


def live_head_state(cfg, state_dict, x, pos, vol, share=0.1, **engine_kw):
    """A copy of the port's `state_dict` whose volume decoder head is
    relu(z + b) (identity BatchNorm), with b putting `share` of the voxels
    of (x, pos) above 0.5 at width `vol`, read by the port's engine on the
    CPU for the port's configuration `cfg`."""
    from garmentnets_tpu_torch.harness.predict_engine import PredictEngine
    sd = {k: v.clone() for k, v in state_dict.items()}
    head = f"volume_decoder.mlp.{len(cfg.volume_decoder_channels) - 2}"
    sd[f"{head}.2.weight"].fill_(1.0)
    sd[f"{head}.2.bias"].zero_()
    sd[f"{head}.2.running_mean"].zero_()
    sd[f"{head}.2.running_var"].fill_(1 - 1e-5)
    sd[f"{head}.0.bias"].fill_(100.0)
    probe = PredictEngine(cfg, sd, volume_size=vol, return_volume=True,
                          decode_precision="highest", mc_threads=1,
                          device="cpu", **engine_kw)
    z = probe.encode(x, pos)["wnf_volume"].numpy() - 100.0
    sd[f"{head}.0.bias"].fill_(0.5 - np.quantile(z, 1 - share))
    return sd


def live_head(variables, x, pos, vol, share=0.1, cfg=None, **engine_kw):
    """`live_head_state` on JAX variables: a copy with the same head, for
    the port's configuration `cfg` (the tiny one by default)."""
    from garmentnets_tpu_torch.core.weights import state_dict_from_jax
    cfg = cfg or torch_cfg()
    sd = live_head_state(cfg, state_dict_from_jax(variables), x, pos, vol,
                         share, **engine_kw)
    v = copy.deepcopy(variables)
    head = v["params"]["volume_decoder"]["mlp"]
    last = len(cfg.volume_decoder_channels) - 2
    head[f"bn_{last}"]["scale"][:] = 1.0
    head[f"bn_{last}"]["bias"][:] = 0.0
    stats = v["batch_stats"]["volume_decoder"]["mlp"][f"bn_{last}"]
    stats["mean"][:] = 0.0
    stats["var"][:] = 1 - 1e-5
    head[f"dense_{last}"]["bias"][:] = sd[
        f"volume_decoder.mlp.{last}.0.bias"].numpy()
    return v


def torch_model(variables):
    """The port's pipeline (CPU, eval mode) with the JAX weights."""
    from garmentnets_tpu_torch.core.weights import state_dict_from_jax
    from garmentnets_tpu_torch.models.pipeline import (
        ConvImplicitWNFPipeline)
    m = ConvImplicitWNFPipeline(torch_cfg())
    m.load_state_dict(state_dict_from_jax(variables))
    return m.eval()


# ---------------------------------------------------------------------------
# train-step references: JAX's step in float64, and the bars against it
# ---------------------------------------------------------------------------
# how many times the float64 step's own spread (see _atol) the port's
# float32 step may differ by
SPREAD_FACTOR = 10
# the port's float64 step against JAX's, of each tensor's largest entry
F64_REL = 1e-9
DTYPES = ("float32", "float64")


def _numpy_tree(t):
    import jax
    return jax.tree_util.tree_map(np.asarray, t)


def as_dtype(tree, dtype):
    """A numpy copy of a tree whose floating arrays are cast to dtype."""
    import jax
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, dtype) if np.issubdtype(
            np.asarray(a).dtype, np.floating) else np.asarray(a), tree)


def _jitter(tree, seed: int):
    """Every float32 of a numpy tree times (1 + 1e-6 N(0, 1)): about the
    rounding of an f32 dot product of a hundred terms, the size of the
    differences between two implementations that sum in other orders."""
    import jax
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (a * (1 + 1e-6 * rng.randn(*np.shape(a)))).astype(
            np.float32) if np.asarray(a).dtype == np.float32 else a, tree)


def _atol(ref, spread, rel):
    """The tolerance on one tensor: rel of its largest entry, or
    SPREAD_FACTOR times the most that the reference moved when its inputs
    or its weights were jittered (_jitter), whichever is larger."""
    return max(rel * np.abs(ref).max(), SPREAD_FACTOR * spread)


def rel_err(got, ref) -> float:
    """max |got - ref| over the largest |ref| (0 where both are 0)."""
    ref = np.asarray(ref, np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - ref).max())
    top = float(np.abs(ref).max())
    return err / top if top > 0 else float(err > 0)


def assert_f64_parity(got: dict, ref: dict, what: str = "") -> float:
    """Every tensor of `got` (the port's float64 step) within F64_REL of
    the largest entry of the same tensor of `ref` (JAX's float64 step);
    returns the worst ratio."""
    assert set(got) <= set(ref), sorted(set(got) - set(ref))
    worst = 0.0
    for k, v in got.items():
        r = np.asarray(ref[k], np.float64)
        assert np.asarray(v).dtype == np.float64, (k, np.asarray(v).dtype)
        np.testing.assert_allclose(v, r, rtol=0, err_msg=f"{what} {k}",
                                   atol=F64_REL * np.abs(r).max())
        worst = max(worst, rel_err(v, r))
    print(f"\n{what}: the port's float64 step against JAX's float64 step, "
          f"worst error / the tensor's largest entry {worst:.3e} over "
          f"{len(got)} tensors")
    return worst


def report_jax_float32(j32: dict, ref: dict, what: str = "") -> None:
    """Print (never assert) how far JAX's own float32 step lies from its
    float64 step: the worst tensors, as fractions of their largest entry."""
    errs = sorted(((rel_err(v, ref[k]), k) for k, v in j32.items()
                   if k in ref), reverse=True)
    print(f"\n{what}: JAX's float32 step against its float64 step, worst "
          "error / the tensor's largest entry: " + ", ".join(
              f"{e:.3e} ({k})" for e, k in errs[:3]))


# the float32 step's bars, of each tensor's largest entry: gradients, and
# outputs and statistics (the loss: rtol LOSS_REL)
GRAD_REL, STAT_REL, LOSS_REL = 1e-4, 1e-5, 1e-5


def _rel(name: str) -> float:
    """A tensor's float32 bar: GRAD_REL for a gradient (a parameter's or
    an input's), STAT_REL for an output or a running statistic."""
    stat = name == "out" or name.endswith(("running_mean", "running_var"))
    return STAT_REL if stat else GRAD_REL


def check_against_float64(got: dict, ref: dict, spread: dict, dtype: str,
                          what: str, j32: dict = None, rel: float = None,
                          frozen: str = None) -> float:
    """A port step (`got`: name -> array, "loss" a float) against JAX's
    float64 step `ref` and its spread under a 1e-6 jitter: in float64
    within F64_REL of each tensor's largest entry; in float32 within
    _atol(ref, spread, rel or _rel(name)), the loss within LOSS_REL or
    SPREAD_FACTOR times its spread. Every tensor of `ref` must be in
    `got` but a num_batches_tracked and, under the prefix `frozen` (a
    frozen module, whose parameters take no gradient in the port), a
    gradient that is 0 in the reference. JAX's float32 step `j32`, where
    given, is printed only. Returns the worst error / bar (float32) or
    error / largest entry (float64)."""
    assert set(got) <= set(ref), sorted(set(got) - set(ref))
    missing = sorted(k for k in set(ref) - set(got)
                     if not k.endswith("num_batches_tracked") and not (
                         frozen and k.startswith(frozen)
                         and not np.any(ref[k])))
    assert not missing, f"{what}: the port gives no {missing}"
    if dtype == "float64":
        return assert_f64_parity(got, ref, what)
    if j32 is not None:
        report_jax_float32(j32, ref, what)
    ratios = []
    for k, v in got.items():
        if k == "loss":
            err = abs(v - ref[k])
            bar = max(LOSS_REL * abs(ref[k]), SPREAD_FACTOR * spread[k])
        else:
            err = float(np.abs(v - ref[k]).max())
            bar = _atol(ref[k], spread[k], rel or _rel(k))
        # a tensor that is 0 in the reference and never moved must be 0
        ratios.append((err / bar if bar > 0 else float(err > 0) * 2.0, k))
    ratios.sort(reverse=True)
    worst = max((rel_err(v, ref[k]), k) for k, v in got.items()
                if k != "loss")
    print(f"{what}: the port's float32 step, worst error / bar "
          + ", ".join(f"{r:.3f} ({k})" for r, k in ratios[:3])
          + f"; worst error / the tensor's largest entry {worst[0]:.3e} "
          f"({worst[1]})")
    bad = [(k, r) for r, k in ratios if r > 1.0]
    assert not bad, bad
    return ratios[0][0]


def float64_reference(run, args: tuple, jitters) -> tuple:
    """JAX's step `run(*args, dtype)` -> {name: array} in float64 (inside
    jax_float64) and its spread: the largest change of each tensor when
    it runs on each of `jitters` (argument tuples, a 1e-6 jitter of the
    inputs or of the weights) instead."""
    with jax_float64():
        ref = run(*args, np.float64)
        spread = dict.fromkeys(ref, 0.0)
        for moved in (run(*a, np.float64) for a in jitters):
            spread = {k: max(spread[k], float(np.max(np.abs(
                np.asarray(moved[k]) - ref[k])))) for k in ref}
    return ref, spread


@contextlib.contextmanager
def jax_float64():
    """JAX's step in float64 throughout, the JAX package unedited (see the
    module docstring): x64 on; MaskedBatchNorm's float32 casts read as
    float64; the virtual grid's points in float64; FPS and the ball query
    choose on float32 positions."""
    import jax
    import jax.numpy as jnp
    from garmentnets_tpu.models import mlp as jax_mlp
    from garmentnets_tpu.models import pointnet2 as jax_p2
    from garmentnets_tpu.ops import virtual_grid as jax_vg
    view = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                    if not k.startswith("__")})
    view.float32 = jnp.float64
    saved = (jax_mlp.jnp, jax_p2.furthest_point_sampling, jax_p2.ball_query,
             jax_vg._float_dtype)
    fps, bq = saved[1:3]
    jax_mlp.jnp = view
    jax_p2.furthest_point_sampling = lambda pos, n, **kw: fps(
        pos.astype(jnp.float32), n, **kw)
    jax_p2.ball_query = lambda p, c, r, **kw: bq(
        p.astype(jnp.float32), c.astype(jnp.float32), r, **kw)
    jax_vg._float_dtype = lambda xp: np.float64
    try:
        with jax.enable_x64(True):
            yield
    finally:
        (jax_mlp.jnp, jax_p2.furthest_point_sampling, jax_p2.ball_query,
         jax_vg._float_dtype) = saved


@contextlib.contextmanager
def port_float64():
    """The port's side of jax_float64, for a float64 step of the port: the
    virtual grid's points in float64; FPS and the ball query choose on the
    positions rounded to float32."""
    from garmentnets_tpu_torch.models import pointnet2 as port_p2
    from garmentnets_tpu_torch.ops import virtual_grid as port_vg
    grid = port_vg.VirtualGrid
    saved = (port_p2.ball_query, port_p2.furthest_point_sampling,
             grid._f32, grid.idxs_to_points)
    bq, fps, f32 = saved[:3]

    def points64(self, idxs):
        lc = self._f32(self.lower_corner, idxs)
        uc = self._f32(self.upper_corner, idxs)
        return idxs.double() * ((uc - lc) / (self._f32(self.grid_shape,
                                                       idxs) - 1)) + lc

    port_p2.ball_query = lambda p, c, r, **kw: bq(p.float(), c.float(), r,
                                                  **kw)
    port_p2.furthest_point_sampling = lambda p, n: fps(p.float(), n)
    grid._f32 = lambda self, values, like: f32(self, values, like).double()
    grid.idxs_to_points = points64
    try:
        yield
    finally:
        (port_p2.ball_query, port_p2.furthest_point_sampling, grid._f32,
         grid.idxs_to_points) = saved
