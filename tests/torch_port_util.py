"""Shared fixtures of the port's parity tests (tests/test_torch_*.py).

One tiny pipeline configuration, built on both sides: the JAX package's
`PipelineConfig` and the port's, with JAX-initialized weights whose norm
parameters and running statistics are randomized from a numpy seed, and
carried to the port through garmentnets_tpu_torch/core/weights.py. Its
model variants (`VARIANTS`) are overrides of the same configuration.
"""
import copy

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
