"""Shared fixtures of the port's parity tests (tests/test_torch_*.py).

One tiny pipeline configuration, built on both sides: the JAX package's
`PipelineConfig` and the port's, with JAX-initialized weights whose norm
parameters and running statistics are randomized from a numpy seed, and
carried to the port through garmentnets_tpu_torch/core/weights.py.
"""
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


def jax_cfg():
    from garmentnets_tpu.models.pipeline import PipelineConfig
    from garmentnets_tpu.models.pointnet2_nocs import PointNet2NOCSConfig
    return PipelineConfig(pointnet2=PointNet2NOCSConfig(
        feature_dim=FEAT, nocs_bins=BINS, sa1_r=SA1_R, sa2_r=SA2_R), **TINY)


def torch_cfg():
    from garmentnets_tpu_torch.models.pipeline import PipelineConfig
    from garmentnets_tpu_torch.models.pointnet2_nocs import (
        PointNet2NOCSConfig)
    return PipelineConfig(pointnet2=PointNet2NOCSConfig(
        feature_dim=FEAT, nocs_bins=BINS, sa1_r=SA1_R, sa2_r=SA2_R), **TINY)


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


def jax_variables(seed=0):
    """Numpy variables tree {"params", "batch_stats"} of the tiny JAX
    pipeline."""
    import jax
    import jax.numpy as jnp
    from garmentnets_tpu.models.pipeline import ConvImplicitWNFPipeline
    x = inputs()
    batch = {"x": jnp.asarray(x["x"]), "pos": jnp.asarray(x["pos"]),
             "volume_query_points": jnp.asarray(x["sq"]),
             "surf_query_points": jnp.asarray(x["sq"])}
    model = ConvImplicitWNFPipeline(jax_cfg())
    variables = jax.jit(lambda key: model.init(key, batch, train=False))(
        jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed + 7)
    return {k: _randomize(jax.tree_util.tree_map(np.asarray, v), rng)
            for k, v in variables.items()}


def torch_model(variables):
    """The port's pipeline (CPU, eval mode) with the JAX weights."""
    from garmentnets_tpu_torch.core.weights import state_dict_from_jax
    from garmentnets_tpu_torch.models.pipeline import (
        ConvImplicitWNFPipeline)
    m = ConvImplicitWNFPipeline(torch_cfg())
    m.load_state_dict(state_dict_from_jax(variables))
    return m.eval()
