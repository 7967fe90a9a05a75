"""Stage 2 of the port vs the JAX pipeline with the same weights and the same
stage-1 output: feature volume (aggregation + U-Net), the dense WNF over the
lattice, and the surface decoder (warp), within rtol 1e-3 / atol 5e-4."""
import pathlib
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_port_util as pu  # noqa: E402

from garmentnets_tpu.models.pipeline import ConvImplicitWNFPipeline  # noqa: E402
from garmentnets_tpu.ops.dense_decode import (  # noqa: E402
    dense_decode as jax_decode, eval_layers as jax_eval_layers)
from garmentnets_tpu_torch.ops.dense_decode import (  # noqa: E402
    dense_decode, eval_layers)

TOL = dict(rtol=1e-3, atol=5e-4)


@pytest.fixture(scope="module")
def setup():
    variables = pu.jax_variables()
    x = pu.inputs()
    jm = ConvImplicitWNFPipeline(pu.jax_cfg())
    p2 = jax.jit(lambda v, a, b: jm.apply(
        v, a, b, method=ConvImplicitWNFPipeline.pointnet2_forward))(
            variables, jnp.asarray(x["x"]), jnp.asarray(x["pos"]))
    nocs = {k: np.array(v) for k, v in p2["nocs_data"].items()}
    fv_ref = np.asarray(jax.jit(lambda v, nd: jm.apply(
        v, nd, train=False, method=ConvImplicitWNFPipeline.unet3d_forward))(
            variables, {k: jnp.asarray(v) for k, v in nocs.items()}))
    tm = pu.torch_model(variables)
    with torch.no_grad():
        fv = tm.unet3d_forward({k: torch.from_numpy(v)
                                for k, v in nocs.items()})
    return dict(variables=variables, jm=jm, tm=tm, x=x, fv=fv, fv_ref=fv_ref)


def test_feature_volume_matches(setup):
    fv = setup["fv"].numpy()
    assert fv.shape == setup["fv_ref"].shape == (pu.B, pu.GRID, pu.GRID,
                                                 pu.GRID, 32)
    np.testing.assert_allclose(fv, setup["fv_ref"], **TOL)


def test_dense_wnf_matches(setup):
    """The engine's decode of the transposed volume on both sides."""
    v = setup["variables"]
    layers = jax_eval_layers(v["params"]["volume_decoder"]["mlp"],
                             v["batch_stats"]["volume_decoder"]["mlp"])
    ref = np.asarray(jax_decode(
        jnp.swapaxes(jnp.asarray(setup["fv_ref"]), 1, 3), layers, pu.VOL,
        slab=4, precision=jax.lax.Precision.HIGHEST, backend="xla"))
    with torch.no_grad():
        ours = dense_decode(
            setup["fv"].transpose(1, 3).contiguous(),
            eval_layers(setup["tm"].volume_decoder.mlp), pu.VOL).numpy()
    np.testing.assert_allclose(ours, ref, **TOL)


def test_surface_decoder_matches(setup):
    q = setup["x"]["sq"]
    jm = setup["jm"]
    ref = np.asarray(jax.jit(lambda v, fv, qq: jm.apply(
        v, fv, qq, train=False,
        method=ConvImplicitWNFPipeline.surface_decoder_forward))(
            setup["variables"], jnp.asarray(setup["fv_ref"]),
            jnp.asarray(q)))
    with torch.no_grad():
        ours = setup["tm"].surface_decoder_forward(
            setup["fv"], torch.from_numpy(q)).numpy()
    assert ours.shape == (pu.B, q.shape[1], 3)
    np.testing.assert_allclose(ours, ref, **TOL)


def test_volume_decoder_at_lattice_matches_dense_decode(setup):
    """The fused lattice decode equals grid_sample + MLP at the lattice
    points (the axis-order quirk on both paths)."""
    tm = setup["tm"]
    ax = np.linspace(0, 1, pu.VOL, dtype=np.float32)
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    q = torch.from_numpy(np.broadcast_to(g, (pu.B,) + g.shape).copy())
    with torch.no_grad():
        pointwise = tm.volume_decoder_forward(setup["fv"], q).numpy()
        dense = dense_decode(setup["fv"].transpose(1, 3).contiguous(),
                             eval_layers(tm.volume_decoder.mlp),
                             pu.VOL).numpy()
    np.testing.assert_allclose(dense.reshape(pu.B, -1), pointwise,
                               rtol=1e-4, atol=1e-5)
