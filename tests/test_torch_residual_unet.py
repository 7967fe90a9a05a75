"""The port's ResidualUNet3D against the JAX package's, with the JAX
variables carried by core/weights.py (ExtResNetBlock conv1..conv3, the
decoders' transposed convolutions without a spatial flip), for the orders
'cge' and 'gcr' at f_maps 4, 3 levels, 2 groups, within atol 1e-5 /
rtol 1e-4 (measured: 4e-6 for 'cge' and 4e-5 on outputs of magnitude ~7
for 'gcr'). Biases and GroupNorm parameters are randomized from a numpy
seed, as init leaves them at 0 and 1, which would hide a wrong mapping.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from garmentnets_tpu.models.unet3d import ResidualUNet3D as JaxResidualUNet3D
from garmentnets_tpu_torch.core.weights import unet3d_state_from_jax
from garmentnets_tpu_torch.models.unet3d import ResidualUNet3D

TOL = dict(rtol=1e-4, atol=1e-5)


def _randomized(variables, seed):
    rng = np.random.RandomState(seed)

    def leaf(path, v):
        v = np.array(v)
        name = path[-1].key
        if name in ("bias", "scale"):
            v = v + 0.3 * rng.randn(*v.shape).astype(v.dtype)
        return v
    return jax.tree_util.tree_map_with_path(leaf, variables)


def _pair(order, f_maps=4, num_levels=3, in_ch=8, out_ch=6, seed=0):
    net = JaxResidualUNet3D(in_channels=in_ch, out_channels=out_ch,
                            f_maps=f_maps, num_levels=num_levels,
                            num_groups=2, layer_order=order)
    x = np.random.RandomState(seed + 1).rand(2, 8, 8, 8, in_ch).astype(
        np.float32)
    variables = _randomized(
        net.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False),
        seed + 2)
    port = ResidualUNet3D(in_ch, out_ch, f_maps=f_maps, layer_order=order,
                          num_groups=2, num_levels=num_levels)
    sd = unet3d_state_from_jax(variables, "abstract_3d_unet")
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                         strict=True)
    return net, variables, port.eval(), x


@pytest.mark.parametrize("order", ["cge", "gcr"])
def test_residual_unet3d_matches_jax(order):
    net, variables, port, x = _pair(order)
    want = np.asarray(net.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 8, 8, 8, 6)
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, **TOL)


def test_weight_layout_and_keys():
    """Every port parameter is mapped; the transposed kernel is [in, out,
    3, 3, 3], flax's [3, 3, 3, out, in] transposed, not flipped."""
    _, variables, port, _ = _pair("cge")
    sd = unet3d_state_from_jax(variables, "abstract_3d_unet")
    assert set(sd) == set(port.state_dict())
    k = np.asarray(variables["params"]["upsample_0"]["kernel"])
    w = sd["abstract_3d_unet.decoders.0.upsampling.upsample.weight"]
    assert k.shape == (3, 3, 3, 8, 16) and w.shape == (16, 8, 3, 3, 3)
    np.testing.assert_array_equal(w[3, 5, 0, 1, 2], k[0, 1, 2, 5, 3])
    conv3 = port.abstract_3d_unet.encoders[0].basic_module.conv3
    assert [n for n, _ in conv3.named_children()] == ["conv", "groupnorm"]


def test_default_five_levels():
    """The default of 5 levels halves a 16^3 volume down to 1^3 and back."""
    port = ResidualUNet3D(3, 2, f_maps=4, num_groups=2).eval()
    assert len(port.abstract_3d_unet.encoders) == 5
    assert len(port.abstract_3d_unet.decoders) == 4
    with torch.no_grad():
        out = port(torch.rand(1, 16, 16, 16, 3))
    assert out.shape == (1, 16, 16, 16, 2) and bool(torch.isfinite(out).all())
