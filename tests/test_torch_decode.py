"""Port dense decode vs the JAX package's separable slab path and its fused
Pallas kernel in interpret mode (HIGHEST precision)."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from garmentnets_tpu.ops.dense_decode import dense_decode as jax_decode
from garmentnets_tpu.ops.dense_decode_pallas import dense_decode_fused
from garmentnets_tpu_torch.kernels.dense_decode_tc import (
    dense_decode_tc_cuda, pack_decoder)
from garmentnets_tpu_torch.ops.dense_decode import (
    axis_plan, dense_decode, dense_decode_plain, interp_matrix)

HIGHEST = jax.lax.Precision.HIGHEST


def _rand_layers(rs, widths):
    layers = []
    for cin, cout in zip(widths[:-1], widths[1:]):
        k = (rs.rand(cin, cout).astype(np.float32) - 0.5) / np.sqrt(cin)
        b = (rs.rand(cout).astype(np.float32) - 0.5)
        g = 0.5 + rs.rand(cout).astype(np.float32)
        s = (rs.rand(cout).astype(np.float32) - 0.5)
        layers.append((k, b, g, s))
    return layers


@pytest.mark.parametrize("D,S,widths", [
    (8, 16, (8, 24, 24, 1)),      # production shape class, scaled
    (4, 16, (6, 16, 16, 16, 1)),  # two hidden layers
])
def test_decode_plain_matches_jax_slab(D, S, widths):
    rs = np.random.RandomState(0)
    layers = _rand_layers(rs, widths)
    fv = rs.rand(2, D, D, D, widths[0]).astype(np.float32)
    ours = dense_decode_plain(torch.from_numpy(fv), layers, S).numpy()
    ref = np.asarray(jax_decode(jnp.asarray(fv), layers, S, slab=4,
                                precision=HIGHEST, backend="xla"))
    assert ours.shape == ref.shape == (2, S, S, S)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_decode_plain_matches_pallas_interpret():
    rs = np.random.RandomState(1)
    layers = _rand_layers(rs, (8, 24, 24, 1))
    fv = rs.rand(2, 8, 8, 8, 8).astype(np.float32)
    ours = dense_decode_plain(torch.from_numpy(fv), layers, 16).numpy()
    ref = np.asarray(dense_decode_fused(jnp.asarray(fv), layers, 16,
                                        precision=HIGHEST, interpret=True))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_decode_plain_non_cubic_coarse_grid():
    """Unequal D/H/W, as the engine's swapaxes call site can give."""
    rs = np.random.RandomState(2)
    layers = _rand_layers(rs, (5, 12, 1))
    fv = rs.rand(1, 4, 6, 8, 5).astype(np.float32)
    ours = dense_decode_plain(torch.from_numpy(fv), layers, 8).numpy()
    ref = np.asarray(jax_decode(jnp.asarray(fv), layers, 8, slab=2,
                                precision=HIGHEST, backend="xla"))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("S,n", [(128, 32), (16, 8), (16, 16), (7, 3),
                                 (2, 2)])
def test_axis_plan_equals_interp_matrix(S, n):
    """The kernel's per-axis tap tables rebuild the plain version's
    interpolation matrices exactly."""
    lo, w = (t.numpy() for t in axis_plan(S, n))
    dense = np.zeros((S, n), np.float32)
    dense[np.arange(S), lo] += w[:, 0]
    dense[np.arange(S), lo + 1] += w[:, 1]
    np.testing.assert_array_equal(dense, interp_matrix(S, n))


def test_decode_cpu_tensor_takes_plain_path():
    rs = np.random.RandomState(3)
    layers = _rand_layers(rs, (4, 8, 1))
    fv = torch.from_numpy(rs.rand(1, 4, 4, 4, 4).astype(np.float32))
    assert torch.equal(dense_decode(fv, layers, 8),
                       dense_decode_plain(fv, layers, 8))


def test_decode_launcher_refuses_cpu_tensor():
    """The 'highest' tier's launcher (the tensor-core kernel at bf16x6)
    takes no CPU tensor."""
    rs = np.random.RandomState(4)
    layers = [tuple(torch.from_numpy(a) for a in lay)
              for lay in _rand_layers(rs, (4, 8, 1))]
    with pytest.raises(ValueError, match="CUDA tensor"):
        dense_decode_tc_cuda(torch.zeros(1, 4, 4, 4, 4),
                             pack_decoder(layers, "highest"), 8)
