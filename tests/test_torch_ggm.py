"""Port gaussian gradient magnitude vs the JAX package's XLA path, its Pallas
kernel in interpret mode, and scipy in float64."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from garmentnets_tpu.ops.gaussian import _ggm_xla
from garmentnets_tpu.ops.gaussian_pallas import ggm_pallas
from garmentnets_tpu_torch.kernels.ggm import ggm_cuda
from garmentnets_tpu_torch.ops.gaussian import (
    gaussian_gradient_magnitude, ggm_plain, ggm_taps)


def _vol(S, seed=0, B=2):
    return np.random.RandomState(seed).rand(B, S, S, S).astype(np.float32)


@pytest.mark.parametrize("S,sigma", [(8, 0.5), (16, 0.5), (12, 1.0)])
def test_ggm_plain_matches_xla(S, sigma):
    """Same taps, same pass order, f32: within 1e-6 absolute."""
    vol = _vol(S)
    ours = ggm_plain(torch.from_numpy(vol), sigma).numpy()
    ref = np.asarray(_ggm_xla(jnp.asarray(vol), sigma))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_ggm_plain_matches_pallas_interpret():
    vol = _vol(16, seed=1)
    ours = ggm_plain(torch.from_numpy(vol), 0.5).numpy()
    ref = np.asarray(ggm_pallas(jnp.asarray(vol), 0.5, interpret=True))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_ggm_plain_matches_scipy():
    """f32 against scipy's float64 filter: within 1e-5 absolute."""
    from scipy import ndimage
    vol = _vol(16, seed=2, B=1)
    ours = ggm_plain(torch.from_numpy(vol), 0.5).numpy()[0]
    ref = ndimage.gaussian_gradient_magnitude(
        vol[0].astype(np.float64), 0.5, mode="nearest")
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_ggm_taps_match_scipy_radius():
    k0, k1 = ggm_taps(0.5)
    assert len(k0) == len(k1) == 5           # radius int(4*0.5+0.5) = 2
    np.testing.assert_allclose(k0.sum(), 1.0, rtol=0, atol=1e-12)
    np.testing.assert_allclose(k1, -k1[::-1], rtol=0, atol=1e-15)


def test_ggm_cpu_tensor_takes_plain_path():
    vol = torch.from_numpy(_vol(8, seed=3))
    assert torch.equal(gaussian_gradient_magnitude(vol, 0.5),
                       ggm_plain(vol, 0.5))


def test_ggm_launcher_refuses_cpu_tensor():
    k0, k1 = ggm_taps(0.5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ggm_cuda(torch.zeros(1, 8, 8, 8), k0, k1)
