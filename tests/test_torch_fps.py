"""Port FPS (garmentnets_tpu_torch) vs the JAX package's XLA FPS and its
Pallas kernel in interpret mode. Indices must be identical."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from garmentnets_tpu.kernels.fps_pallas import furthest_point_sampling_pallas
from garmentnets_tpu.ops.pointcloud import _furthest_point_sampling_xla
from garmentnets_tpu_torch.kernels.fps import furthest_point_sampling_cuda
from garmentnets_tpu_torch.ops.pointcloud import (
    furthest_point_sampling, furthest_point_sampling_plain)


@pytest.mark.parametrize("B,N,M,seed", [
    (3, 200, 32, 0),
    (2, 300, 150, 1),      # ratio 0.5 as in SA1
    (2, 256, 64, 2),       # ratio 0.25 as in SA2
])
def test_fps_plain_matches_jax(B, N, M, seed):
    pos = (np.random.RandomState(seed).rand(B, N, 3) - 0.5).astype(
        np.float32)
    ours = furthest_point_sampling_plain(torch.from_numpy(pos), M).numpy()
    ref = np.asarray(_furthest_point_sampling_xla(jnp.asarray(pos), M))
    np.testing.assert_array_equal(ours, ref)


def test_fps_plain_matches_pallas_interpret():
    pos = np.random.RandomState(3).rand(2, 200, 3).astype(np.float32)
    ours = furthest_point_sampling_plain(torch.from_numpy(pos), 40).numpy()
    ref = np.asarray(furthest_point_sampling_pallas(
        jnp.asarray(pos), 40, interpret=True))
    np.testing.assert_array_equal(ours, ref)


def test_fps_ties_pick_lowest_index():
    """Duplicate points tie exactly; the first occurrence wins, as in
    jnp.argmax."""
    base = np.random.RandomState(4).rand(1, 20, 3).astype(np.float32)
    pos = np.concatenate([base, base], axis=1)          # every point twice
    ours = furthest_point_sampling_plain(torch.from_numpy(pos), 20).numpy()
    ref = np.asarray(_furthest_point_sampling_xla(jnp.asarray(pos), 20))
    np.testing.assert_array_equal(ours, ref)


def test_fps_cpu_tensor_takes_plain_path():
    pos = torch.from_numpy(np.random.RandomState(5).rand(2, 64, 3)
                           .astype(np.float32))
    assert torch.equal(furthest_point_sampling(pos, 16),
                       furthest_point_sampling_plain(pos, 16))


def test_fps_launcher_refuses_cpu_tensor():
    """The kernel launcher never falls back: a CPU tensor is an error."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        furthest_point_sampling_cuda(torch.zeros(1, 8, 3), 4)
