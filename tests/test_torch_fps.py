"""Port FPS (garmentnets_tpu_torch) vs the JAX package's XLA FPS and its
Pallas kernel in interpret mode. Indices must be identical. Also a numpy
model of the CUDA kernel's reduction (points spread over threads as
kernels/fps.fps_plan lays them out, f32 distance bits compared as unsigned
ints, the lowest index among equal maxima per thread, warp and block)
against the plain version on inputs full of exact ties."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import chip_smoke

from garmentnets_tpu.kernels.fps_pallas import furthest_point_sampling_pallas
from garmentnets_tpu.ops.pointcloud import _furthest_point_sampling_xla
from garmentnets_tpu_torch.kernels.fps import (
    MAX_POINTS, PPTS, REG_THREADS, SMEM_THREADS, fps_plan,
    furthest_point_sampling_cuda)
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


def _kernel_model(pos: np.ndarray, m: int) -> np.ndarray:
    """csrc/fps.cu's picks in numpy: thread t holds points t + i * T (the
    register instance pads to T * PPT points with distance 0; the
    shared-memory instance's threads past N hold key 0 and index t); a
    thread keeps the first of its largest keys (the f32 bits of the running
    minimum as uint32); a warp and then the block take the largest key and
    the lowest index holding it."""
    B, N, _ = pos.shape
    threads, ppt = fps_plan(N)
    per = ppt if ppt else -(-N // threads)
    out = np.zeros((B, m), np.int64)
    for b in range(B):
        p = np.zeros((per * threads, 3), np.float32)
        p[:N] = pos[b]
        mind = np.zeros(per * threads, np.float32)
        mind[:N] = np.inf
        last = 0
        for step in range(1, m):
            d = p - p[last]
            dist = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
            real = np.arange(per * threads) < N
            mind = np.where(real, np.minimum(mind, dist), mind)
            keys = mind.view(np.uint32).reshape(per, threads)
            first = keys.argmax(axis=0)               # first largest, per t
            key = keys.max(axis=0)
            index = first * threads + np.arange(threads)
            key, index = key.reshape(-1, 32), index.reshape(-1, 32)
            wk = key.max(axis=1)
            wi = np.where(key == wk[:, None], index, 2 ** 32 - 1).min(axis=1)
            last = int(wi[wk == wk.max()].min())
            out[b, step] = last
    return out


def test_fps_plan_covers_every_size():
    assert fps_plan(6000) == (REG_THREADS, 12)
    assert fps_plan(3000) == (REG_THREADS, 6)
    assert fps_plan(REG_THREADS * PPTS[-1]) == (REG_THREADS, PPTS[-1])
    assert fps_plan(REG_THREADS * PPTS[-1] + 1) == (SMEM_THREADS, 0)
    assert fps_plan(MAX_POINTS) == (SMEM_THREADS, 0)
    assert 16 * MAX_POINTS <= 232448 - 2 * 2 * 32 * 4


@pytest.mark.parametrize("kind", ["duplicates", "lattice", "identical"])
@pytest.mark.parametrize("N,M", [(200, 60), (1500, 40), (3000, 30),
                                 (9000, 12)])
def test_fps_kernel_reduction_model_matches_plain_on_ties(kind, N, M):
    pos = chip_smoke.fps_points(kind, 2, N, N)
    want = furthest_point_sampling_plain(torch.from_numpy(pos), M).numpy()
    np.testing.assert_array_equal(_kernel_model(pos, M), want)
    if kind == "identical":
        assert not want.any()            # every tie goes to index 0
