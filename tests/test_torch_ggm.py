"""Port gaussian gradient magnitude vs the JAX package's XLA path, its Pallas
kernel in interpret mode, and scipy in float64; and a numpy model of the
CUDA kernel's order of work (csrc/ggm.cu) against the plain version, bit
for bit."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from garmentnets_tpu.ops.gaussian import _ggm_xla
from garmentnets_tpu.ops.gaussian_pallas import ggm_pallas
from garmentnets_tpu_torch.kernels.ggm import MAX_WIDTH, ggm_cuda
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


TH, TD = 8, 32                  # csrc/ggm.cu kTH, kTD


def _ggm_schedule(vol: np.ndarray, sigma: float) -> np.ndarray:
    """numpy model of csrc/ggm.cu, in f32 with its order of work: blocks of
    TH full-width rows walking TD planes along D (ranges that start and end
    inside the volume), input planes of TH + 2r rows with clamped row and
    column indices entering a ring of 2r + 1 planes (the registers' sliding
    window, the next plane fetched one step ahead), the D pass from the
    window, the H pass over each column's 2r halo rows, the shared-memory
    rows of the H pass with r edge copies at both ends (every slot the
    kernel does not write is NaN here, so reading one shows), then the W
    pass and the sum of squares. Returns that sum; the kernel's square
    root is correctly rounded (__fsqrt_rn), as the plain version's is on
    the card."""
    k0, k1 = (np.asarray(t, np.float32) for t in ggm_taps(sigma))
    R = (len(k0) - 1) // 2
    T = 2 * R + 1
    PAD = (R + 3) // 4 * 4      # csrc/ggm.cu pad_of(R)
    B, D, H, W = vol.shape
    TW = 128 if W <= 128 else 256
    cols = np.minimum(np.arange(TW), W - 1)
    acc = np.full(vol.shape, np.nan, np.float32)
    for b in range(B):
        for h0 in range(0, H, TH):
            rows = np.clip(h0 - R + np.arange(TH + 2 * R), 0, H - 1)
            for d0 in range(0, D, TD):
                n_out = min(TD, D - d0)

                def plane(rel):
                    dd = min(max(d0 - R + rel, 0), D - 1)
                    return vol[b, dd][rows][:, cols]

                ring = [None] * T
                for i in range(2 * R):
                    ring[i] = plane(i)
                nxt = plane(2 * R)
                for step in range(n_out):
                    j = step % T
                    ring[(j + 2 * R) % T] = nxt
                    if step + 1 < n_out:
                        nxt = plane(step + 1 + 2 * R)
                    a1 = np.zeros((TH + 2 * R, TW), np.float32)
                    a0 = np.zeros_like(a1)
                    for i in range(T):
                        x = ring[(j + i) % T]
                        a1 = a1 + k1[i] * x
                        a0 = a0 + k0[i] * x
                    g = np.zeros((3, TH, TW), np.float32)
                    for i in range(T):
                        g[0] = g[0] + k0[i] * a1[i:i + TH]
                        g[1] = g[1] + k1[i] * a0[i:i + TH]
                        g[2] = g[2] + k0[i] * a0[i:i + TH]
                    hp = np.full((3, TH, TW + 2 * PAD), np.nan, np.float32)
                    hp[:, :, PAD:PAD + W] = g[:, :, :W]
                    hp[:, :, PAD - R:PAD] = g[:, :, :1]
                    hp[:, :, PAD + W:PAD + W + R] = g[:, :, W - 1:W]
                    s = np.zeros((3, TH, W), np.float32)
                    taps = (k0, k0, k1)
                    for i in range(T):
                        for q in range(3):
                            s[q] = s[q] + taps[q][i] * hp[
                                q, :, PAD - R + i:PAD - R + i + W]
                    sq = (s[0] * s[0] + s[1] * s[1]) + s[2] * s[2]
                    n_rows = min(TH, H - h0)
                    acc[b, d0 + step, h0:h0 + n_rows] = sq[:n_rows]
    return acc


def _check_schedule(vol, sigma):
    """The model's sum of squares under the plain version's square root
    equals the plain version bit for bit. On the CPU torch's vectorized
    sqrt is within 0.5001 ulp, not always correctly rounded, so the
    correctly rounded root (the kernel's) is checked to lie within one
    ulp of it."""
    want = ggm_plain(torch.from_numpy(vol), sigma).numpy()
    acc = _ggm_schedule(vol, sigma)
    np.testing.assert_array_equal(torch.sqrt(torch.from_numpy(acc)).numpy(),
                                  want)
    np.testing.assert_array_max_ulp(np.sqrt(acc), want, maxulp=1)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("sigma", [0.25, 0.5, 0.75, 1.0])   # radius 1..4
@pytest.mark.parametrize("S", [8, 20, 37])
def test_ggm_kernel_schedule_equals_plain(S, sigma, B):
    """The kernel's order of work gives the plain version's bits, on
    volumes whose sides are not multiples of the tile (8 rows, 32
    planes)."""
    vol = np.random.RandomState(S).rand(B, S, S, S).astype(np.float32)
    _check_schedule(vol, sigma)


@pytest.mark.parametrize("sigma", [1.25, 1.5, 1.75, 2.0])   # radius 5..8
def test_ggm_kernel_schedule_equals_plain_wide_radius(sigma):
    """Radius 5 to 8: three D-pass rows a thread and an 8-column pad."""
    vol = np.random.RandomState(5).rand(2, 21, 19, 35).astype(np.float32)
    _check_schedule(vol, sigma)


def test_ggm_launcher_refuses_radius_above_its_taps():
    from garmentnets_tpu_torch.kernels.ggm import MAX_RADIUS
    k0, k1 = ggm_taps((MAX_RADIUS + 0.5) / 4)      # radius MAX_RADIUS + 1
    with pytest.raises(ValueError, match="radius"):
        ggm_cuda(torch.zeros(1, 8, 8, 8), k0, k1)


@pytest.mark.parametrize("shape", [(2, 33, 7, 20), (1, 5, 9, 130),
                                   (1, 3, 2, 1)])
def test_ggm_kernel_schedule_other_shapes(shape):
    """Unequal sides, a row wider than 128 (the 256-column instance) and a
    row of one voxel."""
    vol = np.random.RandomState(1).rand(*shape).astype(np.float32)
    _check_schedule(vol, 0.5)


def test_ggm_launcher_refuses_rows_wider_than_a_block():
    k0, k1 = ggm_taps(0.5)
    with pytest.raises(ValueError, match="W <= 256"):
        ggm_cuda(torch.zeros(1, 2, 2, MAX_WIDTH + 1), k0, k1)
