"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `cuda`: every test skips without a CUDA device. On a machine with a
card, where JAX need not be installed (`--noconftest` leaves out the
conftest, which imports JAX):

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""
import pytest
import torch

import chip_smoke
from garmentnets_tpu_torch.kernels import _build
from garmentnets_tpu_torch.ops.dense_decode import (
    coarse_first_layer, dense_decode_plain)
from garmentnets_tpu_torch.ops.gaussian import ggm_plain, ggm_taps
from garmentnets_tpu_torch.ops.pointcloud import furthest_point_sampling_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rand(gen, *shape):
    return torch.rand(*shape, generator=gen)


@pytest.mark.parametrize("B,N,M", [(3, 2000, 500), (2, 6000, 3000),
                                   (1, 33, 33)])
def test_fps_kernel_indices_identical(dev, B, N, M):
    from garmentnets_tpu_torch.kernels.fps import furthest_point_sampling_cuda
    pos = (_rand(torch.Generator().manual_seed(N), B, N, 3) - 0.5).to(dev)
    before = _build.LAUNCHES["fps"]
    k = furthest_point_sampling_cuda(pos, M)
    assert _build.LAUNCHES["fps"] == before + 1
    assert torch.equal(k, furthest_point_sampling_plain(pos, M))


@pytest.mark.parametrize("shape,sigma", [((2, 24, 40, 36), 0.5),
                                         ((1, 16, 16, 16), 1.0),
                                         ((2, 7, 9, 5), 0.5)])
def test_ggm_kernel_matches_plain(dev, shape, sigma):
    from garmentnets_tpu_torch.kernels.ggm import ggm_cuda
    vol = _rand(torch.Generator().manual_seed(1), *shape).to(dev)
    k0, k1 = ggm_taps(sigma)
    out = ggm_cuda(vol, k0, k1)
    torch.testing.assert_close(out, ggm_plain(vol, sigma), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("coarse,S,widths", [
    ((8, 8, 8), 32, (128, 256, 256, 1)),
    ((5, 6, 7), 20, (16, 40, 24, 1)),
    ((4, 4, 4), 8, (8, 16, 1)),          # no hidden layer
])
def test_decode_kernel_matches_plain(dev, coarse, S, widths):
    from garmentnets_tpu_torch.kernels.dense_decode import dense_decode_cuda
    fv, layers = chip_smoke.decode_inputs(
        torch.Generator().manual_seed(S), (2, *coarse), widths, dev)
    want = dense_decode_plain(fv, layers, S)
    assert float(want.std()) > 0.1           # the field is not flat
    out = dense_decode_cuda(coarse_first_layer(fv, layers).contiguous(),
                            layers, S)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-4)


def test_decode_kernel_refuses_vector_head(dev):
    from garmentnets_tpu_torch.kernels.dense_decode import dense_decode_cuda
    layers = [tuple(torch.ones(*s, device=dev) for s in
                    ((4, 8), (8,), (8,), (8,))),
              tuple(torch.ones(*s, device=dev) for s in
                    ((8, 3), (3,), (3,), (3,)))]
    with pytest.raises(ValueError, match="scalar head"):
        dense_decode_cuda(torch.zeros(1, 4, 4, 4, 8, device=dev), layers, 8)


def test_engine_card_matches_cpu(dev):
    """A tiny engine on the card against the same weights on the CPU."""
    chip_smoke.phase_small_reference(dev)
