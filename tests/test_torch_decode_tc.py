"""The dense decode's bf16 precision tiers ('high' = bf16x3, 'default' =
bf16) and the tensor-core kernel's host-side layout, on the CPU.

The plain tiers are held to the JAX package: its bf16 split bit for bit,
and its fused Pallas kernel at HIGH in interpret mode. The kernel itself
(csrc/dense_decode_tc.cu) runs only on the card (tests/test_torch_cuda.py);
here its wrapper's packing, padding and window are checked against the
layout the kernel assumes."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import chip_smoke
from garmentnets_tpu.harness.predict_engine import decode_precision_from_str
from garmentnets_tpu.ops.dense_decode_pallas import dense_decode_fused
from garmentnets_tpu_torch.kernels.dense_decode_tc import (
    KC, core_index, dense_decode_tc_cuda, line_window, pack_decoder,
    pack_wgmma_weights, padded_width, unpack_wgmma_weights)
from garmentnets_tpu_torch.ops.dense_decode import (
    axis_plan, check_precision, dense_decode, dense_decode_plain, split_bf16)


def test_split_bf16_equals_jax_cast_split():
    rs = np.random.RandomState(0)
    x = np.concatenate([rs.randn(4096), rs.randn(4096) * 1e-3,
                        rs.randn(4096) * 1e3, [0.0, -0.0, 1.0, 1 + 2**-8,
                                               1 + 3 * 2**-9]]).astype(
        np.float32)
    hi, lo = split_bf16(torch.from_numpy(x))
    jx = jnp.asarray(x)
    jhi = jx.astype(jnp.bfloat16)
    jlo = (jx - jhi.astype(jnp.float32)).astype(jnp.bfloat16)
    np.testing.assert_array_equal(hi.view(torch.int16).numpy(),
                                  np.asarray(jhi).view(np.int16))
    np.testing.assert_array_equal(lo.view(torch.int16).numpy(),
                                  np.asarray(jlo).view(np.int16))


def _live_relu_layers():
    """The layers of tests/test_dense_decode_pallas.py's bf16_3x test:
    positive biases keep every ReLU live."""
    rs = np.random.RandomState(3)
    layers = []
    for cin, cout in zip((8, 24, 24), (24, 24, 1)):
        k = (rs.rand(cin, cout).astype(np.float32) - 0.5) / np.sqrt(cin)
        b = 0.3 + rs.rand(cout).astype(np.float32) * 0.2
        g = 0.5 + rs.rand(cout).astype(np.float32)
        s = (rs.rand(cout).astype(np.float32) - 0.5)
        layers.append((k, b, g, s))
    return layers, rs.rand(2, 8, 8, 8, 8).astype(np.float32)


def test_plain_high_matches_pallas_interpret_high():
    """The same bf16x3 products as the JAX kernel's `_mm`; the JAX kernel
    also sends the W-axis upsample through `_mm`, the port keeps it f32,
    so the two agree to 5e-5, not bit for bit."""
    layers, fv = _live_relu_layers()
    ours = dense_decode_plain(torch.from_numpy(fv), layers, 16,
                              "high").numpy()
    ref = np.asarray(dense_decode_fused(
        jnp.asarray(fv), layers, 16, precision=jax.lax.Precision.HIGH,
        interpret=True))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=5e-5)


@pytest.mark.parametrize("precision,limit", [("high", 2e-4),
                                             ("default", 3e-2)])
def test_bf16_tiers_are_reduced_within_limits(precision, limit):
    """Each bf16 tier differs from the f32 plain output (so the tier is
    really applied), by less than its limit: ~1e-4 at bf16x3, ~2e-2 at
    one bf16 pass (configs/predict_default.yaml)."""
    fv, layers = chip_smoke.decode_inputs(
        torch.Generator().manual_seed(5), (2, 8, 8, 8), (8, 24, 24, 1),
        "cpu")
    f32 = dense_decode_plain(fv, layers, 16)
    assert float(f32.std()) > 0.1
    err = float((dense_decode_plain(fv, layers, 16, precision)
                 - f32).abs().max())
    assert 0 < err < limit, err


def test_no_hidden_layer_is_f32_at_every_tier():
    """Without a hidden layer no product runs at a reduced tier."""
    fv, layers = chip_smoke.decode_inputs(
        torch.Generator().manual_seed(6), (1, 4, 4, 4), (5, 12, 1), "cpu")
    f32 = dense_decode_plain(fv, layers, 7)
    for precision in ("high", "default"):
        assert torch.equal(dense_decode_plain(fv, layers, 7, precision), f32)


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_cpu_tensor_takes_the_plain_tier(precision):
    fv, layers = chip_smoke.decode_inputs(
        torch.Generator().manual_seed(7), (1, 4, 4, 4), (4, 8, 8, 1), "cpu")
    assert torch.equal(dense_decode(fv, layers, 8, precision),
                       dense_decode_plain(fv, layers, 8, precision))


@pytest.mark.parametrize("name", ["high", "HIGH", "Default", "highest"])
def test_precision_names_parse_as_jax(name):
    assert check_precision(name) == name.lower()
    assert decode_precision_from_str(name) is not None


def test_unknown_precision_raises_as_jax():
    with pytest.raises(ValueError) as ours:
        check_precision("tf32")
    with pytest.raises(ValueError) as theirs:
        decode_precision_from_str("tf32")
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="decode_precision"):
        dense_decode_plain(torch.zeros(1, 2, 2, 2, 4),
                           [(torch.zeros(4, 1),) + (torch.zeros(1),) * 3],
                           4, "bf16")


@pytest.mark.parametrize("cin,cout,np_,parts", [(24, 24, 64, 2),
                                                (256, 256, 256, 2),
                                                (130, 70, 256, 1),
                                                (16, 16, 64, 1)])
def test_pack_wgmma_weights_round_trips(cin, cout, np_, parts):
    """Unpacking gives the zero-padded bf16 hi (and lo) parts back, and
    every element sits where the kernel's B descriptor reads it."""
    k = torch.randn(cin, cout, generator=torch.Generator().manual_seed(cin))
    packed = pack_wgmma_weights(k, np_, parts)
    assert packed.dtype == torch.bfloat16
    assert packed.shape == (np_ // KC, parts, np_ * KC)
    pad = torch.zeros(np_, np_)
    pad[:cin, :cout] = k
    hi, lo = split_bf16(pad)
    got_hi, got_lo = unpack_wgmma_weights(packed, np_)
    assert torch.equal(got_hi, hi)
    assert torch.equal(got_lo, lo) if parts == 2 else got_lo is None
    assert torch.equal(hi[cin:], torch.zeros_like(hi[cin:]))
    rs = np.random.RandomState(0)
    for kk, n in zip(rs.randint(0, np_, 64), rs.randint(0, np_, 64)):
        c, kc = divmod(int(kk), KC)
        flat = packed[c, 0].reshape(-1)
        assert flat[core_index(int(n), kc, KC // 8)] == hi[kk, n]


def test_pack_decoder_pads_and_refuses():
    fv, layers = chip_smoke.decode_inputs(
        torch.Generator().manual_seed(8), (1, 4, 4, 4), (6, 40, 24, 1),
        "cpu")
    pk = pack_decoder(layers, "high")
    assert (pk.np_, pk.c1, pk.n_mid) == (64, 40, 1)
    assert pk.wts.shape == (1, 64 // KC, 2, 64 * KC)
    assert torch.equal(pk.epi[0, :, 24:], torch.zeros(3, 40))
    assert torch.equal(pk.aff0[:, 40:], torch.zeros(2, 24))
    assert pk.head.shape == (64 + 3,)
    assert float(pk.head[64]) == float(layers[-1][1])
    assert pack_decoder(layers, "default").wts.shape[2] == 1
    with pytest.raises(ValueError, match="f32 kernel"):
        pack_decoder(layers, "highest")
    vec = layers[:-1] + [(torch.ones(24, 3),) + (torch.ones(3),) * 3]
    with pytest.raises(ValueError, match="scalar head"):
        pack_decoder(vec, "high")
    wide = [(torch.ones(6, 300),) + (torch.ones(300),) * 3, layers[-1]]
    with pytest.raises(ValueError, match="widths"):
        pack_decoder(wide, "default")
    assert [padded_width([w]) for w in (1, 64, 65, 200)] == [64, 64, 128, 256]


@pytest.mark.parametrize("S,wc", [(128, 32), (16, 8), (20, 7), (7, 4),
                                  (256, 32), (300, 100)])
def test_line_window_covers_every_tile(S, wc):
    """The window is the most coarse W columns any 128-voxel tile reads
    (both taps), from the same tap table the kernel gets."""
    lo = axis_plan(S, wc)[0].numpy()
    want = max(int(lo[min(t + 128, S) - 1]) + 2 - int(lo[t])
               for t in range(0, S, 128))
    assert line_window(S, wc) == want
    if (S, wc) == (128, 32):
        assert want == 32


def test_tc_launcher_refuses_cpu_tensor():
    fv, layers = chip_smoke.decode_inputs(
        torch.Generator().manual_seed(9), (1, 4, 4, 4), (4, 8, 8, 1), "cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        dense_decode_tc_cuda(torch.zeros(1, 4, 4, 4, 8),
                             pack_decoder(layers, "high"), 8)
