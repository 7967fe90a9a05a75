"""The dense decode's bf16 precision tiers ('high' = bf16x3, 'default' =
bf16), the 'highest' kernel's bf16x6 arithmetic, and the tensor-core
kernel's host-side layout, on the CPU.

The plain tiers are held to the JAX package: its bf16 splits bit for bit,
its fused Pallas kernel at HIGH in interpret mode, and its f32 decode at
HIGHEST for the bf16x6 emulation. The kernel itself
(csrc/dense_decode_tc.cu) runs only on the card (tests/test_torch_cuda.py);
here its wrapper's packing, padding and window, and its shared-memory
addressing at 64-row tiles, are checked against the layout the kernel
assumes."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import chip_smoke
from garmentnets_tpu.harness.predict_engine import decode_precision_from_str
from garmentnets_tpu.ops.dense_decode import dense_decode as jax_decode
from garmentnets_tpu.ops.dense_decode_pallas import dense_decode_fused
from garmentnets_tpu_torch.kernels.dense_decode_tc import (
    KC, PARTS, core_index, dense_decode_tc_cuda, line_window, pack_decoder,
    pack_wgmma_weights, padded_width, unpack_wgmma_weights)
from garmentnets_tpu_torch.ops.dense_decode import (
    axis_plan, bf16x6_matmul, check_precision, dense_decode,
    dense_decode_plain, split_bf16, split_bf16_3, split_bf16_parts)


def _split_values():
    rs = np.random.RandomState(0)
    return np.concatenate([rs.randn(4096), rs.randn(4096) * 1e-3,
                           rs.randn(4096) * 1e3, [0.0, -0.0, 1.0, 1 + 2**-8,
                                                  1 + 3 * 2**-9]]).astype(
        np.float32)


def test_split_bf16_equals_jax_cast_split():
    x = _split_values()
    hi, lo = split_bf16(torch.from_numpy(x))
    jx = jnp.asarray(x)
    jhi = jx.astype(jnp.bfloat16)
    jlo = (jx - jhi.astype(jnp.float32)).astype(jnp.bfloat16)
    np.testing.assert_array_equal(hi.view(torch.int16).numpy(),
                                  np.asarray(jhi).view(np.int16))
    np.testing.assert_array_equal(lo.view(torch.int16).numpy(),
                                  np.asarray(jlo).view(np.int16))


def test_split_bf16_3_equals_jax_cast_chain():
    """hi, mid, lo bit for bit as JAX's cast chain gives them, and
    hi + mid + lo rebuilds x exactly: three bf16 significands (8 bits
    each) carry f32's 24, and no part here falls below bf16's normal
    range."""
    x = _split_values()
    parts = split_bf16_3(torch.from_numpy(x))
    jx = jnp.asarray(x)
    jhi = jx.astype(jnp.bfloat16)
    jmid = (jx - jhi.astype(jnp.float32)).astype(jnp.bfloat16)
    jlo = (jx - jhi.astype(jnp.float32)
           - jmid.astype(jnp.float32)).astype(jnp.bfloat16)
    for ours, theirs in zip(parts, (jhi, jmid, jlo)):
        np.testing.assert_array_equal(ours.view(torch.int16).numpy(),
                                      np.asarray(theirs).view(np.int16))
    hi, mid, lo = (t.double() for t in parts)
    np.testing.assert_array_equal((hi + mid + lo).numpy(),
                                  x.astype(np.float64))
    assert split_bf16_parts(torch.from_numpy(x), 3)[1].equal(parts[1])
    assert torch.equal(split_bf16_parts(torch.from_numpy(x), 2)[1],
                       split_bf16(torch.from_numpy(x))[1])


@pytest.mark.parametrize("D,S,widths", [(4, 8, (32, 128, 128, 1)),
                                        (4, 8, (32, 64, 64, 64, 1))])
def test_bf16x6_emulation_matches_f32(D, S, widths):
    """The 'highest' kernel's arithmetic (bf16x6, dense_decode_plain with
    kernel_products=True) stays within 5e-6 abs of the port's f32 plain
    version (reads 3.9e-6 and 4.4e-6 on fields of largest magnitude 2.4
    and 1.4). Against the JAX package's f32 decode (XLA slab path at
    HIGHEST) the limit is 5e-6 times the field's largest magnitude: the two
    f32 decodes sum in other orders and themselves differ by 2.7e-6 and
    3.7e-6 here, which is asserted too, and the emulation reads 3.9e-6 and
    5.3e-6 from JAX's. The emulation is not the f32 product itself (the
    split is applied)."""
    fv, layers = chip_smoke.decode_inputs(
        torch.Generator().manual_seed(D), (2, D, D, D), widths, "cpu")
    emu = dense_decode_plain(fv, layers, S, "highest", kernel_products=True)
    f32 = dense_decode_plain(fv, layers, S, "highest")
    assert float(f32.std()) > 0.1
    ref = np.asarray(jax_decode(
        jnp.asarray(fv.numpy()), [tuple(t.numpy() for t in lay)
                                  for lay in layers], S, slab=4,
        precision=jax.lax.Precision.HIGHEST, backend="xla"))
    assert float((emu - f32).abs().max()) <= 5e-6
    limit = 5e-6 * max(1.0, float(f32.abs().max()))
    np.testing.assert_allclose(f32.numpy(), ref, rtol=0, atol=limit)
    np.testing.assert_allclose(emu.numpy(), ref, rtol=0, atol=limit)
    x = torch.randn(64, widths[1], generator=torch.Generator().manual_seed(1))
    k = layers[1][0]
    assert not torch.equal(bf16x6_matmul(x, k), x @ k)
    assert float((bf16x6_matmul(x, k) - x @ k).abs().max()) <= 1e-6


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
                                                (16, 16, 64, 1),
                                                (256, 256, 256, 3),
                                                (100, 128, 128, 3)])
def test_pack_wgmma_weights_round_trips(cin, cout, np_, parts):
    """Unpacking gives the zero-padded bf16 parts back (hi, then lo, or
    mid and lo), and every element sits where the kernel's B descriptor
    reads it."""
    k = torch.randn(cin, cout, generator=torch.Generator().manual_seed(cin))
    packed = pack_wgmma_weights(k, np_, parts)
    assert packed.dtype == torch.bfloat16
    assert packed.shape == (np_ // KC, parts, np_ * KC)
    pad = torch.zeros(np_, np_)
    pad[:cin, :cout] = k
    want = split_bf16_parts(pad, parts)
    got = unpack_wgmma_weights(packed, np_)
    assert len(got) == parts
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    hi = want[0]
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
    pk3 = pack_decoder(layers, "highest")
    assert pk3.wts.shape == (1, 64 // KC, 3, 64 * KC)
    assert [PARTS[t] for t in ("highest", "high", "default")] == [3, 2, 1]
    vec = layers[:-1] + [(torch.ones(24, 3),) + (torch.ones(3),) * 3]
    with pytest.raises(ValueError, match="scalar head"):
        pack_decoder(vec, "high")
    wide = [(torch.ones(6, 300),) + (torch.ones(300),) * 3, layers[-1]]
    with pytest.raises(ValueError, match="widths"):
        pack_decoder(wide, "default")
    assert [padded_width([w]) for w in (1, 64, 65, 200)] == [64, 64, 128, 256]


@pytest.mark.parametrize("rows", [128, 64])
@pytest.mark.parametrize("S,wc", [(128, 32), (16, 8), (20, 7), (7, 4),
                                  (256, 32), (300, 100)])
def test_line_window_covers_every_tile(S, wc, rows):
    """The window is the most coarse W columns any tile of `rows` voxels
    reads (both taps), from the same tap table the kernel gets; 64-row
    tiles are the 'highest' instance at width 256."""
    lo = axis_plan(S, wc)[0].numpy()
    want = max(int(lo[min(t + rows, S) - 1]) + 2 - int(lo[t])
               for t in range(0, S, rows))
    assert line_window(S, wc, rows) == want
    if (S, wc) == (128, 32):
        assert want == {128: 32, 64: 17}[rows]


def test_tc_launcher_refuses_cpu_tensor():
    fv, layers = chip_smoke.decode_inputs(
        torch.Generator().manual_seed(9), (1, 4, 4, 4), (4, 8, 8, 1), "cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        dense_decode_tc_cuda(torch.zeros(1, 4, 4, 4, 8),
                             pack_decoder(layers, "high"), 8)


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _tile(buf, start, lbo, sbo, rows):
    """The [rows, 16] bf16 tile that a no-swizzle K-major wgmma descriptor
    (start address, LBO, SBO in bytes) reads from the shared-memory image
    `buf` (uint16), as f64."""
    i = np.arange(rows)[:, None]
    j = np.arange(16)[None, :]
    byte = start + (i // 8) * sbo + (j // 8) * lbo + (i % 8) * 16 + (j % 8) * 2
    bits = buf[byte // 2].astype(np.uint32) << 16
    return bits.view(np.float32).astype(np.float64)


def _store_a(a_img, vals, np_, parts, a_part):
    """store_parts over a whole [64, np_] activation tile: part q of
    element (m, k) at q * a_part + core_offset(m, k, np_ / 8)."""
    m = np.arange(vals.shape[0])[:, None]
    k = np.arange(np_)[None, :]
    off = core_index(m, k, np_ // 8)          # elements
    for q, part in enumerate(split_bf16_parts(torch.from_numpy(vals),
                                              parts)):
        a_img[q * a_part // 2 + off] = _bf16_bits(part)


def test_highest_tile_addressing_matches_bf16x6():
    """A CPU emulation of the 'highest' instance at width 256: 64-row
    tiles whose two warpgroups read the same A and split N (B descriptor
    offset by 128 columns), the three A parts written by store_split3 at
    core offsets, each weight stage one bulk copy of a packed chunk, the
    six products per k16 step read through
    the kernel's descriptors, the accumulator fragments written back by the
    epilogue, and the head's two halves summed. Two hidden layers; it
    equals the plain bf16x6 emulation."""
    np_, parts, rows, kc = 256, 3, 64, KC
    gen = torch.Generator().manual_seed(11)
    mids = [((torch.rand(np_, np_, generator=gen) - 0.5) / 8,
             torch.rand(np_, generator=gen) - 0.5,
             0.5 + torch.rand(np_, generator=gen),
             torch.rand(np_, generator=gen) - 0.5) for _ in range(2)]
    k_head = torch.rand(np_, 1, generator=gen) - 0.5
    a0 = (torch.rand(rows, np_, generator=gen) - 0.5)
    packed = [pack_wgmma_weights(k, np_, parts) for k, _, _, _ in mids]

    a_part = rows * np_ * 2                     # bytes
    stage_part = kc * np_ * 2
    stage = stage_part * parts
    n_w = np_ // 2                              # columns a warpgroup
    a_img = np.zeros(a_part * parts // 2, np.uint16)
    ring = np.zeros(stage * 2 // 2, np.uint16)
    _store_a(a_img, a0.numpy(), np_, parts, a_part)
    pairs = [(0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0)]
    g = 0
    out = None
    for l, (k, b, gg, ss) in enumerate(mids):
        acc = [np.zeros((rows, n_w)) for _ in range(2)]
        for c in range(np_ // kc):
            s = g % 2
            img = _bf16_bits(packed[l][c]).reshape(-1)   # parts contiguous
            ring[s * stage // 2:(s + 1) * stage // 2] = img
            for wg in range(2):
                ring_base = wg * (n_w // 8) * 512
                for ks in range(kc // 16):
                    ka = (c * (kc // 16) + ks) * 256
                    kb = s * stage + ks * 256
                    for qa, qb in pairs:
                        ta = _tile(a_img, qa * a_part + ka, 128, np_ * 16,
                                   rows)
                        tb = _tile(ring, ring_base + kb + qb * stage_part,
                                   128, 512, n_w)
                        acc[wg] += ta @ tb.T
            g += 1
        # epilogue: accumulator element i of lane `lane` of warp w holds
        # D[16 (w % 4) + lane / 4 + 8 ((i / 2) % 2), 8 (i / 4) + 2 (lane % 4)
        # + i % 2]; the kernel puts it at row r0 + 8 hf, column col_base +
        # 8 j + qcol + e (i = 4 j + 2 hf + e)
        full = np.zeros((rows, np_))
        w, lane, i = np.meshgrid(np.arange(4), np.arange(32),
                                 np.arange(n_w // 2), indexing="ij")
        hw_row = 16 * w + lane // 4 + 8 * ((i // 2) % 2)
        hw_col = 8 * (i // 4) + 2 * (lane % 4) + i % 2
        j, hf, e = i // 4, (i // 2) % 2, i % 2
        r0 = (w % 4) * 16 + lane // 4
        for wg in range(2):
            full[r0 + 8 * hf, wg * n_w + 8 * j + 2 * (lane % 4) + e] = \
                acc[wg][hw_row, hw_col]
        act = (np.maximum(full + b.double().numpy(), 0) * gg.double().numpy()
               + ss.double().numpy())
        if l + 1 < len(mids):
            _store_a(a_img, act.astype(np.float32), np_, parts, a_part)
        else:
            halves = [act[:, h * n_w:(h + 1) * n_w]
                      @ k_head.double().numpy()[h * n_w:(h + 1) * n_w, 0]
                      for h in range(2)]
            out = halves[0] + halves[1]
    h = a0
    for k, b, gg, ss in mids:
        h = torch.relu(bf16x6_matmul(h, k) + b) * gg + ss
    want = (h @ k_head)[:, 0].double().numpy()
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-5)
