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
    coarse_first_layer, dense_decode, dense_decode_plain)
from garmentnets_tpu_torch.ops.gaussian import ggm_plain, ggm_taps
from garmentnets_tpu_torch.ops.pointcloud import furthest_point_sampling_plain
from garmentnets_tpu_torch.ops.set_abstraction import sa_fused_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rand(gen, *shape):
    return torch.rand(*shape, generator=gen)


@pytest.mark.parametrize("kind", ["random", "duplicates", "lattice"])
@pytest.mark.parametrize("B,N,M", [(8, 6000, 3000), (8, 3000, 750),
                                   (2, 14464, 2000), (3, 2000, 500),
                                   (1, 33, 33)])
def test_fps_kernel_indices_identical(dev, kind, B, N, M):
    """Both kernel instances (registers up to 8192 points, shared memory
    above, up to MAX_POINTS = 14464) at the main path's shapes, on random
    points and on inputs full of exact ties."""
    from garmentnets_tpu_torch.kernels.fps import (
        MAX_POINTS, furthest_point_sampling_cuda)
    assert N <= MAX_POINTS
    pos = torch.from_numpy(chip_smoke.fps_points(kind, B, N, N)).to(dev)
    before = _build.LAUNCHES["fps"]
    k = furthest_point_sampling_cuda(pos, M)
    assert _build.LAUNCHES["fps"] == before + 1
    assert torch.equal(k, furthest_point_sampling_plain(pos, M))


@pytest.mark.parametrize("shape,sigma", [((2, 24, 40, 36), 0.5),
                                         ((1, 16, 16, 16), 1.0),
                                         ((2, 7, 9, 5), 0.5),
                                         ((1, 8, 8, 8), 0.25),
                                         ((3, 20, 20, 20), 0.75),
                                         ((3, 37, 37, 37), 1.0),
                                         ((1, 37, 37, 37), 0.5),
                                         ((1, 6, 9, 200), 0.5),
                                         ((8, 128, 128, 128), 0.5)])
def test_ggm_kernel_matches_plain(dev, shape, sigma):
    """Bit for bit: the same taps in the same order with the same
    roundings, and a correctly rounded square root on both sides; sides
    that are not multiples of the tile, radius 1 to 4, the 256-column
    instance and the main path's shape."""
    from garmentnets_tpu_torch.kernels.ggm import ggm_cuda
    vol = _rand(torch.Generator().manual_seed(1), *shape).to(dev)
    k0, k1 = ggm_taps(sigma)
    before = _build.LAUNCHES["ggm"]
    out = ggm_cuda(vol, k0, k1)
    assert _build.LAUNCHES["ggm"] == before + 1
    assert torch.equal(out, ggm_plain(vol, sigma))


@pytest.mark.parametrize("shape,sigma", [
    ((2, 37, 37, 37), 1.25), ((2, 37, 37, 37), 1.5),
    ((2, 37, 37, 37), 1.75), ((2, 37, 37, 37), 2.0),
    ((1, 9, 12, 200), 1.25), ((1, 9, 12, 200), 2.0),
    ((8, 128, 128, 128), 2.0)])
def test_ggm_kernel_matches_plain_wide_radius(dev, shape, sigma):
    """Radius 5 to 8 (gradient_sigma 1.25 to 2.0): three D-pass rows a
    thread and an 8-column pad, bit for bit, both row instances and the
    main path's shape."""
    from garmentnets_tpu_torch.kernels.ggm import ggm_cuda
    vol = _rand(torch.Generator().manual_seed(2), *shape).to(dev)
    k0, k1 = ggm_taps(sigma)
    assert len(k0) == 2 * int(4 * sigma + 0.5) + 1
    out = ggm_cuda(vol, k0, k1)
    assert torch.equal(out, ggm_plain(vol, sigma))


@pytest.mark.parametrize("kind", ["random", "lattice", "duplicates",
                                  "near_lattice"])
@pytest.mark.parametrize("B,N,M,radius", [(8, 6000, 3000, 0.35),
                                          (8, 3000, 750, 0.4)])
def test_ball_query_card_sets_equal_cpu(dev, kind, B, N, M, radius):
    """The neighbour sets (and the slots) that ball_query chooses on the
    card equal the CPU's at the main path's shapes, on data with exact
    ties at the 64th neighbour (a lattice of step 1/8, where 24 points
    share the shell that holds it; every point two or three times) and
    with near-ties (that lattice moved by ~1e-6), where the card's cuBLAS
    cross term rounds otherwise than the CPU's."""
    import numpy as np
    from garmentnets_tpu_torch.core.device import full_f32
    from garmentnets_tpu_torch.ops.pointcloud import ball_query
    pts = chip_smoke.fps_points("lattice" if kind == "near_lattice"
                                else kind, B, N, N)
    if kind == "near_lattice":
        pts = pts + np.random.RandomState(4).randn(*pts.shape).astype(
            np.float32) * np.float32(1e-6)
    pts = torch.from_numpy(pts)
    ctr = pts[:, :M].contiguous()
    with full_f32():
        gi, gm = ball_query(pts.to(dev), ctr.to(dev), radius, k=64)
    ci, cm = ball_query(pts, ctr, radius, k=64)
    gi, gm = gi.cpu(), gm.cpu()
    assert torch.equal(gm.sum(-1), cm.sum(-1))
    assert torch.equal(gi, ci) and torch.equal(gm, cm)


@pytest.mark.parametrize("coarse,S,widths", [
    ((8, 8, 8), 32, (128, 256, 256, 1)),      # NP 256, 64-row tiles
    ((5, 6, 7), 20, (16, 40, 24, 1)),         # NP 64
    ((4, 4, 4), 8, (8, 16, 1)),               # no hidden layer
    ((6, 6, 6), 24, (32, 128, 96, 64, 1)),    # NP 128, two hidden layers
    ((5, 5, 6), 17, (64, 256, 200, 256, 1)),  # NP 256, two hidden layers
    ((4, 5, 4), 9, (24, 200, 1)),             # NP 256, no hidden layer
])
def test_decode_kernel_matches_plain(dev, coarse, S, widths):
    """The 'highest' tier on the tensor cores (bf16x6) within 2e-5 of the
    plain emulation of its arithmetic and within 1e-4 of the f32 plain
    version, at widths 64, 128 and 256 with zero, one and two hidden
    layers."""
    from garmentnets_tpu_torch.kernels.dense_decode_tc import (
        dense_decode_tc_cuda, pack_decoder)
    fv, layers = chip_smoke.decode_inputs(
        torch.Generator().manual_seed(S), (2, *coarse), widths, dev)
    want = dense_decode_plain(fv, layers, S)
    emu = dense_decode_plain(fv, layers, S, kernel_products=True)
    assert float(want.std()) > 0.1           # the field is not flat
    before = _build.LAUNCHES["dense_decode_tc"]
    out = dense_decode_tc_cuda(coarse_first_layer(fv, layers).contiguous(),
                               pack_decoder(layers, "highest"), S)
    assert _build.LAUNCHES["dense_decode_tc"] == before + 1
    torch.testing.assert_close(out, emu, rtol=0, atol=2e-5)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-4)


def test_decode_tile_rows_from_the_library(dev):
    """64-row tiles only where three A parts of 128 rows and a weight ring
    would not fit (bf16x6 at width 256); the window covers such a tile."""
    from garmentnets_tpu_torch.kernels.dense_decode_tc import (
        line_window, tile_rows)
    rows = {(n, p): tile_rows(n, p) for n in (64, 128, 256)
            for p in (1, 2, 3)}
    assert rows.pop((256, 3)) == 64
    assert set(rows.values()) == {128}
    assert line_window(128, 32, tile_rows(256, 3)) == 17


def test_decode_kernel_refuses_vector_head(dev):
    layers = [tuple(torch.ones(*s, device=dev) for s in
                    ((4, 8), (8,), (8,), (8,))),
              tuple(torch.ones(*s, device=dev) for s in
                    ((8, 3), (3,), (3,), (3,)))]
    with pytest.raises(ValueError, match="scalar head"):
        dense_decode(torch.zeros(1, 4, 4, 4, 4, device=dev), layers, 8,
                     "highest")


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("coarse,S,widths", [
    ((2, 8, 8, 8), 16, (8, 24, 24, 1)),
    ((2, 5, 6, 7), 20, (6, 16, 16, 16, 1)),   # two hidden layers
    ((1, 4, 4, 4), 7, (5, 12, 1)),            # no hidden layer
    ((2, 8, 8, 8), 32, (128, 256, 256, 1)),   # the main path's widths
])
def test_tc_decode_kernel_matches_plain_tier(dev, precision, coarse, S,
                                             widths):
    """The tensor-core kernel against the plain version of its tier. The
    products are the same; the sums run in another order (and through the
    tensor cores' adders), so 'high' holds 2e-4. At 'default' that order
    can flip the bf16 rounding of an activation that feeds a second hidden
    layer (one bf16 ulp, 2^-8 relative): every voxel holds 5e-3 with at
    most one hidden layer; with two, 99.9% of the voxels hold 5e-3 and
    all of them 5e-2."""
    from garmentnets_tpu_torch.kernels.dense_decode_tc import (
        dense_decode_tc_cuda, pack_decoder)
    fv, layers = chip_smoke.decode_inputs(
        torch.Generator().manual_seed(S), coarse, widths, dev)
    want = dense_decode_plain(fv, layers, S, precision)
    assert float(want.std()) > 0.1           # the field is not flat
    before = _build.LAUNCHES["dense_decode_tc"]
    out = dense_decode_tc_cuda(coarse_first_layer(fv, layers).contiguous(),
                               pack_decoder(layers, precision), S)
    assert _build.LAUNCHES["dense_decode_tc"] == before + 1
    err = (out - want).abs()
    if precision == "high":
        assert float(err.max()) <= 2e-4, float(err.max())
    elif len(widths) <= 4:
        assert float(err.max()) <= 5e-3, float(err.max())
    else:
        assert float((err > 5e-3).float().mean()) <= 1e-3
        assert float(err.max()) <= 5e-2, float(err.max())


def test_tc_decode_kernel_refuses_vector_head(dev):
    layers = [tuple(torch.ones(*s, device=dev) for s in
                    ((4, 8), (8,), (8,), (8,))),
              tuple(torch.ones(*s, device=dev) for s in
                    ((8, 3), (3,), (3,), (3,)))]
    for precision in ("high", "default"):
        with pytest.raises(ValueError, match="scalar head"):
            dense_decode(torch.zeros(1, 4, 4, 4, 4, device=dev), layers, 8,
                         precision)


def test_engine_card_matches_cpu(dev):
    """A tiny engine on the card against the same weights on the CPU, at
    the decode tiers 'highest' and 'high'."""
    chip_smoke.phase_small_reference(dev)


def _check_sa(args, want_inf=False):
    """The tensor-core kernel against the plain 'high' tier (2e-5: the
    same bf16 splits and products, f32 sums in another order) and the f32
    plain version (1e-4), with -inf exactly where the plain version has
    it; one launch counted."""
    from garmentnets_tpu_torch.kernels.sa_tc import sa_tc_cuda
    high = sa_fused_plain(*args, precision="high")
    f32 = sa_fused_plain(*args)
    before = _build.LAUNCHES["sa_tc"]
    out = sa_tc_cuda(*args)
    assert _build.LAUNCHES["sa_tc"] == before + 1
    assert torch.equal(torch.isinf(out), torch.isinf(f32))
    assert bool(torch.isinf(f32).any()) == want_inf
    fin = torch.isfinite(f32)
    assert bool(torch.isfinite(out[fin]).all())
    assert float((out[fin] - high[fin]).abs().max()) <= 2e-5
    assert float((out[fin] - f32[fin]).abs().max()) <= 1e-4
    return out


@pytest.mark.parametrize("n_pts,m,cin,widths,radius", [
    (6000, 3000, 3, (6, 64, 64, 128), 0.05),          # SA1
    (3000, 750, 128, (131, 128, 128, 256), 0.1),      # SA2
])
def test_sa_kernel_matches_plain_full_shapes(dev, n_pts, m, cin, widths,
                                             radius):
    """B=8, K=64, indices from the port's FPS and ball query."""
    args = chip_smoke.sa_inputs(torch.Generator().manual_seed(n_pts), 8,
                                n_pts, m, cin, widths, radius, dev)
    assert float(sa_fused_plain(*args).std()) > 0.1   # not flat
    _check_sa(args)


def _random_sa_case(seed, B, N, M, K, cin, widths, keep, dev):
    """Random indices and a random mask (`keep` valid share)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(B, N, cin, generator=g) - 0.5
    pos = torch.rand(B, N, 3, generator=g)
    idx = torch.randint(0, N, (B, M, K), generator=g)
    mask = torch.rand(B, M, K, generator=g) < keep
    layers = chip_smoke.sa_layers(g, widths, dev)
    return [t.to(dev) for t in (x, pos, pos[:, :M].contiguous(), idx,
                                mask)] + [layers]


@pytest.mark.parametrize("M,K,cin,widths,keep", [
    (97, 24, 5, (8, 40, 32), 0.6),        # odd M, Cin 5, padded K and width
    (50, 64, 3, (6, 16, 8), 0.03),        # heavily masked: empty rows
    (33, 8, 3, (6, 256), 1.0),            # one layer at the widest width
    (40, 64, 128, (131, 128, 128, 256), 0.9),   # SA2's widths (weight ring)
])
def test_sa_kernel_random_cases(dev, M, K, cin, widths, keep):
    args = _random_sa_case(M, 2, 300, M, K, cin, widths, keep, dev)
    _check_sa(args, want_inf=keep < 0.1)


@pytest.mark.parametrize("widths", [(6, 64, 64, 128), (131, 128, 128, 256)])
def test_sa_kernel_single_valid_slot_and_empty_center(dev, widths):
    """Each center keeps exactly one valid slot, at a random position,
    except three that keep none and must give -inf."""
    args = _random_sa_case(5, 2, 400, 70, 64, widths[0] - 3, widths, 1.0,
                           dev)
    g = torch.Generator().manual_seed(6)
    slot = torch.randint(0, 64, (2, 70, 1), generator=g).to(dev)
    mask = torch.zeros(2, 70, 64, dtype=torch.bool, device=dev)
    mask.scatter_(2, slot, True)
    mask[0, 3] = mask[1, 0] = mask[1, 69] = False
    args[4] = mask
    out = _check_sa(args, want_inf=True)
    assert bool(torch.isinf(out[0, 3]).all() and (out[0, 3] < 0).all())
    assert int(torch.isinf(out).any(-1).sum()) == 3


def test_prefetch_extract_meshes_card_matches_cpu(dev):
    """Pages and NOCS outputs read through prefetch (pinned copies and an
    event) on the card equal the same calls on the CPU."""
    import numpy as np
    from garmentnets_tpu_torch.core.random_weights import seeded_init_
    from garmentnets_tpu_torch.harness.predict_engine import PredictEngine
    from garmentnets_tpu_torch.models.pipeline import ConvImplicitWNFPipeline
    from garmentnets_tpu_torch.ops.isosurface import (
        extract_active_bricks, pack_brick_pages)
    model = ConvImplicitWNFPipeline(chip_smoke.small_cfg())
    seeded_init_(model, 4)
    rng = np.random.RandomState(4)
    x = rng.rand(2, 256, 3).astype(np.float32)
    pos = (rng.rand(2, 256, 3) - 0.5).astype(np.float32)
    ax = torch.linspace(0, 1, 32)
    g = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1)
    wnf = 1.0 - (g - 0.5).norm(dim=-1) / 0.6
    wnf = torch.stack([wnf, wnf.flip(0)]).contiguous()
    out = {}
    for d in (dev, "cpu"):
        eng = PredictEngine(chip_smoke.small_cfg(), model.state_dict(),
                            volume_size=32, mc_threads=1, device=d)
        enc = eng.encode(x, pos)
        eng.prefetch(enc, extra_keys=("pred_nocs",))
        nocs = eng.host_outputs(enc)["pred_nocs"].numpy().copy()
        base, vals, counts = extract_active_bricks(wnf.to(d), 0.5,
                                                   eng.brick_cap)
        enc = {"active_pages": pack_brick_pages(base, vals, eng.brick_page,
                                                counts=counts)}
        eng.prefetch(enc)
        assert eng.encode_done(enc) or d != "cpu"
        out[str(d)] = (nocs, eng.extract_meshes(enc))
        eng.close()
    (n_card, m_card), (n_cpu, m_cpu) = out[str(dev)], out["cpu"]
    np.testing.assert_array_equal(n_card, n_cpu)
    for a, b in zip(m_card, m_cpu):
        assert a is not None and len(a[0]) > 0
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


def test_to_device_from_host_and_card(dev):
    """Host data goes up through a pinned copy; a tensor already on a card
    (device "cuda:0" against "cuda") is passed through."""
    import numpy as np
    from garmentnets_tpu_torch.core.device import to_device
    a = np.arange(12, dtype=np.float64).reshape(3, 4)
    t = to_device(a, "cuda", torch.float32)
    assert t.is_cuda and t.dtype == torch.float32
    assert torch.equal(t.cpu(), torch.from_numpy(a).float())
    assert torch.equal(to_device(t, "cuda"), t)


@pytest.mark.parametrize("variant", ["holes", "task_space"])
def test_variant_engine_card_matches_cpu(dev, variant):
    """The hole head (its logits a fifth warp channel) and the task-space
    volume on the card against the same engine on the CPU at 'highest', a
    tiny size: NOCS within 1e-6, WNF and ggm within 1e-3, and every warp
    channel at the same vertices within 1e-3."""
    import dataclasses
    import numpy as np
    from garmentnets_tpu_torch.core.random_weights import seeded_init_
    from garmentnets_tpu_torch.harness.predict_engine import PredictEngine
    from garmentnets_tpu_torch.models.pipeline import ConvImplicitWNFPipeline
    over = ({"mc_surface_loss_weight": 1.0,
             "mc_surface_decoder_channels": (32, 16, 1)}
            if variant == "holes" else {"volume_task_space": True})
    cfg = dataclasses.replace(chip_smoke.small_cfg(), **over)
    model = ConvImplicitWNFPipeline(cfg)
    seeded_init_(model, 6)
    rng = np.random.RandomState(6)
    x = rng.rand(2, 256, 3).astype(np.float32)
    pos = (rng.rand(2, 256, 3) - 0.5).astype(np.float32)
    verts = rng.rand(2, 300, 3).astype(np.float16).astype(np.float32)
    meshes = [(v, None) for v in verts]
    kw = dict(use_hole_prediction=True, task_aabb=np.array(
        [[-0.5, -0.5, -0.6], [0.5, 0.55, 0.4]], np.float32))
    out = {}
    for d in (dev, "cpu"):
        eng = PredictEngine(cfg, model.state_dict(), volume_size=32,
                            return_volume=True, decode_precision="highest",
                            mc_threads=1, device=d, **kw)
        enc = eng.encode(x, pos)
        out[str(d)] = ({k: v.cpu() for k, v in enc.items()
                        if torch.is_tensor(v)}, eng.warp_batch(enc, meshes))
        eng.close()
    (e_card, w_card), (e_cpu, w_cpu) = out[str(dev)], out["cpu"]
    assert float((e_card["pred_nocs"] - e_cpu["pred_nocs"]).abs().max()) \
        <= 1e-6
    for k in ("wnf_volume", "wnf_ggm"):
        assert float((e_card[k] - e_cpu[k]).abs().max()) <= 1e-3, k
    for a, b in zip(w_card, w_cpu):
        assert sorted(a) == sorted(b)
        assert ("mc_surface_logits" in a) == (variant == "holes")
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-3,
                                       err_msg=k)
