"""The filter-gradient kernel's plan and indexing on the CPU
(kernels/conv3d_wgrad): its plain-torch emulation (chunks, taps, padding
edges, split-K, the six bf16 part products) against a float64 filter
gradient for every (Cin, Cout) pair of both stage-2 U-Nets, the plans at
their real shapes, and the CPU path of models/unet3d.weight_grad."""
import pytest
import torch

from garmentnets_tpu_torch.kernels import conv3d_wgrad as cw
from garmentnets_tpu_torch.models import unet3d

# (Cin, Cout) of every 3x3x3 convolution, with its side at B=24, 32^3
# (test_shape_tables_are_the_models holds them to the models)
UNET3D = [(128, 128, 32), (128, 32, 32), (32, 32, 16), (32, 64, 16),
          (64, 64, 8), (64, 128, 8), (128, 128, 4), (128, 256, 4),
          (384, 128, 8), (128, 128, 8), (192, 64, 16), (64, 64, 16),
          (96, 32, 32), (32, 32, 32)]
RESIDUAL = [(128, 64, 32), (64, 64, 32), (64, 128, 16), (128, 128, 16),
            (128, 256, 8), (256, 256, 8), (256, 512, 4), (512, 512, 4),
            (512, 1024, 2), (1024, 1024, 2)]
PAIRS = sorted({(cin, cout) for cin, cout, _ in UNET3D + RESIDUAL})


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small float64 products: one intra-op thread a worker, so that the
    suite's workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, cin, cout, dhw, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(B, cin, *dhw, generator=gen)
    g = torch.randn(B, cout, *dhw, generator=gen)
    return g, x


@pytest.mark.parametrize("cin,cout", PAIRS)
def test_emulation_matches_float64(cin, cout):
    """At a small volume that is not a cube and whose sides are not powers
    of two (boxes overhang every side), with a multiprocessor count that
    splits K: within the six products' dropped terms of float64."""
    dhw, B = ((3, 2, 3), 1) if cin * cout > 2 ** 17 else ((5, 6, 3), 2)
    g, x = _inputs(B, cin, cout, dhw)
    plan = cw.make_plan(B, *dhw, cin, cout, sms=16)
    got = cw.conv3d_wgrad_emulated(g, x, plan)
    want = cw.wgrad_float64(g, x)
    assert got.shape == want.shape == (cout, cin, 3, 3, 3)
    assert float((got - want).abs().max()) <= 1e-7 * float(want.abs().max())


@pytest.mark.parametrize("splits_from_sms", [1, 8, 132])
def test_emulation_is_the_same_sum_at_any_split(splits_from_sms):
    """The split of K changes only which block adds which chunks."""
    g, x = _inputs(2, 64, 128, (4, 4, 4), seed=1)
    plan = cw.make_plan(2, 4, 4, 4, 64, 128, sms=splits_from_sms)
    one = cw.make_plan(2, 4, 4, 4, 64, 128, sms=1)
    assert one.splits == 1
    got = cw.conv3d_wgrad_emulated(g, x, plan)
    want = cw.conv3d_wgrad_emulated(g, x, one)
    assert torch.allclose(got, want, rtol=0, atol=1e-12)


def test_emulation_keeps_six_of_nine_products():
    """Operands whose mid and lo parts are large: the six products are
    within 2^-22 of the exact sum, where the bf16 hi parts alone are
    not."""
    g, x = _inputs(1, 64, 64, (2, 4, 4), seed=2)
    third = torch.tensor(1.0 / 3.0)
    g, x = g * third, x * third
    want = cw.wgrad_float64(g, x)
    got = cw.conv3d_wgrad_emulated(g, x)
    hi = cw.wgrad_float64(g.bfloat16().float(), x.bfloat16().float())
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2 ** -22 * scale
    assert float((hi - want).abs().max()) > 2 ** -10 * scale


def test_split_parts_carry_every_bit():
    v = torch.randn(2, 5, 3, 4, 2) * torch.logspace(-3, 3, 2)[:, None, None,
                                                              None, None]
    parts = cw.split_parts(v, 64)
    assert parts.shape == (3, 2, 3, 4, 2, 64)
    assert torch.equal(parts[..., 5:], torch.zeros_like(parts[..., 5:]))
    for q in range(3):
        assert torch.equal(parts[q], parts[q].bfloat16().float())
    back = parts.double().sum(0)[..., :5].permute(0, 4, 1, 2, 3)
    assert float(((back - v.double()).abs() / v.double().abs()).max()) \
        <= 2 ** -24


@pytest.mark.parametrize("unet,table", [("UNet3D", UNET3D),
                                        ("ResidualUNet3D", RESIDUAL)])
def test_shape_tables_are_the_models(unet, table):
    """The tables above are the distinct filter-gradient shapes that
    tools/profile_unet3d.wgrad_shapes (which the chip smoke and the card
    tests run) reads from the model on the meta device, in module order."""
    from garmentnets_tpu_torch.tools.profile_unet3d import wgrad_shapes
    assert wgrad_shapes(unet, 24, 32) == [(24, *t) for t in table]


@pytest.mark.parametrize("cin,cout,side", UNET3D + RESIDUAL)
def test_plans_at_the_unets_shapes(cin, cout, side):
    """At B=24: the box is 32 positions of whole rows, the chunks cover
    the volume once, the splits cover the chunks once and none is empty,
    each block's tile covers (output atom, tap-atom) pairs that together
    cover the output once, and the blocks fill the multiprocessors in
    waves at least 80% full where there are several."""
    plan = cw.make_plan(24, side, side, side, cin, cout)
    bw, bh, bd, bn = plan.box
    assert bw * bh * bd * bn == cw.KC
    assert bw == min(side, cw.KC)
    pos = cw.chunk_positions(plan, 0, plan.chunks)
    dims = torch.tensor([24, side, side, side])
    inside = ((pos >= 0) & (pos < dims)).all(dim=1)
    flat = ((pos[inside, 0] * side + pos[inside, 1]) * side
            + pos[inside, 2]) * side + pos[inside, 3]
    assert torch.equal(torch.bincount(flat, minlength=24 * side ** 3),
                       torch.ones(24 * side ** 3, dtype=torch.long))
    assert (plan.splits - 1) * plan.per_split < plan.chunks
    assert plan.splits * plan.per_split >= plan.chunks
    tiles = cw.tile_atoms(plan)
    assert len(tiles) == plan.tiles_m * plan.tiles_n
    pairs = [p for t in tiles for p in t]
    assert sorted(pairs) == [(m, j) for m in range(plan.mp // cw.ATOM)
                             for j in range(cw.TAPS * plan.nb)]
    assert plan.ma * cw.ATOM * plan.tiles_m == plan.mp
    blocks = len(tiles) * plan.splits
    if blocks > cw.SMS:
        assert blocks / (-(-blocks // cw.SMS) * cw.SMS) >= 0.8


def test_plan_pads_channels_to_atoms_and_picks_the_tile():
    """A is grad unless x pads less: 32 output channels are B's one
    32-channel atom, with x as A."""
    p = cw.make_plan(24, 32, 32, 32, 128, 128)
    assert (p.a_is_x, p.mp, p.np_, p.bw, p.ma, p.na, p.tiles_m,
            p.tiles_n) == (False, 128, 128, 64, 2, 2, 1, 27)
    p = cw.make_plan(24, 32, 32, 32, 128, 32)
    assert (p.a_is_x, p.mp, p.np_, p.bw, p.ma, p.na, p.tiles_n) == (
        True, 128, 32, 32, 2, 4, 7)
    p = cw.make_plan(24, 32, 32, 32, 96, 32)
    assert (p.a_is_x, p.mp, p.np_, p.bw, p.ma, p.na) == (
        True, 128, 32, 32, 2, 4)
    p = cw.make_plan(24, 32, 32, 32, 32, 32)
    assert (p.a_is_x, p.mp, p.np_, p.bw, p.ma, p.na, p.tiles_n) == (
        False, 64, 32, 32, 1, 8, 4)
    p = cw.make_plan(24, 16, 16, 16, 192, 64)
    assert (p.a_is_x, p.mp, p.np_, p.bw, p.ma, p.na, p.tiles_n) == (
        False, 64, 192, 64, 1, 4, 21)
    p = cw.make_plan(24, 2, 2, 2, 1024, 1024)
    assert p.box == (2, 2, 2, 4) and p.chunks == 6
    with pytest.raises(ValueError, match="cin"):
        cw.make_plan(1, 2, 2, 2, 0, 8)


def test_weight_grad_on_the_cpu_takes_the_swapped_problem(monkeypatch):
    """The CPU path is the plain version; the kernel's launcher is never
    asked, and refuses a CPU tensor itself."""
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel was asked on the CPU")

    monkeypatch.setattr(unet3d, "conv3d_wgrad_cuda", refuse)
    g, x = _inputs(2, 5, 3, (6, 7, 5))
    w = torch.empty(3, 5, 3, 3, 3)
    got = unet3d.weight_grad(g, x, w, (1, 1, 1))
    assert torch.equal(got, unet3d.swapped_weight_grad(g, x, w, (1, 1, 1)))
    want = cw.wgrad_float64(g, x)
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):
        cw.conv3d_wgrad_cuda(g, x)
