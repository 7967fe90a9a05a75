"""The port's set abstraction against the JAX package's fused SA kernel.

- ops/set_abstraction.sa_fused_plain vs garmentnets_tpu/kernels/
  sa_pallas.sa_fused (interpreted, HIGHEST precision) on the shape cases
  and the heavy-mask case of tests/test_sa_pallas.py, within rtol 1e-5 and
  atol 1e-6 (f32 sums in another order);
- the port's SAModule in eval mode (weights carried by
  core/weights.state_dict_from_jax) vs the JAX SAModule with
  GARMENTNETS_SA=pallas: centers identical, output within 1e-5;
- the plain 'high' tier (bf16x3) vs the JAX kernel at "bf16_3x"
  (interpreted), and against the f32 tier;
- the tensor-core kernel's layer packing (kernels/sa_tc.py), read back at
  the kernel's offsets, and a CPU emulation of the kernel's shared-memory
  addressing (gather into the A operand, wgmma descriptors over A and the
  weight chunks, epilogue into the next A, masked max) against the plain
  'high' tier;
- the launcher's refusals of CPU tensors and of bad shapes and widths.
"""
import functools
import pathlib
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_port_util as pu  # noqa: E402
from test_sa_pallas import _rand_case  # noqa: E402

from garmentnets_tpu.kernels import sa_pallas  # noqa: E402
from garmentnets_tpu.models import pointnet2 as jax_p2  # noqa: E402
from garmentnets_tpu_torch.kernels import _build  # noqa: E402
from garmentnets_tpu_torch.kernels.sa_tc import (  # noqa: E402
    KSTEP, ROWS, SMEM_TWO_BLOCKS, WG_ROWS, pack_sa_layers, ring_stages,
    sa_tc_cuda, smem_bytes)
from garmentnets_tpu_torch.ops.dense_decode import (  # noqa: E402
    eval_layers, split_bf16)
from garmentnets_tpu_torch.models import pointnet2 as torch_p2  # noqa: E402
from garmentnets_tpu_torch.ops.set_abstraction import (  # noqa: E402
    sa_fused, sa_fused_plain)

CASES = [
    # (B, N, M, K, Cin, chans, heavy mask): tests/test_sa_pallas.py:64-94
    (2, 256, 64, 8, 3, (8, 16), False),
    (1, 300, 96, 16, 5, (8,), False),
    (2, 200, 10, 8, 3, (8, 8), False),
    (1, 512, 32, 32, 3, (8, 16, 8), False),
    (2, 128, 16, 8, 3, (8, 16), True),
]


def _torch_args(x, pos, centers, idx, mask, layers):
    t = [torch.from_numpy(np.array(a)) for a in (x, pos, centers)]
    t += [torch.from_numpy(np.array(idx, np.int64)),
          torch.from_numpy(np.array(mask))]
    t.append([(torch.from_numpy(np.array(w)),
               *(torch.from_numpy(v) for v in np.array(bgs)))
              for w, bgs in layers])
    return t


@pytest.mark.parametrize("B,N,M,K,Cin,chans,heavy", CASES)
def test_sa_plain_matches_jax_kernel(B, N, M, K, Cin, chans, heavy):
    if heavy:
        x, pos, centers, idx, mask, layers = _rand_case(
            3, B, N, M, K, Cin, chans)
        mask = np.array(mask)
        mask[0, :4, 1:] = False        # one valid slot on some rows
        mask = jnp.asarray(mask)
    else:
        x, pos, centers, idx, mask, layers = _rand_case(
            0, B, N, M, K, Cin, chans)
    ref = np.asarray(sa_pallas.sa_fused(
        x, pos, centers, idx, mask, layers,
        precision=jax.lax.Precision.HIGHEST, interpret=True))
    args = _torch_args(x, pos, centers, idx, mask, layers)
    ours = sa_fused_plain(*args)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-6)
    # on a CPU tensor the dispatch is the plain version itself
    assert torch.equal(sa_fused(*args), ours)


@pytest.fixture(scope="module")
def tiny_pipeline():
    variables = pu.jax_variables()
    return variables, pu.torch_model(variables)


@pytest.mark.parametrize("stage", ["sa1", "sa2"])
def test_sa_module_eval_matches_jax_pallas_path(tiny_pipeline, monkeypatch,
                                                stage):
    variables, model = tiny_pipeline
    x = pu.inputs()
    params = variables["params"]["pointnet2_nocs"]
    stats = variables["batch_stats"]["pointnet2_nocs"]
    sa1 = jax_p2.SAModule(0.5, pu.SA1_R, (6, 64, 64, 128))
    sa2 = jax_p2.SAModule(0.25, pu.SA2_R, (131, 128, 128, 256))
    monkeypatch.setenv("GARMENTNETS_SA", "pallas")
    monkeypatch.setattr(sa_pallas, "sa_fused", functools.partial(
        sa_pallas.sa_fused, precision=jax.lax.Precision.HIGHEST,
        interpret=True))

    def run(mod, name, a, b):
        return mod.apply({"params": params[name], "batch_stats": stats[name]},
                         jnp.asarray(a), jnp.asarray(b), train=False)

    feat, pos = x["x"], x["pos"]
    if stage == "sa2":
        h, c = run(sa1, "sa1", feat, pos)
        feat, pos = np.asarray(h), np.asarray(c)
    ref, ref_c = run(sa1 if stage == "sa1" else sa2, stage, feat, pos)
    module = getattr(model.pointnet2_nocs, f"{stage}_module")
    assert not module.training
    with torch.no_grad():
        out, c = module(torch.from_numpy(feat), torch.from_numpy(pos))
    np.testing.assert_array_equal(c.numpy(), np.asarray(ref_c))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_sa_module_eval_uses_sa_fused_and_train_uses_stock_ops(
        tiny_pipeline, monkeypatch):
    """Eval mode goes through ops/set_abstraction.sa_fused with the folded
    layers; training mode keeps the stock-op path, which normalizes with
    the batch statistics of the valid neighbour slots: its output and
    updated running statistics equal the JAX SAModule's in training mode
    (within 1e-5 of the largest output; statistics rtol 1e-5, atol 1e-5),
    and the module's state is restored after."""
    variables, model = tiny_pipeline
    module = model.pointnet2_nocs.sa1_module
    x = pu.inputs()
    feat, pos = torch.from_numpy(x["x"]), torch.from_numpy(x["pos"])
    calls = []

    def spy(*args):
        calls.append(len(args[5]))           # the folded layers
        return sa_fused(*args)

    monkeypatch.setattr(torch_p2, "sa_fused", spy)
    state = {k: v.clone() for k, v in module.state_dict().items()}
    with torch.no_grad():
        module(feat, pos)
        module.train()
        try:
            out_train, _ = module(feat, pos)
            stats_train = {k: v.clone() for k, v in
                           module.state_dict().items() if "running" in k}
        finally:
            module.eval()
            module.load_state_dict(state)
    assert calls == [3]                      # one eval call, three layers
    params = variables["params"]["pointnet2_nocs"]["sa1"]
    (ref, _), mut = jax_p2.SAModule(0.5, pu.SA1_R, (6, 64, 64, 128)).apply(
        {"params": params,
         "batch_stats": variables["batch_stats"]["pointnet2_nocs"]["sa1"]},
        jnp.asarray(x["x"]), jnp.asarray(x["pos"]), train=True,
        mutable=["batch_stats"])
    ref = np.asarray(ref)
    np.testing.assert_allclose(out_train.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    for i, st in mut["batch_stats"]["mlp"].items():
        layer = int(i.split("_")[1])
        for ours, theirs in (("running_mean", "mean"),
                             ("running_var", "var")):
            np.testing.assert_allclose(
                stats_train[f"conv.local_nn.{layer}.2.{ours}"].numpy(),
                np.asarray(st[theirs]), rtol=1e-5, atol=1e-5)


def _case(B, N, M, K, Cin, chans, heavy):
    if heavy:
        x, pos, centers, idx, mask, layers = _rand_case(
            3, B, N, M, K, Cin, chans)
        mask = np.array(mask)
        mask[0, :4, 1:] = False        # one valid slot on some rows
        return x, pos, centers, idx, jnp.asarray(mask), layers
    return _rand_case(0, B, N, M, K, Cin, chans)


@pytest.mark.parametrize("B,N,M,K,Cin,chans,heavy", CASES)
def test_sa_plain_high_matches_jax_bf16_3x(B, N, M, K, Cin, chans, heavy):
    """The plain 'high' tier against the JAX kernel's "bf16_3x" products
    (interpreted): the same bf16 splits and products, f32 sums in another
    order (the JAX kernel adds the three passes after the products). They
    agree to 1.4e-7 on these O(1) outputs; the limit, 3e-7, is below the
    tier's distance from f32 on every case (4.5e-7 to 3.9e-6)."""
    case = _case(B, N, M, K, Cin, chans, heavy)
    ref = np.asarray(sa_pallas.sa_fused(*case, precision="bf16_3x",
                                        interpret=True))
    ours = sa_fused_plain(*_torch_args(*case), precision="high")
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=3e-7)


@pytest.mark.parametrize("B,N,M,K,Cin,chans,heavy", CASES[:2])
def test_sa_plain_high_tier_against_f32(B, N, M, K, Cin, chans, heavy):
    """bf16x3 drops only the lo*lo term (2^-16 relative to each product):
    the tier differs from f32, by less than 1e-5 on these O(1) outputs."""
    args = _torch_args(*_case(B, N, M, K, Cin, chans, heavy))
    f32 = sa_fused_plain(*args)
    high = sa_fused_plain(*args, precision="high")
    err = float((high - f32).abs().max())
    assert 0 < err <= 1e-5, err
    with pytest.raises(ValueError, match="precision"):
        sa_fused_plain(*args, precision="default")


def test_sa_module_folded_layers_cache_follows_the_weights(tiny_pipeline):
    """SAModule folds (and on the card packs) its MLP once and reuses it
    until a weight changes: load_state_dict and in-place edits both give
    a new fold with the new values."""
    _, model = tiny_pipeline
    module = model.pointnet2_nocs.sa2_module
    first = module.folded_layers(torch.device("cpu"))
    assert module.folded_layers(torch.device("cpu")) is first
    assert first[1] is None                      # nothing to pack on the CPU
    sd = {k: v.clone() for k, v in module.state_dict().items()}
    module.load_state_dict(sd)
    second = module.folded_layers(torch.device("cpu"))
    assert second is not first
    for a, b in zip(first[0], second[0]):
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    bn = module.conv.local_nn[0][2]
    with torch.no_grad():
        bn.running_var.mul_(4.0)
    try:
        third = module.folded_layers(torch.device("cpu"))
        fresh = eval_layers(module.conv.local_nn)
        assert not torch.equal(third[0][0][2], second[0][0][2])
        for a, b in zip(third[0], fresh):
            assert all(torch.equal(u, v) for u, v in zip(a, b))
    finally:
        module.load_state_dict(sd)


def _layers(cin0, widths, seed):
    gen = torch.Generator().manual_seed(seed)
    dims = (cin0,) + widths
    return [((torch.rand(a, b, generator=gen) - 0.5) * (2 / a ** 0.5),
             torch.rand(b, generator=gen) - 0.5,
             torch.rand(b, generator=gen) + 0.5,
             torch.rand(b, generator=gen) - 0.5)
            for a, b in zip(dims[:-1], dims[1:])]


def _desc_read(buf, start, sbo, rows, lbo=128, kcols=KSTEP):
    """[rows, kcols] read of a K-major no-swizzle wgmma operand as the
    kernel's descriptors address it (csrc make_desc): element (r, k) at
    start + (r/8) SBO + (k/8) LBO + (r%8) 16 + (k%8) 2 bytes."""
    r = torch.arange(rows)[:, None]
    k = torch.arange(kcols)[None, :]
    off = (start + (r // 8) * sbo + (k // 8) * lbo + (r % 8) * 16
           + (k % 8) * 2) // 2
    return buf[off]


def _core_offset(row, k, kgroups):
    """csrc core_offset, in bytes."""
    return (((row // 8) * kgroups + k // 8) * 64 + (row % 8) * 8 + k % 8) * 2


def _unpack_pass(packed, i, w_off):
    """Pass i's weights read back at the kernel's offsets: ([kp, np] hi,
    lo) from its chunk images, which start at element w_off."""
    kp, np_ = packed.kp[i], packed.np_[i]
    part = np_ * KSTEP
    hi = torch.zeros(kp, np_, dtype=torch.bfloat16)
    lo = torch.zeros(kp, np_, dtype=torch.bfloat16)
    for c in range(kp // KSTEP):
        base = w_off + c * 2 * part
        hi[c * KSTEP:(c + 1) * KSTEP] = _desc_read(packed.wts, base * 2,
                                                   256, np_).t()
        lo[c * KSTEP:(c + 1) * KSTEP] = _desc_read(
            packed.wts, (base + part) * 2, 256, np_).t()
    return hi, lo


@pytest.mark.parametrize("cin0,widths", [(6, (64, 64, 128)),
                                         (131, (128, 128, 256)),
                                         (8, (40, 32)), (6, (5,))])
def test_pack_layers_padding_keeps_the_chain(cin0, widths):
    """The kernel's packed layout, read back at the kernel's offsets: one
    pass per hidden layer and the last layer's columns in passes of <= 128
    (two at SA2's 256); each pass's chunk images hold the bf16 hi and lo
    parts of its K columns zero-padded to [kp, np] (kp of layer 0 is cin0
    rounded up to 16: 6 -> 16, 131 -> 144; then the previous np), b, g, s
    are zero-padded, and the chain of padded passes computes the unpadded
    chain with zeros in the padded columns."""
    layers = _layers(cin0, widths, cin0)
    packed = pack_sa_layers(layers, cin0)
    n_last = -(-widths[-1] // 128)
    assert len(packed.kp) == len(widths) - 1 + n_last
    assert packed.n_hidden == len(widths) - 1
    assert packed.kp[0] == -(-cin0 // 16) * 16
    assert packed.kp[1:packed.n_hidden + 1] == packed.np_[:packed.n_hidden]
    assert len(set(packed.kp[packed.n_hidden:])) == 1
    assert packed.col0 == [0] * packed.n_hidden + [
        128 * j for j in range(n_last)]
    assert all(n in (64, 128) for n in packed.np_)
    assert packed.cout_last == widths[-1]
    w_off = e_off = 0
    h = ref = torch.rand(50, cin0, generator=torch.Generator().manual_seed(1))
    h = torch.nn.functional.pad(h, (0, packed.kp[0] - cin0))
    outs = []
    for i, (kp, np_, c0) in enumerate(zip(packed.kp, packed.np_,
                                          packed.col0)):
        k, b, g, s = layers[min(i, packed.n_hidden)]
        hi, lo = _unpack_pass(packed, i, w_off)
        w_off += kp * np_ * 2
        n = min(np_, k.shape[1] - c0)
        want = torch.zeros(kp, np_)
        want[:k.shape[0], :n] = k[:, c0:c0 + n]
        want_hi, want_lo = split_bf16(want)
        assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
        bgs = packed.epi[e_off:e_off + 3 * np_].reshape(3, np_)
        e_off += 3 * np_
        assert bool((bgs[:, n:] == 0).all())
        out = torch.relu(h @ (hi.float() + lo.float()) + bgs[0]) * bgs[1] \
            + bgs[2]
        if i < packed.n_hidden:
            h = out
            ref = torch.relu(ref @ k + b) * g + s
        else:
            outs.append(out[:, :n])
            assert bool((out[:, n:] == 0).all())
    k, b, g, s = layers[-1]
    ref = torch.relu(ref @ k + b) * g + s
    assert w_off == packed.wts.numel() and e_off == packed.epi.numel()
    torch.testing.assert_close(torch.cat(outs, dim=1), ref, rtol=0,
                               atol=2e-5)


def _emulate_kernel(x, pos, centers, idx, mask, layers):
    """The kernel's arithmetic with its shared-memory addressing, on the
    CPU: per warpgroup of 64 rows of a 128-row tile, the gather writes
    the hi/lo A operand at core_offset, each 16-row K-step of a pass reads
    A and the weight chunk through the descriptors (A: SBO kp * 16; B: SBO
    256), the three bf16 products accumulate in f32 (here in f64, exact
    for the products), a hidden pass's epilogue writes the next A at
    core_offset, and each pass of the last layer takes the masked max per
    center over its columns."""
    B, N, Cin = x.shape
    M, K = idx.shape[1:]
    kpad = next(p for p in (16, 32, 64) if p >= K)
    idx = torch.nn.functional.pad(idx, (0, kpad - K))
    mask = torch.nn.functional.pad(mask, (0, kpad - K))
    packed = pack_sa_layers(layers, Cin + 3)
    kp_max = max(packed.kp)
    n_rows = B * M * kpad
    out = torch.full((B * M, packed.cout_last), float("nan"))
    fidx, fmask = idx.reshape(-1), mask.reshape(-1)
    for row0 in range(0, -(-n_rows // ROWS) * ROWS, WG_ROWS):
        rows = torch.arange(row0, row0 + WG_ROWS)
        live = rows < n_rows
        valid = live.clone()
        valid[live] = fmask[rows[live]]
        gc = torch.where(live, rows // kpad, 0)
        j = torch.where(live, fidx[rows.clamp(max=n_rows - 1)], 0)
        pt_b = gc // M
        a_hi = torch.zeros(WG_ROWS * kp_max, dtype=torch.bfloat16)
        a_lo = torch.zeros_like(a_hi)
        feats = torch.cat([x[pt_b, j], pos[pt_b, j] - centers.reshape(
            -1, 3)[gc]], dim=-1)
        feats = torch.where(valid[:, None], feats, 0.0)
        kg0 = packed.kp[0] // 8
        for r in range(WG_ROWS):
            for c in range(packed.kp[0]):
                v = feats[r, c] if c < Cin + 3 else torch.tensor(0.0)
                hi, lo = split_bf16(v)
                a_hi[_core_offset(r, c, kg0) // 2] = hi
                a_lo[_core_offset(r, c, kg0) // 2] = lo
        w_off = e_off = 0
        for i, (kp, np_, c0) in enumerate(zip(packed.kp, packed.np_,
                                              packed.col0)):
            part = np_ * KSTEP
            acc = torch.zeros(WG_ROWS, np_, dtype=torch.float64)
            for c in range(kp // KSTEP):
                ah = _desc_read(a_hi, c * 256, kp * 16, WG_ROWS).double()
                al = _desc_read(a_lo, c * 256, kp * 16, WG_ROWS).double()
                base = (w_off + c * 2 * part) * 2
                bh = _desc_read(packed.wts, base, 256, np_).double()
                bl = _desc_read(packed.wts, base + part * 2, 256,
                                np_).double()
                acc += ah @ bh.t() + ah @ bl.t() + al @ bh.t()
            w_off += kp * np_ * 2
            b, g, s = packed.epi[e_off:e_off + 3 * np_].reshape(3, np_)
            e_off += 3 * np_
            act = torch.relu(acc.float() + b) * g + s
            if i < packed.n_hidden:
                hi, lo = split_bf16(act)
                r = torch.arange(WG_ROWS)[:, None]
                col = torch.arange(np_)[None, :]
                off = (_core_offset(r, col, np_ // 8) // 2).reshape(-1)
                a_hi[off] = hi.reshape(-1)
                a_lo[off] = lo.reshape(-1)
                continue
            n = min(np_, packed.cout_last - c0)
            act = torch.where(valid[:, None], act, float("-inf"))
            for r0 in range(0, WG_ROWS, kpad):
                if row0 + r0 < n_rows:
                    out[gc[r0], c0:c0 + n] = act[r0:r0 + kpad, :n].amax(0)
    return out.reshape(B, M, packed.cout_last)


@pytest.mark.parametrize("B,N,M,K,Cin,chans", [
    (1, 60, 3, 64, 3, (64, 64, 128)),       # SA1's widths, Kp 64
    (1, 50, 5, 20, 128, (128, 128, 256)),   # SA2's widths, K 20 -> Kp 32
    (2, 40, 3, 9, 5, (40, 200)),            # K 9 -> Kp 16, 200 = 128 + 72
])
def test_kernel_layout_emulation_matches_plain_high(B, N, M, K, Cin, chans):
    x, pos, centers, idx, mask, _ = _rand_case(7, B, N, M, K, Cin, chans)
    args = _torch_args(x, pos, centers, idx, mask, [])
    args[-1] = _layers(Cin + 3, chans, K)
    args[4][0, 0, :] = False                  # a center with no valid slot
    want = sa_fused_plain(*args, precision="high")
    got = _emulate_kernel(*args)
    assert bool(torch.isinf(want[0, 0]).all()) and bool(
        torch.isinf(got[0, 0]).all())
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


def test_weight_placement_resident_and_ring():
    """SA1's weights (53 KB as hi + lo) stay resident in shared memory,
    two blocks to an SM; SA2's (264 KB) stream through a ring of 8 KB
    stages, four of them so that two blocks still fit on an SM."""
    sa1 = pack_sa_layers(_layers(6, (64, 64, 128), 0), 6)
    sa2 = pack_sa_layers(_layers(131, (128, 128, 256), 0), 131)
    assert sa1.w_bytes == 53248 and ring_stages(sa1) == 0
    assert smem_bytes(sa1, sa1.w_bytes) <= SMEM_TWO_BLOCKS
    assert sa2.w_bytes == 270336 and sa2.stage_bytes == 8192
    assert ring_stages(sa2) == 4
    assert smem_bytes(sa2, 4 * sa2.stage_bytes) <= SMEM_TWO_BLOCKS
    assert smem_bytes(sa2, 5 * sa2.stage_bytes) > SMEM_TWO_BLOCKS


def test_sa_kernel_wrapper_refuses_cpu_tensors():
    x, pos, centers, idx, mask, layers = _rand_case(1, 1, 64, 8, 8, 3, (8,))
    before = _build.LAUNCHES["sa_tc"]
    with pytest.raises(ValueError, match="CUDA"):
        sa_tc_cuda(*_torch_args(x, pos, centers, idx, mask, layers))
    assert _build.LAUNCHES["sa_tc"] == before
    assert not _build._LIBS.get("sa_tc")


@pytest.mark.parametrize("what,match", [
    ("x", "must be"), ("pos", "must be"), ("mask", "must both be"),
    ("centers", "centers must be"), ("slots", "neighbour slots"),
    ("width", "output widths <= 256"), ("hidden", "hidden widths <= 128"),
    ("layers", "1..4 layers"), ("cin", "input rows"),
])
def test_sa_kernel_wrapper_refuses_bad_shapes(what, match):
    """Shapes and widths the kernel does not take raise before any launch
    (and before the device check)."""
    B, N, M, K = 1, 32, 8, 8
    g = torch.Generator().manual_seed(0)
    x, pos = torch.rand(B, N, 3, generator=g), torch.rand(B, N, 3,
                                                          generator=g)
    centers = pos[:, :M].contiguous()
    idx = torch.zeros(B, M, K, dtype=torch.int64)
    mask = torch.ones(B, M, K, dtype=torch.bool)
    widths = {"width": (300,), "hidden": (200, 8),
              "layers": (8,) * 5}.get(what, (8, 16))
    layers = _layers(6, widths, 0)
    if what == "x":
        x = x[0]
    elif what == "pos":
        pos = pos[..., :2]
    elif what == "mask":
        mask = mask[..., :4]
    elif what == "centers":
        centers = centers[:, :4]
    elif what == "slots":
        idx = torch.zeros(B, M, 65, dtype=torch.int64)
        mask = torch.ones(B, M, 65, dtype=torch.bool)
    elif what == "cin":
        layers = _layers(7, widths, 0)
    before = _build.LAUNCHES["sa_tc"]
    with pytest.raises(ValueError, match=match):
        sa_tc_cuda(x, pos, centers, idx, mask, layers)
    assert _build.LAUNCHES["sa_tc"] == before
