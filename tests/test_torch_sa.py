"""The port's set abstraction against the JAX package's fused SA kernel.

- ops/set_abstraction.sa_fused_plain vs garmentnets_tpu/kernels/
  sa_pallas.sa_fused (interpreted, HIGHEST precision) on the shape cases
  and the heavy-mask case of tests/test_sa_pallas.py, within rtol 1e-5 and
  atol 1e-6 (f32 sums in another order);
- the port's SAModule in eval mode (weights carried by
  core/weights.state_dict_from_jax) vs the JAX SAModule with
  GARMENTNETS_SA=pallas: centers identical, output within 1e-5;
- the kernel wrapper's layer packing and its refusal of CPU tensors.
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
from garmentnets_tpu_torch.kernels.sa import pack_layers, sa_cuda  # noqa: E402
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
    layers; training mode keeps the stock-op path, which computes the same
    function (the port's PointMLP normalizes with running statistics)."""
    _, model = tiny_pipeline
    module = model.pointnet2_nocs.sa1_module
    x = pu.inputs()
    feat, pos = torch.from_numpy(x["x"]), torch.from_numpy(x["pos"])
    calls = []

    def spy(*args):
        calls.append(len(args[-1]))
        return sa_fused(*args)

    monkeypatch.setattr(torch_p2, "sa_fused", spy)
    with torch.no_grad():
        out_eval, _ = module(feat, pos)
        module.train()
        try:
            out_train, _ = module(feat, pos)
        finally:
            module.eval()
    assert calls == [3]                      # one eval call, three layers
    torch.testing.assert_close(out_train, out_eval, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cin0,widths", [(6, (64, 64, 128)),
                                         (131, (128, 128, 256)),
                                         (8, (40, 32)), (6, (5,))])
def test_pack_layers_padding_keeps_the_chain(cin0, widths):
    """The kernel's packed layout (every width zero-padded to a multiple of
    32), read back as the kernel reads it, computes the unpadded chain."""
    gen = torch.Generator().manual_seed(cin0)
    dims = (cin0,) + widths
    layers = [((torch.rand(a, b, generator=gen) - 0.5),
               torch.rand(b, generator=gen) - 0.5,
               torch.rand(b, generator=gen) + 0.5,
               torch.rand(b, generator=gen) - 0.5)
              for a, b in zip(dims[:-1], dims[1:])]
    flat, couts, cout_last = pack_layers(layers, cin0, "cpu")
    assert all(c % 32 == 0 and c - 32 < w for c, w in zip(couts, widths))
    assert cout_last == widths[-1]
    h0 = torch.rand(50, cin0, generator=gen) - 0.5
    h, ref, off, cin = h0, h0, 0, cin0
    for cout, lay in zip(couts, layers):
        k = flat[off:off + cin * cout].reshape(cin, cout)
        b, g, s = flat[off + cin * cout:off + (cin + 3) * cout].reshape(3,
                                                                       cout)
        off += (cin + 3) * cout
        h = torch.relu(h @ k + b) * g + s
        ref = torch.relu(ref @ lay[0] + lay[1]) * lay[2] + lay[3]
        cin = cout
    assert off == flat.numel()
    torch.testing.assert_close(h[:, :cout_last], ref, rtol=0, atol=1e-6)
    assert bool((h[:, cout_last:] == 0).all())


def test_sa_kernel_wrapper_refuses_cpu_tensors():
    x, pos, centers, idx, mask, layers = _rand_case(1, 1, 64, 8, 8, 3, (8,))
    before = _build.LAUNCHES["sa"]
    with pytest.raises(ValueError, match="CUDA"):
        sa_cuda(*_torch_args(x, pos, centers, idx, mask, layers))
    assert _build.LAUNCHES["sa"] == before
    assert not _build._LIBS.get("sa")
