"""Stage 2 on the residual U-Net (`conv_implicit_model.unet3d_params.name:
ResidualUNet3D`) through the port's normal path, held to the benchmark's
plain reference (benchmark/reference/residual_unet.py) on the CPU in
float64 at a small size (f_maps 4, 3 levels, an 8^3 grid, B=2, 256
points): the loss and every trained leaf's gradient, and one step of
make_train_fns with Adam. Both sides start from the same seeded weights
and the port's own frozen stage-1 answers, as the benchmark's check does.
Also the config key's round trip through the builders and a checkpoint,
PredictEngine's encode on the CPU, and the operation counts of the
benchmark's yardstick (benchmark/harness/flops.py, flops_residual.py).

float64 bars: F64_REL of each tensor's largest entry, as the JAX float64
parity tests. The frozen stage 1's FPS and ball query choose on the
positions rounded to float32 (the port's ball query works in float32),
and both sides compute the aggregator's cell centres in float32.
"""
import copy

import numpy as np
import pytest
import torch

from benchmark.harness import flops, flops_residual, manifest, weights
from benchmark.harness import traffic as gen
from benchmark.reference import model as M
from benchmark.reference import residual_unet as R
from benchmark.reference import train as ref_train
from garmentnets_tpu_torch.core.builders import (
    build_pipeline_config, build_pointnet2_config,
    pipeline_config_from_hparams, pipeline_hparams)
from garmentnets_tpu_torch.core.config import load_config
from garmentnets_tpu_torch.core.checkpoint import (
    load_pipeline_checkpoint, save_pipeline_checkpoint)
from garmentnets_tpu_torch.harness.predict_engine import PredictEngine
from garmentnets_tpu_torch.harness.training import make_adam, make_train_fns
from garmentnets_tpu_torch.models import pointnet2 as port_p2
from garmentnets_tpu_torch.models.pipeline import (
    ConvImplicitWNFPipeline, PipelineConfig, pipeline_loss)
from garmentnets_tpu_torch.models.unet3d import ResidualUNet3D, UNet3D

CELL = "train2-resunet-b24"
SEED = 2 ** 31 + 11
F64_REL = 1e-9


def small_config() -> dict:
    """The cell's configuration with its widths, grid and batch cut."""
    bench = manifest.load()
    cfg = copy.deepcopy(manifest.config_of(bench, manifest.cell(bench, CELL)))
    cfg["model"].update(feature_dim=16, nocs_bins=8, sa1_r=0.2, sa2_r=0.4)
    c = cfg["conv_implicit_model"]
    c["volume_agg_params"].update(grid_shape=[8, 8, 8],
                                  nn_channels=[25, 32, 16])
    c["unet3d_params"].update(in_channels=16, out_channels=16, f_maps=4,
                              num_levels=3, num_groups=2)
    for k in ("volume_decoder_params", "surface_decoder_params",
              "mc_surface_decoder_params"):
        c[k]["nn_channels"] = [16, 32, c[k]["nn_channels"][-1]]
    cfg["datamodule"].update(batch_size=2, num_pc_sample=256,
                             num_volume_sample=128, num_surface_sample=128)
    return cfg


@pytest.fixture(scope="module")
def small():
    cfg = small_config()
    pipe = build_pipeline_config(cfg["conv_implicit_model"],
                                 build_pointnet2_config(cfg["model"]))
    model = ConvImplicitWNFPipeline(pipe)
    model.pointnet2_nocs.requires_grad_(False)
    state = {k: v.double() if v.is_floating_point() else v for k, v in
             weights.seeded_state(weights.state_spec(model), SEED,
                                  "cpu").items()}
    dm = cfg["datamodule"]
    bench = manifest.load()
    tr = manifest.traffic_of(manifest.cell(bench, CELL))
    batch = gen.train_batches(
        dict(tr, batches=1, points=dm["num_pc_sample"],
             volume_samples=dm["num_volume_sample"],
             surface_samples=dm["num_surface_sample"]),
        dm["batch_size"], SEED)[0]
    batch = {k: v.astype(np.float64) for k, v in batch.items()}
    return cfg, pipe, state, batch


@pytest.fixture
def f32_choices(monkeypatch):
    bq, fps = port_p2.ball_query, port_p2.furthest_point_sampling
    monkeypatch.setattr(port_p2, "ball_query", lambda p, c, r, **kw: bq(
        p.float(), c.float(), r, **kw))
    monkeypatch.setattr(port_p2, "furthest_point_sampling",
                        lambda p, n: fps(p.float(), n))


def _port(pipe, state):
    """The port's float64 pipeline from `state`, and a list that its frozen
    stage 1's answers are appended to at each forward."""
    model = ConvImplicitWNFPipeline(pipe).double()
    model.load_state_dict(state)
    model.pointnet2_nocs.requires_grad_(False)
    s1 = []
    model.pointnet2_nocs.register_forward_hook(
        lambda mod, args, out: s1.append(
            {"features": out["per_point_features"].detach(),
             "logits": out["per_point_logits"].detach()}))
    return model, s1


def _close(got, want, what):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= F64_REL * max(scale, 1e-30), (what, err, scale)


def test_residual_stage2_loss_and_gradients_match_the_reference(
        small, f32_choices):
    cfg, pipe, state, batch = small
    assert pipe.unet_name == "ResidualUNet3D"
    model, s1 = _port(pipe, state)
    assert isinstance(model.unet_3d, ResidualUNet3D)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    model.train()
    loss = pipeline_loss(pipe, model(b), b)["loss"]
    names = [k for k, p in model.named_parameters() if p.requires_grad]
    got = dict(zip(names, torch.autograd.grad(
        loss, [p for p in model.parameters() if p.requires_grad])))
    p = {k: v.clone() for k, v in state.items()}
    for k in names:
        p[k].requires_grad_(True)
    c = cfg["conv_implicit_model"]
    un = c["unet3d_params"]
    with R.in_reference():
        ref, _ = M.stage2_forward_loss(
            p, {"pointnet2": cfg["model"], **c}, b,
            c["volume_agg_params"]["grid_shape"][0], un["num_groups"],
            un["num_levels"], True, {}, s1[0])
    want = dict(zip(names, torch.autograd.grad(ref, [p[k] for k in names])))
    assert abs(float(loss.detach()) - float(ref.detach())) <= 1e-12 * abs(
        float(ref.detach()))
    assert any(".upsampling.upsample." in k for k in names)
    for k in names:
        _close(got[k], want[k], k)


def test_one_train_step_with_adam_matches_the_reference(small,
                                                        f32_choices):
    cfg, pipe, state, batch = small
    model, s1 = _port(pipe, state)
    trainable = [k for k, p in model.named_parameters() if p.requires_grad]
    opt = make_adam(model, pipe.learning_rate)
    step, _ = make_train_fns(
        model, lambda b, g: model(b), lambda o, b: pipeline_loss(pipe, o, b),
        opt)
    tf32 = []           # cuDNN's flag as each transposed conv runs, each way

    def seen(mod, args, out):
        tf32.append(torch.backends.cudnn.allow_tf32)
        out.register_hook(lambda g: tf32.append(
            torch.backends.cudnn.allow_tf32))

    for dec in model.unet_3d.abstract_3d_unet.decoders:
        dec.upsampling.upsample.register_forward_hook(seen)
    step({k: torch.from_numpy(v) for k, v in batch.items()})
    assert tf32 == [False] * 4
    with R.in_reference():
        ref = ref_train.steps(state, trainable, cfg, 2, [batch], 0, "cpu",
                              stage1_in=s1)
    got = model.state_dict()
    for k, want in ref["final"].items():
        if not want.is_floating_point():
            assert torch.equal(got[k], want), k
            continue
        d_got, d_want = got[k] - state[k], want - state[k]
        g = ref["grad1"].get(k)
        if g is None:                   # a running statistic
            _close(d_got, d_want, k)
            continue
        # a gradient that is 0 in exact arithmetic (a bias before a
        # BatchNorm) is rounding noise, which Adam's eps scales down to a
        # step far under lr on both sides; the rest take the float64 bar
        noise = g.abs() <= 1e-12 * g.abs().max()
        assert bool((d_got[noise].abs() <= 1e-3 * pipe.learning_rate).all()), k
        _close(d_got[~noise], d_want[~noise], k)


def test_unet_name_round_trips_and_the_default_hparams_are_unchanged(small):
    cfg, pipe, _, _ = small
    hp = pipeline_hparams(pipe)
    assert hp["unet3d_params"]["name"] == "ResidualUNet3D"
    assert pipeline_config_from_hparams(hp) == pipe
    default = pipeline_hparams(PipelineConfig())
    assert default["unet3d_params"] == {
        "in_channels": 128, "out_channels": 128, "f_maps": 32,
        "layer_order": "gcr", "num_groups": 8, "num_levels": 4}
    assert pipeline_config_from_hparams(default) == PipelineConfig()
    assert isinstance(ConvImplicitWNFPipeline(
        pipeline_config_from_hparams(default)).unet_3d, UNet3D)
    cli = load_config("train_pipeline_default", [
        "conv_implicit_model.unet3d_params.name=ResidualUNet3D"])
    assert build_pipeline_config(     # as harness/train_pipeline.py builds
        cli["conv_implicit_model"],
        build_pointnet2_config({})).unet_name == "ResidualUNet3D"
    bad = copy.deepcopy(cfg["conv_implicit_model"])
    bad["unet3d_params"]["name"] = "UNet2D"
    with pytest.raises(ValueError, match=r"unet3d_params\.name='UNet2D'"):
        build_pipeline_config(bad, build_pointnet2_config(cfg["model"]))


def test_checkpoint_rebuilds_the_residual_pipeline_and_encodes(small,
                                                               tmp_path):
    _, pipe, state, batch = small
    path = tmp_path / "resunet.ckpt"
    save_pipeline_checkpoint(path, pipe, {
        k: v.float() if v.is_floating_point() else v
        for k, v in state.items()})
    cfg2, sd = load_pipeline_checkpoint(path)
    assert cfg2 == pipe
    eng = PredictEngine(cfg2, sd, volume_size=8, mc_threads=1, device="cpu")
    assert isinstance(eng.model.unet_3d, ResidualUNet3D)
    enc = eng.encode(batch["x"].astype(np.float32),
                     batch["pos"].astype(np.float32))
    vol = enc["feature_volume"]
    assert vol.shape == (2, 8, 8, 8, 16) and bool(torch.isfinite(vol).all())


def _cell_sample(name: str, count=flops_residual.DEFAULT) -> float:
    bench = manifest.load()
    cell = manifest.cell(bench, name)
    cfg = manifest.config_of(bench, cell)
    dm = cfg["datamodule"]
    return count(cfg, manifest.traffic_of(cell)["stage"],
                 dm["num_pc_sample"], dm["num_volume_sample"],
                 dm["num_surface_sample"])


def test_operation_counts():
    """The two accepted cells' counts as they were before the residual
    count existed, through flops.py's function and the one that
    flops_residual.install() puts in its place; the residual U-Net
    against a closed form (2.18 TFLOP of forward convolutions at B=24)."""
    for count in (flops_residual.DEFAULT, flops_residual.train_sample):
        assert _cell_sample("train1-b8", count) == 47644351002.0
        assert _cell_sample("train2-b24", count) == 176061782046.0
    # one level, 1 -> 2 channels on a 2^3 grid, then the 1x1x1 conv to 3
    w = flops_residual.residual_unet3d(1, 1, 3, 2, 1, 2)
    assert w.tc == 2 * 27 * (1 * 2 + 2 * 2 + 2 * 2) * 8 + 2 * 2 * 3 * 8
    assert w.cc == ((8 + 2) + 9 * 2 + 8 * 2 + 2 * 2) * 8 + 3 * 8
    # the published widths: 27 products a voxel and channel pair, the
    # transposed convolutions over their input voxels
    ch = [64 * 2 ** i for i in range(5)]
    vox = [24 * (32 >> i) ** 3 for i in range(5)]
    conv = sum(v * (cin * c + 2 * c * c) for v, cin, c in
               zip(vox, [128] + ch[:-1], ch))
    conv += sum(vox[i + 1] * ch[i + 1] * ch[i] + vox[i] * 3 * ch[i] ** 2
                for i in range(4))
    tc = 2 * 27 * conv + 2 * 64 * 128 * vox[0]
    w = flops_residual.residual_unet3d(24, 128, 128, 64, 5, 32)
    assert w.tc == tc and round(tc / 1e12, 2) == 2.18
    per = _cell_sample(CELL, flops_residual.train_sample)
    unet = flops_residual.residual_unet3d(1, 128, 128, 64, 5, 32).flops
    double = flops.unet3d(1, 128, 128, 64, 5, 32).flops
    assert per == pytest.approx(_cell_sample(CELL) + 3 * (unet - double))
