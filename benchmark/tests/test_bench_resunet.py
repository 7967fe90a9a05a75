"""The residual U-Net's cell (train2-resunet-b24, drivers/train_residual.py):
the reader of its transposed convolutions' device time, the manifest, the
U-Net's gradient error, the first training step against the plain
reference at a small size on the CPU, a program that builds another
U-Net refused at set-up, and on a card both controls and every planted
fault not correct."""
import sys
import time
import types

import pytest
import torch

from benchmark.harness import cell, flops, manifest
from benchmark.harness.trace import Trace
from benchmark.tests.small import small_cell
from garmentnets_tpu_torch import core
from garmentnets_tpu_torch.core import trace as program_trace

CELL = "train2-resunet-b24"
METRIC = "unet_upsample_device_ms.train"
SEED = 2 ** 31 + 23


@pytest.fixture(autouse=True)
def _flops_restored(monkeypatch):
    """The residual driver's set-up installs its count for the process;
    each test here gives flops.py its own function back."""
    monkeypatch.setattr(flops, "train_sample", flops.train_sample)


def _ctx(steps=2):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench/window",
           "ts": 0, "dur": 200, "tid": 1}]
    return types.SimpleNamespace(trace_data=Trace(ev), steps=steps,
                                 notes={})


def test_upsample_reader_sums_both_directions_over_the_steps(monkeypatch):
    totals = {"unet3d/forward": (9.0, 2), "unet3d/upsample": (8.0, 8),
              "unet3d/upsample_backward": (14.0, 8)}
    monkeypatch.setattr(program_trace, "device_ms", lambda: dict(totals))
    assert manifest.reader(METRIC)(_ctx()) == pytest.approx(11.0)
    del totals["unet3d/upsample_backward"]
    assert manifest.reader(METRIC)(_ctx()) == pytest.approx(4.0)
    del totals["unet3d/upsample"]
    assert manifest.reader(METRIC)(_ctx()) is None
    assert manifest.reader(METRIC)(
        types.SimpleNamespace(notes={}, steps=3)) is None


def test_upsample_reader_of_a_program_without_the_timers(monkeypatch):
    monkeypatch.setattr(program_trace, "device_ms",
                        lambda: {"unet3d/upsample": (20.0, 8)})
    monkeypatch.delattr(core, "trace")
    monkeypatch.setitem(sys.modules, "garmentnets_tpu_torch.core.trace",
                        None)
    assert manifest.reader(METRIC)(_ctx()) is None


def test_manifest_with_the_residual_cell():
    bench = manifest.load()
    assert manifest.problems(bench) == []
    layer = {m["name"] for m in manifest.metrics_of(bench, CELL, True)}
    assert {METRIC, "mfu.train", "unet_forward_device_ms.train",
            "unet_backward_device_ms.train"} <= layer


def test_reference_reads_every_weight_of_the_port_residual_unet():
    from benchmark.drivers import train
    from benchmark.reference import residual_unet as R
    bench = manifest.load()
    cfg = manifest.config_of(bench, manifest.cell(bench, CELL))
    model, _ = train._model(cfg, 2, "cpu")
    unet = {k for k in model.state_dict() if k.startswith(R.BASE)}
    assert sorted(R.state_names(5)) == sorted(unet)


def test_unet_grad_error_reads_the_worst_unet_leaf():
    from benchmark.drivers.train_residual import unet_grad_error
    from benchmark.reference.residual_unet import BASE
    ref = {BASE + "a": torch.tensor([3.0, 4.0]),        # norm 5
           BASE + "b": torch.tensor([0.0, 1.0]),        # norm 1
           BASE + "c": torch.tensor([0.0, 2.0]),        # norm 2, the median
           "volume_agg.w": torch.tensor([1.0])}
    got = dict(ref)
    assert unet_grad_error(ref, got) == 0.0
    got["volume_agg.w"] = torch.tensor([9.0])           # not a U-Net leaf
    assert unet_grad_error(ref, got) == 0.0
    got[BASE + "a"] = torch.tensor([3.0, 4.5])
    assert unet_grad_error(ref, got) == pytest.approx(0.1)
    got[BASE + "b"] = torch.tensor([0.0, 0.0])          # over the median's
    assert unet_grad_error(ref, got) == pytest.approx(0.5)


def _small() -> dict:
    """small_cell with the U-Net's widths and grid cut as well."""
    kw = small_cell(CELL)
    c = kw["config"]["conv_implicit_model"]
    c["unet3d_params"].update(f_maps=4, num_levels=3, num_groups=2,
                              in_channels=16, out_channels=16)
    c["volume_agg_params"].update(grid_shape=[8, 8, 8],
                                  nn_channels=[137, 32, 16])
    for k in ("volume_decoder_params", "surface_decoder_params",
              "mc_surface_decoder_params"):
        c[k]["nn_channels"] = [16, 32, c[k]["nn_channels"][-1]]
    return kw


@pytest.fixture
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_first_step_agrees_with_the_port_on_the_cpu(_threads):
    kw = _small()
    numbers = {}
    cell.run(manifest.load(), CELL, SEED, 1.0, False, time.perf_counter(),
             numbers_out=numbers, **kw)
    for k in ("loss1_gap", "unet_grad_error", "stage1_nocs_gap_mean",
              "stage1_feature_gap"):
        assert numbers[k] <= kw["limits"][k], (k, numbers[k])


def test_a_program_with_another_unet_fails_at_setup(monkeypatch, _threads):
    """The parent program ignores `unet3d_params.name` and builds UNet3D:
    set-up stops before a weight is made."""
    from garmentnets_tpu_torch.models import pipeline, unet3d
    monkeypatch.setitem(pipeline.UNETS, "ResidualUNet3D", unet3d.UNet3D)
    kw = _small()
    with pytest.raises(KeyError, match="basic_module.conv1"):
        cell.run(manifest.load(), CELL, SEED, 1.0, False,
                 time.perf_counter(), **kw)


@pytest.mark.cuda
def test_control_and_faults_fail_on_a_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    from benchmark.tools import readings_residual
    kw = _small()
    got = readings_residual.control_train(kw["config"], kw["traffic"], SEED,
                                          "cuda")
    for kind in ("control_tf32", "control_tf32_stage2", "fault_half_batch",
                 "fault_state_unchanged",
                 "fault_update_reversed", "fault_stats_frozen",
                 "fault_residual_left_out", "fault_upsample_reversed"):
        assert not cell.decide(got[kind], kw["limits"])[1], kind
