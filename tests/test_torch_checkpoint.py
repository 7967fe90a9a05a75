"""The port's checkpoint loader (core/checkpoint.py, core/builders.py) on a
JAX checkpoint exported to the reference's Lightning format by
tools/export_checkpoint.py: the state_dict must equal
core/weights.state_dict_from_jax exactly, the config must equal the tiny
test configuration, and save -> load must round-trip exactly."""
import pathlib
import sys

import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_port_util as pu  # noqa: E402

from garmentnets_tpu.core.builders import pipeline_hparams as jax_hparams  # noqa: E402
from garmentnets_tpu.core.checkpoint import save_checkpoint  # noqa: E402
from garmentnets_tpu_torch.core import builders  # noqa: E402
from garmentnets_tpu_torch.core.checkpoint import (  # noqa: E402
    load_pipeline_checkpoint, save_pipeline_checkpoint)
from garmentnets_tpu_torch.core.weights import state_dict_from_jax  # noqa: E402
from tools import convert_checkpoint, export_checkpoint  # noqa: E402


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    variables = pu.jax_variables()
    d = tmp_path_factory.mktemp("ckpt")
    save_checkpoint(d / "jax.msgpack", {
        "params": variables["params"],
        "batch_stats": variables["batch_stats"], "step": 0},
        hparams=jax_hparams(pu.jax_cfg()))
    export_checkpoint.main(str(d / "jax.msgpack"), str(d / "port.ckpt"))
    return variables, d / "port.ckpt"


def _assert_same_state(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


def test_exported_checkpoint_loads_exactly(exported):
    variables, path = exported
    cfg, sd = load_pipeline_checkpoint(path)
    assert cfg == pu.torch_cfg()
    _assert_same_state(sd, state_dict_from_jax(variables))


def test_save_load_round_trip(exported, tmp_path):
    _, path = exported
    cfg, sd = load_pipeline_checkpoint(path)
    save_pipeline_checkpoint(tmp_path / "again.ckpt", cfg, sd)
    cfg2, sd2 = load_pipeline_checkpoint(tmp_path / "again.ckpt", "cpu")
    assert cfg2 == cfg
    _assert_same_state(sd2, sd)


def test_released_checkpoint_logging_keys_are_dropped(exported, tmp_path):
    """A released reference checkpoint also carries logging keys (at the
    top level and in pointnet2_params) and training-only hparams; the
    loader drops them as tools/convert_checkpoint.py does."""
    _, path = exported
    ckpt = torch.load(path, weights_only=True)
    hp = dict(ckpt["hyper_parameters"])
    hp["pointnet2_params"] = dict(hp["pointnet2_params"], batch_size=16,
                                  vis_per_items=4)
    hp.update(batch_size=16, max_vis_per_epoch_train=2,
              max_vis_per_epoch_val=2, vis_per_items=4)
    assert builders.clean_hparams(hp) == \
        convert_checkpoint._pipeline_hparams_from_torch(hp)
    ckpt["hyper_parameters"] = hp
    torch.save(ckpt, tmp_path / "released.ckpt")
    cfg, _ = load_pipeline_checkpoint(tmp_path / "released.ckpt")
    assert cfg == pu.torch_cfg()


@pytest.mark.parametrize("key,value", [
    ("volume_task_space", True), ("mc_surface_loss_weight", 1.0),
    ("volume_classification", True)])
def test_unported_variants_raise(key, value):
    hp = dict(jax_hparams(pu.jax_cfg()), **{key: value})
    with pytest.raises(NotImplementedError, match=key):
        builders.pipeline_config_from_hparams(hp)


def test_checkpoint_without_hparams_raises(tmp_path):
    torch.save({"state_dict": {}}, tmp_path / "bare.ckpt")
    with pytest.raises(ValueError, match="hyper_parameters"):
        load_pipeline_checkpoint(tmp_path / "bare.ckpt")
