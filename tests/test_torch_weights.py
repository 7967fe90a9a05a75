"""core/weights.py vs tools/export_checkpoint.export_state: the port's
state_dict from a JAX variables tree is the reference Lightning layout, key
for key and value for value, and loads into the port's modules strictly."""
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import export_checkpoint  # noqa: E402
import torch_port_util as pu  # noqa: E402

from garmentnets_tpu_torch.core.weights import (  # noqa: E402
    numpy_state_from_jax, state_dict_from_jax)


@pytest.fixture(scope="module")
def variables():
    return pu.jax_variables()


def test_pipeline_state_matches_export_state(variables):
    ours = numpy_state_from_jax(variables)
    ref = export_checkpoint.export_state(variables)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].shape == np.shape(ref[k]), k
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)


def test_stage1_state_matches_export_state(variables):
    sub = {"params": variables["params"]["pointnet2_nocs"],
           "batch_stats": variables["batch_stats"]["pointnet2_nocs"]}
    ours = numpy_state_from_jax(sub)
    ref = export_checkpoint.export_state(sub)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)


def test_port_modules_load_state_strictly(variables):
    from garmentnets_tpu_torch.models.pipeline import (
        ConvImplicitWNFPipeline)
    model = ConvImplicitWNFPipeline(pu.torch_cfg())
    sd = state_dict_from_jax(variables)
    assert sorted(model.state_dict()) == sorted(sd)
    model.load_state_dict(sd, strict=True)
    w = model.volume_decoder.mlp[0][0].weight.detach().numpy()
    k = variables["params"]["volume_decoder"]["mlp"]["dense_0"]["kernel"]
    np.testing.assert_array_equal(w, np.asarray(k).T)
    conv = model.unet_3d.abstract_3d_unet.encoders[0].basic_module \
        .SingleConv1.conv.weight.detach().numpy()
    kc = variables["params"]["unet_3d"]["encoder_0"]["conv1"]["conv_1"][
        "kernel"]
    np.testing.assert_array_equal(conv, np.transpose(kc, (4, 3, 0, 1, 2)))
    assert model.volume_decoder.mlp[0][2].num_batches_tracked.dtype \
        == torch.int64
