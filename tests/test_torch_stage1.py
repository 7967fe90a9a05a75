"""Stage 1 (PointNet++ NOCS) of the port vs the JAX pipeline's
pointnet2_forward, with the same weights carried by core/weights.py. NOCS
bins must be identical; logits and confidence within the golden test's bar
(rtol 1e-3, atol 2e-4)."""
import pathlib
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_port_util as pu  # noqa: E402

from garmentnets_tpu.models.pipeline import ConvImplicitWNFPipeline  # noqa: E402


@pytest.fixture(scope="module")
def both():
    variables = pu.jax_variables()
    x = pu.inputs()
    model = ConvImplicitWNFPipeline(pu.jax_cfg())
    ref = jax.jit(lambda v, a, b: model.apply(
        v, a, b, method=ConvImplicitWNFPipeline.pointnet2_forward))(
            variables, jnp.asarray(x["x"]), jnp.asarray(x["pos"]))
    with torch.no_grad():
        ours = pu.torch_model(variables).pointnet2_forward(
            torch.from_numpy(x["x"]), torch.from_numpy(x["pos"]))
    return ours, ref


@pytest.mark.parametrize("key", ["per_point_logits", "global_logits",
                                 "per_point_features", "global_feature"])
def test_stage1_outputs_match(both, key):
    ours, ref = both
    np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]),
                               rtol=1e-3, atol=2e-4)


def test_stage1_nocs_bins_identical(both):
    ours, ref = both
    np.testing.assert_array_equal(ours["nocs_data"]["pos"].numpy(),
                                  np.asarray(ref["nocs_data"]["pos"]))


def test_stage1_confidence_matches(both):
    ours, ref = both
    np.testing.assert_allclose(
        ours["nocs_data"]["pred_confidence"].numpy(),
        np.asarray(ref["nocs_data"]["pred_confidence"]),
        rtol=1e-3, atol=2e-4)
