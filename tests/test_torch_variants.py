"""The inference model variants of the port's engine against the JAX
PredictEngine at HIGHEST, on the tiny configuration of torch_port_util with
each variant's overrides (`pu.VARIANTS`) and the same JAX-initialized
weights, carried by core/weights.py, whose volume-decoder head puts ~10% of
the voxels above the iso level:

- the mc-surface (hole) head with use_hole_prediction: its logits are a
  fifth warp channel;
- the task-space volume, with the same sim AABB on both sides;
- each of the aggregator's include flags off (its first width shrinks);
- volume_classification, which changes only the training loss.

Encode outputs are held within tests/test_torch_engine.py's bars, meshes as
in tests/test_torch_predict.py (identical faces, at most 1% of the vertices
moved by an int8 brick rounding), and the warp channels at the port's
vertices within the F16_TOL of the warp field there (the JAX engine returns
every warp channel as f16); is_on_surface (logits > 0) is equal at every
vertex whose position agrees. The checkpoint round trip keeps every
variant key."""
import copy
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_port_util as pu  # noqa: E402

from garmentnets_tpu.core.builders import pipeline_hparams as jax_hparams  # noqa: E402
from garmentnets_tpu.harness.predict_engine import (  # noqa: E402
    PredictEngine as JaxEngine)
from garmentnets_tpu_torch.core import builders  # noqa: E402
from garmentnets_tpu_torch.core.checkpoint import (  # noqa: E402
    load_pipeline_checkpoint, save_pipeline_checkpoint)
from garmentnets_tpu_torch.core.weights import state_dict_from_jax  # noqa: E402
from garmentnets_tpu_torch.harness.predict_engine import PredictEngine  # noqa: E402

F16_TOL = dict(rtol=2e-3, atol=1e-3)
ENCODE_TOL = {
    "global_logits": dict(rtol=1e-3, atol=2e-4),
    "global_feature": dict(rtol=1e-3, atol=2e-4),
    "feature_volume": dict(rtol=1e-3, atol=5e-4),
    "wnf_volume": dict(rtol=1e-3, atol=5e-4),
    "wnf_ggm": dict(rtol=1e-3, atol=5e-4),
    "per_point_logits": F16_TOL,
    "pred_nocs_confidence": F16_TOL,
}


def _engine_kw(name):
    return dict(use_hole_prediction=name == "holes",
                task_aabb=pu.TASK_AABB if name == "task_space" else None)


# rows of the aggregator's first layer: point features, then the point's
# offset in its cell and the sim point (include_point_feature), then the
# confidence (include_confidence_feature)
_DROPPED_ROWS = {"no_point_feature": slice(pu.FEAT, pu.FEAT + 6),
                 "no_confidence_feature": slice(pu.FEAT + 6, pu.FEAT + 9)}


@pytest.fixture(scope="module")
def base_variables():
    return pu.jax_variables()


def variant_variables(base: dict, name: str) -> dict:
    """The JAX variables of a variant, from the tiny configuration's (one
    JAX init serves every variant): an include flag off drops its rows of
    the aggregator's first layer; the hole head is a scaled copy of the
    volume decoder, whose widths it shares; task space and classification
    have the base weights."""
    v = copy.deepcopy(base)
    if name in _DROPPED_ROWS:
        dense = v["params"]["volume_agg"]["local_nn"]["dense_0"]
        keep = np.ones(len(dense["kernel"]), bool)
        keep[_DROPPED_ROWS[name]] = False
        dense["kernel"] = dense["kernel"][keep]
    if name == "holes":
        head = copy.deepcopy(v["params"]["volume_decoder"])
        for layer in head["mlp"].values():
            for k in layer:
                layer[k] = layer[k] * np.float32(-1.5)
        v["params"]["mc_surface_decoder"] = head
        v["batch_stats"]["mc_surface_decoder"] = copy.deepcopy(
            v["batch_stats"]["volume_decoder"])
    return v


@pytest.fixture(scope="module", params=sorted(pu.VARIANTS))
def run(request, base_variables):
    name = request.param
    over = pu.VARIANTS[name]
    x = pu.inputs()
    jcfg, tcfg = pu.jax_cfg(**over), pu.torch_cfg(**over)
    if tcfg.has_mc_surface_decoder:
        assert (tcfg.mc_surface_decoder_channels
                == tcfg.volume_decoder_channels)
    variables = pu.live_head(variant_variables(base_variables, name),
                             x["x"], x["pos"], pu.VOL, cfg=tcfg,
                             **_engine_kw(name))
    jeng = JaxEngine(jcfg, variables, volume_size=pu.VOL, return_volume=True,
                     precision=jax.lax.Precision.HIGHEST,
                     **_engine_kw(name))
    teng = PredictEngine(tcfg, state_dict_from_jax(variables),
                         volume_size=pu.VOL, return_volume=True,
                         decode_precision="highest", mc_threads=1,
                         device="cpu", **_engine_kw(name))
    jenc = jeng.encode(x["x"], x["pos"])
    tenc = teng.encode(x["x"], x["pos"])
    jm, tm = jeng.extract_meshes(jenc), teng.extract_meshes(tenc)
    # the warp of both engines at the port's vertices
    jw, tw = jeng.warp_batch(jenc, tm), teng.warp_batch(tenc, tm)
    yield dict(name=name, tcfg=tcfg, jcfg=jcfg, variables=variables,
               jeng=jeng, teng=teng, jenc=jenc, tenc=tenc, jm=jm, tm=tm,
               jw=jw, tw=tw)
    teng.close()


def test_variant_config_matches_jax(run):
    """The JAX checkpoint hparams of the variant build the port's config,
    and the port's model holds exactly the JAX variables' weights."""
    assert builders.pipeline_config_from_hparams(
        jax_hparams(run["jcfg"])) == run["tcfg"]
    sd = run["teng"].model.state_dict()
    assert sorted(sd) == sorted(state_dict_from_jax(run["variables"]))
    assert ("mc_surface_decoder.mlp.0.0.weight" in sd) == (
        run["name"] == "holes")
    first = run["teng"].model.volume_agg.local_nn[0][0].weight.shape[1]
    assert first == run["tcfg"].volume_agg_nn_channels[0]


def test_encode_nocs_identical(run):
    """Identical NOCS bins; in task space, the sim points rescaled by the
    AABB within 1e-7, about one f32 step below 1 (XLA's CPU code for
    pos * scale + offset rounds some of them differently from torch's)."""
    ours = run["tenc"]["pred_nocs"].numpy()
    ref = np.asarray(run["jenc"]["pred_nocs"])
    if run["name"] == "task_space":
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-7)
        scale, offset = run["teng"].model.get_aabb_scale_offset(
            torch.from_numpy(pu.TASK_AABB[None]))
        np.testing.assert_allclose(
            ours, pu.inputs()["pos"] * scale.numpy() + offset.numpy(),
            rtol=0, atol=1e-7)
    else:
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("key", sorted(ENCODE_TOL))
def test_encode_outputs_match(run, key):
    ours = run["tenc"][key].numpy()
    ref = np.asarray(run["jenc"][key]).astype(np.float32)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, **ENCODE_TOL[key])


def _moved(jm, tm):
    return np.abs(jm[0] - tm[0]).max(1) > 1e-4


def test_meshes_match(run):
    """Both engines find a surface in every garment; identical faces and
    vertices within 1e-4 but for at most 1% moved by an int8 brick
    value's rounding, each within one lattice step."""
    for jm, tm in zip(run["jm"], run["tm"]):
        assert jm is not None and tm is not None and len(tm[0]) > 20
        np.testing.assert_array_equal(tm[1], jm[1])
        assert _moved(jm, tm).mean() <= 0.01
        assert np.abs(tm[0] - jm[0]).max() <= 1.0 / (pu.VOL - 1)


def test_warp_channels_match(run):
    """warp_field and verts_ggm (and the mc-surface logits with hole
    prediction) within F16_TOL at the same vertices; the logits' channel
    exactly when the variant has the head."""
    holes = run["name"] == "holes"
    assert run["teng"].use_hole_prediction == holes
    for o, r, m in zip(run["tw"], run["jw"], run["tm"]):
        assert sorted(o) == sorted(r)
        assert ("mc_surface_logits" in o) == holes
        for k in o:
            assert len(o[k]) == len(m[0])
            np.testing.assert_allclose(o[k], r[k].astype(np.float32),
                                       **F16_TOL, err_msg=k)


def test_is_on_surface_equal_where_meshes_agree(run):
    """With the head, logits > 0 equal at every vertex whose position
    agrees, and both on and off somewhere; without it, no logits."""
    if run["name"] != "holes":
        assert not any("mc_surface_logits" in o for o in run["tw"])
        return
    n_on = 0
    for o, r, jm, tm in zip(run["tw"], run["jw"], run["jm"], run["tm"]):
        keep = ~_moved(jm, tm)
        ours = o["mc_surface_logits"] > 0
        np.testing.assert_array_equal(
            ours[keep], r["mc_surface_logits"].astype(np.float32)[keep] > 0)
        n_on += int(ours.sum())
    total = sum(len(m[0]) for m in run["tm"])
    assert 0 < n_on < total          # the head says both on and off


def test_checkpoint_round_trip_keeps_variant(run, tmp_path):
    tcfg = run["tcfg"]
    save_pipeline_checkpoint(tmp_path / "v.ckpt", tcfg,
                             run["teng"].model.state_dict())
    cfg, sd = load_pipeline_checkpoint(tmp_path / "v.ckpt")
    assert cfg == tcfg
    hp = builders.pipeline_hparams(cfg)
    jhp = jax_hparams(run["jcfg"])
    for key in ("mc_surface_loss_weight", "volume_classification",
                "volume_task_space", "mc_surface_decoder_params"):
        assert hp[key] == jhp[key], key
    for key in ("include_point_feature", "include_confidence_feature",
                "nn_channels"):
        assert hp["volume_agg_params"][key] == \
            jhp["volume_agg_params"][key], key
    PredictEngine(cfg, sd, volume_size=pu.VOL, mc_threads=1, device="cpu",
                  **_engine_kw(run["name"])).close()


def test_task_space_needs_the_aabb(run):
    """A task-space configuration refuses to build without the AABB; the
    others build without one."""
    def build():
        PredictEngine(run["tcfg"], run["teng"].model.state_dict(),
                      volume_size=pu.VOL, mc_threads=1,
                      device="cpu").close()
    if run["name"] == "task_space":
        with pytest.raises(ValueError, match="task_aabb"):
            build()
    else:
        build()


def test_hole_prediction_needs_the_head(run):
    """use_hole_prediction is on only for a configuration with the head,
    as in the JAX engine."""
    eng = PredictEngine(run["tcfg"], run["teng"].model.state_dict(),
                        volume_size=pu.VOL, mc_threads=1, device="cpu",
                        **dict(_engine_kw(run["name"]),
                               use_hole_prediction=True))
    assert eng.use_hole_prediction == run["tcfg"].has_mc_surface_decoder
    eng.close()
