"""JAX variables tree -> the port's state_dict (reference Lightning layout).

The port's modules are keyed like the reference code base's state_dict, so
released reference `.ckpt` files load with no further mapping. A JAX
variables tree of numpy arrays (`{"params", "batch_stats"}`, as flax
`model.init` and the JAX package's checkpoints give it) reaches that
layout through `state_dict_from_jax`:

  Dense kernel [in, out]            -> Linear weight [out, in]
  Conv kernel [kd, kh, kw, i, o]    -> Conv3d weight [o, i, kd, kh, kw]
  ConvTranspose kernel               -> ConvTranspose3d weight
    [kd, kh, kw, o, i] (flax's          [i, o, kd, kh, kw], no spatial
    transpose_kernel layout)             flip (flax's transpose_kernel
                                         takes torch's adjoint convention)
  scale/bias (+ batch_stats)        -> BatchNorm/GroupNorm weight/bias
                                       (+ running_mean/var,
                                       num_batches_tracked = 0)

The JAX trainer's whole state at any step (`{"params", "batch_stats",
"opt_state", "step"}`, garmentnets_tpu/harness/training.py) reaches the
port's model and torch.optim.Adam through `training_state_from_jax`:
optax.adam's first and second moments `mu` and `nu` become `exp_avg` and
`exp_avg_sq` under the same mapping, and its update count `count` becomes
`step`.
"""
from __future__ import annotations

import numpy as np
import torch


def _put_lin(sd, prefix, p):
    sd[f"{prefix}.weight"] = np.ascontiguousarray(np.asarray(p["kernel"]).T)
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _put_conv3d(sd, prefix, p):
    k = np.asarray(p["kernel"])                      # [kd,kh,kw,i,o]
    sd[f"{prefix}.weight"] = np.ascontiguousarray(
        np.transpose(k, (4, 3, 0, 1, 2)))
    if "bias" in p:
        sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _put_bn(sd, prefix, p, s):
    sd[f"{prefix}.weight"] = np.asarray(p["scale"])
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])
    sd[f"{prefix}.running_mean"] = np.asarray(s["mean"])
    sd[f"{prefix}.running_var"] = np.asarray(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)


def _put_gn(sd, prefix, p):
    sd[f"{prefix}.weight"] = np.asarray(p["scale"])
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _put_mlp(sd, prefix, params, stats):
    """PointMLP -> reference MLP Seq(Seq(Lin, ReLU, BN)) keys."""
    i = 0
    while f"dense_{i}" in params:
        _put_lin(sd, f"{prefix}.{i}.0", params[f"dense_{i}"])
        if f"bn_{i}" in params:
            _put_bn(sd, f"{prefix}.{i}.2", params[f"bn_{i}"],
                    (stats or {})[f"bn_{i}"])
        i += 1
    if i == 0:
        raise ValueError(f"no MLP layers for {prefix}")


def _pointnet2(sd, params, stats, prefix):
    for sa, name in (("sa1", "sa1_module.conv.local_nn"),
                     ("sa2", "sa2_module.conv.local_nn"),
                     ("sa3", "sa3_module.nn"),
                     ("fp3", "fp3_module.nn"), ("fp2", "fp2_module.nn"),
                     ("fp1", "fp1_module.nn")):
        _put_mlp(sd, prefix + name, params[sa]["mlp"],
                 stats.get(sa, {}).get("mlp"))
    for lin in ("lin1", "lin2", "lin3", "global_lin1", "global_lin2"):
        _put_lin(sd, prefix + lin, params[lin])


def _single_conv(sd, prefix, p, s):
    """Positional conv_i/gn_i/bn_i -> reference kind-named submodules."""
    for name, sub in p.items():
        if name.startswith("conv_"):
            _put_conv3d(sd, f"{prefix}.conv", sub)
        elif name.startswith("gn_"):
            _put_gn(sd, f"{prefix}.groupnorm", sub)
        elif name.startswith("bn_"):
            _put_bn(sd, f"{prefix}.batchnorm", sub, (s or {})[name])


def _put_conv_transpose3d(sd, prefix, p):
    k = np.asarray(p["kernel"])                      # [kd,kh,kw,o,i]
    sd[f"{prefix}.weight"] = np.ascontiguousarray(
        np.transpose(k, (4, 3, 0, 1, 2)))
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _residual_unet3d(sd, params, stats, prefix):
    """ResidualUNet3D: ExtResNetBlock conv1..conv3 and the decoders'
    transposed convolutions."""
    for kind in ("encoder", "decoder"):
        i = 0
        while f"{kind}_{i}" in params:
            bp, bs = params[f"{kind}_{i}"], stats.get(f"{kind}_{i}", {})
            base = f"{prefix}.{kind}s.{i}"
            for j in (1, 2, 3):
                _single_conv(sd, f"{base}.basic_module.conv{j}",
                             bp[f"conv{j}"], bs.get(f"conv{j}"))
            if kind == "decoder":
                _put_conv_transpose3d(sd, f"{base}.upsampling.upsample",
                                      params[f"upsample_{i}"])
            i += 1
    _put_conv3d(sd, f"{prefix}.final_conv", params["final_conv"])


def unet3d_state_from_jax(variables: dict, prefix: str) -> dict:
    """{"params"[, "batch_stats"]} of a JAX UNet3D or ResidualUNet3D ->
    reference-layout {key: numpy array} under `prefix` (the port's module
    path of its `abstract_3d_unet`)."""
    sd: dict = {}
    _unet3d(sd, variables["params"], variables.get("batch_stats", {}),
            prefix)
    return sd


def _unet3d(sd, params, stats, prefix):
    if "conv3" in params.get("encoder_0", {}):
        _residual_unet3d(sd, params, stats, prefix)
        return
    for kind in ("encoder", "decoder"):
        i = 0
        while f"{kind}_{i}" in params:
            bp, bs = params[f"{kind}_{i}"], stats.get(f"{kind}_{i}", {})
            base = f"{prefix}.{kind}s.{i}.basic_module"
            for j in (1, 2):
                _single_conv(sd, f"{base}.SingleConv{j}", bp[f"conv{j}"],
                             bs.get(f"conv{j}"))
            i += 1
    _put_conv3d(sd, f"{prefix}.final_conv", params["final_conv"])


def numpy_state_from_jax(variables: dict) -> dict:
    """{"params", "batch_stats"} of the stage-1 network or the stage-2
    pipeline -> reference-layout {key: numpy array}."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: dict = {}
    if "volume_agg" not in params:
        _pointnet2(sd, params, stats, "")
        return sd
    _pointnet2(sd, params["pointnet2_nocs"], stats.get("pointnet2_nocs", {}),
               "pointnet2_nocs.")
    _put_mlp(sd, "volume_agg.local_nn", params["volume_agg"]["local_nn"],
             stats.get("volume_agg", {}).get("local_nn"))
    _unet3d(sd, params["unet_3d"], stats.get("unet_3d", {}),
            "unet_3d.abstract_3d_unet")
    for dec in ("volume_decoder", "surface_decoder", "mc_surface_decoder"):
        if dec in params:
            _put_mlp(sd, f"{dec}.mlp", params[dec]["mlp"],
                     stats.get(dec, {}).get("mlp"))
    return sd


def state_dict_from_jax(variables: dict) -> dict:
    """The port's state_dict (torch tensors) from a JAX variables tree."""
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in numpy_state_from_jax(variables).items()}


def _adam_moments(opt_state):
    """optax.adam's ScaleByAdamState in the trainer's opt_state (the
    chain's tuple) -> (count, mu, nu)."""
    for node in opt_state:
        if all(hasattr(node, k) for k in ("count", "mu", "nu")):
            return node.count, node.mu, node.nu
    raise ValueError("no optax.adam state (count, mu, nu) in opt_state")


def training_state_from_jax(state: dict, model: torch.nn.Module,
                            optimizer: torch.optim.Optimizer) -> tuple:
    """The JAX trainer's state {"params", "batch_stats", "opt_state",
    "step"} (numpy arrays) -> (the model's state_dict, the state_dict of
    `optimizer`, a torch.optim.Adam over parameters of `model` such as
    harness/training.make_adam builds). Each parameter's Adam state is
    optax's at that step: exp_avg from mu, exp_avg_sq from nu, step from
    count; the optimizer's own hyperparameters are kept."""
    count, mu, nu = _adam_moments(state["opt_state"])
    stats = state.get("batch_stats", {})
    moments = {k: numpy_state_from_jax({"params": tree, "batch_stats": stats})
               for k, tree in (("exp_avg", mu), ("exp_avg_sq", nu))}
    names = {id(p): n for n, p in model.named_parameters()}
    step = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
    opt_sd = optimizer.state_dict()
    opt_sd["state"] = {}
    for group, saved in zip(optimizer.param_groups, opt_sd["param_groups"]):
        for p, i in zip(group["params"], saved["params"]):
            name = names[id(p)]
            opt_sd["state"][i] = {"step": step.clone(), **{
                k: torch.from_numpy(np.array(m[name], np.float32))
                for k, m in moments.items()}}
    return state_dict_from_jax(state), opt_sd
