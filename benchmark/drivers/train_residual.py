"""Stage-2 training cells whose U-Net is the residual one
(`unet3d_params.name: ResidualUNet3D`): drivers/train.py's set-up, window
and check, with the plain reference's U-Net the residual one
(reference/residual_unet.py) and the model's operations counted with it
(harness/flops_residual.py).

Set-up refuses, before any weight is made, a program whose model is not
the residual U-Net the configuration names: its state must hold every
weight the reference's U-Net reads.

The check adds one number to drivers/train.py's, `unet_grad_error`: the
first gradient's error on the U-Net's leaves, the worst leaf's norm of
its difference from the reference's gradient over the larger of the
reference's norm of that leaf and of the median U-Net leaf. The U-Net's
convolutions in a lower precision move it where the losses, means over
the batch, and the gaps between two gradients' norms hardly move. It
reads the U-Net's leaves alone, the layers this cell exists for.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from benchmark.drivers import train
from benchmark.harness import flops_residual
from benchmark.reference import residual_unet as R
from benchmark.reference import train as ref_train

window, release = train.window, train.release


def setup(ctx) -> None:
    un = ctx.config["conv_implicit_model"]["unet3d_params"]
    R.check_config(un)
    model, _ = train._model(ctx.config, ctx.traffic["stage"], ctx.device)
    R.check_state(model.state_dict(), un["num_levels"])
    flops_residual.install()
    train.setup(ctx)


def unet_grad_error(ref: dict, got: dict) -> float:
    """The worst U-Net leaf's ||got - ref|| over max(||ref||, the median
    U-Net leaf's ||ref||) of two first gradients."""
    keys = [k for k in ref if k.startswith(R.BASE)]
    norm = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keys}
    med = float(np.median(list(norm.values())))
    return max(float(torch.linalg.vector_norm(got[k].double()
                                              - ref[k].double()))
               / max(norm[k], med) for k in keys)


def judge(init, ref, got, stage1_ref, bins: int) -> dict:
    """reference/train.judge and `unet_grad_error`."""
    out = ref_train.judge(init, ref, got, stage1_ref, bins)
    out["unet_grad_error"] = unet_grad_error(ref["grad1"], got["grad1"])
    return out


def check(ctx) -> dict:
    """drivers/train.py's check with the residual reference, and
    `unet_grad_error`."""
    got = {"losses": ctx.losses, "grad1": ctx.grad1, "final": ctx.final,
           "stage1": ctx.stage1}
    stage1_ref = train.reference_stage1(ctx)
    if [(g["logits"].shape, g["features"].shape) for g in ctx.stage1
        ] != [(r["logits"].shape, r["features"].shape) for r in stage1_ref]:
        return collections.defaultdict(lambda: float("inf"))
    ref = reference_steps(ctx, stage1_in=ctx.stage1)
    out = judge(ctx.init, ref, got, stage1_ref,
                ctx.config["model"]["nocs_bins"])
    ctx.notes.update({"grad_worst": out.pop("grad_worst"),
                      "change_worst": out.pop("change_worst"),
                      "leaves_left_out_of_change": out.pop("left_out")})
    return out


def reference_steps(ctx, tf32: bool = False, stage1_in=None,
                    residual_left_out=None, **faults) -> dict:
    """train.reference_steps with the residual reference (residual_left_out:
    the decoder whose block leaves its residual sum out, a planted
    fault)."""
    with R.in_reference(residual_left_out):
        return train.reference_steps(ctx, tf32, stage1_in, **faults)
