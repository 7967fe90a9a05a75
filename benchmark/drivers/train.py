"""Training cells: the port's `make_train_fns` train step, fed by
`batch_to_device` (the trainer's own copy to the card) from a set of
numpy batches made in set-up and rotated through.

Set-up seeds the weights on the device, builds one training step with its
model and Adam state, and drives it through its first steps by the
window's own call on distinct batches: the reference follows the first
`checked_steps` of them (the loss of each, the first gradient as Adam
holds it, every leaf's change after them). The same object then goes on
into the window, which ends after a synchronize.
"""
from __future__ import annotations

import collections
import time

import torch
from torch.profiler import record_function

from benchmark.harness import traffic as gen
from benchmark.harness import weights
from benchmark.harness.cell import start_profiler, stop_profiler
from benchmark.reference import model as M
from benchmark.reference import train as ref_train

DROPOUT_STREAM = 7


def _model(config: dict, stage: int, device):
    from garmentnets_tpu_torch.core.builders import (
        build_pipeline_config, build_pointnet2_config)
    from garmentnets_tpu_torch.models.pipeline import ConvImplicitWNFPipeline
    from garmentnets_tpu_torch.models.pointnet2_nocs import PointNet2NOCS
    pn2 = build_pointnet2_config(config["model"])
    with torch.device("meta"):
        if stage == 1:
            return PointNet2NOCS(pn2), pn2
        cfg = build_pipeline_config(config["conv_implicit_model"], pn2)
        return ConvImplicitWNFPipeline(cfg), cfg


def dropout_seed(seed: int) -> int:
    return int(gen.rng_for(seed, DROPOUT_STREAM).integers(0, 2 ** 62))


def plan(ctx) -> tuple:
    """What the reference needs of a cell without running it: the weights'
    names and shapes, the trainable leaves and the batches. Returns the
    model on the meta device and its config."""
    cfg, tr = ctx.config, ctx.traffic
    ctx.batch_size = cfg["datamodule"]["batch_size"]
    model, mcfg = _model(cfg, tr["stage"], ctx.device)
    if tr["stage"] == 2:
        model.pointnet2_nocs.requires_grad_(False)
    ctx.spec = weights.state_spec(model)
    ctx.trainable = [k for k, p in model.named_parameters() if p.requires_grad]
    dm = cfg["datamodule"]
    ctx.batches = gen.train_batches(
        dict(tr, points=dm["num_pc_sample"],
             volume_samples=dm["num_volume_sample"],
             surface_samples=dm["num_surface_sample"]),
        ctx.batch_size, ctx.seed)
    return model, mcfg


def setup(ctx) -> None:
    from garmentnets_tpu_torch.harness.training import (
        ADAM_BETAS, batch_to_device, make_adam, make_train_fns)
    from garmentnets_tpu_torch.models.pipeline import pipeline_loss
    from garmentnets_tpu_torch.models.pointnet2_nocs import get_metrics
    tr, dev = ctx.traffic, ctx.device
    model, mcfg = plan(ctx)
    ctx.mark("batches")
    ctx.init = weights.seeded_state(ctx.spec, ctx.seed, dev)
    model = model.to_empty(device=dev)
    model.load_state_dict(ctx.init)
    ctx.mark("weights")
    if tr["stage"] == 1:
        def apply_fn(batch, generator):
            return model(batch["x"], batch["pos"], generator=generator)

        def loss_fn(out, batch):
            return get_metrics(mcfg, out, batch)[0]
    else:
        def apply_fn(batch, generator):
            return model(batch)

        def loss_fn(out, batch):
            return pipeline_loss(mcfg, out, batch)
    opt = make_adam(model, mcfg.learning_rate)
    train_step, _ = make_train_fns(model, apply_fn, loss_fn, opt)
    gen_ = torch.Generator(device=dev).manual_seed(dropout_seed(ctx.seed))
    ctx.issue_s = []
    ctx.n_steps = 0

    def step():
        b = ctx.batches[ctx.n_steps % len(ctx.batches)]
        with record_function("bench/batch_to_device"):
            rows = batch_to_device(b, dev)
        t0 = time.perf_counter()
        with record_function("bench/train_step"):
            m = train_step(rows, gen_)
        ctx.issue_s.append(time.perf_counter() - t0)
        ctx.n_steps += 1
        return m

    ctx.step, ctx.model, ctx.opt = step, model, opt
    named = [(k, p) for k, p in model.named_parameters() if p.requires_grad]
    ctx.stage1 = []
    if tr["stage"] == 2:    # the frozen stage 1's answers the reference follows
        hook = model.pointnet2_nocs.register_forward_hook(
            lambda mod, args, out: ctx.stage1.append(
                {"features": out["per_point_features"].detach().clone(),
                 "logits": out["per_point_logits"].detach().clone()}))
    losses = []
    for i in range(tr["checked_steps"]):
        losses.append(step()["loss"])
        if i == 0:      # Adam's first moment after one step is (1 - b1) g
            ctx.grad1 = {k: opt.state[p]["exp_avg"].detach() / (
                1 - ADAM_BETAS[0]) if "exp_avg" in opt.state[p]
                else torch.zeros_like(p) for k, p in named}
    if tr["stage"] == 2:
        hook.remove()
    ctx.final = {k: v.detach().clone() for k, v in model.state_dict().items()}
    ctx.losses = [float(x) for x in losses]
    ctx.mark("checked_steps")
    for _ in range(tr["warm_steps"]):
        step()
    _sync(dev)
    ctx.mark("warm_steps")


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def window(ctx, seconds: float) -> None:
    prof = start_profiler(ctx) if ctx.trace else None
    ctx.issue_s.clear()
    n0 = ctx.n_steps
    ctx.t0 = t0 = time.perf_counter()
    with record_function("bench/window"):
        while time.perf_counter() - t0 < seconds:
            ctx.step()
        _sync(ctx.device)
    ctx.window_s = time.perf_counter() - t0
    if prof is not None:
        stop_profiler(ctx, prof)
    ctx.steps = ctx.n_steps - n0
    ctx.samples = ctx.steps * ctx.batch_size
    ctx.attempted, ctx.failed = ctx.steps, 0
    ctx.notes.update({"steps": ctx.steps, "first_losses": ctx.losses})


def release(ctx) -> None:
    del ctx.model, ctx.opt, ctx.step
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.empty_cache()


def check(ctx) -> dict:
    """The reference's first steps from the same seeded weights, batches
    and dropout draws, against the run's. In stage 2 the reference's
    stage 2 starts from the run's own frozen stage-1 answers, and those
    are judged apart against the reference's stage 1; answers that do not
    match the batches fail every number."""
    got = {"losses": ctx.losses, "grad1": ctx.grad1, "final": ctx.final,
           "stage1": ctx.stage1}
    stage1_ref = follow = None
    if ctx.traffic["stage"] == 2:
        stage1_ref = reference_stage1(ctx)
        if [(g["logits"].shape, g["features"].shape) for g in ctx.stage1
            ] != [(r["logits"].shape, r["features"].shape)
                  for r in stage1_ref]:
            return collections.defaultdict(lambda: float("inf"))
        follow = ctx.stage1
    ref = reference_steps(ctx, stage1_in=follow)
    out = ref_train.judge(ctx.init, ref, got, stage1_ref,
                          ctx.config["model"]["nocs_bins"])
    ctx.notes.update({"grad_worst": out.pop("grad_worst"),
                      "change_worst": out.pop("change_worst"),
                      "leaves_left_out_of_change": out.pop("left_out")})
    return out


def reference_steps(ctx, tf32: bool = False, stage1_in=None,
                    **faults) -> dict:
    """The reference's first steps (tf32: the control's precision;
    stage1_in: the frozen stage-1 answers stage 2 starts from; faults:
    rows, lr_scale, freeze_stats, flip, planted as reference/train.steps
    says)."""
    tr, dev = ctx.traffic, ctx.device
    init = weights.seeded_state(ctx.spec, ctx.seed, dev)
    with M.precision(tf32=tf32):
        return ref_train.steps(init, ctx.trainable, ctx.config, tr["stage"],
                               ctx.batches[:tr["checked_steps"]],
                               dropout_seed(ctx.seed), dev,
                               stage1_in=stage1_in, **faults)


@torch.no_grad()
def reference_stage1(ctx, tf32: bool = False) -> list:
    """The reference's frozen stage 1 (eval mode) on the checked batches."""
    p = weights.seeded_state(ctx.spec, ctx.seed, ctx.device)
    out = []
    with M.precision(tf32=tf32):
        for b in ctx.batches[:ctx.traffic["checked_steps"]]:
            x, pos = (torch.as_tensor(b[k], device=ctx.device)
                      for k in ("x", "pos"))
            out.append(M.stage1(p, ctx.config["model"], x, pos,
                                prefix="pointnet2_nocs."))
    return out
