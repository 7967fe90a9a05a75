"""The first training steps worked out again in plain PyTorch, and the
comparison of a training run's first steps with them.

`steps` runs the forward, the loss, autograd's gradients, the BatchNorm
running statistics and Adam over the given batches from the given
weights, drawing dropout from a generator seeded as the run's. `judge`
compares, by the worst leaf, the gap between two runs' norms (not the
norm of their difference) against the reference's norm of that leaf or
of the median leaf, whichever is larger:
- each step's loss, relative to the reference's (the second step's shows
  the direction of the first update);
- the first gradient as the optimizer got it;
- each leaf's change after the steps (parameters and BatchNorm running
  statistics), leaving out parameters whose reference gradient is under
  a thousandth of the median leaf's: rounding alone moves those under
  Adam.
Beside the worst leaf's gap it gives the median leaf's (of the leaves the
reference moves, for the change), and beside the worst step's loss each
step's. In stage 2 it also judges the frozen stage 1's answers that the
run's stage 2 consumed against the reference's stage 1: the NOCS bins and
confidences they give, and the per-point features, by the norm of their
difference over the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import model as M

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def _batch(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def steps(state: dict, trainable, cfg: dict, stage: int, batches: list,
          dropout_seed: int, device, rows=None, lr_scale: float = 1.0,
          stage1_in=None, freeze_stats: bool = False, flip=None) -> dict:
    """-> {"losses": [float], "grad1": {leaf: tensor}, "final": state,
    "stage1": [the frozen stage 1's features and logits a step]} (stage
    2 only for the last). stage1_in: stage 2 starts each step from these
    stage-1 outputs instead of its own. Planted faults: rows keeps only
    these rows of every batch; lr_scale 0 leaves the parameters unchanged
    (a step that returns its state), -1 runs every update backwards;
    freeze_stats leaves the BatchNorm running statistics unchanged; flip
    (a name prefix) runs the updates of those leaves backwards."""
    p = {k: v.detach().clone() for k, v in state.items()}
    train = {k: p[k] for k in trainable}
    lr = (cfg["model"]["learning_rate"] if stage == 1
          else cfg["conv_implicit_model"]["learning_rate"])
    adam = M.Adam(train, lr * lr_scale, ADAM_BETAS, ADAM_EPS)
    gen = torch.Generator(device=device).manual_seed(dropout_seed)
    losses, grad1, used = [], None, []
    for i, batch in enumerate(batches):
        b = _batch(batch, device)
        if rows is not None:
            b = {k: v[rows] for k, v in b.items()}
        for v in train.values():
            v.requires_grad_(True)
        bn = {}
        if stage == 1:
            out = M.stage1(p, cfg["model"], b["x"], b["pos"], train=True,
                           bn_out=bn, generator=gen)
            loss = M.stage1_loss(out, b, cfg["model"])
        else:
            c = cfg["conv_implicit_model"]
            un = c["unet3d_params"]
            loss, s1 = M.stage2_forward_loss(
                p, {"pointnet2": cfg["model"], **c}, b,
                c["volume_agg_params"]["grid_shape"][0], un["num_groups"],
                un["num_levels"], True, bn,
                None if stage1_in is None else stage1_in[i])
            used.append(s1)
        names = list(train)
        grads = torch.autograd.grad(loss, [train[k] for k in names],
                                    allow_unused=True)
        grads = {k: (torch.zeros_like(train[k]) if g is None else g)
                 for k, g in zip(names, grads)}
        for v in train.values():
            v.requires_grad_(False)
        if grad1 is None:   # as Adam holds it: none where no step ran
            grad1 = {k: g.detach().clone() * (lr_scale != 0)
                     for k, g in grads.items()}
        flipped = {k: v.detach().clone() for k, v in train.items()
                   if flip is not None and k.startswith(flip)}
        adam.step(train, grads)
        with torch.no_grad():
            for k, v in flipped.items():
                train[k].mul_(-1).add_(v, alpha=2)
            for k, v in ({} if freeze_stats else bn).items():
                p[k].copy_(v)
                nbt = k.rsplit(".", 1)[0] + ".num_batches_tracked"
                if nbt in p and k.endswith("running_mean"):
                    p[nbt].add_(1)
        losses.append(float(loss.detach()))
    return {"losses": losses, "grad1": grad1, "final": p, "stage1": used}


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in d.items()}


def judge(init: dict, ref: dict, got: dict, stage1_ref=None,
          bins: int = 64) -> dict:
    """got: {"losses", "grad1", "final"} of the run judged, as ref.
    Returns the compared numbers and the leaves that set them; with
    stage1_ref (the reference's own frozen stage-1 outputs on the same
    batches) also the gap of got's stage-1 answers to them."""
    out = {}
    if stage1_ref is not None:
        pairs = [M.nocs_gap(g["logits"], r["logits"], bins)
                 for g, r in zip(got["stage1"], stage1_ref)]
        out["stage1_nocs_gap_mean"] = (sum(a for a, _ in pairs)
                                       / max(sum(n for _, n in pairs), 1))
        diff = sum(float(torch.sum((g["features"].double()
                                    - r["features"].double()) ** 2))
                   for g, r in zip(got["stage1"], stage1_ref))
        norm = sum(float(torch.sum(r["features"].double() ** 2))
                   for r in stage1_ref)
        out["stage1_feature_gap"] = (diff / max(norm, 1e-300)) ** 0.5
    lr = np.asarray(ref["losses"], np.float64)
    lg = np.asarray(got["losses"], np.float64)
    gap = np.abs(lg - lr) / np.abs(lr)
    out["loss_gap"] = float(gap.max())
    for i, g in enumerate(gap):
        out[f"loss{i + 1}_gap"] = float(g)
    gr, gg = _norms(ref["grad1"]), _norms(got["grad1"])
    med = float(np.median(list(gr.values())))
    gaps = {k: abs(gg.get(k, 0.0) - gr[k]) / max(gr[k], med) for k in gr}
    worst = max(gaps, key=gaps.get)
    out["grad_gap"], out["grad_worst"] = gaps[worst], worst
    out["grad_gap_median"] = float(np.median(list(gaps.values())))
    floats = [k for k, v in init.items() if v.is_floating_point()]
    keep = [k for k in floats if k not in gr or gr[k] >= 1e-3 * med]
    dr = _norms({k: ref["final"][k] - init[k] for k in keep})
    dg = _norms({k: got["final"][k] - init[k] for k in keep})
    moved = [v for v in dr.values() if v > 0]
    dmed = float(np.median(moved)) if moved else 1.0
    gaps = {k: abs(dg[k] - dr[k]) / max(dr[k], dmed) for k in keep}
    worst = max(gaps, key=gaps.get)
    out["change_gap"], out["change_worst"] = gaps[worst], worst
    out["change_gap_median"] = float(np.median(
        [g for k, g in gaps.items() if dr[k] > 0]))
    out["left_out"] = len(floats) - len(keep)
    return out
