"""The carried stage-1 step, card against CPU, over several card-made states.

    python -m garmentnets_tpu_torch.tools.profile_carried_step [--states 8]

Run from the repository's root on a machine with a CUDA card (it reads
chip_smoke's step helpers). Each state is chip_smoke.carried_state's: the
production stage 1 after CARRY_STEPS card steps at lr CARRY_LR, dropout
on, from one init and one set of batches; the card's atomic sums make
each state its own. From each, one step at CARRY_N points, dropout off, on
the card and on the CPU:

- in float32, held as phase_train_reference holds a step (step_ratios at
  TRAIN_REL[1]: 1e-4 of a tensor's largest entry, or SPREAD_FACTOR times
  the CPU's own change under a 1e-6 jitter of the weights or of the input
  colours): the worst error / bar and the tensors over their bar. For the
  worst tensor of a Linear layer: the share of its error in one row (one
  output channel), and the CPU's pre-activation nearest 0 in that channel
  with the cosine between the row's error and that entry's input row. A
  ReLU that takes its other side on one device moves one row along one
  input, so the share and the cosine are then ~1;
- in float64 (chip_smoke.carried_step, as phase_train_trajectory holds
  it): the worst error of a tensor's largest entry.

Prints a line a state, then a JSON line of the same numbers.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import pathlib
import tempfile
import time

import torch


def float32_step(dev, cfg, carried: dict, batch: dict, jitter_seed=None,
                 inputs: dict | None = None):
    """The float32 step (make_train_fns, Adam) from `carried` on `dev`, the
    weights optionally times (1 + 1e-6 N(0, 1)) -> (loss, {name:
    gradient}, {name: running statistic}), on the CPU. `inputs`, if
    given, gets {Linear's name: (its input, its output)} of the forward."""
    from garmentnets_tpu_torch.harness.training import (
        batch_to_device, make_adam, make_train_fns)
    from garmentnets_tpu_torch.models import pointnet2_nocs
    model = pointnet2_nocs.PointNet2NOCS(cfg)
    model.load_state_dict(carried["model"])
    if jitter_seed is not None:
        gen = torch.Generator().manual_seed(jitter_seed)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + 1e-6 * torch.randn(p.shape, generator=gen))
    if inputs is not None:
        for name, mod in model.named_modules():
            if isinstance(mod, torch.nn.Linear):
                mod.register_forward_hook(
                    lambda m, a, o, name=name: inputs.__setitem__(
                        name, (a[0].detach().cpu(), o.detach().cpu())))
    model.to(dev)
    opt = make_adam(model, cfg.learning_rate)
    opt.load_state_dict(copy.deepcopy(carried["adam"]))
    train_step, _ = make_train_fns(
        model, lambda b, g: model(b["x"], b["pos"], generator=g),
        lambda o, b: pointnet2_nocs.get_metrics(cfg, o, b)[0], opt)
    loss = float(train_step(batch_to_device(batch, dev))["loss"])
    return (loss, {n: p.grad.cpu() for n, p in model.named_parameters()},
            {n: t.cpu() for n, t in model.named_buffers() if "running" in n})


def one_row(card: dict, cpu: dict, name: str, inputs: dict) -> dict:
    """Where a Linear's gradient error lies: its share in the largest row,
    and the CPU's pre-activation nearest 0 in that row's channel with the
    cosine between the row's error and that entry's input row."""
    layer = name.rsplit(".", 1)[0]
    weight = layer + ".weight"
    if layer not in inputs:
        return {}
    err = card[weight] - cpu[weight]
    rows = err.norm(dim=1)
    r = int(rows.argmax())
    x, z = inputs[layer]
    x, z = x.reshape(-1, x.shape[-1]), z.reshape(-1, z.shape[-1])[:, r]
    i = int(z.abs().argmin())
    cos = float(torch.dot(x[i], err[r]) / (x[i].norm() * err[r].norm()))
    return {"row_share": float(rows[r] / err.norm()), "channel": r,
            "nearest_zero": float(z[i]), "cosine": cos}


def main(argv=None) -> None:
    import chip_smoke as cs
    from garmentnets_tpu_torch.data.synthetic import generate_dataset
    from garmentnets_tpu_torch.models.pointnet2_nocs import (
        PointNet2NOCSConfig)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--states", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="the device held to the CPU (cpu: a dry run)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    tmp = pathlib.Path(tempfile.mkdtemp())
    generate_dataset(str(tmp / "trajectory.zarr"), num_instances=4,
                     grips_per_instance=3, volume_size=16, pts_per_view=1000,
                     include_task_space=False, device="cpu")
    carry = cs.stage1_batches(tmp / "trajectory.zarr", cs.CARRY_N,
                              cs.CARRY_STEPS + 1)
    batch = carry[-1]
    cfg = PointNet2NOCSConfig(learning_rate=cs.CARRY_LR)
    step_cfg = dataclasses.replace(cfg, dropout=False)
    out = []
    device_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")
    print(f"device: {device_name}")
    for s in range(args.states):
        t0 = time.perf_counter()
        carried = cs.carried_state(dev, cfg, carry[:-1])
        inputs = {}
        card = float32_step(dev, step_cfg, carried, batch)
        cpu = float32_step("cpu", step_cfg, carried, batch, inputs=inputs)
        moved = [float32_step("cpu", step_cfg, carried, batch, jitter_seed=3),
                 float32_step("cpu", step_cfg, carried,
                              cs.jittered_colours(batch))]
        ratio, name, _, _ = cs.step_ratios(card, cpu, moved, cs.TRAIN_REL[1])
        over = sum(
            float((card[1][n] - g).abs().max()) > max(
                cs.TRAIN_REL[1] * float(g.abs().max()),
                cs.SPREAD_FACTOR * max(float((m[1][n] - g).abs().max())
                                       for m in moved))
            for n, g in cpu[1].items())
        row = (one_row(card[1], cpu[1], name.split(" ", 1)[1], inputs)
               if name.startswith("gradient") else {})
        f64 = cs.step_ratios(cs.carried_step(dev, step_cfg, carried, batch),
                             cs.carried_step("cpu", step_cfg, carried, batch),
                             (), cs.CARRY_REL)
        rec = {"state": s, "float32_worst": ratio, "float32_tensor": name,
               "float32_gradients_over": over, **row,
               "float64_worst_of_largest": f64[0] * cs.CARRY_REL,
               "float64_tensor": f64[1],
               "seconds": time.perf_counter() - t0}
        out.append(rec)
        print(f"state {s}: float32 worst {ratio:.3f} of its bar ({name}; "
              f"{over} gradients over their bar)"
              + (f"; its largest row {row['row_share']:.6f} of its error, "
                 f"channel {row['channel']}, pre-activation nearest 0 "
                 f"{row['nearest_zero']:.3e}, cosine with that input "
                 f"{row['cosine']:.6f}" if row else "")
              + f"; float64 worst {rec['float64_worst_of_largest']:.3e} of "
              f"the largest entry ({f64[1]}); {rec['seconds']:.1f} s",
              flush=True)
    print(json.dumps({"device": device_name, "carried_steps": out}))


if __name__ == "__main__":
    main()
