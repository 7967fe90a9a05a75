"""Rank programs of tests/test_torch_ddp.py: data-parallel train steps of
the port on torch.distributed's gloo backend, on the CPU.

Run as `python -m torch_ddp_util <scenario> <dir>` (the tests start it as
a subprocess under a timeout): the scenario spawns two ranks with
parallel/mesh.launch_ranks, and each rank writes what it saw into <dir>.

- `steps`: <dir>/inputs.pt holds a model kind ("stage1" or "stage2"), its
  configuration, weights, one global batch (numpy) and a step count; each
  rank takes its rows (harness/training.batch_to_device), runs the steps
  of make_train_fns over the group and writes rank<r>.pt: the first
  step's global loss, the summed gradients and the running statistics
  after it, this rank's share of that loss in the step's dtype, and the
  parameters after every step. Then, from the same
  weights, one step in float64 (the model, the rows and the step;
  torch_port_util.port_float64), written as rank<r>_float64.pt.
- `shard`: <dir>/inputs.pt holds datamodule kwargs with
  shard_by_process=True, a stage-2 configuration and its weights; each
  rank records the dataset indices its train loader reads over one epoch,
  runs an eval step over the group on rows that end uneven (rank r keeps
  2 - r rows of its first batch), then takes that batch as the Trainer
  does (whole: harness/training.own_rows_to_device) for one stage-2 train
  step, and writes shard<r>.pt.
- `fail`: rank 0 waits at an all-reduce while rank 1 raises; the run must
  fail with rank 1's error, not hang.
- `train`: <dir>/train.pt holds a stage (1 or 2) and a train CLI
  configuration with trainer.num_devices=2; the CLI's main spawns the
  ranks itself.
"""
import pathlib
import sys

import torch
import torch.distributed as dist

from garmentnets_tpu_torch.data.dataset import ConvImplicitWNFDataModule
from garmentnets_tpu_torch.harness.training import (
    Trainer, batch_to_device, make_adam, make_train_fns, own_rows_to_device)
from garmentnets_tpu_torch.models import pipeline as pipe
from garmentnets_tpu_torch.models import pointnet2_nocs as nocs
from garmentnets_tpu_torch.parallel.mesh import launch_ranks
from torch_port_util import port_float64

WORLD = 2
LR = 1e-3


def step_worker(out_dir: str) -> None:
    out_dir = pathlib.Path(out_dir)
    inp = torch.load(out_dir / "inputs.pt", weights_only=False)
    rank = dist.get_rank()
    out = run_steps(inp, torch.float32, inp["steps"])
    torch.save(out, out_dir / f"rank{rank}.pt")
    with port_float64():
        out = run_steps(inp, torch.float64, 1)
    torch.save(out, out_dir / f"rank{rank}_float64.pt")


def run_steps(inp: dict, dtype, steps: int) -> dict:
    """`steps` steps of the `steps` scenario's model in `dtype` on this
    rank's rows."""
    rank, group = dist.get_rank(), dist.group.WORLD
    cfg = inp["cfg"]
    if inp["kind"] == "stage2":
        model = pipe.ConvImplicitWNFPipeline(cfg)
        model.load_state_dict(inp["state"])
        model.pointnet2_nocs.requires_grad_(False)

        def apply_fn(b, gen):
            return model(b)

        def metrics_fn(o, b):
            return pipe.pipeline_loss(cfg, o, b, group)
    else:
        model = nocs.PointNet2NOCS(cfg)
        model.load_state_dict(inp["state"])

        def apply_fn(b, gen):
            return model(b["x"], b["pos"], generator=gen)

        def metrics_fn(o, b):
            return nocs.get_metrics(cfg, o, b, group)[0]

    shares = []

    def loss_fn(o, b):
        # this rank's share of the global loss, in the step's dtype (the
        # step returns the global metrics in float32)
        metrics = metrics_fn(o, b)
        shares.append(float(metrics["loss"].detach()))
        return metrics

    model.to(dtype)
    optimizer = make_adam(model, LR)
    grads = {}
    step = optimizer.step

    def step_after_snapshot():
        if not grads:
            grads.update({n: p.grad.clone() for n, p in
                          model.named_parameters() if p.grad is not None})
        return step()

    optimizer.step = step_after_snapshot
    train_step, _ = make_train_fns(model, apply_fn, loss_fn, optimizer,
                                   group)
    rows = {k: v.to(dtype) if v.is_floating_point() else v for k, v in
            batch_to_device(inp["batch"], "cpu", WORLD, rank).items()}
    out = {"rows": {k: v.clone() for k, v in rows.items()}, "params": []}
    for i in range(steps):
        metrics = train_step(rows)
        if i == 0:
            out["loss"] = float(metrics["loss"])
            out["loss_share"] = shares[0]
            out["grads"] = grads
            out["stats"] = {n: b.clone() for n, b in model.named_buffers()}
        out["params"].append({n: p.detach().clone()
                              for n, p in model.named_parameters()})
    return out


def shard_worker(out_dir: str) -> None:
    out_dir = pathlib.Path(out_dir)
    inp = torch.load(out_dir / "inputs.pt", weights_only=False)
    rank, group = dist.get_rank(), dist.group.WORLD
    dm = ConvImplicitWNFDataModule(**inp["dm"])
    dm.prepare_data()
    loader = dm.train_dataloader()
    dataset, seen = loader.dataset, []

    class Recorder:
        def __getitem__(self, i):
            seen.append(int(i))
            return dataset[i]

    loader.dataset = Recorder()
    batches = list(loader)
    cfg = inp["cfg"]
    model = pipe.ConvImplicitWNFPipeline(cfg)
    model.load_state_dict(inp["state"])
    model.pointnet2_nocs.requires_grad_(False)
    optimizer = make_adam(model, LR)
    train_step, eval_step = make_train_fns(
        model, lambda b, gen: model(b),
        lambda o, b: pipe.pipeline_loss(cfg, o, b, group), optimizer, group)
    short = {k: v[:2 - rank] for k, v in batches[0].items()}
    eval_rows, n_eval = own_rows_to_device(short, "cpu", group)
    eval_loss = float(eval_step(eval_rows)["loss"])
    trainer = Trainer(max_epochs=1, run_dir=str(out_dir / "run"),
                      device="cpu")
    rows, n_rows = trainer._rows(batches[0], loader)
    loss = float(train_step(rows)["loss"])
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    torch.save({"seen": seen, "sharded": loader.process_sharded,
                "n_batches": len(batches), "batch": batches[0],
                "mask": rows["_valid_mask"], "n_rows": n_rows,
                "loss": loss, "grads": grads,
                "eval_mask": eval_rows["_valid_mask"], "n_eval": n_eval,
                "eval_loss": eval_loss}, out_dir / f"shard{rank}.pt")


def fail_worker() -> None:
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(1))


def main(argv) -> None:
    scenario, out_dir = argv
    if scenario == "steps":
        launch_ranks(step_worker, WORLD, args=(out_dir,), device="cpu")
    elif scenario == "shard":
        launch_ranks(shard_worker, WORLD, args=(out_dir,), device="cpu")
    elif scenario == "fail":
        launch_ranks(fail_worker, WORLD, device="cpu")
    elif scenario == "train":
        from garmentnets_tpu_torch.harness import (
            train_pipeline, train_pointnet2)
        spec = torch.load(pathlib.Path(out_dir) / "train.pt",
                          weights_only=False)
        cli = train_pointnet2 if spec["stage"] == 1 else train_pipeline
        print(cli.main(spec["cfg"], run_dir=spec["run_dir"]))
    else:
        raise SystemExit(f"unknown scenario {scenario!r}")


if __name__ == "__main__":
    main(sys.argv[1:])
