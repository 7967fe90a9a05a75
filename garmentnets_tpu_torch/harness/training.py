"""Training loop: torch.optim.Adam, top-k checkpoints, metrics.jsonl
(torch port of garmentnets_tpu/harness/training.py).

- make_train_fns: the train step (forward, loss, backward, Adam update and
  the BatchNorm running statistics, in full f32 with TF32 off) and the
  eval step (eval mode, no gradient);
- MetricFlusher: step metrics stay on the device and go to the host in one
  stacked copy every 32 steps, not with one synchronization a step;
- Trainer.fit: the epoch loop with `_valid_mask` in every batch,
  limit_train_batches / limit_val_batches, a sample-weighted epoch
  val_loss, top-k and last checkpoints, `best_checkpoint` in the summary
  and an optional torch.profiler trace of the first epochs.

Data parallelism (`trainer.num_devices`, the JAX trainer's mesh): one
process a rank on torch.distributed (`run_ranks`: spawned ranks on
localhost, or torchrun's). Where the rows come from depends on
`datamodule.shard_by_process` (data/dataset.py `_process_shard`):
- off (the shipped configs): every rank reads the same global batch, pads
  it to a multiple of the world size by repeating row 0 as the JAX
  trainer's `_prep` does, and keeps its own rows, `_valid_mask` 0 on the
  padded ones (`batch_to_device`);
- on: every rank's loader yields its own samples and the rank takes its
  whole batch, so the global batch is world x batch_size rows, in rank
  order; a batch that ends uneven across ranks (a val or test tail) is
  padded to the most rows any rank holds, `_valid_mask` 0 on the padding
  (`own_rows_to_device`).
One process is the same in both modes. BatchNorm takes its statistics
over the whole padded global batch and every loss is the rank's share of
the global masked mean (models/mlp.py, models/losses.py), so after one
all-reduce (a sum) of the gradients in one flat bucket every rank holds
the global batch's gradient and runs the same Adam step: the replicas
stay equal. Only rank 0 logs, runs the per-epoch images and writes
checkpoints.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from garmentnets_tpu_torch.core import config as config_mod
from garmentnets_tpu_torch.core.checkpoint import (
    TopKCheckpointManager, resume_training, training_checkpoint)
from garmentnets_tpu_torch.core.device import (
    full_f32, resolve_device, to_device)
from garmentnets_tpu_torch.core.logging import NullLogger, make_logger
from garmentnets_tpu_torch.models.mlp import set_batch_norm_group
from garmentnets_tpu_torch.parallel.mesh import (
    init_distributed, launch_ranks, pad_batch_to, shard_rows)

# optax.adam's defaults
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
FLUSH_EVERY = 32
# rank r draws dropout from seed + DROPOUT_SEED_STRIDE * r
DROPOUT_SEED_STRIDE = 1_000_003


def metrics_to_host(metric_dicts: list) -> list:
    """Same-keyed dicts of scalar device tensors -> dicts of floats, in
    one stacked device-to-host copy."""
    if not metric_dicts:
        return []
    keys = list(metric_dicts[0])
    if any(list(m) != keys for m in metric_dicts):
        return [{k: float(v) for k, v in m.items()} for m in metric_dicts]
    mat = torch.stack([torch.stack([m[k].detach().float().reshape(())
                                    for k in keys])
                       for m in metric_dicts]).cpu().numpy()
    return [dict(zip(keys, map(float, row))) for row in mat]


class MetricFlusher:
    """Buffers the step metrics (device tensors) and logs them in one
    transfer every `flush_every` steps, which also bounds how far the
    host runs ahead of the device."""

    def __init__(self, logger, flush_every: int = FLUSH_EVERY):
        self.logger = logger
        self.flush_every = flush_every
        self._buf: list = []

    def add(self, prefix: str, metrics: dict, step: int) -> None:
        self._buf.append((prefix, metrics, step))
        if len(self._buf) >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        if not self._buf:
            return
        rows = metrics_to_host([m for _, m, _ in self._buf])
        for (prefix, _, step), row in zip(self._buf, rows):
            self.logger.log({f"{prefix}{k}": v for k, v in row.items()},
                            step=step)
        self._buf.clear()


def make_adam(model: torch.nn.Module,
              learning_rate: float) -> torch.optim.Adam:
    """optax.adam(learning_rate) over the parameters that take a gradient
    (the frozen stage 1 of the pipeline takes none)."""
    return torch.optim.Adam(
        [p for p in model.parameters() if p.requires_grad],
        lr=learning_rate, betas=ADAM_BETAS, eps=ADAM_EPS)


def all_reduce_grads(params, group) -> None:
    """Sum the gradients of `params` over the ranks of `group`, in one
    flat bucket (the parameters without a gradient are the same on every
    rank, and stay without one)."""
    with_grad = [p for p in params if p.grad is not None]
    if not with_grad:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in with_grad])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    for p, g in zip(with_grad, flat.split([p.numel() for p in with_grad])):
        p.grad.copy_(g.view_as(p))


def global_metrics(metrics: dict, group) -> dict:
    """Each metric's global value, the sum of the ranks' shares, in one
    all-reduce; the metrics as they are without a group."""
    if group is None:
        return metrics
    keys = list(metrics)
    vec = torch.stack([metrics[k].detach().float().reshape(())
                       for k in keys])
    dist.all_reduce(vec, op=dist.ReduceOp.SUM, group=group)
    return dict(zip(keys, vec.unbind()))


def make_train_fns(model: torch.nn.Module, apply_fn: Callable,
                   loss_fn: Callable, optimizer: torch.optim.Optimizer,
                   group=None):
    """apply_fn(batch, generator) -> the model's outputs; loss_fn(out,
    batch) -> metrics with 'loss'. Returns (train_step(batch, generator)
    -> metrics, eval_step(batch) -> metrics), metrics as detached device
    scalars. group: the process group of data-parallel training; the
    model's BatchNorm statistics then span its ranks, loss_fn must give
    this rank's share of each metric (models/losses.masked_mean with the
    same group), the gradients are summed over the ranks before Adam, and
    the returned metrics are the global values."""
    set_batch_norm_group(model, group)
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(batch: dict, generator=None) -> dict:
        model.train()
        with full_f32():
            metrics = loss_fn(apply_fn(batch, generator), batch)
            optimizer.zero_grad(set_to_none=True)
            metrics["loss"].backward()
            if group is not None:
                all_reduce_grads(params, group)
            optimizer.step()
        return global_metrics({k: v.detach() for k, v in metrics.items()},
                              group)

    @torch.no_grad()
    def eval_step(batch: dict) -> dict:
        model.eval()
        with full_f32():
            return global_metrics(loss_fn(apply_fn(batch, None), batch),
                                  group)

    return train_step, eval_step


def resolve_num_devices(num_devices, device="cuda") -> int:
    """trainer.num_devices -> the number of ranks: -1 is every card on
    a bare "cuda", and one process on the CPU or on one named card
    ("cuda:i"); a count must be at least 1 and, on cuda, at most the
    cards present, and several ranks need a bare "cuda" (each takes its
    own card). A CUDA device without a card raises
    (core.device.resolve_device)."""
    dev = resolve_device(device)
    one_card = dev.type == "cuda" and dev.index is not None
    if num_devices is None or num_devices == -1:
        if dev.type == "cpu" or one_card:
            return 1
        return max(1, torch.cuda.device_count())
    if num_devices < 1:
        raise ValueError(f"trainer.num_devices={num_devices}: expected -1 "
                         "(every card) or a count of at least 1")
    if one_card and num_devices > 1:
        raise ValueError(f"trainer.num_devices={num_devices}: "
                         f"trainer.device={device} names one card; several "
                         "ranks take trainer.device=cuda, a card each")
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if num_devices > cards:
            raise ValueError(f"trainer.num_devices={num_devices}: {cards} "
                             "CUDA device(s) present")
    return int(num_devices)


def _masked(batch: dict, rows: int) -> dict:
    """`batch` padded to `rows` rows by repeating its row 0
    (mesh.pad_batch_to), with `_valid_mask` [rows] 1 on the real rows and
    0 on the padded ones (the JAX trainer's _prep)."""
    padded, b = pad_batch_to(batch, rows)
    mask = np.zeros(rows, np.float32)
    mask[:b] = 1.0
    return dict(padded, _valid_mask=mask)


def batch_to_device(batch: dict, device, world_size: int = 1,
                    rank: int = 0) -> dict:
    """A global loader batch (numpy arrays; every rank reads the same one:
    shard_by_process off, or one process) -> this rank's rows as tensors
    on `device`: the batch padded to a multiple of world_size by repeating
    row 0, then rank's contiguous share of the rows, `_valid_mask` 0 on
    the padded ones."""
    b = len(batch["x"])
    padded = _masked(batch, -(-b // world_size) * world_size)
    mine = shard_rows(padded, world_size, rank)
    return {k: to_device(v, device) for k, v in mine.items()}


def own_rows_to_device(batch: dict, device, group,
                       even: bool = False) -> tuple:
    """This rank's own loader batch (shard_by_process on under a process
    group; the global batch is every rank's batch in rank order) -> (its
    rows as tensors on `device`, the global batch's real rows). The rows
    are padded by repeating row 0 to the most rows any rank holds, found
    by one all-reduce of the ranks' row counts, with `_valid_mask` 0 on
    the padding. even: every rank's batch has as many rows as this one
    (a drop_last loader's), so no count is exchanged."""
    b = len(batch["x"])
    world = dist.get_world_size(group)
    if even:
        rows, total = b, world * b
    else:
        counts = torch.zeros(world, dtype=torch.int64, device=device)
        counts[dist.get_rank(group)] = b
        dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=group)
        rows, total = int(counts.max()), int(counts.sum())
    mine = _masked(batch, rows)
    return {k: to_device(v, device) for k, v in mine.items()}, total


class Trainer:
    """Explicit epoch loop with val-loss checkpoint selection, on one rank
    of a process group when one exists (harness/training.run_ranks)."""

    def __init__(self, max_epochs: int, run_dir, checkpoint_top_k: int = 20,
                 num_devices: int = -1,
                 limit_train_batches: Optional[int] = None,
                 limit_val_batches: Optional[int] = None,
                 seed: int = 0, profile_epochs: int = 0,
                 logger_cfg: Optional[dict] = None, device="cuda"):
        self.device = resolve_device(device)
        if dist.is_initialized():
            self.group = dist.group.WORLD
            self.world_size = dist.get_world_size()
            self.rank = dist.get_rank()
            if self.device.type == "cuda":
                # the rank's own card, set by init_distributed
                own = torch.device("cuda", torch.cuda.current_device())
                if self.device.index not in (None, own.index):
                    raise ValueError(
                        f"trainer.device={device}: rank {self.rank} of "
                        f"{self.world_size} runs on {own} (give "
                        "trainer.device=cuda)")
                self.device = own
            if num_devices not in (-1, None, self.world_size):
                raise ValueError(
                    f"trainer.num_devices={num_devices}: the process group "
                    f"has {self.world_size} ranks")
        elif resolve_num_devices(num_devices, device) > 1:
            raise ValueError(
                f"trainer.num_devices={num_devices}: several ranks need a "
                "process group (start them with harness.training.run_ranks "
                "or torchrun)")
        else:
            self.group, self.world_size, self.rank = None, 1, 0
            if self.device.type == "cuda" and self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
        self.max_epochs = max_epochs
        self.run_dir = run_dir
        self.ckpt = (TopKCheckpointManager(
            f"{run_dir}/checkpoints", k=checkpoint_top_k)
            if self.rank == 0 else None)
        self.logger = (make_logger(run_dir, logger_cfg) if self.rank == 0
                       else NullLogger())
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.seed = seed
        self.profile_epochs = profile_epochs

    def _profiler(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof

    def _stop_profiler(self, prof) -> None:
        prof.stop()
        prof.export_chrome_trace(f"{self.run_dir}/torch_trace.json")

    def _rows(self, batch: dict, loader) -> tuple:
        """(this rank's rows of a loader batch on its device, the global
        batch's real rows): the rank's whole batch when `loader` is
        sharded by process (data/dataset.py), else its share of the global
        batch that every rank reads."""
        if getattr(loader, "process_sharded", False):
            return own_rows_to_device(batch, self.device, self.group,
                                      even=loader.drop_last)
        return (batch_to_device(batch, self.device, self.world_size,
                                self.rank), len(batch["x"]))

    def fit(self, model, optimizer, train_step, eval_step, train_loader,
            val_loader, hparams: dict, epoch_vis_fn=None,
            start_epoch: int = 0, global_step: int = 0) -> dict:
        """Train epochs start_epoch .. max_epochs - 1 (a resumed run
        passes its checkpoint's epoch + 1 and global_step).
        epoch_vis_fn(epoch, global_step): the per-epoch image hook
        (harness/vis_hooks.py). Returns the logger's summary."""
        # dropout's random source, on the training device, one a rank
        gen = torch.Generator(device=self.device).manual_seed(
            self.seed + DROPOUT_SEED_STRIDE * self.rank)
        prof = None
        loader_wait = []
        for epoch in range(start_epoch, self.max_epochs):
            if self.profile_epochs and epoch == start_epoch and (
                    self.rank == 0):
                prof = self._profiler()
            if prof is not None and epoch == start_epoch + self.profile_epochs:
                self._stop_profiler(prof)
                prof = None
            t0 = time.time()
            n_train, wait = 0, 0.0
            flusher = MetricFlusher(self.logger)
            batches = iter(train_loader)
            while (self.limit_train_batches is None
                   or n_train < self.limit_train_batches):
                tw = time.perf_counter()
                batch = next(batches, None)
                wait += time.perf_counter() - tw
                if batch is None:
                    break
                metrics = train_step(self._rows(batch, train_loader)[0],
                                     gen)
                flusher.add("train_", metrics, global_step)
                global_step += 1
                n_train += 1
            if hasattr(batches, "close"):
                batches.close()
            flusher.flush()
            loader_wait.append(wait)

            val_metrics, val_weights = [], []
            for batch in val_loader:
                if (self.limit_val_batches is not None
                        and len(val_metrics) >= self.limit_val_batches):
                    break
                rows, n = self._rows(batch, val_loader)
                val_metrics.append(eval_step(rows))
                val_weights.append(n)
            val_rows = metrics_to_host(val_metrics)
            for row in val_rows:
                self.logger.log({f"val_{k}": v for k, v in row.items()},
                                step=global_step)
            # each batch's mean already leaves out padded rows: weight the
            # batches by their sample counts
            val_loss = (float(np.average([r["loss"] for r in val_rows],
                                         weights=val_weights))
                        if val_rows else float("nan"))

            if self.rank == 0:
                if epoch_vis_fn is not None:
                    epoch_vis_fn(epoch, global_step)
                self.ckpt.save(epoch, val_loss, training_checkpoint(
                    model, hparams, optimizer, epoch, global_step))
            if self.group is not None:
                # the other ranks go on once the epoch's checkpoint is down
                dist.barrier(group=self.group)
            self.logger.log({"epoch": epoch, "val_loss": val_loss,
                             "epoch_sec": time.time() - t0},
                            step=global_step)
        if prof is not None:
            self._stop_profiler(prof)
        summary = self.logger.summary
        summary["best_checkpoint"] = str(
            None if self.ckpt is None else self.ckpt.best_path)
        summary["global_step"] = global_step
        summary["loader_wait_sec"] = loader_wait
        self.logger.close()
        return summary


def make_trainer(cfg: dict, run_dir) -> Trainer:
    """The Trainer of a train CLI's `trainer` and `logger` blocks."""
    t = cfg["trainer"]
    return Trainer(
        max_epochs=t["max_epochs"], run_dir=run_dir,
        checkpoint_top_k=t.get("checkpoint_top_k", 20),
        num_devices=t.get("num_devices", -1),
        limit_train_batches=t.get("limit_train_batches"),
        limit_val_batches=t.get("limit_val_batches"),
        seed=t.get("seed", 0), profile_epochs=t.get("profile_epochs", 0),
        logger_cfg=cfg.get("logger"), device=t.get("device", "cuda"))


def run_training(cfg: dict, trainer: Trainer, model, learning_rate: float,
                 apply_fn, loss_fn, datamodule, hparams: dict,
                 vis_fn=None) -> dict:
    """The train CLIs' common tail: Adam, the step functions, an optional
    resume (`trainer.resume_from_checkpoint`: weights, statistics,
    optimizer state and step; training goes on at the next epoch), the
    seeded train loader, the per-epoch vis hook and the epoch loop.
    vis_fn(model, vis_batch, epoch, step) runs on the first validation
    batch after each epoch. Returns the run's summary."""
    optimizer = make_adam(model, learning_rate)
    train_step, eval_step = make_train_fns(model, apply_fn, loss_fn,
                                           optimizer, trainer.group)
    start_epoch, step = 0, 0
    resume = cfg["trainer"].get("resume_from_checkpoint")
    if resume:
        epoch, step = resume_training(resume, model, optimizer)
        start_epoch = epoch + 1
    train_loader = datamodule.train_dataloader()
    train_loader.seed = trainer.seed
    val_loader = datamodule.val_dataloader()
    epoch_vis_fn = None
    if vis_fn is not None and len(val_loader) > 0 and trainer.rank == 0:
        vis_batch = batch_to_device(next(iter(val_loader)), trainer.device)
        del vis_batch["_valid_mask"]

        def epoch_vis_fn(epoch, global_step):
            model.eval()
            with torch.no_grad(), full_f32():
                vis_fn(model, vis_batch, epoch, global_step)

    return trainer.fit(model, optimizer, train_step, eval_step,
                       train_loader, val_loader, hparams,
                       epoch_vis_fn=epoch_vis_fn, start_epoch=start_epoch,
                       global_step=step)


def _shared_run_dir(run_dir) -> str:
    """Rank 0's run directory, on every rank of the process group."""
    box = [str(config_mod.make_run_dir(run_dir=run_dir))
           if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def run_ranks(train_fn: Callable, cfg: dict, run_dir=None):
    """The train CLIs' entry: train_fn(cfg, run_dir) on every rank of the
    run, which returns the run directory.

    - Under torchrun (WORLD_SIZE in the environment) this process joins
      that group (init_distributed, nccl on cards) and rank 0's run
      directory is every rank's.
    - Otherwise, when trainer.num_devices resolves to n > 1, n ranks are
      spawned on localhost (launch_ranks: gloo on trainer.device=cpu, nccl
      on cards, one card a rank); a rank that raises stops the others and
      the exception is raised here.
    - Otherwise train_fn runs in this process."""
    t = cfg["trainer"]
    device = t.get("device", "cuda")
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        init_distributed(device=device)
        try:
            return train_fn(cfg, _shared_run_dir(run_dir))
        finally:
            dist.destroy_process_group()
    if dist.is_initialized():
        return train_fn(cfg, run_dir)
    n = resolve_num_devices(t.get("num_devices", -1), device)
    if n == 1:
        return train_fn(cfg, run_dir)
    run_dir = config_mod.make_run_dir(run_dir=run_dir)
    launch_ranks(train_fn, n, args=(cfg, str(run_dir)), device=device)
    return run_dir
