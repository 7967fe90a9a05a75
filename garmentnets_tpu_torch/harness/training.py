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

One device: `num_devices` of -1 or 1. The JAX trainer's data parallelism
over a device mesh is not ported.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from garmentnets_tpu_torch.core.checkpoint import (
    TopKCheckpointManager, resume_training, training_checkpoint)
from garmentnets_tpu_torch.core.device import (
    full_f32, resolve_device, to_device)
from garmentnets_tpu_torch.core.logging import make_logger

# optax.adam's defaults
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
FLUSH_EVERY = 32


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


def make_train_fns(model: torch.nn.Module, apply_fn: Callable,
                   loss_fn: Callable, optimizer: torch.optim.Optimizer):
    """apply_fn(batch, generator) -> the model's outputs; loss_fn(out,
    batch) -> metrics with 'loss'. Returns (train_step(batch, generator)
    -> metrics, eval_step(batch) -> metrics), metrics as detached device
    scalars."""

    def train_step(batch: dict, generator=None) -> dict:
        model.train()
        with full_f32():
            metrics = loss_fn(apply_fn(batch, generator), batch)
            optimizer.zero_grad(set_to_none=True)
            metrics["loss"].backward()
            optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def eval_step(batch: dict) -> dict:
        model.eval()
        with full_f32():
            return loss_fn(apply_fn(batch, None), batch)

    return train_step, eval_step


def check_num_devices(num_devices) -> None:
    if num_devices not in (-1, 1):
        raise ValueError(
            f"trainer.num_devices={num_devices}: the port trains on one "
            "device (-1 or 1); data parallelism over several is not "
            "ported yet")


def batch_to_device(batch: dict, device) -> dict:
    """A loader batch (numpy arrays) -> tensors on `device`, with a
    `_valid_mask` of ones [B] (one device: no padded rows)."""
    out = {k: to_device(v, device) for k, v in batch.items()}
    out["_valid_mask"] = torch.ones(len(batch["x"]), device=device)
    return out


class Trainer:
    """Explicit epoch loop with val-loss checkpoint selection."""

    def __init__(self, max_epochs: int, run_dir, checkpoint_top_k: int = 20,
                 num_devices: int = -1,
                 limit_train_batches: Optional[int] = None,
                 limit_val_batches: Optional[int] = None,
                 seed: int = 0, profile_epochs: int = 0,
                 logger_cfg: Optional[dict] = None, device="cuda"):
        check_num_devices(num_devices)
        self.device = resolve_device(device)
        self.max_epochs = max_epochs
        self.run_dir = run_dir
        self.ckpt = TopKCheckpointManager(
            f"{run_dir}/checkpoints", k=checkpoint_top_k)
        self.logger = make_logger(run_dir, logger_cfg)
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

    def fit(self, model, optimizer, train_step, eval_step, train_loader,
            val_loader, hparams: dict, epoch_vis_fn=None,
            start_epoch: int = 0, global_step: int = 0) -> dict:
        """Train epochs start_epoch .. max_epochs - 1 (a resumed run
        passes its checkpoint's epoch + 1 and global_step).
        epoch_vis_fn(epoch, global_step): the per-epoch image hook
        (harness/vis_hooks.py). Returns the logger's summary."""
        # dropout's random source, on the training device
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        prof = None
        loader_wait = []
        for epoch in range(start_epoch, self.max_epochs):
            if self.profile_epochs and epoch == start_epoch:
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
                metrics = train_step(batch_to_device(batch, self.device), gen)
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
                prepped = batch_to_device(batch, self.device)
                val_metrics.append(eval_step(prepped))
                val_weights.append(len(prepped["_valid_mask"]))
            val_rows = metrics_to_host(val_metrics)
            for row in val_rows:
                self.logger.log({f"val_{k}": v for k, v in row.items()},
                                step=global_step)
            # each batch's mean already leaves out padded rows: weight the
            # batches by their sample counts
            val_loss = (float(np.average([r["loss"] for r in val_rows],
                                         weights=val_weights))
                        if val_rows else float("nan"))

            if epoch_vis_fn is not None:
                epoch_vis_fn(epoch, global_step)
            self.ckpt.save(epoch, val_loss, training_checkpoint(
                model, hparams, optimizer, epoch, global_step))
            self.logger.log({"epoch": epoch, "val_loss": val_loss,
                             "epoch_sec": time.time() - t0},
                            step=global_step)
        if prof is not None:
            self._stop_profiler(prof)
        summary = self.logger.summary
        summary["best_checkpoint"] = str(self.ckpt.best_path)
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
                                           optimizer)
    start_epoch, step = 0, 0
    resume = cfg["trainer"].get("resume_from_checkpoint")
    if resume:
        epoch, step = resume_training(resume, model, optimizer)
        start_epoch = epoch + 1
    train_loader = datamodule.train_dataloader()
    train_loader.seed = trainer.seed
    val_loader = datamodule.val_dataloader()
    epoch_vis_fn = None
    if vis_fn is not None and len(val_loader) > 0:
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
