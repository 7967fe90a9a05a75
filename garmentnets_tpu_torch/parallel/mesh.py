"""Device meshes, batch padding and sharding, and the process group of
data-parallel training (torch port of garmentnets_tpu/parallel/mesh.py).

The JAX package runs one program over a mesh of devices and lets XLA
split it. The port uses PyTorch's two idioms instead:

- inference: one process drives a `Mesh` of devices, as the JAX engine's
  single controller does; the engine splits a batch's rows over the
  "data" axis and the dense decode's D planes over the "space" axis
  (harness/predict_engine.py, ops/dense_decode.dense_decode_sharded);
- training: one process per rank on torch.distributed
  (`init_distributed`); every rank reads the same global batch, pads it
  with `pad_batch_to` and keeps its `shard_rows`, and every cross-rank sum
  that autograd must see goes through `AllReduceSum`
  (models/mlp.py, models/losses.py, harness/training.py).

A mesh may list one device more than once: the CPU tests shard over
several "cpu" entries, and a card can stand in for several.
"""
from __future__ import annotations

import datetime
import os
import sys
import traceback
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# how long a rank waits at a collective before the process group fails
DIST_TIMEOUT_S = 300.0


class Mesh:
    """Devices on named axes (the counterpart of jax.sharding.Mesh), built
    from an explicit device list or nested list whose depth matches
    `axis_names`. Repeated entries are allowed."""

    def __init__(self, devices, axis_names: Sequence[str] = ("data",)):
        arr = np.array(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names) or arr.size == 0:
            raise ValueError(f"a mesh of shape {arr.shape} cannot take the "
                             f"axes {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis names {axis_names}")
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [torch.device(d) for d in arr.reshape(-1)]
        self.devices = flat.reshape(arr.shape)
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_size(self, name: str) -> int:
        """The axis' size, 1 for an axis the mesh does not have."""
        return self.shape.get(name, 1)

    def distinct_devices(self) -> list:
        """Each device of the mesh once, in mesh order."""
        return list(dict.fromkeys(self.devices.reshape(-1)))


def available_devices(num_devices: int = -1, device="cuda") -> list:
    """`num_devices` devices of `device`'s type: each card once (-1: every
    card), or that many "cpu" entries (-1: one). A count above the cards
    present is refused, naming both counts."""
    kind = torch.device(device).type
    if num_devices is None:
        num_devices = -1
    if num_devices < 1 and num_devices != -1:
        raise ValueError(f"num_devices={num_devices}: expected -1 (all) or "
                         "a count of at least 1")
    if kind == "cpu":
        return [torch.device("cpu")] * (1 if num_devices == -1
                                        else num_devices)
    cards = torch.cuda.device_count()
    n = cards if num_devices == -1 else num_devices
    if n > cards or n == 0:
        raise ValueError(f"num_devices={num_devices}: {cards} CUDA "
                         "device(s) present")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(num_devices: int = -1, axis_name: str = "data",
              device="cuda") -> Mesh:
    """A 1-D mesh over `num_devices` devices (available_devices)."""
    return Mesh(available_devices(num_devices, device), (axis_name,))


def make_mesh_2d(n_data: int, n_space: int, device="cuda",
                 data_axis: str = "data", space_axis: str = "space") -> Mesh:
    """A (data, space) mesh over n_data * n_space devices, "space" the
    inner axis: the decode strips of one data shard sit on neighbouring
    devices."""
    devs = available_devices(n_data * n_space, device)
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(n_data, n_space), (data_axis, space_axis))


def pad_batch_to(batch: dict, target_b: int) -> tuple:
    """Pad axis 0 of every array to target_b rows by repeating row 0;
    returns (padded batch, real row count). The padded rows' results are
    dropped by the caller."""
    real_b = next(iter(batch.values())).shape[0]
    if real_b == target_b:
        return batch, real_b
    if real_b > target_b:
        raise ValueError(f"cannot pad a batch of {real_b} rows to "
                         f"{target_b}")

    def pad(a):
        a = np.asarray(a)
        reps = np.repeat(a[:1], target_b - real_b, axis=0)
        return np.concatenate([a, reps], axis=0)
    return {k: pad(v) for k, v in batch.items()}, real_b


def shard_rows(batch, n_shards: int, i: int):
    """Shard i's contiguous rows of a batch (a dict of arrays or tensors,
    or one array) whose row count n_shards divides."""
    if isinstance(batch, dict):
        return {k: shard_rows(v, n_shards, i) for k, v in batch.items()}
    rows = batch.shape[0]
    if rows % n_shards:
        raise ValueError(f"a batch of {rows} rows does not divide into "
                         f"{n_shards} shards")
    if not 0 <= i < n_shards:
        raise ValueError(f"shard {i} of {n_shards}")
    per = rows // n_shards
    return batch[i * per:(i + 1) * per]


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None, device="cuda",
                     timeout_s: float = DIST_TIMEOUT_S) -> torch.device:
    """Join the default process group and return this rank's device.

    world_size, rank and the rendezvous come from the arguments or from
    torchrun's environment (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT; `init_method` defaults to "env://"). The backend defaults
    to nccl on cards, one card a rank (more ranks than cards raises,
    naming both counts), and to gloo on the CPU. Ranks share cards only
    when the caller passes backend="gloo" with a CUDA device: rank r then
    runs on card r mod the card count. A rank waits at most `timeout_s`
    at a collective."""
    env = os.environ
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(env["RANK"]) if rank is None else rank
    local_rank = int(env.get("LOCAL_RANK", rank))
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("init_distributed on cuda: no CUDA device "
                               "present")
        if backend is None:
            if world_size > cards:
                raise ValueError(
                    f"{world_size} ranks on {cards} CUDA device(s): nccl "
                    "takes one card a rank (pass backend='gloo' to share "
                    "cards)")
            backend = "nccl"
        rank_device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(rank_device)
    else:
        backend = backend or "gloo"
        rank_device = torch.device("cpu")
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return rank_device


class AllReduceSum(torch.autograd.Function):
    """The sum of x over the ranks of `group`, on every rank. Backward
    all-reduces the incoming gradient: each rank's loss depends on every
    rank's x through the sum, so x's gradient is the sum of the ranks'."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        g = grad.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """AllReduceSum over `group`; x itself when there is no group (one
    process)."""
    return x if group is None else AllReduceSum.apply(x, group)


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank: int, fn, world_size: int, init_method: str, device,
                backend, timeout_s: float, args: tuple) -> None:
    if torch.device(device).type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    init_distributed(backend, init_method, world_size, rank, device,
                     timeout_s)
    try:
        fn(*args)
    except BaseException:
        # the first rank to fail may not be the one the parent reports (a
        # peer's collective fails right after it), so every rank prints
        # its own error
        print(f"rank {rank} of {world_size} failed:", file=sys.stderr)
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def launch_ranks(fn, world_size: int, args: tuple = (), device="cuda",
                 backend: Optional[str] = None,
                 timeout_s: float = DIST_TIMEOUT_S) -> None:
    """Run fn(*args) on `world_size` ranks, each a process started with
    the spawn method, joined over tcp://127.0.0.1 (init_distributed with
    `backend` and `device`; fn must be importable by its module path).
    Returns when every rank has returned; when a rank raises, the others
    are stopped and the exception is raised here."""
    import torch.multiprocessing as mp
    init_method = f"tcp://127.0.0.1:{free_port()}"
    mp.start_processes(
        _rank_entry, args=(fn, world_size, init_method, device, backend,
                           timeout_s, tuple(args)),
        nprocs=world_size, join=True, start_method="spawn")
