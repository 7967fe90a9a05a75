"""Predict CLI: batched inference over a dataset -> prediction.zarr (torch
port of garmentnets_tpu/harness/predict.py).

    python -m garmentnets_tpu_torch.harness.predict \\
        main.checkpoint_path=<.ckpt> datamodule.zarr_path=<dataset.zarr>

reads configs/predict_default.yaml with dotted overrides. Per sample it
writes the JAX CLI's prediction.zarr schema: marching_cubes_mesh {verts,
faces, normals, volume_value, volume_gradient_magnitude, warp_field[,
is_on_surface, is_on_surface_logits with prediction.use_hole_prediction]},
point_cloud {pred/gt NOCS, inputs[, pred_nocs_logits]}, the copied
gt_marching_cubes_mesh, the rot-augmented gt_mesh and misc grip-point
data, every array Blosc zstd-6 bitshuffle (zlib, with zarrlite's warning,
where neither libblosc nor `zstandard` is installed), with NaN-sentinel
placeholders where marching cubes finds no surface. The port's eval CLI
(harness/eval.py) and the JAX package's read it. A task-space checkpoint
(`volume_task_space`) runs with the dataset's sim AABB.

`prediction.device` picks the device: the card unless it says cpu (no
fallback). Checkpoints are Lightning `.ckpt` files (core/checkpoint.py;
tools/export_checkpoint.py converts the JAX package's). Batches run as a
4-stage pipeline: the device encodes batch i+1 while the host runs batch
i's marching cubes, warp results are collected two batches later, and a
writer thread compresses and writes the zarr groups. Each batch's stage
times go to the run's metrics.jsonl; garments, elapsed_sec and
garments_per_sec to its summary.json.
"""
from __future__ import annotations

import collections
import pathlib
import queue
import sys
import threading
import time

import numpy as np
import torch

from garmentnets_tpu_torch.core import config as config_mod
from garmentnets_tpu_torch.core.checkpoint import load_pipeline_checkpoint
from garmentnets_tpu_torch.core.device import resolve_device
from garmentnets_tpu_torch.core.logging import make_logger
from garmentnets_tpu_torch.data import zarrlite
from garmentnets_tpu_torch.data.dataset import ConvImplicitWNFDataModule
from garmentnets_tpu_torch.harness.predict_engine import PredictEngine

# encode outputs the zarr groups read, copied to the host behind the pages
FETCH_KEYS = ("pred_nocs", "pred_nocs_confidence", "global_logits",
              "global_feature")


def nan_mc_placeholders() -> dict:
    """The marching_cubes_mesh group of a garment without a surface."""
    return {
        "verts": np.full((1, 3), np.nan, np.float32),
        "faces": np.zeros((1, 3), np.int32),
        "normals": np.full((1, 3), np.nan, np.float32),
        "volume_value": np.full((1,), np.nan, np.float32),
        "volume_gradient_magnitude": np.full((1,), np.nan, np.float32),
        "warp_field": np.full((1, 3), np.nan, np.float32),
    }


def _write_group(group, data: dict) -> None:
    for key, arr in data.items():
        arr = np.asarray(arr)
        # Blosc zstd-6 bitshuffle, the reference's prediction.zarr
        # compressor (reference predict.py:75-79)
        group.array(name=key, data=arr,
                    chunks=arr.shape if arr.size else None,
                    compressor="blosc")


def process_item(enc_np: dict, item: int, batch_np: dict, input_group,
                 output_group, volume_size: int, mesh, warp) -> dict:
    """Write one garment's groups (host side, on the writer thread)."""
    mc_data = nan_mc_placeholders()
    if mesh is not None and warp is not None:
        mc_verts, mc_faces, mc_values, mc_normals = mesh
        mc_data = {
            "verts": mc_verts.astype(np.float32),
            "faces": mc_faces.astype(np.int32),
            # unit volume-gradient normals and per-vertex volume values
            # from the host MC kernel (skimage semantics; reference
            # predict.py:172-197)
            "normals": mc_normals.astype(np.float32),
            "volume_value": mc_values.astype(np.float32),
            "volume_gradient_magnitude":
                warp["verts_ggm"].astype(np.float32),
            "warp_field": warp["warp_field"].astype(np.float32),
        }
        if "mc_surface_logits" in warp:
            # the hole head's logits at the vertices, which the engine
            # returns with use_hole_prediction (JAX CLI predict.py:92-95)
            logits = warp["mc_surface_logits"].astype(np.float32)
            mc_data["is_on_surface"] = logits > 0
            mc_data["is_on_surface_logits"] = logits
    _write_group(output_group.require_group("marching_cubes_mesh"), mc_data)

    pc_data = {
        "pred_nocs": enc_np["pred_nocs"][item],
        "pred_nocs_confidence": enc_np["pred_nocs_confidence"][item].astype(
            np.float32),
        "input_points": batch_np["pos"][item],
        "input_rgb": (batch_np["x"][item] * 255).astype(np.uint8),
        "gt_nocs": batch_np["y"][item],
    }
    if "per_point_logits" in enc_np:
        # reference schema (predict.py:211-236); nothing in eval reads them,
        # and prediction.store_pred_nocs_logits=false skips them
        pc_data["pred_nocs_logits"] = (
            enc_np["per_point_logits"][item].astype(np.float32))
    _write_group(output_group.require_group("point_cloud"), pc_data)

    # copy the gt marching-cubes mesh and the rot-augmented gt mesh
    zarrlite.copy(input_group["marching_cube_mesh"], output_group,
                  name="gt_marching_cubes_mesh")
    rot_mat = batch_np["input_aug_rot_mat"][item]
    gt_mesh_out = output_group.require_group("gt_mesh")
    for key, value in input_group["mesh"].arrays():
        data = value[:]
        if key == "cloth_verts":
            data = data @ rot_mat.T
        gt_mesh_out.array(name=key, data=data, compressor="blosc")

    # grip point predictions (reference predict.py:254-279)
    global_logits = enc_np["global_logits"][item]
    bins = global_logits.shape[-1] // 3
    gb = global_logits.reshape(bins, 3)
    grip_bin = np.argmax(gb, axis=0)
    # REFERENCE QUIRK kept for output and metric parity: the reference's
    # VirtualGrid has grid_shape=(volume_size,)*3, the prediction grid, so
    # the argmax bin is scaled by 1/(volume_size-1), not 1/(bins-1); eval's
    # grip_point_*_global metrics read this value (reference eval.py:152)
    pred_grip = grip_bin.astype(np.float32) / (volume_size - 1)
    eg = np.exp(gb - gb.max(axis=0, keepdims=True))
    grip_conf = eg / eg.sum(axis=0, keepdims=True)

    pos = batch_np["pos"][item]
    grip_idx = int(np.argmin(np.linalg.norm(pos, axis=1)))
    misc = {
        "gt_nocs_grip_point": batch_np["nocs_grip_point"][item],
        "pred_nocs_grip_point": enc_np["pred_nocs"][item][grip_idx],
        "pred_global_nocs_grip_point": pred_grip,
        "pred_global_confidence": grip_conf,
        "global_feature": enc_np["global_feature"][item],
    }
    _write_group(output_group.require_group("misc"), misc)
    return mc_data


def check_supported(pred_cfg: dict) -> None:
    """Refuse, naming the key, the prediction options the port lacks."""
    if pred_cfg.get("device_normals"):
        raise NotImplementedError(
            "prediction.device_normals=true: device normals are not ported "
            "yet (ROADMAP Queue 1, engine options at large volumes)")


class _StageClock:
    """A batch's device encode time: CUDA events around the encode on a
    card (read once the batch is done), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.start, self.end = (torch.cuda.Event(enable_timing=True),
                                    torch.cuda.Event(enable_timing=True))
            self.start.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            self.end.record()
        else:
            self.ms = (time.perf_counter() - self.t0) * 1e3

    def elapsed_ms(self) -> float:
        return self.start.elapsed_time(self.end) if self.cuda else self.ms


def main(cfg, run_dir=None) -> pathlib.Path:
    pred_cfg = dict(cfg["prediction"])
    dm_cfg = dict(cfg["datamodule"])
    check_supported(pred_cfg)
    device = resolve_device(pred_cfg.get("device", "cuda"))
    volume_size = int(pred_cfg["volume_size"])

    checkpoint_path = pathlib.Path(cfg["main"]["checkpoint_path"]).expanduser()
    if not checkpoint_path.exists():
        raise FileNotFoundError(f"main.checkpoint_path: {checkpoint_path}")
    pipe_cfg, state_dict = load_pipeline_checkpoint(checkpoint_path)
    use_holes = bool(pred_cfg.get("use_hole_prediction"))
    if use_holes and not pipe_cfg.has_mc_surface_decoder:
        raise ValueError(
            f"prediction.use_hole_prediction=true needs a checkpoint with "
            f"the mc-surface head (mc_surface_loss_weight > 0); "
            f"main.checkpoint_path={checkpoint_path} has none")
    datamodule = ConvImplicitWNFDataModule(**dm_cfg)
    datamodule.prepare_data()
    val_dataset = datamodule.val_dataset
    # on a card the engine refuses, naming the config key, what the kernels
    # cannot run, before anything is written; prediction.query_chunk sizes
    # the JAX engine's TPU decode programs, while the card's decode kernel
    # tiles the lattice itself, so it is ignored
    engine = PredictEngine(
        pipe_cfg, state_dict, volume_size=volume_size,
        gradient_sigma=pred_cfg["gradient_sigma"],
        iso_level=pred_cfg["iso_surface_level"],
        gradient_direction=pred_cfg["gradient_direction"],
        decode_precision=pred_cfg.get("decode_precision", "high"),
        device=device, num_points=int(dm_cfg["num_pc_sample"]),
        points_key="datamodule.num_pc_sample",
        use_hole_prediction=use_holes,
        task_aabb=(val_dataset.cloth_sim_aabb
                   if pipe_cfg.volume_task_space else None))

    run_dir = config_mod.make_run_dir(run_dir=run_dir)
    logger = make_logger(run_dir, cfg.get("logger"))

    subset = pred_cfg["subset"]
    dataloader = getattr(datamodule, f"{subset}_dataloader")()

    input_samples_group = zarrlite.open(dm_cfg["zarr_path"], "r")["samples"]
    output_root = zarrlite.open(str(run_dir / "prediction.zarr"), "a")
    output_samples = output_root.require_group("samples")
    output_root.attrs.put({"subset": subset})

    config_mod.dump_config(cfg, run_dir, extra={
        "meta": {"script_path": __file__},
        "wandb": {"run_name": logger.name, "run_id": logger.name},
    })

    fetch_keys = FETCH_KEYS
    if pred_cfg.get("store_pred_nocs_logits", True):
        fetch_keys += ("per_point_logits",)

    t_start = time.time()
    n_done = 0

    def finalize(entry):
        """Collect one batch's warp results and write its zarr groups (on
        the writer thread, so compression and IO overlap later batches)."""
        nonlocal n_done
        enc, batch_np, meshes, handle, bidx, stages = entry
        t0 = time.perf_counter()
        warps = engine.warp_collect(handle)
        t1 = time.perf_counter()
        host = engine.host_outputs(enc)
        enc_np = {k: host[k].numpy() for k in fetch_keys}
        for item in range(batch_np["x"].shape[0]):
            row = val_dataset.groups_df.iloc[
                int(batch_np["dataset_idx"][item])]
            attrs = {k: row[k] for k in
                     ("scale", "gender", "sample_id", "garment_name",
                      "grip_vertex_idx")}
            for k in ("gender", "grip_vertex_idx"):
                attrs[k] = int(attrs[k])
            attrs["batch_idx"] = bidx
            out_group = output_samples.require_group(row.group_key)
            out_group.attrs.put(attrs)
            process_item(enc_np, item, batch_np,
                         input_samples_group[row.group_key], out_group,
                         volume_size, meshes[item], warps[item])
            n_done += 1
        t2 = time.perf_counter()
        stages.update(encode_ms=stages.pop("clock").elapsed_ms(),
                      warp_collect_ms=(t1 - t0) * 1e3,
                      writer_ms=(t2 - t1) * 1e3)
        logger.log({"prediction_batch_idx": bidx, **stages}, step=bidx)

    # writer thread with a bounded queue; its exception is re-raised on the
    # main thread
    write_q: queue.Queue = queue.Queue(maxsize=4)
    writer_err: list = []

    def writer_loop():
        while True:
            entry = write_q.get()
            if entry is None:
                return
            try:
                finalize(entry)
            except BaseException as e:  # noqa: BLE001 — re-raised on main
                writer_err.append(e)
                return

    writer = threading.Thread(target=writer_loop, daemon=True,
                              name="predict-writer")
    writer.start()

    def check_writer():
        if writer_err:
            raise writer_err[0]

    def writer_put(entry):
        # never block for good on a full queue if the writer died
        while True:
            check_writer()
            try:
                write_q.put(entry, timeout=5)
                return
            except queue.Full:
                continue

    # 4-stage pipeline: encode(i+1) is queued on the device before batch
    # i's host marching cubes; warp results are collected at depth 2
    pending = None
    inflight = collections.deque()
    batch_iter = iter(dataloader)
    batch_idx = 0
    while True:
        nxt = next(batch_iter, None)
        if nxt is not None:
            clock = _StageClock(device)
            enc = engine.encode(nxt["x"], nxt["pos"])
            clock.stop()
            # pinned host copies of the pages and the point-cloud outputs
            engine.prefetch(enc, extra_keys=fetch_keys)
            nxt_pending = (enc, nxt, clock)
        else:
            nxt_pending = None

        if pending is not None:
            enc, batch_np, clock = pending
            t0 = time.perf_counter()
            engine.host_outputs(enc)        # waits for this batch's encode
            t1 = time.perf_counter()
            meshes = engine.extract_meshes(enc)
            t2 = time.perf_counter()
            handle = engine.warp_dispatch(enc, meshes)
            t3 = time.perf_counter()
            stages = {"clock": clock, "encode_wait_ms": (t1 - t0) * 1e3,
                      "host_mc_ms": (t2 - t1) * 1e3,
                      "warp_dispatch_ms": (t3 - t2) * 1e3}
            inflight.append((enc, batch_np, meshes, handle, batch_idx,
                             stages))
            batch_idx += 1
            while len(inflight) > 2:
                writer_put(inflight.popleft())

        pending = nxt_pending
        if pending is None:
            break
    while inflight:
        writer_put(inflight.popleft())
    writer_put(None)
    writer.join()
    check_writer()
    engine.close()

    elapsed = time.time() - t_start
    logger.summary["garments"] = n_done
    logger.summary["elapsed_sec"] = elapsed
    logger.summary["garments_per_sec"] = n_done / max(elapsed, 1e-9)
    logger.close()
    return run_dir


def cli() -> None:
    overrides = config_mod.parse_cli(sys.argv[1:])
    print(main(config_mod.load_config("predict_default", overrides)))


if __name__ == "__main__":
    cli()
