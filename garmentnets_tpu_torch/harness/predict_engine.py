"""Batched inference engine (torch port of garmentnets_tpu/harness/predict_engine.py).

Per batch:
  encode: stage-1 PointNet++ (FPS kernel) -> NOCS + confidence -> volume
      aggregation -> 3D U-Net -> dense WNF over the volume_size^3 lattice
      (the fused decode kernel of the precision tier) -> gaussian gradient
      magnitude (ggm kernel) -> int8 brick extraction and page packing.
  extract_meshes: host C++ marching cubes on the brick pages, one garment
      per thread.
  warp: surface decoder at the mesh vertices plus the ggm gather at each
      vertex's nearest voxel (plus the mc-surface head's logits with
      `use_hole_prediction`, and the vertex normals' octahedral codes with
      `device_normals`).

Two options for large volumes, as in the JAX engine:
- `cube_masks` (on by default at volume_size >= 192): the bricks carry
  each brick's 64-bit cube-straddle mask (72-byte payloads), so host
  marching cubes skips its rejection scan; the meshes are the same.
- `device_normals` (off by default): the vertex normals come from the
  warp (ops/normals: the gradient of the full-precision WNF at each
  vertex, 16-bit octahedral codes) and host marching cubes skips its
  normals pass. The codes ride the float32 warp buffer as their exact
  integer values, and the dense WNF stays on the device until the warp.

The model variants run as the JAX engine runs them: a task-space
checkpoint (`volume_task_space`) takes the dataset's sim AABB
(`task_aabb`) and aggregates the sim points normalized by it in place of
the predicted NOCS; hole prediction (`use_hole_prediction`, on only for a
checkpoint with the mc-surface head) adds the head's logits as a fifth
warp channel, at the same f16-rounded queries.

Several devices (`mesh`, a parallel/mesh.Mesh on "data" and "space"
axes, the JAX engine's mesh): one model replica and packed decoder a
distinct device; a batch's rows split over "data" (a batch the axis does
not divide is refused), and each data shard runs stage 1, the U-Net, the
ggm, the bricks and the warp on its data device and its dense decode as
one strip of D planes a device of its "space" row
(ops/dense_decode.dense_decode_sharded). Every card runs the kernels on
its own shard; the host queues every shard's work before it waits on
any. The encoding holds one dict a shard (`"_shards"`), and the engine's
methods walk them in batch order, so callers see the same results as
from one device.

The warp's query points are the mesh vertices rounded to float16, as the
JAX engine's are (its f16 wire format): the nearest-voxel ggm gather
floors q * (S - 1), and a vertex on a lattice plane floors to one side or
the other with the last bit of q, so only the same rounding gives the JAX
engine's values (a 0.03-voxel move at 128^3). Results stay float32. Entry
points run on the card unless the caller passes device="cpu".

Nothing on the host waits for the whole stream: inputs go up through
pinned staging copies, `prefetch` copies a batch's brick pages and NOCS
outputs into pinned host buffers and records an event, `extract_meshes`
waits on that event only, and `warp_dispatch`/`warp_collect` do the same
for the warp result. So a caller can queue encode(i+1) before running
batch i's host marching cubes, and the two overlap. On the CPU the copies
and events are skipped on the same code path.
"""
from __future__ import annotations

import atexit
import contextlib
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from garmentnets_tpu_torch.core.device import (
    full_f32, resolve_device, to_device)
from garmentnets_tpu_torch.core.trace import span
from garmentnets_tpu_torch.models.pipeline import (
    ConvImplicitWNFPipeline, PipelineConfig)
from garmentnets_tpu_torch.ops.dense_decode import (
    check_precision, dense_decode, dense_decode_sharded, eval_layers)
from garmentnets_tpu_torch.ops.gaussian import gaussian_gradient_magnitude
from garmentnets_tpu_torch.ops.isosurface import (
    extract_active_bricks, pack_brick_pages, read_page_counts,
    split_brick_payload, unpack_brick_pages)
from garmentnets_tpu_torch.ops.marching_cubes import (
    marching_cubes, marching_cubes_bricks)
from garmentnets_tpu_torch.ops.normals import (
    oct_decode_np, sample_gradient_normals_oct)
from garmentnets_tpu_torch.parallel.mesh import shard_rows

# the volume width from which the engine ships straddle masks by default
MASKS_FROM_VOLUME = 192


_MC_POOLS: dict = {}
_MC_POOLS_LOCK = threading.Lock()


def shared_mc_pool(threads: int) -> Optional[ThreadPoolExecutor]:
    """The process-wide marching-cubes pool of `threads` workers (None for
    one thread): one pool per width for the life of the process, shut down
    at exit, so building engine after engine adds no threads. The C++
    marching-cubes library is loaded before the first pool exists, so no
    worker races its build."""
    if threads <= 1:
        return None
    pool = _MC_POOLS.get(threads)
    if pool is None:
        with _MC_POOLS_LOCK:
            pool = _MC_POOLS.get(threads)
            if pool is None:
                from garmentnets_tpu_torch.ops.marching_cubes import _lib
                _lib()
                pool = ThreadPoolExecutor(threads, thread_name_prefix="mc")
                atexit.register(pool.shutdown, wait=False)
                _MC_POOLS[threads] = pool
    return pool


def check_card_limits(cfg: PipelineConfig, volume_size: int,
                      gradient_sigma: float, num_points: Optional[int] = None,
                      points_key: str = "datamodule.num_pc_sample") -> None:
    """Refuse, naming the config key, what the card's kernels cannot run:
    a volume wider than the ggm kernel's rows, a gaussian radius beyond its
    taps, more points than the FPS kernel holds, and volume-decoder widths,
    depth or head that the dense decode kernel does not take. Runs on the
    CPU too; the engine calls it for a card device, with the point count
    its caller gives. The variants need no limit of their own: the
    mc-surface head runs in stock torch at the mesh vertices (grid_sample
    and its MLP, as the surface decoder does), not through the decode
    kernel, and the task-space rescale is elementwise."""
    from garmentnets_tpu_torch.kernels import dense_decode_tc, fps, ggm
    from garmentnets_tpu_torch.ops.gaussian import ggm_radius
    errors = []
    if volume_size > ggm.MAX_WIDTH:
        errors.append(f"prediction.volume_size={volume_size}: the ggm "
                      f"kernel takes volumes up to {ggm.MAX_WIDTH} wide")
    radius = ggm_radius(gradient_sigma)
    if not 1 <= radius <= ggm.MAX_RADIUS:
        errors.append(f"prediction.gradient_sigma={gradient_sigma}: gaussian "
                      f"radius {radius}, the ggm kernel takes 1 to "
                      f"{ggm.MAX_RADIUS} (sigma below "
                      f"{(ggm.MAX_RADIUS + 0.5) / 4})")
    if num_points is not None and not 1 <= num_points <= fps.MAX_POINTS:
        errors.append(f"{points_key}={num_points}: the FPS kernel takes 1 "
                      f"to {fps.MAX_POINTS} points")
    ch = list(cfg.volume_decoder_channels)
    key = f"volume_decoder_params.nn_channels={ch} (checkpoint hparams)"
    if ch[-1] != 1:
        errors.append(f"{key}: the dense decode kernel has a scalar head "
                      f"only, got {ch[-1]} outputs")
    if len(ch) - 3 > dense_decode_tc.MAX_MID:
        errors.append(f"{key}: the dense decode kernel takes up to "
                      f"{dense_decode_tc.MAX_MID} hidden layers, got "
                      f"{len(ch) - 3}")
    if max(ch[1:-1], default=0) > dense_decode_tc.WIDTHS[-1]:
        errors.append(f"{key}: the dense decode kernel takes widths up to "
                      f"{dense_decode_tc.WIDTHS[-1]}")
    if errors:
        raise ValueError("the CUDA kernels cannot run this configuration: "
                         + "; ".join(errors))


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """Queue a copy of a card tensor into a pinned host buffer (a CPU
    tensor is returned as it is)."""
    if not t.is_cuda:
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t, non_blocking=True)


def _record_event(device: torch.device):
    """An event behind the work queued so far on a card; None on the
    CPU."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def _on(device: torch.device):
    """The current-device context of a card (nothing on the CPU)."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _key(device) -> torch.device:
    """A device with its card index filled in (the current card for a
    bare "cuda")."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def mesh_grid(mesh) -> np.ndarray:
    """A mesh's devices as an [n_data, n_space] grid (an axis the mesh
    lacks has size 1); axes other than "data" and "space" are refused."""
    names = tuple(mesh.axis_names)
    if not set(names) <= {"data", "space"}:
        raise ValueError(f"the engine's mesh axes are 'data' and 'space', "
                         f"got {names}")
    grid = np.vectorize(_key, otypes=[object])(mesh.devices)
    if "data" not in names:
        grid, names = grid[None], ("data",) + names
    if "space" not in names:
        grid, names = grid[..., None], names + ("space",)
    return grid if names == ("data", "space") else grid.T


class _Replica:
    """The model and packed decoder of one device."""

    def __init__(self, cfg: PipelineConfig, device: torch.device,
                 task_aabb):
        self.device = device
        self.model = ConvImplicitWNFPipeline(cfg).to(device).eval()
        self.task_aabb = (None if task_aabb is None else torch.as_tensor(
            np.asarray(task_aabb, np.float32), device=device))
        self.vd_layers = None
        self.vd_packed = None

    def load_state_dict(self, state_dict: dict, precision: str) -> None:
        self.model.load_state_dict(state_dict)
        self.vd_layers = eval_layers(self.model.volume_decoder.mlp)
        self.vd_packed = None
        if self.device.type == "cuda":
            from garmentnets_tpu_torch.kernels.dense_decode_tc import (
                pack_decoder)
            with _on(self.device):
                self.vd_packed = pack_decoder(self.vd_layers, precision)


class PredictEngine:
    def __init__(self, cfg: PipelineConfig, state_dict: dict,
                 volume_size: int = 128, gradient_sigma: float = 0.5,
                 iso_level: float = 0.5, gradient_direction: str = "ascent",
                 active_cap: Optional[int] = None,
                 decode_precision: str = "high",
                 return_volume: bool = False,
                 mc_threads: Optional[int] = None,
                 device="cuda", num_points: Optional[int] = None,
                 points_key: str = "datamodule.num_pc_sample",
                 use_hole_prediction: bool = False, task_aabb=None,
                 cube_masks: Optional[bool] = None,
                 device_normals: bool = False, mesh=None):
        """state_dict: the pipeline's weights in the reference layout (see
        core/weights.py). decode_precision: the dense decode's tier, 'high'
        (bf16x3, the JAX engine's default), 'default' (bf16) or 'highest'
        (f32), case-insensitive. num_points: the caller's points a cloud,
        checked on a card device against the FPS kernel under the config
        key `points_key`. use_hole_prediction: add the mc-surface logits to
        the warp (on only when cfg has the head). task_aabb: the dataset's
        sim AABB [2, 3], required by a task-space cfg. cube_masks: ship
        the per-brick straddle masks (None: from volume_size 192 on, the
        JAX engine's rule). device_normals: the vertex normals from the
        warp instead of host marching cubes. mesh: a parallel/mesh.Mesh
        with "data" and/or "space" axes to run on instead of `device`
        (volume_size must divide over "space")."""
        if cfg.volume_task_space and task_aabb is None:
            raise ValueError(
                "cfg.volume_task_space=True requires task_aabb "
                "(dataset.cloth_sim_aabb, shape [2,3])")
        self.decode_precision = check_precision(decode_precision)
        self.mesh = mesh
        kinds = ([resolve_device(device)] if mesh is None else
                 [resolve_device(d) for d in mesh.distinct_devices()])
        n_space = 1 if mesh is None else mesh.axis_size("space")
        if volume_size % n_space:
            raise ValueError(
                f"prediction.volume_size={volume_size} does not divide over "
                f"the mesh's {n_space}-way 'space' axis")
        if any(d.type == "cuda" for d in kinds):
            check_card_limits(cfg, volume_size, gradient_sigma,
                              num_points=num_points, points_key=points_key)
        if mesh is None:
            self._grid = np.empty((1, 1), dtype=object)
            self._grid[0, 0] = _key(kinds[0])
        else:
            self._grid = mesh_grid(mesh)
        # the first data shard's device: the engine's device
        self.device = self._grid[0, 0]
        devices = list(dict.fromkeys(self._grid.reshape(-1)))
        self.cfg = cfg
        self.use_hole_prediction = bool(use_hole_prediction
                                        and cfg.has_mc_surface_decoder)
        self._replicas = {d: _Replica(cfg, d, task_aabb) for d in devices}
        self.model = self._replicas[self.device].model
        self.volume_size = volume_size
        self.gradient_sigma = gradient_sigma
        self.iso_level = float(iso_level)
        self.gradient_direction = gradient_direction
        if active_cap is None:
            # active cubes scale with iso-surface area ~ volume_size^2
            active_cap = int(65536 * max(1.0, (volume_size / 128) ** 2))
        self.active_cap = active_cap
        # ~20 active cubes per shipped brick on a cloth shell: cap/8 bricks
        brick_cap = max(64, active_cap // 8)
        self.brick_page = min(1024, brick_cap)
        self.brick_cap = -(-brick_cap // self.brick_page) * self.brick_page
        self.return_volume = return_volume
        self.cube_masks = (volume_size >= MASKS_FROM_VOLUME
                           if cube_masks is None else bool(cube_masks))
        self.device_normals = bool(device_normals)
        self.load_state_dict(state_dict)
        if mc_threads is None:
            mc_threads = min(4, os.cpu_count() or 1)
        self._pool = shared_mc_pool(mc_threads)

    @property
    def n_data(self) -> int:
        """The data shards a batch splits into (1 without a mesh)."""
        return self._grid.shape[0]

    def load_state_dict(self, state_dict: dict) -> None:
        """Load new weights (the same architecture) into every replica,
        re-fold the volume decoder's layers, which the dense decode reads,
        and, for the tensor-core kernel on a card, re-pack their bf16
        parts."""
        for rep in self._replicas.values():
            rep.load_state_dict(state_dict, self.decode_precision)

    def _decode(self, feature_volume: torch.Tensor,
                space_devices=None) -> torch.Tensor:
        """The dense WNF at the engine's tier, on the feature volume's
        device or as strips over `space_devices`. The transposed volume
        decoded at the xyz lattice equals the volume decoded at the flipped
        lattice: ImplicitWNFDecoder's axis quirk."""
        rep = self._replicas[_key(feature_volume.device)]
        fv = feature_volume.transpose(1, 3).contiguous()
        if space_devices is None or list(space_devices) == [rep.device]:
            return dense_decode(fv, rep.vd_layers, self.volume_size,
                                self.decode_precision, packed=rep.vd_packed)
        return dense_decode_sharded(
            fv, rep.vd_layers, self.volume_size, self.decode_precision,
            space_devices, {d: self._replicas[d].vd_packed
                            for d in space_devices})

    def close(self) -> None:
        """Let go of the marching-cubes pool; the pool itself is shared by
        every engine of the process and stays up."""
        self._pool = None

    # ------------------------------------------------------------------
    @torch.no_grad()
    @full_f32()
    def encode(self, x, pos) -> dict:
        """x, pos: [B, N, 3] (numpy or tensors) -> dict of device tensors;
        with a mesh, {"_shards": [one such dict a data shard]}, every
        shard's work queued before the host waits on any."""
        if self.mesh is None:
            return self._encode_shard(x, pos, self._grid[0])
        B = x.shape[0]
        if B % self.n_data:
            raise ValueError(f"a batch of {B} rows does not divide over the "
                             f"mesh's {self.n_data}-way 'data' axis")
        return {"_shards": [
            self._encode_shard(shard_rows(x, self.n_data, i),
                               shard_rows(pos, self.n_data, i), row)
            for i, row in enumerate(self._grid)]}

    def _encode_shard(self, x, pos, row) -> dict:
        """One data shard's encode on its device row[0], its dense decode
        as strips over `row` (the shard's "space" devices)."""
        dev = row[0]
        rep = self._replicas[dev]
        with _on(dev):
            x = to_device(x, dev, torch.float32)
            pos = to_device(pos, dev, torch.float32)
            # the encode/* spans name the stages in a torch.profiler trace
            # (tools/profile_encode.py)
            with span("encode/stage1_pointnet2"):
                p2 = rep.model.pointnet2_forward(x, pos)
                if self.cfg.volume_task_space:
                    aabb = rep.task_aabb.expand(pos.shape[0], 2, 3)
                    p2 = rep.model.apply_volume_task_space(pos, aabb, p2)
            with span("encode/aggregate_unet3d"):
                feature_volume = rep.model.unet3d_forward(p2["nocs_data"])
            with span("encode/dense_decode"):
                wnf = self._decode(feature_volume, list(row))
            with span("encode/ggm"):
                ggm = gaussian_gradient_magnitude(wnf, self.gradient_sigma)
            with span("encode/bricks_and_pages"):
                base, vals, counts = extract_active_bricks(
                    wnf, self.iso_level, self.brick_cap,
                    with_masks=self.cube_masks)
                # page 0 carries the counts in a header row
                pages = pack_brick_pages(base, vals, self.brick_page,
                                         counts=counts)
        nd = p2["nocs_data"]
        out = {
            "active_pages": pages,
            "active_counts": counts,
            "wnf_ggm": ggm,
            "feature_volume": feature_volume,
            "pred_nocs": nd["pos"],
            "pred_nocs_confidence": nd["pred_confidence"],
            "per_point_logits": p2["per_point_logits"],
            "global_logits": p2["global_logits"],
            "global_feature": p2["global_feature"],
        }
        if self.return_volume or self.device_normals:
            out["wnf_volume"] = wnf
        return out

    def prefetch(self, enc: dict, extra_keys=()) -> None:
        """Start copying every brick page of `enc`, and the tensors named
        in `extra_keys`, into pinned host buffers, and record an event
        behind the copies (one a shard). All pages are copied (~4.5 MB at
        B=8, 128^3, ~20 MB at 256^3 with masks), so no count has to come
        back first. The buffers hold stale bytes until the event has
        completed: read them only through `host_outputs`."""
        for sh in enc.get("_shards", [enc]):
            pages = sh["active_pages"]
            dev = _key(pages[0].device)
            with _on(dev):
                host = {"active_pages": [_to_host(p) for p in pages]}
                host.update({k: _to_host(sh[k]) for k in extra_keys})
                # the source page list is kept to tell a stale prefetch
                # apart
                sh["_prefetch"] = (pages, host, _record_event(dev))

    def encode_done(self, enc: dict) -> bool:
        """Whether the prefetched copies of `enc` (and so its encode) have
        completed; True on the CPU."""
        return all(sh["_prefetch"][2] is None or sh["_prefetch"][2].query()
                   for sh in enc.get("_shards", [enc]))

    def host_outputs(self, enc: dict) -> dict:
        """The prefetched host tensors of `enc`, after waiting on its
        events only (prefetching first if it was not, or if its pages were
        replaced since); a sharded encoding's shards concatenated in batch
        order."""
        if "_shards" not in enc:
            return self._host_outputs_shard(enc)
        outs = [self._host_outputs_shard(sh) for sh in enc["_shards"]]
        merged = {k: torch.cat([o[k] for o in outs])
                  for k in outs[0] if k != "active_pages"}
        merged["active_pages"] = [
            torch.cat(pages) for pages in zip(*(o["active_pages"]
                                                for o in outs))]
        return merged

    def _host_outputs_shard(self, enc: dict) -> dict:
        pf = enc.get("_prefetch")
        if pf is None or pf[0] is not enc["active_pages"]:
            self.prefetch(enc)
            pf = enc["_prefetch"]
        if pf[2] is not None:
            pf[2].synchronize()
        return pf[1]

    def extract_meshes(self, enc: dict) -> list:
        """Read the batch's prefetched brick pages and run the host C++
        marching cubes per garment (with the pages' straddle masks where
        they carry them). Returns per garment (verts, faces, values,
        normals), or None where no surface was found; normals is None with
        device_normals (the warp returns them)."""
        return [m for sh in enc.get("_shards", [enc])
                for m in self._extract_meshes_shard(sh)]

    def _extract_meshes_shard(self, enc: dict) -> list:
        pages = self._host_outputs_shard(enc)["active_pages"]
        p0 = pages[0].numpy()
        counts = read_page_counts(p0)
        B = len(counts)
        kmax = int(counts.max()) if B else 0
        S = self.volume_size
        spacing = (1.0 / (S - 1),) * 3
        results: list = [None] * B
        if kmax == 0:
            return results
        if kmax > self.brick_cap:
            # capacity overflow: full-volume MC on the dense WNF (rare)
            wnf = self._dense_wnf(enc).cpu().numpy()
            for b in range(B):
                try:
                    v, f, norms, vals = marching_cubes(
                        wnf[b], self.iso_level, spacing=spacing,
                        gradient_direction=self.gradient_direction)
                    results[b] = (v, f, vals, norms)
                except ValueError:
                    pass
            return results
        n_pages = max(1, -(-kmax // self.brick_page))
        srcs = [p0] + [p.numpy() for p in pages[1:n_pages]]
        brick_idx, brick_vals = unpack_brick_pages(srcs, header=True)
        brick_vals, masks = split_brick_payload(brick_vals)
        devnorm = self.device_normals

        def run_one(b):
            n = int(counts[b])
            if n == 0:
                return None
            try:
                res = marching_cubes_bricks(
                    brick_idx[b, :n], brick_vals[b, :n], (S, S, S),
                    self.iso_level, spacing,
                    gradient_direction=self.gradient_direction,
                    return_values=True, return_normals=not devnorm,
                    cube_masks=None if masks is None else masks[b, :n])
            except ValueError:
                return None
            return (*res, None) if devnorm else res

        if self._pool is not None and B > 1:
            return list(self._pool.map(run_one, range(B)))
        return [run_one(b) for b in range(B)]

    @torch.no_grad()
    @full_f32()
    def _dense_wnf(self, enc: dict) -> torch.Tensor:
        if "wnf_volume" in enc:
            return enc["wnf_volume"]
        fv = enc["feature_volume"]
        with _on(_key(fv.device)):
            return self._decode(fv)

    @torch.no_grad()
    @full_f32()
    def warp_dispatch(self, enc: dict, meshes: list):
        """Queue the surface decoder + ggm gather (+ the mc-surface logits
        with hole prediction, + the normals' octahedral codes with device
        normals) over all garments' mesh vertices, each shard's on its
        device, and the copy of the result into a pinned host buffer;
        returns a handle for warp_collect."""
        if "_shards" not in enc:
            return self._warp_dispatch_shard(enc, meshes)
        handles, start = [], 0
        for sh in enc["_shards"]:
            n = sh["feature_volume"].shape[0]
            handles.append(self._warp_dispatch_shard(
                sh, meshes[start:start + n]))
            start += n
        return {"_shards": handles}

    def _warp_dispatch_shard(self, enc: dict, meshes: list):
        sizes = [0 if m is None else len(m[0]) for m in meshes]
        vmax = max(sizes) if sizes else 0
        if vmax == 0:
            return (None, None, sizes)
        q = np.zeros((len(meshes), vmax, 3), np.float16)
        for b, m in enumerate(meshes):
            if m is not None:
                q[b, :len(m[0])] = m[0]
        dev = _key(enc["feature_volume"].device)
        model = self._replicas[dev].model
        with _on(dev):
            q = to_device(q, dev).float()
            warp = model.surface_decoder_forward(enc["feature_volume"], q)
            ggm = enc["wnf_ggm"]
            B, S = ggm.shape[0], self.volume_size
            nn_idx = torch.clamp((q * (S - 1)).to(torch.int64), 0, S - 1)
            flat = ((nn_idx[..., 0] * S + nn_idx[..., 1]) * S
                    + nn_idx[..., 2])
            ggm_at = torch.gather(ggm.reshape(B, -1), 1, flat)
            cols = [warp, ggm_at[..., None]]
            if self.use_hole_prediction:
                cols.append(model.mc_surface_decoder_forward(
                    enc["feature_volume"], q)[..., :1])
            if self.device_normals:
                # the u16 codes as exact float32 integers (exact below
                # 2^24)
                codes = sample_gradient_normals_oct(
                    enc["wnf_volume"], q, self.gradient_direction == "ascent")
                cols.append(codes.to(torch.float32)[..., None])
            out = _to_host(torch.cat(cols, dim=-1))
            return (out, _record_event(dev), sizes)

    def warp_collect(self, handle) -> list:
        """Wait on the handle's events only and split the host result."""
        if isinstance(handle, dict):
            return [w for h in handle["_shards"]
                    for w in self.warp_collect(h)]
        out, event, sizes = handle
        if out is None:
            return [None] * len(sizes)
        if event is not None:
            event.synchronize()
        out = out.numpy()
        return [None if n == 0 else self._split_channels(out[b, :n])
                for b, n in enumerate(sizes)]

    def _split_channels(self, rows: np.ndarray) -> dict:
        res = {"warp_field": rows[:, :3], "verts_ggm": rows[:, 3]}
        if self.use_hole_prediction:
            res["mc_surface_logits"] = rows[:, 4]
        if self.device_normals:
            res["normals"] = oct_decode_np(rows[:, -1])
        return res

    def warp_batch(self, enc: dict, meshes: list) -> list:
        """meshes: list of (verts, faces, ...) or None -> per garment
        {"warp_field" [V, 3], "verts_ggm" [V][, "mc_surface_logits" [V]]
        [, "normals" [V, 3]]} or None."""
        return self.warp_collect(self.warp_dispatch(enc, meshes))
