"""Dataset + datamodule: zarr-backed sampling with reference-exact semantics.

The port's copy of garmentnets_tpu/data/dataset.py: the same draws in the
same order, so a seeded sample is bit-equal to the JAX package's.

Capability parity with reference `datasets/conv_implicit_wnf_dataset.py`:
- `data_io` (zarr group reads), view selection + 6000-point subsample,
  volume/surface/mc-surface query sampling, z-rotation & point-noise
  augmentation, `static_epoch_seed` determinism (idx-seeded RandomState with
  the same call order, so seeded draws reproduce).
- instance-level 8:1:1 split grouped by sample_id with the same seeded
  permutation (reference :478-534).

Samples are dense numpy dicts collated to [B, N, C] arrays (no PyG ragged
Batch), and loading is a host-side prefetch thread with optional worker
threads — not torch DataLoader worker processes.
"""
from __future__ import annotations

import pathlib
import queue
import threading
from typing import Optional, Tuple

import numpy as np
import pandas as pd

from garmentnets_tpu_torch.data import zarrlite
from garmentnets_tpu_torch.ops import geometry
from garmentnets_tpu_torch.ops.grid_sample import grid_sample_trilinear_np
from garmentnets_tpu_torch.utils.cache import file_attr_cache


def _get_groups_df(samples_group) -> pd.DataFrame:
    rows = {}
    for key, group in samples_group.groups():
        rows[key] = group.attrs.asdict()
    df = pd.DataFrame(data=list(rows.values()), index=list(rows.keys()))
    df.drop_duplicates(inplace=True)
    df["group_key"] = df.index
    return df


class ConvImplicitWNFDataset:
    def __init__(self,
                 zarr_path: str,
                 metadata_cache_dir: str = None,
                 # sample size
                 num_pc_sample: int = 6000,
                 num_volume_sample: int = 0,
                 num_surface_sample: int = 0,
                 num_mc_surface_sample: int = 0,
                 # mixed sampling config
                 surface_sample_ratio: float = 0,
                 surface_sample_std: float = 0.05,
                 # surface sample noise
                 surface_normal_noise_ratio: float = 0,
                 surface_normal_std: float = 0,
                 # data augmentation
                 enable_augumentation: bool = True,
                 random_rot_range: Tuple[float, float] = (-90, 90),
                 num_views: int = 4,
                 pc_noise_std: float = 0,
                 # volume config
                 volume_size: int = 128,
                 volume_group: str = "nocs_winding_number_field",
                 tsdf_clip_value: Optional[float] = None,
                 volume_absolute_value: bool = False,
                 include_volume: bool = False,
                 # random seed
                 static_epoch_seed: bool = False,
                 **kwargs):
        path = pathlib.Path(zarr_path).expanduser()
        assert path.exists(), f"dataset not found: {path}"
        root = zarrlite.open(str(path), "r")
        samples_group = root["samples"]

        _, sample_group = next(iter(samples_group.groups()))
        if volume_size is not None and num_volume_sample > 0:
            assert str(volume_size) in sample_group["volume"][volume_group]

        if metadata_cache_dir is not None:
            groups_df = file_attr_cache(
                zarr_path, cache_dir=metadata_cache_dir)(
                    _get_groups_df)(samples_group)
        else:
            groups_df = _get_groups_df(samples_group)
        assert groups_df.index.is_monotonic_increasing
        groups_df["idx"] = np.arange(len(groups_df))

        volume_task_space = False
        if volume_group == "sim_nocs_winding_number_field":
            volume_task_space = True
            assert num_mc_surface_sample == 0

        self.samples_group = samples_group
        self.groups_df = groups_df
        self.num_pc_sample = num_pc_sample
        self.num_volume_sample = num_volume_sample
        self.num_surface_sample = num_surface_sample
        self.num_mc_surface_sample = num_mc_surface_sample
        self.surface_sample_ratio = surface_sample_ratio
        self.surface_sample_std = surface_sample_std
        self.surface_normal_noise_ratio = surface_normal_noise_ratio
        self.surface_normal_std = surface_normal_std
        self.enable_augumentation = enable_augumentation
        self.random_rot_range = tuple(random_rot_range)
        self.num_views = num_views
        assert num_views > 0
        self.pc_noise_std = pc_noise_std
        self.volume_size = volume_size
        self.volume_group = volume_group
        self.tsdf_clip_value = tsdf_clip_value
        self.volume_absolute_value = volume_absolute_value
        self.include_volume = include_volume
        self.volume_task_space = volume_task_space
        self.static_epoch_seed = static_epoch_seed
        self.cloth_sim_aabb = root["summary/cloth_aabb_union"][:].astype(
            np.float32)

    def __len__(self):
        return len(self.groups_df)

    # -- io ---------------------------------------------------------------
    def data_io(self, idx: int) -> dict:
        row = self.groups_df.iloc[idx]
        group = self.samples_group[row.group_key]
        attrs = group.attrs.asdict()
        pc_group = group["point_cloud"]
        mesh_group = group["mesh"]
        data = {
            "cloth_sim_verts": mesh_group["cloth_verts"][:],
            "cloth_nocs_verts": mesh_group["cloth_nocs_verts"][:],
            "cloth_faces_tri": mesh_group["cloth_faces_tri"][:],
            "pc_nocs": pc_group["nocs"][:],
            "pc_sim": pc_group["point"][:],
            "pc_sim_rgb": pc_group["rgb"][:],
            "pc_sizes": pc_group["sizes"][:],
            "scale": attrs["scale"],
            "grip_vertex_idx": attrs["grip_vertex_idx"],
        }
        if self.num_mc_surface_sample > 0:
            mcg = group["marching_cube_mesh"]
            data["marching_cube_verts"] = mcg["marching_cube_verts"][:]
            data["marching_cube_faces"] = mcg["marching_cube_faces"][:]
            data["is_vertex_on_surface"] = mcg["is_vertex_on_surface"][:]
        if self.num_volume_sample > 0:
            vg = group["volume"][self.volume_group]
            raw_volume = vg[str(self.volume_size)][:]
            # copy=False: the zarr read already owns fresh memory, and the
            # 8.4 MB no-op astype copy was measured input-pipeline overhead
            volume = raw_volume.astype(np.float32, copy=False)
            if self.tsdf_clip_value is not None:
                volume = np.clip(volume / self.tsdf_clip_value, -1, 1)
            if self.volume_absolute_value:
                volume = np.abs(volume)
            data["volume"] = volume
        return data

    # -- sampling (reference :182-368) --------------------------------------
    def get_base_data(self, idx: int, data_in: dict) -> dict:
        seed = idx if self.static_epoch_seed else None
        rs = np.random.RandomState(seed=seed)
        all_idxs = np.arange(len(data_in["pc_sim"]))
        all_num_views = len(data_in["pc_sizes"])
        if self.num_views < all_num_views:
            idxs_mask = np.zeros_like(all_idxs, dtype=bool)
            selected_view_idxs = np.sort(rs.choice(
                all_num_views, size=self.num_views, replace=False))
            view_idxs = np.concatenate(
                [[0], np.cumsum(data_in["pc_sizes"])])
            for i in selected_view_idxs:
                idxs_mask[view_idxs[i]: view_idxs[i + 1]] = True
            all_idxs = all_idxs[idxs_mask]

        selected_idxs = rs.choice(
            all_idxs, size=self.num_pc_sample, replace=False)

        pc_sim_rgb = data_in["pc_sim_rgb"][selected_idxs].astype(
            np.float32) / 255
        pc_sim = data_in["pc_sim"][selected_idxs].astype(np.float32)
        pc_nocs = data_in["pc_nocs"][selected_idxs].astype(np.float32)
        grip_idx = data_in["grip_vertex_idx"]
        sim_grip_point = data_in["cloth_sim_verts"][grip_idx].reshape((1, 3))
        nocs_grip_point = data_in["cloth_nocs_verts"][grip_idx].reshape(
            (1, 3))
        dists = np.linalg.norm(pc_sim - sim_grip_point[0], axis=1)
        return {
            "x": pc_sim_rgb,
            "y": pc_nocs,
            "pos": pc_sim,
            "scale": np.array([data_in["scale"]], np.float32),
            "sim_grip_point": sim_grip_point.astype(np.float32),
            "nocs_grip_point": nocs_grip_point.astype(np.float32),
            "grip_pc_idx": np.array([np.argmin(dists)]),
            "dataset_idx": np.array([idx]),
            "cloth_sim_aabb": self.cloth_sim_aabb.reshape(
                (1,) + self.cloth_sim_aabb.shape),
        }

    def get_volume_sample(self, idx: int, data_in: dict) -> dict:
        seed = idx if self.static_epoch_seed else None
        rs = np.random.RandomState(seed=seed)
        n = self.num_volume_sample
        if self.surface_sample_ratio == 0:
            query_points = rs.uniform(0, 1, size=(n, 3)).astype(np.float32)
        else:
            num_uniform = int(n * self.surface_sample_ratio)
            num_surface = n - num_uniform
            uniform_q = rs.uniform(0, 1, size=(num_uniform, 3)).astype(
                np.float32)
            verts = data_in["cloth_nocs_verts"]
            faces = data_in["cloth_faces_tri"]
            bc, fi = geometry.mesh_sample_barycentric(
                verts, faces, num_surface, seed=seed)
            pts = geometry.barycentric_interpolation(bc, verts, faces[fi])
            noise = rs.normal(0, self.surface_sample_std,
                              size=(num_surface, 3))
            query_points = np.clip(np.concatenate(
                [uniform_q, pts + noise], axis=0).astype(np.float32), 0, 1)
        values = grid_sample_trilinear_np(data_in["volume"], query_points)
        if self.volume_group == "nocs_occupancy_grid":
            values = (values > 0.1).astype(np.float32)
        return self.reshape_for_batching({
            "volume_query_points": query_points,
            "gt_volume_value": values.astype(np.float32),
        })

    def get_surface_sample(self, idx: int, data_in: dict) -> dict:
        nocs_verts = data_in["cloth_nocs_verts"]
        sim_verts = data_in["cloth_sim_verts"]
        faces = data_in["cloth_faces_tri"]
        if self.volume_task_space:
            normalizer = geometry.AABBGripNormalizer(self.cloth_sim_aabb)
            nocs_verts, sim_verts = normalizer(sim_verts), nocs_verts

        seed = idx if self.static_epoch_seed else None
        bc, fi = geometry.mesh_sample_barycentric(
            nocs_verts, faces, self.num_surface_sample, seed=seed)
        sampled_faces = faces[fi]
        nocs_pts = geometry.barycentric_interpolation(
            bc, nocs_verts, sampled_faces)
        sim_pts = geometry.barycentric_interpolation(
            bc, sim_verts, sampled_faces)

        if self.surface_normal_noise_ratio != 0:
            k = int(self.num_surface_sample * self.surface_normal_noise_ratio)
            normals = geometry.per_vertex_normals(nocs_verts, faces)
            sampled_n = geometry.barycentric_interpolation(
                bc[:k], normals, sampled_faces[:k])
            rs = np.random.RandomState(seed)
            offset = rs.normal(0, self.surface_normal_std, size=k)
            nocs_pts[:k] = nocs_pts[:k] + (sampled_n.T * offset).T

        return self.reshape_for_batching({
            "surf_query_points": nocs_pts.astype(np.float32),
            "gt_sim_points": sim_pts.astype(np.float32),
        })

    def get_mc_surface_sample(self, idx: int, data_in: dict) -> dict:
        mc_verts = data_in["marching_cube_verts"]
        mc_faces = data_in["marching_cube_faces"]
        on_surf = data_in["is_vertex_on_surface"].astype(np.float32)
        seed = idx if self.static_epoch_seed else None
        bc, fi = geometry.mesh_sample_barycentric(
            mc_verts, mc_faces, self.num_surface_sample, seed=seed)
        sampled_faces = mc_faces[fi]
        pts = geometry.barycentric_interpolation(bc, mc_verts, sampled_faces)
        on = geometry.barycentric_interpolation(
            bc, on_surf[:, None], sampled_faces)
        return self.reshape_for_batching({
            "mc_surf_query_points": pts.astype(np.float32),
            "is_query_point_on_surf": (on > 0.5).astype(np.float32),
        })

    # -- augmentation (reference :370-422) ----------------------------------
    def rotation_augumentation(self, idx: int, data: dict) -> dict:
        lo, hi = self.random_rot_range
        assert lo <= hi
        seed = idx if self.static_epoch_seed else None
        rs = np.random.RandomState(seed=seed)
        rot_angle = rs.uniform(lo, hi)
        theta = np.deg2rad(rot_angle)
        c, s = np.cos(theta), np.sin(theta)
        rot_mat = np.array(
            [[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)

        out = dict(data)
        if not self.volume_task_space:
            for key in ("pos", "sim_grip_point", "gt_sim_points"):
                if key in data:
                    out[key] = (data[key] @ rot_mat.T).astype(np.float32)
        else:
            for key in ("pos", "sim_grip_point"):
                if key in data:
                    out[key] = (data[key] @ rot_mat.T).astype(np.float32)
            offset = np.array([0.5, 0.5, 0], np.float32)
            for key in ("volume_query_points", "surf_query_points"):
                if key in data:
                    out[key] = ((data[key] - offset) @ rot_mat.T
                                + offset).astype(np.float32)
        out["input_aug_rot_mat"] = rot_mat.reshape((1, 3, 3))
        return out

    def noise_augumentation(self, idx: int, data: dict) -> dict:
        seed = idx if self.static_epoch_seed else None
        rs = np.random.RandomState(seed=seed)
        out = dict(data)
        out["pos"] = (data["pos"] + rs.normal(
            0, self.pc_noise_std, size=data["pos"].shape)).astype(np.float32)
        return out

    @staticmethod
    def reshape_for_batching(data: dict) -> dict:
        return {k: v.reshape((1,) + v.shape) for k, v in data.items()}

    def __getitem__(self, idx: int) -> dict:
        data_in = self.data_io(idx)
        data = self.get_base_data(idx, data_in)
        if self.num_volume_sample > 0:
            data.update(self.get_volume_sample(idx, data_in))
        if self.num_surface_sample > 0:
            data.update(self.get_surface_sample(idx, data_in))
        if self.num_mc_surface_sample > 0:
            data.update(self.get_mc_surface_sample(idx, data_in))
        data["input_aug_rot_mat"] = np.expand_dims(
            np.eye(3, dtype=np.float32), axis=0)
        if self.pc_noise_std > 0:
            data = self.noise_augumentation(idx, data)
        if self.enable_augumentation:
            data = self.rotation_augumentation(idx, data)
        if self.include_volume:
            # leading sample axis for collate (reference expands dims (0,1),
            # conv_implicit_wnf_dataset.py:172)
            vol = data_in["volume"]
            data["volume"] = vol.reshape((1,) + vol.shape)
        return data


# per-point keys stacked to [B,N,...]; everything else already has a leading
# sample axis of 1 (reshape_for_batching) and is concatenated.
_PER_POINT_KEYS = ("x", "y", "pos")


def collate(samples: list[dict]) -> dict:
    out = {}
    for key in samples[0]:
        arrs = [s[key] for s in samples]
        if key in _PER_POINT_KEYS:
            out[key] = np.stack(arrs, axis=0)
        else:
            out[key] = np.concatenate(arrs, axis=0)
    return out


class Loader:
    """Minimal batching loader with a background prefetch thread.

    Replaces torch DataLoader workers (SURVEY.md §2.5): sampling is numpy on
    the host; a prefetch thread overlaps it with device compute, and
    `num_workers` threads parallelize per-item fetches within a batch (the
    reference's `num_workers: 4` DataLoader processes,
    datasets/conv_implicit_wnf_dataset.py:539-544 — stage-2 sampling does
    heavy zarr/zlib/numpy work that releases the GIL). Batch contents and
    order are identical for any worker count.
    """

    def __init__(self, dataset, idxs, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False, prefetch: int = 2,
                 num_workers: int = 0):
        self.dataset = dataset
        self.idxs = np.asarray(idxs)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_workers = num_workers
        self._pool = None
        if num_workers and num_workers > 0:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=num_workers)
        self.epoch = 0

    def __del__(self):
        if getattr(self, "_pool", None) is not None:
            self._pool.shutdown(wait=False)

    def __len__(self):
        n = len(self.idxs)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batches(self, epoch: int):
        order = self.idxs
        if self.shuffle:
            rs = np.random.RandomState(self.seed + epoch)
            order = order[rs.permutation(len(order))]
        for i in range(len(self)):
            sel = [int(j) for j in
                   order[i * self.batch_size:(i + 1) * self.batch_size]]
            if self._pool is not None:
                items = list(self._pool.map(self.dataset.__getitem__, sel))
            else:
                items = [self.dataset[j] for j in sel]
            yield collate(items)

    def __iter__(self):
        # Snapshot + advance the epoch counter at iteration START, not on
        # drain: consumers that break out early (limit_train_batches, e2e
        # smokes) must still see a fresh shuffle order next epoch.
        epoch = self.epoch
        self.epoch += 1
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        abandoned = threading.Event()

        def worker():
            try:
                for b in self._batches(epoch):
                    while not abandoned.is_set():
                        try:
                            q.put(b, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    else:
                        return  # consumer gone: drop batch, exit thread
            finally:
                # the stop sentinel must be delivered BLOCKING (same
                # abandoned-check retry as batches): a put_nowait here
                # silently dropped it whenever the consumer was >=prefetch
                # batches behind at end-of-epoch, leaving the consumer
                # waiting on q.get() forever — the predict CLI (fast
                # producer, slow zarr-writing consumer) deadlocked on any
                # dataset longer than ~6 batches; training never saw it
                # because its producer is the slow side
                while not abandoned.is_set():
                    try:
                        q.put(stop, timeout=0.2)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                yield item
        finally:
            # Runs on normal drain AND on generator abandonment (GC/close):
            # unblock the prefetch thread so it releases dataset references
            # instead of sitting on queue.put forever.
            abandoned.set()


class ConvImplicitWNFDataModule:
    """Instance-level 8:1:1 split grouped by sample_id (reference :466-567).

    All grips of one garment instance share a split; permutation is seeded by
    `split_seed`; leftover instances go to train; val/test datasets use
    static_epoch_seed=True.
    """

    def __init__(self, **kwargs):
        assert len(kwargs["dataset_split"]) == 3
        self.kwargs = kwargs
        self.train_dataset = None
        self.val_dataset = None

    def prepare_data(self):
        kwargs = self.kwargs
        split_seed = kwargs["split_seed"]
        dataset_split = kwargs["dataset_split"]

        train_args = dict(kwargs)
        train_args["static_epoch_seed"] = False
        train_dataset = ConvImplicitWNFDataset(**train_args)
        val_args = dict(kwargs)
        val_args["static_epoch_seed"] = True
        val_dataset = ConvImplicitWNFDataset(**val_args)

        groups_df = train_dataset.groups_df
        instances_df = groups_df.groupby("sample_id").agg(
            {"idx": lambda x: sorted(x)})

        num_instances = len(instances_df)
        normalized_split = np.array(dataset_split)
        normalized_split = normalized_split / np.sum(normalized_split)
        instance_split = (normalized_split * num_instances).astype(np.int64)
        instance_split[0] += num_instances - np.sum(instance_split)

        rs = np.random.RandomState(seed=split_seed)
        perm_all_idxs = rs.permutation(np.arange(num_instances))

        split_instance_idx_list = []
        prev = 0
        for x in instance_split:
            split_instance_idx_list.append(perm_all_idxs[prev: prev + x])
            prev += x
        assert np.allclose(
            [len(x) for x in split_instance_idx_list], instance_split)

        split_idx_list = []
        for instance_idxs in split_instance_idx_list:
            if len(instance_idxs) == 0:
                split_idx_list.append(np.array([], np.int64))
                continue
            idxs = np.sort(np.concatenate(
                list(instances_df.iloc[instance_idxs].idx)))
            split_idx_list.append(idxs)
        assert sum(len(x) for x in split_idx_list) == len(groups_df)

        self.groups_df = groups_df
        self.train_idxs, self.val_idxs, self.test_idxs = split_idx_list
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset

    def _process_shard(self, idxs, process_count=None, process_index=None):
        """Disjoint per-process index shard for data parallelism (SURVEY.md
        §2.5 'per-host data loading'). Enabled by shard_by_process=True in
        the datamodule config; every process then loads only its own 1/P
        of the samples, P and the rank coming from torch.distributed when
        its process group is initialized, else (1, 0). The tail remainder
        is dropped so all processes run the same number of steps
        (collectives would deadlock otherwise)."""
        if not self.kwargs.get("shard_by_process", False):
            return idxs
        if process_count is None:
            import torch.distributed as dist
            if dist.is_available() and dist.is_initialized():
                process_count = dist.get_world_size()
                process_index = dist.get_rank()
            else:
                process_count, process_index = 1, 0
        if process_count <= 1:
            return idxs
        n = (len(idxs) // process_count) * process_count
        return idxs[process_index:n:process_count]

    def _loader(self, dataset, idxs, **kw) -> Loader:
        return Loader(dataset, self._process_shard(idxs),
                      self.kwargs["batch_size"],
                      num_workers=self.kwargs.get("num_workers", 0), **kw)

    def train_dataloader(self) -> Loader:
        return self._loader(self.train_dataset, self.train_idxs,
                            shuffle=True,
                            seed=self.kwargs.get("split_seed", 0),
                            drop_last=True)

    def val_dataloader(self) -> Loader:
        return self._loader(self.val_dataset, self.val_idxs, shuffle=False)

    def test_dataloader(self) -> Loader:
        return self._loader(self.val_dataset, self.test_idxs, shuffle=False)
