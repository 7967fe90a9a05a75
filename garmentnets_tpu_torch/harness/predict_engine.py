"""Batched inference engine (torch port of garmentnets_tpu/harness/predict_engine.py).

Per batch:
  encode: stage-1 PointNet++ (FPS kernel) -> NOCS + confidence -> volume
      aggregation -> 3D U-Net -> dense WNF over the volume_size^3 lattice
      (fused decode kernel) -> gaussian gradient magnitude (ggm kernel) ->
      int8 brick extraction and page packing.
  extract_meshes: host C++ marching cubes on the brick pages, one garment
      per thread.
  warp: surface decoder at the mesh vertices plus the ggm gather at each
      vertex's nearest voxel.

Queries and results stay float32 (the JAX engine's f16 wire format was a
measure for its device link). Entry points run on the card unless the
caller passes device="cpu".
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from garmentnets_tpu_torch.core.device import full_f32, resolve_device
from garmentnets_tpu_torch.models.pipeline import (
    ConvImplicitWNFPipeline, PipelineConfig)
from garmentnets_tpu_torch.ops.dense_decode import dense_decode, eval_layers
from garmentnets_tpu_torch.ops.gaussian import gaussian_gradient_magnitude
from garmentnets_tpu_torch.ops.isosurface import (
    extract_active_bricks, pack_brick_pages, read_page_counts,
    split_brick_payload, unpack_brick_pages)
from garmentnets_tpu_torch.ops.marching_cubes import (
    marching_cubes, marching_cubes_bricks)


class PredictEngine:
    def __init__(self, cfg: PipelineConfig, state_dict: dict,
                 volume_size: int = 128, gradient_sigma: float = 0.5,
                 iso_level: float = 0.5, gradient_direction: str = "ascent",
                 active_cap: Optional[int] = None,
                 decode_precision: str = "highest",
                 return_volume: bool = False,
                 mc_threads: Optional[int] = None,
                 device="cuda"):
        """state_dict: the pipeline's weights in the reference layout (see
        core/weights.py). decode_precision: only 'highest' (f32) exists in
        the port so far."""
        if str(decode_precision).lower() != "highest":
            raise ValueError("decode_precision: only 'highest' is supported "
                             f"by the port, got {decode_precision!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = ConvImplicitWNFPipeline(cfg)
        self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()
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
        self._vd_layers = eval_layers(self.model.volume_decoder.mlp)
        if mc_threads is None:
            mc_threads = min(4, os.cpu_count() or 1)
        self._pool = (ThreadPoolExecutor(mc_threads, thread_name_prefix="mc")
                      if mc_threads > 1 else None)

    def close(self) -> None:
        """Stop the marching-cubes worker threads."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    # ------------------------------------------------------------------
    @torch.no_grad()
    @full_f32()
    def encode(self, x, pos) -> dict:
        """x, pos: [B, N, 3] (numpy or tensors) -> dict of device tensors."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        pos = torch.as_tensor(pos, dtype=torch.float32, device=self.device)
        # the encode/* ranges name the stages in a torch.profiler trace
        # (tools/profile_encode.py); without a profiler they cost a few us
        with record_function("encode/stage1_pointnet2"):
            p2 = self.model.pointnet2_forward(x, pos)
        with record_function("encode/aggregate_unet3d"):
            feature_volume = self.model.unet3d_forward(p2["nocs_data"])
        with record_function("encode/dense_decode"):
            # the transposed volume decoded at the xyz lattice equals the
            # volume decoded at the flipped lattice: ImplicitWNFDecoder's
            # axis quirk
            wnf = dense_decode(feature_volume.transpose(1, 3).contiguous(),
                               self._vd_layers, self.volume_size)
        with record_function("encode/ggm"):
            ggm = gaussian_gradient_magnitude(wnf, self.gradient_sigma)
        with record_function("encode/bricks_and_pages"):
            base, vals, counts = extract_active_bricks(
                wnf, self.iso_level, self.brick_cap)
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
        if self.return_volume:
            out["wnf_volume"] = wnf
        return out

    def extract_meshes(self, enc: dict) -> list:
        """Fetch the needed brick pages once for the batch and run the host
        C++ marching cubes per garment. Returns per garment (verts, faces,
        values, normals), or None where no surface was found."""
        pages = enc["active_pages"]
        p0 = pages[0].cpu().numpy()
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
        srcs = [p0] + [p.cpu().numpy() for p in pages[1:n_pages]]
        brick_idx, brick_vals = unpack_brick_pages(srcs, header=True)
        brick_vals, _ = split_brick_payload(brick_vals)

        def run_one(b):
            n = int(counts[b])
            if n == 0:
                return None
            try:
                return marching_cubes_bricks(
                    brick_idx[b, :n], brick_vals[b, :n], (S, S, S),
                    self.iso_level, spacing,
                    gradient_direction=self.gradient_direction,
                    return_values=True, return_normals=True)
            except ValueError:
                return None

        if self._pool is not None and B > 1:
            return list(self._pool.map(run_one, range(B)))
        return [run_one(b) for b in range(B)]

    @torch.no_grad()
    @full_f32()
    def _dense_wnf(self, enc: dict) -> torch.Tensor:
        if "wnf_volume" in enc:
            return enc["wnf_volume"]
        fv = enc["feature_volume"]
        return dense_decode(fv.transpose(1, 3).contiguous(), self._vd_layers,
                            self.volume_size)

    @torch.no_grad()
    @full_f32()
    def warp_dispatch(self, enc: dict, meshes: list):
        """Queue the surface decoder + ggm gather over all garments' mesh
        vertices; returns a handle for warp_collect."""
        sizes = [0 if m is None else len(m[0]) for m in meshes]
        vmax = max(sizes) if sizes else 0
        if vmax == 0:
            return (None, sizes)
        q = np.zeros((len(meshes), vmax, 3), np.float32)
        for b, m in enumerate(meshes):
            if m is not None:
                q[b, :len(m[0])] = m[0]
        q = torch.from_numpy(q).to(self.device)
        warp = self.model.surface_decoder_forward(enc["feature_volume"], q)
        ggm = enc["wnf_ggm"]
        B, S = ggm.shape[0], self.volume_size
        nn_idx = torch.clamp((q * (S - 1)).to(torch.int64), 0, S - 1)
        flat = (nn_idx[..., 0] * S + nn_idx[..., 1]) * S + nn_idx[..., 2]
        ggm_at = torch.gather(ggm.reshape(B, -1), 1, flat)
        return (torch.cat([warp, ggm_at[..., None]], dim=-1), sizes)

    def warp_collect(self, handle) -> list:
        out, sizes = handle
        if out is None:
            return [None] * len(sizes)
        out = out.cpu().numpy()
        return [None if n == 0 else {"warp_field": out[b, :n, :3],
                                     "verts_ggm": out[b, :n, 3]}
                for b, n in enumerate(sizes)]

    def warp_batch(self, enc: dict, meshes: list) -> list:
        """meshes: list of (verts, faces, ...) or None -> per garment
        {"warp_field" [V, 3], "verts_ggm" [V]} or None."""
        return self.warp_collect(self.warp_dispatch(enc, meshes))
