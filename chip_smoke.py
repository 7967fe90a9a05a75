#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (garmentnets_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, and uses every card present in phase 10; exits
non-zero without one. Phases, each fatal:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA kernel (csrc/*.cu, nvcc for sm_90a, one process per
     source, all at once) and the host marching-cubes library, into
     garmentnets_tpu_torch/_build/;
  3. kernels against their plain PyTorch versions at the main path's
     full-width shapes, with times (CUDA events, median), the least time
     the card could take (bound) and, where one PyTorch call computes the
     same function, that call's time; FPS also on inputs full of exact
     ties, with its time per pick; the tensor-core decode at its three
     tiers ('high' and 'highest' in the kernels line, 'default' logged;
     'highest' against f32 and against the plain emulation of its bf16x6
     arithmetic); the tensor-core set abstraction against the plain 'high'
     tier and f32;
  4. the main path: PredictEngine at the full width of PipelineConfig()
     (B=8, N=6000, 128^3 WNF) with seeded random weights at its default
     decode tier 'high', driving encode -> extract_meshes -> warp_batch,
     then one encode at 'highest' (the same tensor-core kernel at bf16x6),
     each with the launch counts reset just before and read just after;
  5. the predict CLI (harness/predict.py) at the same width over a
     synthetic dataset that the port's generator writes, on a checkpoint
     written by save_pipeline_checkpoint: every sample group's schema,
     meshes and warp values, launch counts per batch, garments/s and each
     batch's stage times, and the zarr codec;
  6. the eval CLI (harness/eval.py) on that prediction.zarr, as a
     subprocess as a user runs it (configs/eval_default.yaml as shipped,
     num_workers=-1), then again with vis.samples_per_instance=1: its
     parallel mode, seconds per metric function, garments per second, null
     count, summary keys, finite metrics and PLY count;
  7. the model variants: predict.main at full width on one batch of 8
     each, for the mc-surface (hole) head with use_hole_prediction (and
     both aggregator include flags off) and for the task-space model over
     a dataset with task-space volumes, with launch counts per batch; then
     the eval CLI on each, the hole run with its logits as the value key
     and the grip-point, Hausdorff and geodesic metrics on;
  8. the large-volume path at 256^3: the decode and the ggm at S=256
     against their plain versions, PredictEngine with the straddle masks
     on by default (their bytes against the CPU's, masked host MC
     identical to unmasked), device normals (verts, codes against the
     CPU's, angles against host normals), stage times, garments/s and
     peak memory; the predict CLI at prediction.volume_size=256 with
     prediction.device_normals=true on one batch; ResidualUNet3D on the
     card against the CPU;
  9. the server: PredictService + make_http_server at the same width on a
     checkpoint written by save_pipeline_checkpoint, 24 garments from 4
     concurrent clients through predict_remote, with launch counts per
     device batch, the overlap of host MC with the next encode, and one
     request against a direct engine run; then the engine at a tiny size
     on the card against the CPU path at 'highest' and 'high';
  10. several cards (`phase_multi_gpu`; one card stands in where the
     machine has one): `cards: n`; the decode at 'high' in 2, 4 and 8
     strips of D planes bit-equal to the whole launch at 128^3 and 256^3;
     PredictEngine(mesh=...) at the main path's width on make_mesh_2d(n,
     1) and (n/2, 2), or on cuda:0 listed four times as (2, 2), against
     the one-device engine (WNF within 2e-5, bricks, vertices, warp), with
     its launches, stage ms, garments/s and no host sync during its
     encodes; both training stages at the shipped widths on two ranks
     (nccl on two cards, else gloo on cuda:0, said so): replicas bit-equal
     after every step, the first step within the CPU tests' bars of one
     process's step (no bar above DDP_BAR_CAP of a tensor's largest
     entry), ms a step, samples/s and peak memory a rank; on two or more
     cards, the stage-1 train CLI as shipped on trainer.device=cuda, one
     nccl rank a card;
  11. the acceptance run (`phase_e2e`): the winding number of a 128^3
     lattice on the card against f64 numpy (within 1e-4); the port's
     tools/e2e_synthetic.py at full width (its 128^3 dataset generated on
     the card, 4 instances x 3 grips; both stages 400 steps at B=8, each
     stage's last losses below half its first; the predict CLI without
     null samples; finite eval metrics) with its launches;
     tools/export_meshes.py on its prediction, parsed back; the decode
     tiers and the bf16x3 SA on the trained model against their plain f32
     versions on the card (WNF error, flips, meshes, NOCS bins, the eval's
     canonical chamfer); the geodesic metric's failures counted; the
     acceptance run's stage-1 ms a step against the same steps with the
     batches held in memory;
  12. stage-1 training over a trajectory (`phase_train_trajectory`):
     three seeds of TRAJ_STEPS steps at B=8 on the card and on the card
     host's CPU from the same weights and batches, each seed's 20-step
     window means held within the CPU's 3-seed spread; then one step of
     the production widths at CARRY_N points on both devices in float64
     from the state of CARRY_STEPS card steps, every gradient and
     statistic within CARRY_REL of its largest entry; with the FPS
     kernel's launches;
  13. a `kernels` JSON line, the nvidia-smi line, and the final JSON
     line.
"""
from __future__ import annotations

import copy
import json
import multiprocessing
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

B, N, VOL = 8, 6000, 128
N_BATCHES = 4          # main-path batches; the first one warms up
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
F32_INSTR = F32_FLOPS / 2   # f32 instructions a second (an FMA is 2 flops)
BF16_FLOPS = 989e12         # H100 SXM bf16 tensor cores, dense
# dense_decode_tc limits per tier: max abs error against the plain version
# of the same tier ('highest': the plain emulation of its bf16x6
# arithmetic), and against the f32 plain output
TC_LIMITS = {"highest": (2e-5, 1e-4), "high": (2e-5, 2e-4),
             "default": (5e-3, 3e-2)}
# bf16 products a hidden layer's product takes, and CUDA-core operations an
# input element's split takes, per tier
TC_PASSES = {"highest": 6, "high": 3, "default": 1}
TC_SPLIT_OPS = {"highest": 5, "high": 3, "default": 1}


def log(msg: str) -> None:
    print(msg, flush=True)


def cloth_like_wnf(vol: int) -> np.ndarray:
    """Analytic WNF of a two-sheet garment shell pinched at the top, in
    [0,1]^3 at vol^3 (the same field as bench.py's _cloth_like_wnf): a
    random network's WNF has no real surface, so host marching cubes and
    the warp run on this one."""
    ax = np.linspace(0, 1, vol, dtype=np.float32)
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    amp, half_w = 0.018, 0.26
    wave = (amp * np.sin(14 * gx + 3 * gz)
            + 0.75 * amp * np.sin(9 * gz + 5 * gx)).astype(np.float32)
    mid = 0.5 + wave
    gap = 0.06 * np.clip((0.85 - gz) / 0.7, 0.0, 1.0)
    dist_sheet = np.minimum(np.abs(gy - (mid + gap)),
                            np.abs(gy - (mid - gap)))
    inside_xz = ((np.abs(gx - 0.5) < half_w + 0.05 * np.sin(6 * gz))
                 & (gz > 0.08) & (gz < 0.92))
    arg = np.clip((dist_sheet - 0.012) * 300.0, -30.0, 30.0)
    wnf = 1.0 / (1.0 + np.exp(arg))
    return np.where(inside_xz, wnf, 0.0).astype(np.float32)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median device time of fn() over `reps` runs (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float, op_rate: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / op_rate * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def decode_inputs(gen, coarse_shape, widths, dev):
    """Zero-mean coarse features [*coarse_shape, widths[0]] and centred
    decoder layers (K, b, g, s) for checking the dense decode. The scalar
    head's bias is set to minus the median of its pre-activation over the
    coarse features and its weights are scaled to give that pre-activation
    unit spread, so its ReLU is live on about half the voxels and the
    decoded field varies on the order of 1 instead of sitting near the
    head's shift."""
    import torch
    layers = []
    for cin, cout in zip(widths[:-1], widths[1:]):
        layers.append(tuple(t.to(dev) for t in (
            (torch.rand(cin, cout, generator=gen) - 0.5) * (2 / cin ** 0.5),
            torch.rand(cout, generator=gen) - 0.5,
            0.5 + torch.rand(cout, generator=gen),
            torch.rand(cout, generator=gen) - 0.5)))
    fv = (torch.rand(*coarse_shape, widths[0], generator=gen) - 0.5).to(dev)
    h = fv.reshape(-1, widths[0])
    for k, b, g, s in layers[:-1]:
        h = torch.relu(h @ k + b) * g + s
    k, b = layers[-1][:2]
    pre = h @ k
    scale = 1.0 / pre.std()
    k.mul_(scale)
    b.copy_(-pre.median(dim=0).values * scale)
    return fv, layers


def fps_points(kind: str, B: int, N: int, seed: int) -> np.ndarray:
    """[B, N, 3] float32 points for checking FPS: "random" (uniform in a
    unit cube), "duplicates" (every point two or three times, shuffled),
    "lattice" (a shuffled cubic lattice of step 1/8: exact, equal
    distances everywhere) or "identical" (one point N times)."""
    rs = np.random.RandomState(seed)
    if kind == "random":
        return rs.rand(B, N, 3).astype(np.float32) - 0.5
    if kind == "duplicates":
        base = rs.rand(B, N // 3 + 1, 3).astype(np.float32) - 0.5
        pos = np.concatenate([base, base, base], axis=1)[:, :N]
        return np.ascontiguousarray(pos[:, rs.permutation(N)])
    if kind == "lattice":
        g = int(np.ceil(N ** (1 / 3)))
        ax = np.arange(g, dtype=np.float32) * np.float32(0.125)
        lat = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)
        lat = lat.reshape(-1, 3)[:N]
        return np.stack([lat[rs.permutation(N)] for _ in range(B)])
    if kind == "identical":
        return np.zeros((B, N, 3), np.float32)
    raise ValueError(f"unknown point set {kind!r}")


def sa_layers(gen, widths, dev):
    """Folded layers (K, b, g, s) with centred biases, so the ReLUs are
    live and the set-abstraction output varies."""
    import torch
    return [tuple(t.to(dev) for t in (
        (torch.rand(cin, cout, generator=gen) - 0.5) * (2 / cin ** 0.5),
        torch.rand(cout, generator=gen) - 0.5,
        0.5 + torch.rand(cout, generator=gen),
        torch.rand(cout, generator=gen) - 0.5))
        for cin, cout in zip(widths[:-1], widths[1:])]


def sa_inputs(gen, B, n_points, m, cin, widths, radius, dev, pos=None):
    """One set-abstraction call as stage 1 makes it: zero-mean features,
    points in a cube of side 0.35 (so that most balls of radius 0.05 hold
    64 neighbours at 6000 points), centers from the port's FPS and slots
    from its ball query (K=64)."""
    import torch
    from garmentnets_tpu_torch.ops.pointcloud import (
        ball_query, furthest_point_sampling, gather_rows)
    if pos is None:
        pos = (torch.rand(B, n_points, 3, generator=gen) * 0.35).to(dev)
    x = (torch.rand(B, n_points, cin, generator=gen) - 0.5).to(dev)
    centers = gather_rows(pos, furthest_point_sampling(pos, m)).contiguous()
    idx, mask = ball_query(pos, centers, radius, k=64)
    return x, pos, centers, idx, mask, sa_layers(gen, widths, dev)


def sa_ops(mask, layers) -> float:
    """Operations of one set-abstraction call over the valid slots: per
    slot the relative position (3), each layer's product (2 cin cout) and
    its bias, ReLU and affine (4 cout), and the max (c_out)."""
    per_slot = 3 + sum(2 * k.shape[0] * k.shape[1] + 4 * k.shape[1]
                       for k, _, _, _ in layers) + layers[-1][0].shape[1]
    return float(mask.sum()) * per_slot


def log_decode_time(tier, fv, z, packed, widths, S, ms, pms) -> tuple:
    """Log the tensor-core decode's time at tier `tier` and volume S
    against its bound, the larger of its products on the tensor cores, its
    CUDA-core work and its bytes; returns (bound ms, bound_by)."""
    passes = TC_PASSES[tier]
    Bv, G, c1 = fv.shape[0], fv.shape[1], widths[1]
    vox = Bv * S ** 3
    # the trilinear upsample at its separable minimum: three 2-tap passes
    # (3 flops per output channel) producing S*G*G, S*S*G and S^3 points
    up_ops = 3 * c1 * Bv * (S * G * G + S * S * G + S ** 3)
    hidden = list(zip(widths[1:-2], widths[2:-1]))
    tc_ops = vox * passes * sum(2 * a * b_ for a, b_ in hidden)
    # CUDA cores: the separable upsample, the first affine, the bf16
    # splits of every hidden layer's input (one conversion a part and a
    # subtraction between parts), each epilogue and the head
    cc_ops = up_ops + vox * (
        3 * c1 + TC_SPLIT_OPS[tier] * sum(a for a, _ in hidden)
        + 3 * sum(b_ for _, b_ in hidden) + 2 * widths[-2] + 3)
    tc_bytes = z.numel() * 4 + vox * 4 + packed.wts.numel() * 2 + sum(
        t.numel() * 4 for t in (packed.aff0, packed.epi, packed.head))
    t_tc = tc_ops / BF16_FLOPS * 1e3
    t_cc = cc_ops / F32_FLOPS * 1e3
    t_b = tc_bytes / HBM_BYTES_PER_S * 1e3
    bnd = max(t_tc, t_cc, t_b)
    by = "bytes" if t_b >= max(t_tc, t_cc) else "operations"
    which = ("bytes" if by == "bytes" else "tensor-core operations"
             if t_tc >= t_cc else "CUDA-core operations")
    log(f"dense decode tc {tier} at {S}^3: kernel {ms:.3f} ms, plain "
        f"{pms:.3f} ms, bound {bnd:.3f} ms ({which}; tensor cores "
        f"{t_tc:.3f} ms for {tc_ops / 1e12:.3f} TFLOP in {passes} bf16 "
        f"passes, CUDA cores {t_cc:.3f} ms, bytes {t_b:.4f} ms), "
        f"{tc_ops / (ms * 1e-3) / 1e12:.1f} TFLOP/s on the tensor cores "
        f"achieved")
    return bnd, by


# ---------------------------------------------------------------------------
def phase_kernels(dev) -> dict:
    """Each kernel against its plain version at full-width shapes."""
    import torch
    import torch.nn.functional as F
    from garmentnets_tpu_torch.kernels.dense_decode_tc import (
        dense_decode_tc_cuda, pack_decoder)
    from garmentnets_tpu_torch.kernels.fps import furthest_point_sampling_cuda
    from garmentnets_tpu_torch.kernels.ggm import ggm_cuda
    from garmentnets_tpu_torch.kernels.sa_tc import (
        pack_sa_layers, sa_tc_cuda)
    from garmentnets_tpu_torch.ops.dense_decode import (
        coarse_first_layer, dense_decode_plain)
    from garmentnets_tpu_torch.ops.gaussian import ggm_plain, ggm_taps
    from garmentnets_tpu_torch.ops.pointcloud import (
        furthest_point_sampling_plain, gather_rows)
    from garmentnets_tpu_torch.ops.set_abstraction import sa_fused_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(1)
    rows = {}

    # ---- FPS: SA1 [8,6000,3] -> 3000, SA2 [8,3000,3] -> 750, on random
    # points and on inputs full of exact ties ----
    pos1 = (torch.rand(B, N, 3, generator=gen) - 0.5).to(dev)
    fps = dict(ms=0.0, plain_ms=0.0, bound=0.0, err=0, picks=0)
    pos = pos1
    for n_pts, m in ((N, N // 2), (N // 2, N // 8)):
        k = furthest_point_sampling_cuda(pos, m)
        p = furthest_point_sampling_plain(pos, m)
        mism = {"random": int((k != p).sum())}
        fps["err"] = max(fps["err"], int((k - p).abs().max()))
        for kind in ("duplicates", "lattice"):
            tie = torch.from_numpy(fps_points(kind, B, n_pts, n_pts)).to(dev)
            kt = furthest_point_sampling_cuda(tie, m)
            pt = furthest_point_sampling_plain(tie, m)
            mism[kind] = int((kt != pt).sum())
            fps["err"] = max(fps["err"], int((kt - pt).abs().max()))
        torch.cuda.synchronize()
        log(f"fps [{B},{n_pts},3]->{m}: index mismatches {mism}")
        check(not any(mism.values()), f"fps indices differ at N={n_pts}")
        ms = time_ms(lambda: furthest_point_sampling_cuda(pos, m), 10)
        pms = time_ms(lambda: furthest_point_sampling_plain(pos, m), 2)
        bnd, _ = bound_ms(B * n_pts * 12 + B * m * 8,
                          B * (m - 1) * n_pts * 9, F32_FLOPS)
        log(f"fps N={n_pts} M={m}: kernel {ms:.3f} ms, "
            f"{ms * 1e3 / (m - 1):.3f} us per pick ({m - 1} dependent "
            f"picks), plain {pms:.3f} ms, bound {bnd:.4f} ms (operations; "
            f"{bnd * 1e3 / (m - 1):.4f} us per pick, which no chain of "
            f"dependent picks can approach)")
        fps["ms"] += ms
        fps["plain_ms"] += pms
        fps["bound"] += bnd
        fps["picks"] += m - 1
        pos = gather_rows(pos, k).contiguous()
    log(f"fps both calls: kernel {fps['ms']:.3f} ms, "
        f"{fps['ms'] * 1e3 / fps['picks']:.3f} us per pick on average")
    rows["fps"] = dict(
        name="fps", route="cuda", source="garmentnets_tpu_torch/csrc/fps.cu",
        replaces="garmentnets_tpu/kernels/fps_pallas.py:65",
        max_abs_err=float(fps["err"]), ms=fps["ms"],
        plain_ms=fps["plain_ms"], bound_ms=fps["bound"],
        bound_by="operations", library_ms=None)

    # ---- dense decode on the tensor cores: [8,32,32,32,128] ->
    # [8,128,128,128], 128-256-256-1, at 'highest' (bf16x6), 'high' (bf16x3)
    # and 'default' (bf16), on the same inputs ----
    widths = (128, 256, 256, 1)
    fv, layers = decode_inputs(gen, (B, 32, 32, 32), widths, dev)
    z = coarse_first_layer(fv, layers).contiguous()
    p = dense_decode_plain(fv, layers, VOL)
    std = float(p.std())
    log(f"dense decode check field: output std {std:.3e}, range "
        f"[{float(p.min()):.3f}, {float(p.max()):.3f}]")
    check(std >= 0.1, "dense decode check field is flat")
    tc = {}
    for tier in ("highest", "high", "default"):
        lim_plain, lim_f32 = TC_LIMITS[tier]
        packed = pack_decoder(layers, tier)
        k = dense_decode_tc_cuda(z, packed, VOL)
        pt = dense_decode_plain(fv, layers, VOL, tier,
                                kernel_products=tier == "highest")
        torch.cuda.synchronize()
        err = float((k - pt).abs().max())
        if tier == "highest":
            err_f32 = float((k - p).abs().max())
            log(f"dense decode tc {tier}: max abs err {err:.3e} against the "
                f"plain bf16x6 emulation (limit {lim_plain:.0e}), "
                f"{err_f32:.3e} against f32 (limit {lim_f32:.0e})")
            check(err_f32 <= lim_f32,
                  f"dense decode tc {tier} disagrees with f32")
        else:
            err_f32 = float((pt - p).abs().max())
            log(f"dense decode tc {tier}: max abs err {err:.3e} against the "
                f"plain tier (limit {lim_plain:.0e}), plain tier against "
                f"f32 {err_f32:.3e} (> 0, limit {lim_f32:.0e})")
            check(0 < err_f32 <= lim_f32,
                  f"dense decode tc {tier}: plain tier against f32 "
                  f"{err_f32}")
        check(err <= lim_plain and bool(torch.isfinite(k).all()),
              f"dense decode tc {tier} disagrees with its plain version")
        del k, pt
        ms = time_ms(lambda: dense_decode_tc_cuda(z, packed, VOL), 5)
        # the plain version of the tier ('highest': f32)
        pms = time_ms(lambda: dense_decode_plain(fv, layers, VOL, tier), 2)
        bnd, by = log_decode_time(tier, fv, z, packed, widths, VOL, ms, pms)
        tc[tier] = dict(err=err, ms=ms, pms=pms, bnd=bnd, by=by)
    for tier, name in (("high", "dense_decode_tc"),
                       ("highest", "dense_decode_tc_highest")):
        t = tc[tier]
        rows[name] = dict(
            name=name, route="cuda",
            source="garmentnets_tpu_torch/csrc/dense_decode_tc.cu",
            replaces="garmentnets_tpu/ops/dense_decode_pallas.py:123",
            max_abs_err=t["err"], ms=t["ms"], plain_ms=t["pms"],
            bound_ms=t["bnd"], bound_by=t["by"], library_ms=None)
    del z, fv, p

    # ---- ggm: [8,128,128,128], sigma 0.5 ----
    vol = torch.from_numpy(cloth_like_wnf(VOL)).to(dev)
    vol = (vol[None] + 0.02 * torch.rand(B, VOL, VOL, VOL,
                                         generator=gen).to(dev)).contiguous()
    k0, k1 = ggm_taps(0.5)
    k = ggm_cuda(vol, k0, k1)
    p = ggm_plain(vol, 0.5)
    torch.cuda.synchronize()
    err = float((k - p).abs().max())
    log(f"ggm: max abs err {err:.3e} (limit 1e-5)")
    check(err <= 1e-5, "ggm disagrees with its plain version")
    r = (len(k0) - 1) // 2
    outer = [np.einsum("i,j,k->ijk", a, b_, c) for (a, b_, c) in
             ((k1, k0, k0), (k0, k1, k0), (k0, k0, k1))]
    weight = torch.as_tensor(np.stack(outer)[:, None], dtype=torch.float32,
                             device=dev)

    def ggm_library():
        # one conv3d with the three 5x5x5 outer-product kernels on the
        # replicate-padded volume, then the magnitude: a yardstick only
        g = F.conv3d(F.pad(vol[:, None], (r,) * 6, mode="replicate"), weight)
        return torch.sqrt((g * g).sum(dim=1))

    lib_err = float((ggm_library() - p).abs().max())
    ms = time_ms(lambda: ggm_cuda(vol, k0, k1), 20)
    pms = time_ms(lambda: ggm_plain(vol, 0.5), 5)
    lms = time_ms(ggm_library, 5)
    taps = 2 * r + 1
    ggm_ops = vol.numel() * (8 * taps * 2 + 6)
    bnd, by = bound_ms(2 * vol.numel() * 4, ggm_ops, F32_FLOPS)
    # its roundings forbid FMA contraction: one instruction an operation
    issue_ms = ggm_ops / F32_INSTR * 1e3
    log(f"ggm: kernel {ms:.3f} ms, plain {pms:.3f} ms, conv3d {lms:.3f} ms "
        f"(max abs err {lib_err:.1e}), bound {bnd:.4f} ms ({by}; issue floor "
        f"of {ggm_ops / vol.numel():.0f} unfused instructions a voxel "
        f"{issue_ms:.4f} ms), "
        f"{2 * vol.numel() * 4 / (ms * 1e-3) / 1e9:.0f} GB/s achieved")
    rows["ggm"] = dict(
        name="ggm", route="cuda", source="garmentnets_tpu_torch/csrc/ggm.cu",
        replaces="garmentnets_tpu/ops/gaussian_pallas.py:93",
        max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bnd, bound_by=by,
        library_ms=lms)
    del vol, k, p

    # ---- set abstraction on the tensor cores (bf16x3): SA1 6->64->64->128
    # at [8,6000] -> 3000, SA2 131->128->128->256 at [8,3000] -> 750, K=64 ----
    sa = dict(ms=0.0, plain_ms=0.0, bound=0.0, f32_bound=0.0, t_tc=0.0,
              t_cc=0.0, t_b=0.0, err=0.0)
    pos = None
    for n_pts, m, cin, widths, radius in (
            (N, N // 2, 3, (6, 64, 64, 128), 0.05),
            (N // 2, N // 8, 128, (131, 128, 128, 256), 0.1)):
        args = sa_inputs(gen, B, n_pts, m, cin, widths, radius, dev, pos)
        x, pos_in, centers, idx, mask, layers = args
        # the packed weights, as SAModule caches them between calls
        packed = pack_sa_layers(layers, cin + 3)
        k = sa_tc_cuda(*args, packed)
        ph = sa_fused_plain(*args, precision="high")
        p = sa_fused_plain(*args)
        torch.cuda.synchronize()
        err_h = float((k - ph).abs().max())
        err = float((k - p).abs().max())
        std = float(p.std())
        share = float(mask.float().mean())
        log(f"sa_tc [{B},{n_pts},{cin}] -> [{B},{m},{widths[-1]}]: max abs "
            f"err {err_h:.3e} against the plain 'high' tier (limit 2e-05), "
            f"{err:.3e} against f32 (limit 1e-04), output std {std:.3e}, "
            f"valid slots {share:.4f}")
        check(std >= 0.1, f"sa check output is flat at N={n_pts}")
        check(err_h <= 2e-5 and err <= 1e-4
              and bool(torch.isfinite(k).all()),
              f"sa_tc disagrees with its plain versions at N={n_pts}")
        ms = time_ms(lambda: sa_tc_cuda(*args, packed), 10)
        pms = time_ms(lambda: sa_fused_plain(*args, precision="high"), 3)
        f32_ms = time_ms(lambda: sa_fused_plain(*args), 3)
        pack_ms = time_ms(lambda: pack_sa_layers(layers, cin + 3), 10)
        t0 = time.perf_counter()
        for _ in range(20):
            pack_sa_layers(layers, cin + 3)
        pack_host_ms = (time.perf_counter() - t0) * 1e3 / 20
        torch.cuda.synchronize()
        # over the valid slots, at the real widths: the products (three
        # bf16 passes), and on the CUDA cores the relative position, the
        # bf16 split of every layer's input (3 operations an element), bias,
        # ReLU and affine (4 an output) and the max
        slots = float(mask.sum())
        prods = slots * sum(2 * kk.shape[0] * kk.shape[1]
                            for kk, _, _, _ in layers)
        cc = slots * (3 + sum(3 * kk.shape[0] + 4 * kk.shape[1]
                              for kk, _, _, _ in layers) + widths[-1])
        n_bytes = ((x.numel() + pos_in.numel() + centers.numel()
                    + B * m * widths[-1]) * 4 + idx.numel() * 9
                   + packed.wts.numel() * 2 + packed.epi.numel() * 4)
        t_tc = 3 * prods / BF16_FLOPS * 1e3
        t_cc = cc / F32_FLOPS * 1e3
        t_b = n_bytes / HBM_BYTES_PER_S * 1e3
        bnd = max(t_tc, t_cc, t_b)
        f32_bnd, _ = bound_ms(n_bytes, sa_ops(mask, layers), F32_FLOPS)
        log(f"sa_tc N={n_pts} M={m}: kernel {ms:.3f} ms, plain 'high' "
            f"{pms:.3f} ms, plain f32 {f32_ms:.3f} ms, bound {bnd:.4f} ms "
            f"(tensor cores {t_tc:.4f} ms for {3 * prods / 1e9:.2f} GFLOP, "
            f"CUDA cores {t_cc:.4f} ms, bytes {t_b:.4f} ms; f32 bound "
            f"{f32_bnd:.4f} ms), {3 * prods / (ms * 1e-3) / 1e12:.1f} "
            f"TFLOP/s on the tensor cores over the valid slots, "
            f"{3 * prods / share / (ms * 1e-3) / 1e12:.1f} over all "
            f"slots; weight packing (once per weight change) {pack_ms:.3f} "
            f"ms on the device, {pack_host_ms:.3f} ms on the host")
        sa["ms"] += ms
        sa["plain_ms"] += pms
        sa["bound"] += bnd
        sa["f32_bound"] += f32_bnd
        sa["t_tc"] += t_tc
        sa["t_cc"] += t_cc
        sa["t_b"] += t_b
        sa["err"] = max(sa["err"], err_h)
        pos = centers
    by = "bytes" if sa["t_b"] >= max(sa["t_tc"], sa["t_cc"]) else "operations"
    log(f"sa_tc both calls: kernel {sa['ms']:.3f} ms, plain 'high' "
        f"{sa['plain_ms']:.3f} ms, bound {sa['bound']:.4f} ms ({by}), f32 "
        f"bound {sa['f32_bound']:.4f} ms")
    rows["sa_tc"] = dict(
        name="sa_tc", route="cuda",
        source="garmentnets_tpu_torch/csrc/sa_tc.cu",
        replaces="garmentnets_tpu/kernels/sa_pallas.py:166",
        max_abs_err=sa["err"], ms=sa["ms"], plain_ms=sa["plain_ms"],
        bound_ms=sa["bound"], bound_by=by, library_ms=None)
    return rows


def phase_main_path(dev) -> dict:
    """PredictEngine at the full width of PipelineConfig() on the card, at
    its default decode tier 'high', then one batch of an engine at
    'highest' (the same tensor-core kernel at bf16x6). Returns the launch
    counts of each: {"high": {...}, "highest": {...}}."""
    import torch
    from garmentnets_tpu_torch.core.random_weights import seeded_init_
    from garmentnets_tpu_torch.harness.predict_engine import PredictEngine
    from garmentnets_tpu_torch.kernels import _build
    from garmentnets_tpu_torch.models.pipeline import (
        ConvImplicitWNFPipeline, PipelineConfig)
    from garmentnets_tpu_torch.ops.isosurface import (
        extract_active_bricks, pack_brick_pages, read_page_counts)

    cfg = PipelineConfig()
    model = ConvImplicitWNFPipeline(cfg)
    seeded_init_(model, 0)
    engine = PredictEngine(cfg, model.state_dict(), volume_size=VOL,
                           gradient_sigma=0.5, iso_level=0.5, device=dev)
    check(engine.decode_precision == "high", "the engine's default tier")
    f32_engine = PredictEngine(cfg, model.state_dict(), volume_size=VOL,
                               gradient_sigma=0.5, iso_level=0.5,
                               decode_precision="highest", device=dev)
    rng = np.random.RandomState(0)
    x = rng.rand(B, N, 3).astype(np.float32)
    pos = (rng.rand(B, N, 3) - 0.5).astype(np.float32)
    cloth = torch.from_numpy(cloth_like_wnf(VOL)).to(dev)
    base, vals, counts = extract_active_bricks(
        cloth[None].expand(B, -1, -1, -1).contiguous(), 0.5,
        engine.brick_cap)
    cloth_pages = pack_brick_pages(base, vals, engine.brick_page,
                                   counts=counts)
    log(f"cloth WNF: {int(counts[0])} shipped bricks per garment "
        f"(cap {engine.brick_cap})")

    stages = {"encode": [], "meshes": [], "warp": []}
    _build.reset_launch_counts()
    t_all = None
    for i in range(N_BATCHES):
        if i == 1:
            t_all = time.perf_counter()
        t0 = time.perf_counter()
        enc = engine.encode(x, pos)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sub = dict(enc, active_pages=cloth_pages, active_counts=counts)
        meshes = engine.extract_meshes(sub)
        t2 = time.perf_counter()
        warps = engine.warp_batch(sub, meshes)
        t3 = time.perf_counter()
        if i > 0:
            stages["encode"].append((t1 - t0) * 1e3)
            stages["meshes"].append((t2 - t1) * 1e3)
            stages["warp"].append((t3 - t2) * 1e3)
    elapsed = time.perf_counter() - t_all
    launches = {"high": dict(_build.LAUNCHES)}
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    enc32 = f32_engine.encode(x, pos)
    torch.cuda.synchronize()
    encode32_ms = (time.perf_counter() - t0) * 1e3
    launches["highest"] = dict(_build.LAUNCHES)
    engine.close()
    f32_engine.close()
    log(f"main path launches over {N_BATCHES} batches at 'high': "
        f"{launches['high']}; over one batch at 'highest': "
        f"{launches['highest']}")
    for tier, n in (("high", N_BATCHES), ("highest", 1)):
        check(launches[tier] == {"fps": 2 * n, "dense_decode_tc": n,
                                 "ggm": n, "sa_tc": 2 * n},
              f"unexpected launch counts at '{tier}': {launches[tier]}")
    check(bool(torch.isfinite(enc32["wnf_ggm"]).all()), "f32 ggm not finite")
    del enc32

    for key in ("wnf_ggm", "feature_volume", "pred_nocs", "global_logits"):
        check(bool(torch.isfinite(enc[key]).all()), f"{key} not finite")
    check(tuple(enc["wnf_ggm"].shape) == (B, VOL, VOL, VOL), "ggm shape")
    check(tuple(enc["feature_volume"].shape) == (B, 32, 32, 32, 128),
          "feature volume shape")
    real_counts = read_page_counts(enc["active_pages"][0].cpu().numpy())
    check(bool((real_counts == enc["active_counts"].cpu().numpy()).all()),
          "page header counts disagree with active_counts")
    nverts = [0 if m is None else len(m[0]) for m in meshes]
    check(all(n > 0 for n in nverts), f"empty meshes: {nverts}")
    check(all(w is not None and np.isfinite(w["warp_field"]).all()
              and np.isfinite(w["verts_ggm"]).all() for w in warps),
          "warp results not finite")
    gps = B * (N_BATCHES - 1) / elapsed
    med = {k: statistics.median(v) for k, v in stages.items()}
    per_batch = "; ".join(f"{k} " + ", ".join(f"{t:.1f}" for t in v)
                          for k, v in stages.items())
    log(f"main path on {torch.cuda.get_device_name(0)}: {gps:.3f} "
        f"garments/s (B={B}, N={N}, {VOL}^3, decode 'high', "
        f"{N_BATCHES - 1} timed batches, stages run in sequence); "
        f"median ms per batch: encode {med['encode']:.1f} (one batch at "
        f"'highest': {encode32_ms:.1f}), host MC "
        f"{med['meshes']:.1f}, warp {med['warp']:.1f}; verts per garment "
        f"{nverts[0]}; shipped bricks on the random net's WNF: "
        f"{real_counts.tolist()}")
    log(f"main path ms of each timed batch: {per_batch}; the timed batches "
        f"took {elapsed * 1e3:.1f} ms in all, their stages "
        f"{sum(map(sum, stages.values())):.1f}")
    return launches


def serve_request(rng, n_garments: int):
    """One request: n_garments clouds of the same 5000-7000 points (the
    service resamples them to N)."""
    n = int(rng.randint(5000, 7001))
    return (rng.rand(n_garments, n, 3).astype(np.float32),
            (rng.rand(n_garments, n, 3) - 0.5).astype(np.float32))


def normalized_batch(*requests):
    """The service's zero-padded [B, N, 3] batch of these requests'
    garments, in order."""
    from garmentnets_tpu_torch.harness.serve import _normalize_cloud
    bx = np.zeros((B, N, 3), np.float32)
    bp = np.zeros((B, N, 3), np.float32)
    i = 0
    for x, pos in requests:
        for b in range(len(x)):
            bx[i], bp[i] = _normalize_cloud(x[b], pos[b], N, seed=b)
            i += 1
    return bx, bp


def live_head_(model, x, pos, dev, share=0.01, **engine_kw) -> None:
    """Make the random network's WNF cross the iso level 0.5 on about
    `share` of the voxels: the volume decoder's head becomes relu(z + b)
    (its BatchNorm the identity), z is read once with b = 100 (so the ReLU
    passes everything), and b is set to 0.5 minus z's (1 - share)
    quantile."""
    import torch
    from garmentnets_tpu_torch.harness.predict_engine import PredictEngine
    lin, bn = model.volume_decoder.mlp[-1][0], model.volume_decoder.mlp[-1][2]
    with torch.no_grad():
        bn.weight.fill_(1.0)
        bn.bias.zero_()
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0 - bn.eps)
        lin.bias.fill_(100.0)
    probe = PredictEngine(model.cfg, model.state_dict(), volume_size=VOL,
                          return_volume=True, device=dev, **engine_kw)
    z = probe.encode(x, pos)["wnf_volume"] - 100.0
    probe.close()
    q = float(torch.quantile(z.flatten()[::7], 1.0 - share))
    with torch.no_grad():
        lin.bias.fill_(0.5 - q)


def phase_serve(dev) -> dict:
    """The port's server at full width on the card: PredictService on a
    checkpoint written by save_pipeline_checkpoint, behind
    make_http_server, driven through predict_remote by 4 clients, each
    with its 3 requests of 2 garments in flight at once (24 garments; with
    one request at a time the 4 clients would fill exactly one batch and
    the dispatcher would never hold a next batch to overlap)."""
    import pathlib
    import tempfile
    import threading
    from urllib.request import urlopen

    import torch
    from garmentnets_tpu_torch.core.checkpoint import (
        save_pipeline_checkpoint)
    from garmentnets_tpu_torch.core.random_weights import seeded_init_
    from garmentnets_tpu_torch.harness.serve import (
        PredictService, make_http_server, predict_remote)
    from garmentnets_tpu_torch.kernels import _build
    from garmentnets_tpu_torch.models.pipeline import (
        ConvImplicitWNFPipeline, PipelineConfig)
    from garmentnets_tpu_torch.ops.isosurface import read_page_counts

    n_clients, n_requests, per_request = 4, 3, 2
    rng = np.random.RandomState(1)
    traffic = [[serve_request(rng, per_request) for _ in range(n_requests)]
               for _ in range(n_clients)]
    lone = serve_request(rng, per_request)    # checked against the engine
    cfg = PipelineConfig()
    model = ConvImplicitWNFPipeline(cfg)
    seeded_init_(model, 1)
    live_head_(model, *normalized_batch(
        *(traffic[c][0] for c in range(n_clients))), dev)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = pathlib.Path(tmp) / "serve.ckpt"
        save_pipeline_checkpoint(ckpt, cfg, model.state_dict())
        service = PredictService(ckpt, batch_size=B, num_points=N,
                                 volume_size=VOL, batch_window_ms=20.0,
                                 device=dev)
    httpd = make_http_server(service, "127.0.0.1", 0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        predict_remote(url, *serve_request(rng, 1))         # warm-up batch
        _build.reset_launch_counts()
        before = dict(service.stats)
        results, latencies, errors = {}, [], []

        def send(c, r):
            t0 = time.perf_counter()
            try:
                results[c, r] = predict_remote(url, *traffic[c][r])
                latencies.append((time.perf_counter() - t0) * 1e3)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))

        def client(c):
            reqs = [threading.Thread(target=send, args=(c, r))
                    for r in range(n_requests)]
            for t in reqs:
                t.start()
            for t in reqs:
                t.join(timeout=300)

        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(n_clients)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        stats = dict(service.stats)
        check(not errors and not any(t.is_alive() for t in clients),
              f"serve requests failed: {errors}")
        n_batches = stats["batches"] - before["batches"]
        overlapped = stats["mc_overlapped"] - before["mc_overlapped"]
        with urlopen(url + "/healthz") as resp:
            health = json.loads(resp.read())

        n_ok, n_verts = 0, []
        for (c, r), res in sorted(results.items()):
            check(len(res) == per_request, "wrong result count")
            for g in res:
                check("error" not in g, f"garment failed: {g.get('error')}")
                check(g["pred_nocs"].shape == (N, 3)
                      and np.isfinite(g["pred_nocs"]).all()
                      and np.isfinite(g["pred_nocs_confidence"]).all(),
                      "NOCS output malformed")
                if int(g["ok"]):
                    n_ok += 1
                    n_verts.append(len(g["verts"]))
                    check(g["faces"].shape[1] == 3
                          and g["warp_field"].shape == g["verts"].shape
                          and g["verts_ggm"].shape == (len(g["verts"]),)
                          and all(np.isfinite(g[k]).all() for k in (
                              "verts", "normals", "warp_field",
                              "verts_ggm", "volume_value")),
                          "mesh or warp output malformed")
        log(f"serve: {n_clients * n_requests} requests, "
            f"{n_clients * n_requests * per_request} garments in "
            f"{n_batches} device batches, ok=1 for {n_ok}, verts per "
            f"ok garment {n_verts[:4]}...; launches {launches}; host MC "
            f"began while the next encode ran in {overlapped} batches")
        check(n_ok >= 1, "no garment came back with a mesh")
        check(service.engine.decode_precision == "high",
              "the service's default tier")
        check(n_batches >= 1 and launches == {
            "fps": 2 * n_batches, "dense_decode_tc": n_batches,
            "ggm": n_batches, "sa_tc": 2 * n_batches},
              f"serve launches {launches} over {n_batches} batches")
        check(overlapped >= 1, "host MC never overlapped the next encode")
        lat = np.percentile(latencies, [50, 90])
        gps = n_clients * n_requests * per_request / wall
        log(f"serve on {torch.cuda.get_device_name(0)}: {gps:.3f} "
            f"garments/s, request latency p50 {lat[0]:.1f} ms, p90 "
            f"{lat[1]:.1f} ms (B={B}, N={N}, {VOL}^3, batch window 20 ms); "
            f"/healthz {health}")

        # one request alone against the engine on the same padded batch
        got = predict_remote(url, *lone)
        eng = service.engine
        enc = eng.encode(*normalized_batch(lone))
        eng.prefetch(enc, extra_keys=("pred_nocs",))
        meshes = eng.extract_meshes(enc)
        warps = eng.warp_batch(enc, meshes)
        shipped = read_page_counts(eng.host_outputs(enc)["active_pages"][0]
                                   .numpy())
        nocs = eng.host_outputs(enc)["pred_nocs"].numpy()
        diff = 0.0
        for i, g in enumerate(got):
            m, w = meshes[i], warps[i]
            check(int(g["ok"]) == int(m is not None and w is not None),
                  "served ok flag differs from the engine's")
            diff = max(diff, float(np.abs(g["pred_nocs"] - nocs[i]).max()))
            if int(g["ok"]):
                check(np.array_equal(g["faces"], m[1]),
                      "served faces differ from the engine's")
                for a, b_ in ((g["verts"], m[0]), (g["volume_value"], m[2]),
                              (g["warp_field"], w["warp_field"]),
                              (g["verts_ggm"], w["verts_ggm"])):
                    diff = max(diff, float(np.abs(a - b_).max()))
        log(f"serve vs a direct encode -> extract_meshes -> warp_batch: ok "
            f"{[int(g['ok']) for g in got]}, max abs diff {diff:.3e}; "
            f"shipped bricks {shipped.tolist()}")
        check(diff <= 1e-5, "served results differ from a direct run")
        return {"garments_per_s": gps, "p50_ms": lat[0], "p90_ms": lat[1]}
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()


CLI_INSTANCES, CLI_GRIPS = 8, 4    # 32 garments, all in the test split
CLI_SPLIT = [0, 0, 1]
CLI_STAGES = ("encode_ms", "encode_wait_ms", "host_mc_ms",
              "warp_dispatch_ms", "warp_collect_ms", "writer_ms")
MC_SCHEMA = ("verts", "faces", "normals", "volume_value",
             "volume_gradient_magnitude", "warp_field")
PC_SCHEMA = ("pred_nocs", "pred_nocs_confidence", "pred_nocs_logits",
             "input_points", "input_rgb", "gt_nocs")
MISC_SCHEMA = ("gt_nocs_grip_point", "pred_nocs_grip_point",
               "pred_global_nocs_grip_point", "pred_global_confidence",
               "global_feature")


def blosc_route() -> str:
    """How the zarr writer compresses: libblosc, the pure-Python Blosc
    engine on `zstandard`, or zlib when neither is there."""
    from garmentnets_tpu_torch.data import blosc_codec
    if blosc_codec._LIB is not None:
        return "blosc (libblosc)"
    if blosc_codec.available():
        return "blosc (pure Python on zstandard)"
    return "zlib (no libblosc and no zstandard: degraded)"


def phase_predict_cli(dev, tmp: pathlib.Path) -> tuple:
    """The port's predict CLI at full width on the card: the port's
    generator writes a synthetic dataset (no task-space volumes, a 32^3 GT
    volume, 4 views x 1500 points; 8 instances x 4 grips, all in the test
    split) into `tmp`, PipelineConfig() with seeded weights and a live head
    is saved with save_pipeline_checkpoint, and predict.main runs over it
    at B=8, 128^3, decode 'high'. Returns its launch counts and its run
    directory."""
    import torch
    from garmentnets_tpu_torch.core.checkpoint import (
        save_pipeline_checkpoint)
    from garmentnets_tpu_torch.core.config import load_config
    from garmentnets_tpu_torch.core.random_weights import seeded_init_
    from garmentnets_tpu_torch.data import zarrlite
    from garmentnets_tpu_torch.data.dataset import ConvImplicitWNFDataModule
    from garmentnets_tpu_torch.data.synthetic import generate_dataset
    from garmentnets_tpu_torch.harness import predict
    from garmentnets_tpu_torch.kernels import _build
    from garmentnets_tpu_torch.models.pipeline import (
        ConvImplicitWNFPipeline, PipelineConfig)

    t0 = time.perf_counter()
    generate_dataset(str(tmp / "data.zarr"), num_instances=CLI_INSTANCES,
                     grips_per_instance=CLI_GRIPS, volume_size=32,
                     pts_per_view=N // 4, num_views=4, seed=0,
                     include_task_space=False)
    log(f"predict CLI: synthetic dataset of {CLI_INSTANCES * CLI_GRIPS} "
        f"garments in {time.perf_counter() - t0:.1f} s")
    cfg = load_config("predict_default", [
        f"main.checkpoint_path={tmp / 'pipeline.ckpt'}",
        f"datamodule.zarr_path={tmp / 'data.zarr'}",
        f"datamodule.batch_size={B}", f"datamodule.num_pc_sample={N}",
        "datamodule.volume_size=32",
        f"datamodule.dataset_split={CLI_SPLIT}",
        f"prediction.volume_size={VOL}",
        "prediction.decode_precision=high", f"prediction.device={dev}"])
    dm = ConvImplicitWNFDataModule(**cfg["datamodule"])
    dm.prepare_data()
    n_garments = len(dm.test_idxs)
    n_batches = -(-n_garments // B)
    check(n_garments >= 3 * B, f"only {n_garments} garments to predict")
    first = next(iter(dm.test_dataloader()))
    model = ConvImplicitWNFPipeline(PipelineConfig())
    seeded_init_(model, 2)
    live_head_(model, first["x"], first["pos"], dev)
    save_pipeline_checkpoint(tmp / "pipeline.ckpt", model.cfg,
                             model.state_dict())
    del model

    _build.reset_launch_counts()
    run = first_run = predict.main(cfg, run_dir=str(tmp / "run"))
    launches = dict(_build.LAUNCHES)
    log(f"predict CLI launches over {n_batches} batches: {launches}")
    check(launches == {"fps": 2 * n_batches, "sa_tc": 2 * n_batches,
                       "dense_decode_tc": n_batches, "ggm": n_batches},
          f"unexpected launch counts in the predict CLI: {launches}")

    summary = json.loads((run / "summary.json").read_text())
    recs = [json.loads(x) for x in
            (run / "metrics.jsonl").read_text().splitlines()]
    root = zarrlite.open(str(run / "prediction.zarr"), "r")
    groups = list(root["samples"].groups())
    check(summary["garments"] == n_garments == len(groups),
          f"{summary['garments']} garments written, {len(groups)} "
          f"groups, {n_garments} in the split")
    n_verts = []
    for key, g in groups:
        for sub, names in (("marching_cubes_mesh", MC_SCHEMA),
                           ("point_cloud", PC_SCHEMA),
                           ("misc", MISC_SCHEMA)):
            have = {name for name, _ in g[sub].arrays()}
            check(set(names) <= have, f"{key}/{sub} lacks "
                  f"{sorted(set(names) - have)}")
        for sub in ("gt_mesh", "gt_marching_cubes_mesh"):
            check(sub in g, f"{key} lacks {sub}")
        check(set(g.attrs.asdict()) >= {
            "scale", "gender", "sample_id", "garment_name",
            "grip_vertex_idx", "batch_idx"}, f"{key} attrs")
        mc = g["marching_cubes_mesh"]
        verts = mc["verts"][:]
        check(len(verts) > 1 and np.isfinite(verts).all(),
              f"{key}: the NaN-sentinel mesh (no surface)")
        warp = mc["warp_field"][:]
        check(warp.shape == verts.shape and np.isfinite(warp).all()
              and np.isfinite(mc["volume_gradient_magnitude"][:]).all(),
              f"{key}: warp values not finite")
        n_verts.append(len(verts))
    check(root.attrs.asdict() == {"subset": "test"}, "root attrs")
    per_batch = "; ".join(
        f"{k[:-3]} " + ", ".join(f"{r[k]:.1f}" for r in recs)
        for k in CLI_STAGES)
    log(f"predict CLI on {torch.cuda.get_device_name(0)}: "
        f"{summary['garments_per_sec']:.3f} garments/s "
        f"({summary['garments']} garments in "
        f"{summary['elapsed_sec']:.3f} s; B={B}, N={N}, {VOL}^3, decode "
        f"'high', encode(i+1) under host MC(i), warp collected at depth "
        f"2, zarr written by a writer thread, data loaded by 2 worker "
        f"threads); zarr codec: {blosc_route()}; verts per garment "
        f"{min(n_verts)}-{max(n_verts)}")
    log(f"predict CLI ms of each batch (encode: CUDA events around the "
        f"encode; the rest host clock): {per_batch}")

    # the same run without the [N, bins*3] logits, the largest array a
    # garment writes: how much of the time the writer takes
    cfg["prediction"]["store_pred_nocs_logits"] = False
    _build.reset_launch_counts()
    run = predict.main(cfg, run_dir=str(tmp / "run_nologits"))
    check(dict(_build.LAUNCHES) == launches,
          f"launch counts without logits: {_build.LAUNCHES}")
    summary = json.loads((run / "summary.json").read_text())
    recs = [json.loads(x) for x in
            (run / "metrics.jsonl").read_text().splitlines()]
    per_batch = "; ".join(
        f"{k[:-3]} " + ", ".join(f"{r[k]:.1f}" for r in recs)
        for k in CLI_STAGES)
    log(f"predict CLI with prediction.store_pred_nocs_logits=false: "
        f"{summary['garments_per_sec']:.3f} garments/s; ms of each "
        f"batch: {per_batch}")
    return launches, first_run

ROOT = pathlib.Path(__file__).resolve().parent
# summary columns the hole filter (value_key > value_threshold) can empty:
# every other metric is finite on a sample with a surface
HOLE_FILTERED = ("chamfer_symmetrical_nocs", "chamfer_symmetrical_sim",
                 "hausdorff_nocs", "hausdorff_sim", "geodesic_rms_nocs",
                 "geodesic_rms_sim")


def finite_by_construction(column: str) -> bool:
    return column not in HOLE_FILTERED and "_regular_" not in column


def start_eval_cli(prediction_dir: pathlib.Path, cwd: pathlib.Path,
                   *overrides: str) -> tuple:
    """Start `python -m garmentnets_tpu_torch.harness.eval` on a predict
    run, in a subprocess of its own (a fork of this CUDA process would be
    unsafe), with configs/eval_default.yaml, num_workers=-1 and
    `overrides`; its run directory goes under `cwd`, so evals that run at
    once take a `cwd` each. Returns the handle for finish_eval_cli."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cwd.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(
        [sys.executable, "-m", "garmentnets_tpu_torch.harness.eval",
         f"main.prediction_output_dir={prediction_dir}",
         "main.num_workers=-1", *overrides],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return proc, cwd, time.perf_counter()


def stop_eval_cli(handle: tuple) -> None:
    """Kill an eval started by start_eval_cli if it still runs."""
    proc = handle[0]
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def finish_eval_cli(handle: tuple, allowed_errors=()) -> tuple:
    """Wait for an eval started by start_eval_cli (at most 900 s); a
    metric function that raises on a sample fails the run unless it is
    among `allowed_errors`. Returns (eval run dir, timings with "wall"
    and "errors": {metric function: samples it raised on}, all_metrics
    frame, parallel mode)."""
    import pandas as pd
    proc, cwd, t0 = handle
    try:
        stdout, stderr = proc.communicate(timeout=900)
    finally:
        stop_eval_cli(handle)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"eval CLI failed:\n{stderr[-4000:]}")
    lines = stdout.strip().splitlines()
    run = cwd / lines[-1]
    modes = [x for x in lines if x.startswith("parallel_map: ")]
    check(len(modes) == 1, f"eval CLI parallel modes: {modes}")
    errors, func = {}, None
    for x in lines:
        if x.startswith("Errors in "):
            func = x[len("Errors in "):].rstrip(":")
            errors[func] = 0
        elif x.startswith("  sample ") and func is not None:
            errors[func] += 1
        else:
            func = None
    check(set(errors) <= set(allowed_errors),
          "eval CLI captured errors: " + "; ".join(
              x for x in lines if x.startswith(("Errors in ", "  sample "))))
    timings = json.loads((run / "timings.json").read_text())
    timings["wall"] = wall
    timings["errors"] = errors
    df = pd.read_csv(run / "all_metrics.csv", index_col=0)
    return run, timings, df, modes[0]


def run_eval_cli(prediction_dir: pathlib.Path, cwd: pathlib.Path,
                 *overrides: str, allowed_errors=()) -> tuple:
    """finish_eval_cli(start_eval_cli(...)): one eval CLI run."""
    return finish_eval_cli(start_eval_cli(prediction_dir, cwd, *overrides),
                           allowed_errors)


def report_eval(what: str, run, timings: dict, df, mode: str) -> None:
    """Log an eval run and fail on a non-finite metric that is finite by
    construction on a sample with a surface."""
    summary = json.loads((run / "summary.json").read_text())
    funcs = {k: round(v, 3) for k, v in timings.items()
             if k.startswith("compute_")}
    n = timings["samples"]
    log(f"eval {what}: {mode}; seconds per metric function {funcs}, "
        f"metrics {timings['metrics_total']:.3f} s, eval "
        f"{timings['total']:.3f} s ({n / timings['total']:.3f} garments/s), "
        f"process wall "
        f"{timings['wall']:.3f} s (host times on the card's machine); null "
        f"samples {timings['null_samples']} of {n}")
    log(f"eval {what}: summary.json keys {sorted(summary)}")
    live = df[df["null_percentage"] == 0]
    bad = [c for c in live.columns if finite_by_construction(c)
           and not np.isfinite(live[c].to_numpy(np.float64)).all()]
    check(timings["null_samples"] == 0 and len(live) == n,
          f"eval {what}: null samples")
    check(not bad, f"eval {what}: non-finite values in {bad}")


def phase_eval(cli_run: pathlib.Path, tmp: pathlib.Path) -> dict:
    """The port's eval CLI on the predict CLI's prediction.zarr, as
    shipped (num_workers=-1), then with vis.samples_per_instance=1 and its
    PLY files counted. Returns the seconds each metric function took."""
    import pandas as pd
    t0 = time.perf_counter()
    run, timings, df, mode = run_eval_cli(cli_run, tmp)
    report_eval("of the predict CLI's run", run, timings, df, mode)
    enabled = {"compute_optimal_gradient_treshold", "compute_pc_metrics",
               "compute_chamfer", "compute_hybrid_chamfer"}
    check(enabled <= set(timings), f"eval metrics run: {sorted(timings)}")

    vis_run, vis_t, vis_df, _ = run_eval_cli(cli_run, tmp,
                                             "vis.samples_per_instance=1")
    # the eval's own choice: the 2 best and 2 worst of the rank metric and
    # samples 0..9, each with its three vis functions
    ranked = vis_df["hybrid_chamfer_symmetrical_regular_pred"].sort_values()
    picked = (set(ranked.index[:2]) | set(ranked.index[-2:])
              | set(range(min(10, len(vis_df)))))
    plys = sorted((vis_run / "vis").glob("*.ply"))
    log(f"eval with vis.samples_per_instance=1: {len(plys)} PLY files "
        f"({len(picked)} samples x 3), {vis_t['total']:.3f} s")
    check(len(plys) == 3 * len(picked) and all(
        p.stat().st_size > 200 for p in plys), "vis PLY files")
    pd.testing.assert_frame_equal(vis_df, df)
    log(f"eval phase: {time.perf_counter() - t0:.1f} s")
    return timings


def eval_ready_heads_(model) -> None:
    """Fit a seeded network's outputs for every eval metric, before
    live_head_: the volume head's weights are scaled by 0.2, so that its
    live field stays above the ReLU's 0 around the surface (at full slope
    it drops to 0 within a voxel, and the meshes of the int8 bricks then
    hold near-degenerate triangles whose heat-method systems are exactly
    singular: the geodesic metric fails on them, in the JAX eval as in the
    port's); and the surface decoder's last ReLU is held open (its bias and
    its BatchNorm's running mean raised by 100), so that no channel of the
    warp field is constant and the sim-space mesh is not flat."""
    import torch
    warp_head = model.surface_decoder.mlp[-1]
    lin, bn = warp_head[0], warp_head[2]
    with torch.no_grad():
        model.volume_decoder.mlp[-1][0].weight.mul_(0.2)
        lin.bias.add_(100.0)
        bn.running_mean.add_(100.0)


def phase_variants(dev, tmp: pathlib.Path) -> dict:
    """predict.main at full width on one batch of B=8 for each inference
    variant, on checkpoints written by save_pipeline_checkpoint with seeded
    weights, eval_ready_heads_ and a live head: (a) the mc-surface head
    with use_hole_prediction, both aggregator include flags off, its
    logits changing sign on the meshes (the live volume decoder minus
    0.5); (b) the task-space model. The dataset (2 instances x 4 grips, 16^3 GT
    volumes) carries task-space volumes. Then the eval CLI on each: (a)
    with the logits as the value key, a threshold of 0.0 and the
    grip-point, Hausdorff and geodesic metrics on; (b) with
    volume_task_space. Returns the launch counts of both batches."""
    import torch
    from garmentnets_tpu_torch.core.checkpoint import (
        save_pipeline_checkpoint)
    from garmentnets_tpu_torch.core.config import load_config
    from garmentnets_tpu_torch.core.random_weights import seeded_init_
    from garmentnets_tpu_torch.data import zarrlite
    from garmentnets_tpu_torch.data.dataset import ConvImplicitWNFDataModule
    from garmentnets_tpu_torch.data.synthetic import generate_dataset
    from garmentnets_tpu_torch.harness import predict
    from garmentnets_tpu_torch.kernels import _build
    from garmentnets_tpu_torch.models.pipeline import (
        ConvImplicitWNFPipeline, PipelineConfig)

    t_phase = time.perf_counter()
    zarr = tmp / "variants.zarr"
    generate_dataset(str(zarr), num_instances=2, grips_per_instance=4,
                     volume_size=16, pts_per_view=N // 4, num_views=4,
                     seed=1, include_task_space=True)
    log(f"variants: dataset of 8 garments with task-space volumes in "
        f"{time.perf_counter() - t_phase:.1f} s")
    variants = {
        "holes": (PipelineConfig(
            mc_surface_loss_weight=1.0, include_point_feature=False,
            include_confidence_feature=False,
            volume_agg_nn_channels=(128, 137, 128)),
            ["prediction.use_hole_prediction=true"],
            ["override_all.value_key="
             "marching_cubes_mesh/is_on_surface_logits",
             "override_all.value_threshold=0.0",
             "eval.compute_grip_point_metrics.enabled=true",
             "eval.compute_hausdorff.enabled=true",
             "eval.compute_geodesic.enabled=true"]),
        "task_space": (PipelineConfig(volume_task_space=True), [],
                       ["override_all.volume_task_space=true"]),
    }
    all_launches, timings = {}, {}
    for name, (pcfg, pred_over, eval_over) in variants.items():
        t0 = time.perf_counter()
        ckpt = tmp / f"{name}.ckpt"
        cfg = load_config("predict_default", [
            f"main.checkpoint_path={ckpt}", f"datamodule.zarr_path={zarr}",
            f"datamodule.batch_size={B}", f"datamodule.num_pc_sample={N}",
            "datamodule.volume_size=16", "datamodule.dataset_split=[0,0,1]",
            f"prediction.volume_size={VOL}", f"prediction.device={dev}",
            *pred_over])
        dm = ConvImplicitWNFDataModule(**cfg["datamodule"])
        dm.prepare_data()
        check(len(dm.test_idxs) == B, f"{len(dm.test_idxs)} garments")
        first = next(iter(dm.test_dataloader()))
        model = ConvImplicitWNFPipeline(pcfg)
        seeded_init_(model, 5)
        eval_ready_heads_(model)
        aabb = dm.val_dataset.cloth_sim_aabb
        live_head_(model, first["x"], first["pos"], dev,
                   task_aabb=aabb if pcfg.volume_task_space else None)
        if pcfg.has_mc_surface_decoder:
            with torch.no_grad():
                model.mc_surface_decoder.load_state_dict(
                    model.volume_decoder.state_dict())
                model.mc_surface_decoder.mlp[-1][2].running_mean.add_(0.5)
        save_pipeline_checkpoint(ckpt, pcfg, model.state_dict())
        del model

        _build.reset_launch_counts()
        run = predict.main(cfg, run_dir=str(tmp / f"run_{name}"))
        launches = dict(_build.LAUNCHES)
        t_pred = time.perf_counter() - t0
        log(f"variant {name}: launches over its one batch {launches}; "
            f"predict {t_pred:.1f} s")
        check(launches == {"fps": 2, "sa_tc": 2, "dense_decode_tc": 1,
                           "ggm": 1},
              f"unexpected launch counts in variant {name}: {launches}")
        root = zarrlite.open(str(run / "prediction.zarr"), "r")
        n_on, n_verts = 0, 0
        for key, g in root["samples"].groups():
            mc = g["marching_cubes_mesh"]
            verts = mc["verts"][:]
            check(len(verts) > 1 and np.isfinite(verts).all()
                  and np.isfinite(mc["warp_field"][:]).all(),
                  f"variant {name}, {key}: no surface or warp not finite")
            n_verts += len(verts)
            has = {"is_on_surface", "is_on_surface_logits"} <= {
                k for k, _ in mc.arrays()}
            check(has == (name == "holes"),
                  f"variant {name}, {key}: is_on_surface present {has}")
            if has:
                on = mc["is_on_surface"][:]
                logits = mc["is_on_surface_logits"][:]
                check(on.shape == logits.shape == (len(verts),)
                      and on.dtype == bool and np.isfinite(logits).all()
                      and np.array_equal(on, logits > 0),
                      f"variant {name}, {key}: is_on_surface malformed")
                n_on += int(on.sum())
        log(f"variant {name}: {n_verts} vertices over 8 garments"
            + (f", {n_on} on the surface by the head" if name == "holes"
               else ""))
        ev_run, ev_t, ev_df, mode = run_eval_cli(run, tmp, *eval_over)
        report_eval(f"of variant {name}", ev_run, ev_t, ev_df, mode)
        all_launches[name] = launches
        timings[name] = ev_t
        log(f"variant {name}: phase {time.perf_counter() - t0:.1f} s")
    for key in ("compute_grip_point_metrics", "compute_hausdorff",
                "compute_geodesic"):
        check(key in timings["holes"], f"{key} did not run")
    log(f"variants phase: {time.perf_counter() - t_phase:.1f} s")
    return all_launches


VOL_LARGE = 256
LARGE_BATCHES = 3      # large-volume batches; the first one warms up
# device normals against the host kernel's (tests/test_normals.py's bars)
NORMAL_MEAN_DEG, NORMAL_P95_DEG = 3.0, 8.0


def cloth_batch(vol: int) -> np.ndarray:
    """[B, vol, vol, vol]: cloth_like_wnf(vol) flipped along a different
    subset of the three axes for each garment, so the meshes differ."""
    w = cloth_like_wnf(vol)
    return np.ascontiguousarray(np.stack(
        [np.flip(w, tuple(a for a in range(3) if (i >> a) & 1))
         for i in range(B)]))


def code_agreement(got: np.ndarray, want: np.ndarray) -> tuple:
    """(share of equal octahedral codes, largest difference of a byte)."""
    diff = np.maximum(np.abs((got & 255) - (want & 255)),
                      np.abs((got >> 8) - (want >> 8)))
    return float((got == want).mean()), int(diff.max())


def angles_deg(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.degrees(np.arccos(np.clip((a * b).sum(-1), -1.0, 1.0)))


def phase_large_volume(dev, tmp: pathlib.Path) -> dict:
    """The large-volume path at 256^3 on the card: PredictEngine at the
    full width of PipelineConfig() (B=8, N=6000, 'high', sigma 0.5) with
    seeded weights and a live head, straddle masks on by default, host MC
    and the warp on cloth-like fields. (a) the decode and the ggm at
    S=256 against their plain versions; (b) the masks' bytes against the
    CPU's, and masked host MC identical to unmasked on all 8 garments; (c)
    device normals: the same verts, codes against the CPU's, angles
    against the host normals; (d) stage times of LARGE_BATCHES - 1 timed
    batches after a warm-up and the peak memory; (e) the predict CLI at
    prediction.volume_size=256 with device normals on one batch of 8;
    (f) ResidualUNet3D on the card against the CPU. Returns the launch
    counts of the engine's batches and of the CLI's."""
    import torch
    from garmentnets_tpu_torch.core.checkpoint import (
        save_pipeline_checkpoint)
    from garmentnets_tpu_torch.core.config import load_config
    from garmentnets_tpu_torch.core.device import full_f32
    from garmentnets_tpu_torch.core.random_weights import seeded_init_
    from garmentnets_tpu_torch.data import zarrlite
    from garmentnets_tpu_torch.data.dataset import ConvImplicitWNFDataModule
    from garmentnets_tpu_torch.harness import predict
    from garmentnets_tpu_torch.harness.predict_engine import PredictEngine
    from garmentnets_tpu_torch.kernels import _build
    from garmentnets_tpu_torch.kernels.dense_decode_tc import (
        dense_decode_tc_cuda, pack_decoder)
    from garmentnets_tpu_torch.kernels.ggm import ggm_cuda
    from garmentnets_tpu_torch.models.pipeline import (
        ConvImplicitWNFPipeline, PipelineConfig)
    from garmentnets_tpu_torch.models.unet3d import ResidualUNet3D
    from garmentnets_tpu_torch.ops.dense_decode import (
        coarse_first_layer, dense_decode_plain)
    from garmentnets_tpu_torch.ops.gaussian import (
        gaussian_gradient_magnitude, ggm_plain, ggm_taps)
    from garmentnets_tpu_torch.ops.isosurface import (
        extract_active_bricks, pack_brick_pages, read_page_counts)
    from garmentnets_tpu_torch.ops.normals import (
        oct_decode_np, sample_gradient_normals_oct)

    t_phase = time.perf_counter()
    S = VOL_LARGE
    name = torch.cuda.get_device_name(0)
    gen = torch.Generator().manual_seed(3)

    # ---- (a) the decode at S=256 ('high') and the ggm at W=256 ----
    widths = (128, 256, 256, 1)
    fv, layers = decode_inputs(gen, (B, 32, 32, 32), widths, dev)
    z = coarse_first_layer(fv, layers).contiguous()
    packed = pack_decoder(layers, "high")
    k = dense_decode_tc_cuda(z, packed, S)
    p = dense_decode_plain(fv, layers, S, "high")
    torch.cuda.synchronize()
    err = float((k - p).abs().max())
    log(f"large volume: dense decode tc high at {S}^3: max abs err "
        f"{err:.3e} against the plain tier (limit "
        f"{TC_LIMITS['high'][0]:.0e}), output std {float(p.std()):.3e}")
    check(err <= TC_LIMITS["high"][0] and bool(torch.isfinite(k).all()),
          f"dense decode tc at {S}^3 disagrees with its plain version")
    del k, p
    ms = time_ms(lambda: dense_decode_tc_cuda(z, packed, S), 3)
    pms = time_ms(lambda: dense_decode_plain(fv, layers, S, "high"), 1, 0)
    log_decode_time("high", fv, z, packed, widths, S, ms, pms)
    del z, fv
    vol = torch.from_numpy(cloth_like_wnf(S)).to(dev)
    vol = (vol[None] + 0.02 * torch.rand(B, S, S, S, generator=gen).to(dev)
           ).contiguous()
    k0, k1 = ggm_taps(0.5)
    k = ggm_cuda(vol, k0, k1)
    p = ggm_plain(vol, 0.5)
    check(torch.equal(k, p), f"ggm at W={S} is not bit-equal to ggm_plain "
          f"(max abs err {float((k - p).abs().max()):.3e})")
    gms = time_ms(lambda: ggm_cuda(vol, k0, k1), 10)
    gpms = time_ms(lambda: ggm_plain(vol, 0.5), 2)
    r = (len(k0) - 1) // 2
    gbnd, gby = bound_ms(2 * vol.numel() * 4,
                         vol.numel() * (8 * (2 * r + 1) * 2 + 6), F32_FLOPS)
    log(f"large volume: ggm at W={S}: bit-equal to ggm_plain; kernel "
        f"{gms:.3f} ms, plain {gpms:.3f} ms, bound {gbnd:.4f} ms ({gby}), "
        f"{2 * vol.numel() * 4 / (gms * 1e-3) / 1e9:.0f} GB/s achieved")
    del vol, k, p

    # ---- the engines: masks on by default, the same without masks, and
    # device normals ----
    cfg = PipelineConfig()
    model = ConvImplicitWNFPipeline(cfg)
    seeded_init_(model, 0)
    rng = np.random.RandomState(0)
    x = rng.rand(B, N, 3).astype(np.float32)
    pos = (rng.rand(B, N, 3) - 0.5).astype(np.float32)
    live_head_(model, x, pos, dev)
    kw = dict(volume_size=S, gradient_sigma=0.5, iso_level=0.5, device=dev)
    engine = PredictEngine(cfg, model.state_dict(), return_volume=True, **kw)
    plain = PredictEngine(cfg, model.state_dict(), cube_masks=False, **kw)
    devnorm = PredictEngine(cfg, model.state_dict(), device_normals=True,
                            **kw)
    check(engine.cube_masks and devnorm.cube_masks
          and not plain.cube_masks and not engine.device_normals,
          f"straddle masks are not on by default at {S}^3")
    cloth = torch.from_numpy(cloth_batch(S)).to(dev)
    pages = {}
    for key, eng in (("masked", engine), ("plain", plain)):
        base, vals, counts = extract_active_bricks(
            cloth, 0.5, eng.brick_cap, with_masks=eng.cube_masks)
        pages[key] = pack_brick_pages(base, vals, eng.brick_page,
                                      counts=counts)
    cloth_counts = counts.cpu().numpy()
    check(int(cloth_counts.max()) <= engine.brick_cap,
          f"the cloth fields overflow the brick cap: {cloth_counts}")
    page_mb = sum(pg.numel() for pg in pages["masked"]) / 1e6
    log(f"large volume: cloth fields {cloth_counts.tolist()} shipped bricks "
        f"(cap {engine.brick_cap}, {len(pages['masked'])} pages of "
        f"{engine.brick_page} records, {page_mb:.2f} MB of 76-byte "
        f"records a batch)")

    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    stages = {k: [] for k in ("encode", "mc_masks", "mc_plain", "mc_devnorm",
                              "warp", "warp_devnorm")}
    overflows, real_counts = 0, []
    for i in range(LARGE_BATCHES):
        t0 = time.perf_counter()
        enc = engine.encode(x, pos)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        counts = read_page_counts(enc["active_pages"][0].cpu().numpy())
        real_counts.append(counts.tolist())
        overflows += int(counts.max() > engine.brick_cap)
        # host MC and the warp run on the cloth fields, the warp's
        # features and ggm are the network's
        sub = dict(enc, active_pages=pages["masked"], wnf_volume=cloth)
        m_masked = engine.extract_meshes(sub)
        t2 = time.perf_counter()
        m_plain = plain.extract_meshes(dict(enc, active_pages=pages["plain"]))
        t3 = time.perf_counter()
        w_host = engine.warp_batch(sub, m_masked)
        t4 = time.perf_counter()
        m_dn = devnorm.extract_meshes(sub)
        t5 = time.perf_counter()
        w_dn = devnorm.warp_batch(sub, m_dn)
        t6 = time.perf_counter()
        if i > 0:
            for key, dt in (("encode", t1 - t0), ("mc_masks", t2 - t1),
                            ("mc_plain", t3 - t2), ("warp", t4 - t3),
                            ("mc_devnorm", t5 - t4),
                            ("warp_devnorm", t6 - t5)):
                stages[key].append(dt * 1e3)
    launches = dict(_build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n = LARGE_BATCHES
    log(f"large volume launches over {n} batches: {launches}")
    check(launches == {"fps": 2 * n, "sa_tc": 2 * n, "dense_decode_tc": n,
                       "ggm": n},
          f"unexpected launch counts at {S}^3: {launches}")

    # ---- (b) the masks ----
    wnf0 = enc["wnf_volume"][:1]
    card = [t.cpu() for t in extract_active_bricks(
        wnf0, 0.5, engine.brick_cap, with_masks=True)]
    cpu = extract_active_bricks(wnf0.cpu(), 0.5, engine.brick_cap,
                                with_masks=True)
    check(all(torch.equal(a, b) for a, b in zip(card, cpu)),
          "the card's masked bricks differ from the CPU's")
    check(int(cpu[2][0]) == counts[0] > 0,
          f"garment 0: {counts[0]} shipped bricks, the CPU {int(cpu[2][0])}")
    for b, (mm, mp) in enumerate(zip(m_masked, m_plain)):
        check(mm is not None and len(mm) == len(mp) == 4
              and all(np.array_equal(a, c) for a, c in zip(mm, mp)),
              f"garment {b}: masked host MC differs from unmasked")
    log(f"large volume: masked bricks of garment 0 ({counts[0]} shipped, "
        f"72-byte payloads) byte-equal to the CPU's; masked host MC "
        f"identical to unmasked on all {B} garments")

    # ---- (c) device normals ----
    shares, worst, means, p95s = [], 0, [], []
    cloth_np = cloth.cpu()
    for b in range(B):
        mh, md, wd = m_masked[b], m_dn[b], w_dn[b]
        check(md[3] is None and np.array_equal(md[0], mh[0])
              and np.array_equal(md[1], mh[1]),
              f"garment {b}: device-normal meshes differ")
        q = torch.from_numpy(md[0].astype(np.float16).astype(np.float32))
        on_card = sample_gradient_normals_oct(
            cloth[b:b + 1], q[None].to(dev), True)[0].cpu().numpy()
        on_cpu = sample_gradient_normals_oct(
            cloth_np[b:b + 1], q[None], True)[0].numpy()
        share, diff = code_agreement(on_card, on_cpu)
        shares.append(share)
        worst = max(worst, diff)
        check(np.array_equal(wd["normals"], oct_decode_np(on_card)),
              f"garment {b}: the warp lane's normals are not its codes'")
        ang = angles_deg(wd["normals"], mh[3])
        means.append(float(ang.mean()))
        p95s.append(float(np.percentile(ang, 95)))
    log(f"large volume: device normals: the same verts as host normals on "
        f"all {B} garments; codes equal to the CPU's at "
        f"{min(shares) * 100:.4f}% of vertices or more (limit 99.9), "
        f"at most {worst} count per byte elsewhere (limit 1); angle to the "
        f"host normals mean {max(means):.3f} deg at most (limit "
        f"{NORMAL_MEAN_DEG}), p95 {max(p95s):.3f} (limit {NORMAL_P95_DEG})")
    check(min(shares) >= 0.999 and worst <= 1,
          "device-normal codes disagree with the CPU's")
    check(max(means) < NORMAL_MEAN_DEG and max(p95s) < NORMAL_P95_DEG,
          "device normals disagree with the host normals")

    # ---- (d) stage times ----
    wnf = enc["wnf_volume"]

    def bricks(masks=True):
        base, vals, c = extract_active_bricks(wnf, 0.5, engine.brick_cap,
                                              with_masks=masks)
        return pack_brick_pages(base, vals, engine.brick_page, counts=c)

    # the device normals' sampling alone, at the warp's padded queries
    vmax = max(len(m[0]) for m in m_dn)
    qb = np.zeros((B, vmax, 3), np.float16)
    for b, m in enumerate(m_dn):
        qb[b, :len(m[0])] = m[0]
    qb = torch.from_numpy(qb).to(dev).float()
    wnf_cloth = sub["wnf_volume"]
    normals_ms = time_ms(
        lambda: sample_gradient_normals_oct(wnf_cloth, qb, True), 5)
    codes = sample_gradient_normals_oct(wnf_cloth, qb, True).float().cpu()
    t0 = time.perf_counter()
    for b, m in enumerate(m_dn):
        oct_decode_np(codes[b, :len(m[0])].numpy())
    decode_host_ms = (time.perf_counter() - t0) * 1e3

    dec_ms = time_ms(lambda: engine._decode(enc["feature_volume"]), 3)
    ggm_ms = time_ms(lambda: gaussian_gradient_magnitude(wnf, 0.5), 5)
    brick_ms = time_ms(bricks, 5)
    brick_plain_ms = time_ms(lambda: bricks(False), 5)
    copy_ms = time_ms(lambda: engine.prefetch(enc), 5)
    t0 = time.perf_counter()
    for _ in range(5):
        engine.prefetch(enc)
        engine.host_outputs(enc)
    copy_host_ms = (time.perf_counter() - t0) * 1e3 / 5
    copy_mb = sum(pg.numel() for pg in enc["active_pages"]) / 1e6
    med = {k: statistics.median(v) for k, v in stages.items()}
    per_batch = "; ".join(f"{k} " + ", ".join(f"{t:.1f}" for t in v)
                          for k, v in stages.items())
    seq = med["encode"] + med["mc_masks"] + med["warp"]
    seq_dn = med["encode"] + med["mc_devnorm"] + med["warp_devnorm"]
    log(f"large volume on {name}: B={B}, N={N}, {S}^3, decode 'high', "
        f"{n - 1} timed batches, stages in sequence; median ms a batch: "
        f"encode {med['encode']:.1f} (device: decode {dec_ms:.1f}, ggm "
        f"{ggm_ms:.3f}, bricks and pages with masks {brick_ms:.2f}, "
        f"without {brick_plain_ms:.2f}, the rest "
        f"{med['encode'] - dec_ms - ggm_ms - brick_ms:.1f}); host MC "
        f"with masks {med['mc_masks']:.1f}, without {med['mc_plain']:.1f}, "
        f"with masks and device normals {med['mc_devnorm']:.1f}; warp "
        f"{med['warp']:.1f}, with device normals "
        f"{med['warp_devnorm']:.1f} (their sampling {normals_ms:.3f} on the "
        f"device, the host decode of {sum(len(m[0]) for m in m_dn)} codes "
        f"{decode_host_ms:.1f})")
    log(f"large volume: {B * 1e3 / seq:.3f} garments/s with host normals, "
        f"{B * 1e3 / seq_dn:.3f} with device normals (encode + host MC + "
        f"warp in sequence); the prefetch copies {copy_mb:.2f} MB of pages "
        f"a batch in {copy_ms:.3f} ms on the device, {copy_host_ms:.2f} ms "
        f"on the host clock with its pinned buffers and wait "
        f"({copy_host_ms / med['encode'] * 100:.1f}% of the encode); peak "
        f"memory {peak_gib:.3f} GiB; brick-cap overflows {overflows} of "
        f"{n} batches (shipped bricks of the network's WNF {real_counts}, "
        f"cap {engine.brick_cap})")
    log(f"large volume ms of each timed batch: {per_batch}")
    for eng in (engine, plain, devnorm):
        eng.close()
    del enc, sub, wnf, cloth, wnf0

    # ---- (e) the predict CLI at 256^3 with device normals ----
    ckpt = tmp / "large.ckpt"
    zarr = tmp / "variants.zarr"
    cli_cfg = load_config("predict_default", [
        f"main.checkpoint_path={ckpt}", f"datamodule.zarr_path={zarr}",
        f"datamodule.batch_size={B}", f"datamodule.num_pc_sample={N}",
        "datamodule.volume_size=16", "datamodule.dataset_split=[0,0,1]",
        f"prediction.volume_size={S}", "prediction.device_normals=true",
        f"prediction.device={dev}"])
    dm = ConvImplicitWNFDataModule(**cli_cfg["datamodule"])
    dm.prepare_data()
    check(len(dm.test_idxs) == B, f"{len(dm.test_idxs)} garments")
    first = next(iter(dm.test_dataloader()))
    model = ConvImplicitWNFPipeline(cfg)
    seeded_init_(model, 7)
    live_head_(model, first["x"], first["pos"], dev)
    save_pipeline_checkpoint(ckpt, cfg, model.state_dict())
    del model
    warps = []
    collect = PredictEngine.warp_collect

    def spy(self, handle):
        out = collect(self, handle)
        warps.extend(w for w in out if w is not None)
        return out

    _build.reset_launch_counts()
    PredictEngine.warp_collect = spy
    try:
        run = predict.main(cli_cfg, run_dir=str(tmp / "run_large"))
    finally:
        PredictEngine.warp_collect = collect
    cli_launches = dict(_build.LAUNCHES)
    check(cli_launches == {"fps": 2, "sa_tc": 2, "dense_decode_tc": 1,
                           "ggm": 1},
          f"unexpected launch counts in the {S}^3 CLI: {cli_launches}")
    summary = json.loads((run / "summary.json").read_text())
    rec = json.loads((run / "metrics.jsonl").read_text().splitlines()[0])
    groups = list(zarrlite.open(str(run / "prediction.zarr"),
                                "r")["samples"].groups())
    check(len(groups) == B == len(warps), f"{len(groups)} groups written")
    n_verts = []
    for key, g in groups:
        mc = g["marching_cubes_mesh"]
        verts, normals = mc["verts"][:], mc["normals"][:]
        check(len(verts) > 1 and normals.shape == verts.shape
              and np.abs(np.linalg.norm(normals, axis=-1) - 1).max() < 1e-5,
              f"{key}: normals not unit length")
        check(any(np.array_equal(normals, w["normals"]) for w in warps),
              f"{key}: the written normals are not a warp's")
        n_verts.append(len(verts))
    log(f"large volume: predict CLI at {S}^3 with device normals on "
        f"{name}: {summary['garments_per_sec']:.3f} garments/s ({B} "
        f"garments in {summary['elapsed_sec']:.3f} s, one batch); writer "
        f"{rec['writer_ms']:.1f} ms, encode {rec['encode_ms']:.1f}, host MC "
        f"{rec['host_mc_ms']:.1f}; verts per garment "
        f"{min(n_verts)}-{max(n_verts)}; normals unit length and the "
        f"warp's")

    # ---- (f) ResidualUNet3D, card against CPU ----
    torch.manual_seed(11)
    unet = ResidualUNet3D(cfg.unet_in_channels, cfg.unet_out_channels,
                          f_maps=32, num_groups=8, num_levels=5)
    seeded_init_(unet, 11)
    xin = torch.rand(2, 32, 32, 32, cfg.unet_in_channels, generator=gen)
    with torch.no_grad(), full_f32():
        want = unet.eval()(xin)
        got = unet.to(dev)(xin.to(dev)).cpu()
    uerr = float((got - want).abs().max())
    scale = float(want.abs().max())
    log(f"large volume: ResidualUNet3D (f_maps 32, 5 levels, "
        f"{cfg.unet_in_channels}->{cfg.unet_out_channels}) on [2, 32^3]: "
        f"card against CPU max abs err {uerr:.3e} on outputs up to "
        f"{scale:.3f} (limit 1e-4 of max(1, that))")
    check(uerr <= 1e-4 * max(1.0, scale) and bool(torch.isfinite(got).all()),
          "ResidualUNet3D on the card disagrees with the CPU")
    log(f"large volume phase: {time.perf_counter() - t_phase:.1f} s")
    return {"large": launches, "large_cli": cli_launches}


def small_cfg():
    """A tiny pipeline configuration for checks of the card against the
    CPU."""
    from garmentnets_tpu_torch.models.pipeline import PipelineConfig
    from garmentnets_tpu_torch.models.pointnet2_nocs import (
        PointNet2NOCSConfig)
    return PipelineConfig(
        pointnet2=PointNet2NOCSConfig(nocs_bins=8, sa1_r=0.2, sa2_r=0.4),
        volume_agg_nn_channels=(137, 64, 32), grid_shape=(16, 16, 16),
        unet_in_channels=32, unet_out_channels=32, unet_f_maps=8,
        unet_num_levels=2, unet_num_groups=4,
        volume_decoder_channels=(32, 16, 1),
        surface_decoder_channels=(32, 16, 3))


def phase_small_reference(dev) -> None:
    """A tiny engine on the card against the same engine on the CPU, at
    the decode tiers 'highest' and 'high'. The seed gives a WNF that varies
    and crosses the iso level, so the WNF and ggm comparisons compare
    something."""
    import torch
    from garmentnets_tpu_torch.core.random_weights import seeded_init_
    from garmentnets_tpu_torch.harness.predict_engine import PredictEngine
    from garmentnets_tpu_torch.models.pipeline import ConvImplicitWNFPipeline
    cfg = small_cfg()
    model = ConvImplicitWNFPipeline(cfg)
    seeded_init_(model, 4)
    rng = np.random.RandomState(4)
    x = rng.rand(2, 256, 3).astype(np.float32)
    pos = (rng.rand(2, 256, 3) - 0.5).astype(np.float32)
    for tier in ("highest", "high"):
        out = {}
        for d in (dev, "cpu"):
            eng = PredictEngine(cfg, model.state_dict(), volume_size=32,
                                return_volume=True, decode_precision=tier,
                                mc_threads=1, device=d)
            out[str(d)] = {k: v.cpu() for k, v in eng.encode(x, pos).items()
                           if torch.is_tensor(v)}
            eng.close()
        g, c = out[str(dev)], out["cpu"]
        wnf_std = float(c["wnf_volume"].std())
        check(wnf_std >= 1e-2 and float(c["wnf_ggm"].abs().max()) > 0,
              f"small-input WNF is flat (std {wnf_std:.2e}): compares "
              "nothing")
        same_nocs = bool(torch.equal(g["pred_nocs"], c["pred_nocs"]))
        errs = {k: float((g[k] - c[k]).abs().max())
                for k in ("feature_volume", "wnf_volume", "wnf_ggm")}
        log(f"small input at '{tier}', card vs CPU: NOCS bins identical "
            f"{same_nocs}, WNF std {wnf_std:.3e}, shipped bricks "
            f"{c['active_counts'].tolist()}, max abs err {errs}")
        check(same_nocs, "NOCS bins differ between card and CPU")
        check(all(e <= 1e-3 for e in errs.values()),
              f"card and CPU paths disagree on a small input at '{tier}'")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
# the predict CLI's 8 instances x 4 grips, split for training: 24 train
# garments (3 stage-1 batches of 8, one stage-2 batch of 24), 4 val, 4 test
TRAIN_SPLIT = [6, 1, 1]
S1_EPOCHS, S1_BATCHES, S2_EPOCHS = 2, 3, 4
LEARN_STEPS, WARM_STEPS, TIMED_STEPS = 20, 3, 5
# per tensor: the bar relative to its largest entry (stage 1 on the card
# against the CPU; stage 2, whose frozen stage 1 runs the bf16x3 SA kernel
# on the card), or SPREAD_FACTOR times the CPU's own change when the
# weights or the input colours are jittered by 1e-6 relative
TRAIN_REL = {1: 1e-4, 2: 1e-3}
SPREAD_FACTOR = 10


def train_cfg(stage: int, dropout: bool = False):
    """Stage 1's or the pipeline's configuration for the card-vs-CPU
    step: small_cfg(), dropout off (the card's and the CPU's random
    streams differ)."""
    import dataclasses
    cfg = small_cfg()
    cfg = dataclasses.replace(cfg, pointnet2=dataclasses.replace(
        cfg.pointnet2, dropout=dropout))
    return cfg.pointnet2 if stage == 1 else cfg


def train_batch(stage: int, seed: int = 7, B: int = 2, N: int = 256,
                M: int = 300) -> dict:
    """A seeded numpy batch of the small configuration."""
    rng = np.random.RandomState(seed)
    b = {"x": rng.rand(B, N, 3), "pos": rng.rand(B, N, 3) - 0.5,
         "y": rng.rand(B, N, 3), "nocs_grip_point": rng.rand(B, 3)}
    if stage == 2:
        b.update(volume_query_points=rng.rand(B, M, 3),
                 gt_volume_value=rng.rand(B, M),
                 surf_query_points=rng.rand(B, M, 3),
                 gt_sim_points=rng.randn(B, M, 3))
    return {k: v.astype(np.float32) for k, v in b.items()}


def train_step_once(dev, stage: int, batch: dict, jitter_seed=None):
    """One train step (make_train_fns, Adam) of `stage` at train_cfg()
    with seeded_init_ weights, optionally jittered by (1 + 1e-6 N(0, 1)),
    on `dev` -> (loss, {name: gradient}, {name: running statistic},
    stage 2's NOCS bins or None), all on the CPU."""
    import torch
    from garmentnets_tpu_torch.core.random_weights import seeded_init_
    from garmentnets_tpu_torch.harness.training import (
        batch_to_device, make_adam, make_train_fns)
    from garmentnets_tpu_torch.models import pipeline, pointnet2_nocs
    cfg = train_cfg(stage)
    if stage == 1:
        model = pointnet2_nocs.PointNet2NOCS(cfg)

        def apply_fn(b, gen):
            return model(b["x"], b["pos"], generator=gen)

        def loss_fn(out, b):
            return pointnet2_nocs.get_metrics(cfg, out, b)[0]
    else:
        model = pipeline.ConvImplicitWNFPipeline(cfg)

        def apply_fn(b, gen):
            return model(b)

        def loss_fn(out, b):
            return pipeline.pipeline_loss(cfg, out, b)
    seeded_init_(model, 8)
    if jitter_seed is not None:
        gen = torch.Generator().manual_seed(jitter_seed)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + 1e-6 * torch.randn(p.shape, generator=gen))
    if stage == 2:
        model.pointnet2_nocs.requires_grad_(False)
    model.to(dev)
    train_step, _ = make_train_fns(model, apply_fn, loss_fn,
                                   make_adam(model, 1e-3))
    b = batch_to_device(batch, dev)
    bins = None
    if stage == 2:
        with torch.no_grad():
            bins = model.pointnet2_forward(
                b["x"], b["pos"])["nocs_data"]["pos"].cpu()
    loss = float(train_step(b)["loss"])
    grads = {n: p.grad.cpu() for n, p in model.named_parameters()
             if p.grad is not None}
    stats = {n: t.cpu() for n, t in model.named_buffers()
             if "running" in n}
    return loss, grads, stats, bins


def step_ratios(card, cpu, moved, rel: float) -> tuple:
    """A train step on the card against the CPU's: card, cpu and each of
    `moved` (the CPU's step under a 1e-6 jitter of the weights or of the
    input colours; may be empty) are (loss, {name: gradient}, {name:
    running statistic}, ...). A tensor's bar is `rel` of its largest
    entry, or SPREAD_FACTOR times the most the moved steps changed it,
    whichever is larger; the loss's alike. Returns (the worst error / bar,
    what it is, how many tensors' bars the spread set, how many
    tensors)."""
    ratios, n_spread = [], 0
    for i, what in ((1, "gradient"), (2, "statistic")):
        check(sorted(card[i]) == sorted(cpu[i]),
              f"{what} names differ between the card and the CPU")
        for name, ref in cpu[i].items():
            floor = rel * float(ref.abs().max())
            spread = SPREAD_FACTOR * max(
                (float((m[i][name] - ref).abs().max()) for m in moved),
                default=0.0)
            n_spread += spread > floor
            bar = max(floor, spread)
            err = float((card[i][name] - ref).abs().max())
            ratios.append((err / bar if bar > 0 else float(err > 0),
                           f"{what} {name}"))
    n_bars = len(ratios)
    spread = max((abs(m[0] - cpu[0]) for m in moved), default=0.0)
    bar = max(rel * abs(cpu[0]), SPREAD_FACTOR * spread)
    ratios.append((abs(card[0] - cpu[0]) / bar, "loss"))
    ratio, name = max(ratios)
    return ratio, name, n_spread, n_bars


def jittered_colours(batch: dict, seed: int = 4) -> dict:
    """`batch` with its input colours times (1 + 1e-6 N(0, 1))."""
    x = batch["x"] * (1 + 1e-6 * np.random.RandomState(seed).randn(
        *batch["x"].shape))
    return dict(batch, x=x.astype(np.float32))


def phase_train_reference(dev) -> dict:
    """One train step of each stage at the small configuration on the
    card and on the CPU, from the same seeded state and batch: the loss,
    every gradient and every running statistic within its bar (TRAIN_REL
    of the tensor's largest entry, or SPREAD_FACTOR times the CPU's own
    change under a 1e-6 jitter of the weights or of the input colours);
    stage 2's NOCS bins identical. Returns the worst ratio of error to bar
    per stage."""
    import torch
    worst = {}
    for stage in (1, 2):
        batch = train_batch(stage)
        card = train_step_once(dev, stage, batch)
        cpu = train_step_once("cpu", stage, batch)
        moved = [train_step_once("cpu", stage, batch, jitter_seed=3),
                 train_step_once("cpu", stage, jittered_colours(batch))]
        ratio, name, n_spread, n_bars = step_ratios(card, cpu, moved,
                                                    TRAIN_REL[stage])
        log(f"train step card vs CPU, stage {stage}: loss {card[0]:.6f} vs "
            f"{cpu[0]:.6f}; worst error/bar {ratio:.3f} ({name}); "
            f"{n_spread} of {n_bars} bars set by the CPU's jitter spread")
        if stage == 2:
            check(torch.equal(card[3], cpu[3]),
                  "stage-2 NOCS bins differ between card and CPU")
        check(ratio <= 1.0, f"stage {stage} train step: card and CPU "
              f"disagree ({name}: {ratio:.3f} of its bar)")
        worst[stage] = ratio
    return worst


def run_summary(run: pathlib.Path) -> tuple:
    """(metrics.jsonl records, summary.json) of a train run."""
    recs = [json.loads(x) for x in
            (run / "metrics.jsonl").read_text().splitlines()]
    return recs, json.loads((run / "summary.json").read_text())


def timed_steps(dev, model, loss_fn, apply_fn, batch: dict, steps: int,
                timed: tuple) -> dict:
    """`steps` train steps of `model` on one batch (uploaded once), the
    steps in range(*timed) between two CUDA events; the launches of step
    timed[1] (which must be < steps) and of one eval step; the peak device
    memory over the steps."""
    import torch
    from garmentnets_tpu_torch.harness.training import (
        batch_to_device, make_adam, make_train_fns)
    from garmentnets_tpu_torch.kernels import _build
    opt = make_adam(model, 1e-4)
    train_step, eval_step = make_train_fns(model, apply_fn, loss_fn, opt)
    b = batch_to_device(batch, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(steps):
        if i == timed[0]:
            start.record()
        if i == timed[1]:
            end.record()
            _build.reset_launch_counts()
        losses.append(train_step(b, gen)["loss"])
        if i == timed[1]:
            step_launches = dict(_build.LAUNCHES)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    _build.reset_launch_counts()
    eval_step(b)
    torch.cuda.synchronize()
    return {"ms": start.elapsed_time(end) / (timed[1] - timed[0]),
            "losses": [float(x) for x in losses], "peak": peak,
            "step": step_launches, "eval": dict(_build.LAUNCHES)}


def phase_train(dev, tmp: pathlib.Path) -> dict:
    """Both training stages on the card at the shipped configurations
    (configs/train_*_default.yaml; stage 1 at B=8, 6000 points, 64 bins,
    feature 128, dropout on; stage 2 at B=24, 6000 volume and surface
    queries, 32^3 'gcr' U-Net f_maps 32, 4 levels) on the predict CLI's
    synthetic dataset, split TRAIN_SPLIT:
      - the stage-1 CLI, S1_EPOCHS epochs of S1_BATCHES steps, with
        validation and vis; the stage-2 CLI from its last.ckpt, S2_EPOCHS
        epochs of one step; the predict CLI on one batch from stage 2's
        last.ckpt; launches of each counted exactly;
      - outside the CLIs, a fixed full-width batch per stage: ms per
        step over TIMED_STEPS steps after a warm-up (CUDA events),
        samples/s, peak memory, launches per train and eval step; stage 1
        over LEARN_STEPS steps must end below its first loss;
      - phase_train_reference: one step of each stage, card against CPU.
    Returns the launches of the three CLI runs."""
    import torch
    from garmentnets_tpu_torch.core.config import load_config
    from garmentnets_tpu_torch.core.random_weights import init_like_jax_
    from garmentnets_tpu_torch.data.dataset import ConvImplicitWNFDataModule
    from garmentnets_tpu_torch.harness import (
        predict, train_pipeline, train_pointnet2)
    from garmentnets_tpu_torch.kernels import _build
    from garmentnets_tpu_torch.models import pipeline, pointnet2_nocs

    t_phase = time.perf_counter()
    gpu = torch.cuda.get_device_name(0)
    common = [f"datamodule.zarr_path={tmp / 'data.zarr'}",
              f"datamodule.dataset_split={TRAIN_SPLIT}",
              "datamodule.volume_size=32", f"trainer.device={dev}",
              # one process on the named card: its launches are counted
              # here
              "trainer.num_devices=1"]
    cfg1 = load_config("train_pointnet2_default", common + [
        f"trainer.max_epochs={S1_EPOCHS}",
        f"trainer.limit_train_batches={S1_BATCHES}"])
    m1 = cfg1["model"]
    check((cfg1["datamodule"]["batch_size"], cfg1["datamodule"][
        "num_pc_sample"], m1["nocs_bins"], m1["feature_dim"],
        m1["dropout"]) == (B, N, 64, 128, True),
        "the shipped stage-1 configuration changed")
    dm1 = ConvImplicitWNFDataModule(**cfg1["datamodule"])
    dm1.prepare_data()
    n_val = len(dm1.val_dataloader())
    check(len(dm1.train_dataloader()) >= S1_BATCHES and n_val >= 1,
          f"train split: {len(dm1.train_idxs)} train, "
          f"{len(dm1.val_idxs)} val garments")
    launches = {}

    def run_cli(main, cfg, name):
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        run = main(cfg, run_dir=str(tmp / name))
        torch.cuda.synchronize()
        launches[name] = dict(_build.LAUNCHES)
        return run, time.perf_counter() - t0

    # ---- stage-1 CLI: each train step FPS x2 (training SA: stock ops);
    # each val batch and each epoch's vis forward FPS x2 and SA x2 ----
    run1, wall1 = run_cli(train_pointnet2.main, cfg1, "train_s1")
    evals1 = S1_EPOCHS * (n_val + 1)
    want = {"fps": 2 * (S1_EPOCHS * S1_BATCHES + evals1),
            "sa_tc": 2 * evals1, "dense_decode_tc": 0, "ggm": 0}
    check(launches["train_s1"] == want,
          f"stage-1 CLI launches {launches['train_s1']}, expected {want}")
    recs, summary = run_summary(run1)
    losses1 = [r["train_loss"] for r in recs if "train_loss" in r]
    epochs1 = [r for r in recs if "epoch" in r]
    check(len(losses1) == S1_EPOCHS * S1_BATCHES
          and all(np.isfinite(losses1)), f"stage-1 losses {losses1}")
    check(len(list((run1 / "media").glob("val_*.png"))) >= S1_EPOCHS
          and (run1 / "checkpoints/last.ckpt").exists()
          and len(list((run1 / "checkpoints").glob("epoch=*"))) == S1_EPOCHS,
          "stage-1 CLI outputs")
    log(f"train stage-1 CLI ({gpu}): {len(losses1)} steps at B={B}, "
        f"N={N} over {S1_EPOCHS} epochs in {wall1:.1f} s; train loss "
        f"{losses1[0]:.4f} -> {losses1[-1]:.4f}; val_loss "
        f"{[round(r['val_loss'], 4) for r in epochs1]}; epoch_sec "
        f"{[round(r['epoch_sec'], 3) for r in epochs1]}; step waited on "
        f"the loader {[round(w, 3) for w in summary['loader_wait_sec']]} "
        f"s an epoch; launches {launches['train_s1']}")

    # ---- stage-2 CLI from stage 1's last.ckpt: each step, val batch and
    # vis forward runs the frozen stage 1 in eval mode: FPS x2, SA x2 ----
    cfg2 = load_config("train_pipeline_default", common + [
        f"pointnet2_model.checkpoint_path={run1 / 'checkpoints/last.ckpt'}",
        f"trainer.max_epochs={S2_EPOCHS}"])
    c2, dm2cfg = cfg2["conv_implicit_model"], cfg2["datamodule"]
    check((dm2cfg["batch_size"], dm2cfg["num_volume_sample"],
           dm2cfg["num_surface_sample"], c2["unet3d_params"]["f_maps"],
           c2["unet3d_params"]["num_levels"],
           c2["volume_agg_params"]["grid_shape"]) == (
               24, 6000, 6000, 32, 4, [32, 32, 32]),
          "the shipped stage-2 configuration changed")
    run2, wall2 = run_cli(train_pipeline.main, cfg2, "train_s2")
    steps2 = S2_EPOCHS * (len(dm1.train_idxs) // dm2cfg["batch_size"])
    n_val2 = -(-len(dm1.val_idxs) // dm2cfg["batch_size"])
    per = steps2 + S2_EPOCHS * (n_val2 + 1)
    want = {"fps": 2 * per, "sa_tc": 2 * per, "dense_decode_tc": 0,
            "ggm": 0}
    check(steps2 >= 4 and launches["train_s2"] == want,
          f"stage-2 CLI launches {launches['train_s2']}, expected {want}")
    recs, summary = run_summary(run2)
    losses2 = [r["train_loss"] for r in recs if "train_loss" in r]
    epochs2 = [r for r in recs if "epoch" in r]
    check(len(losses2) == steps2 and all(np.isfinite(losses2)),
          f"stage-2 losses {losses2}")
    log(f"train stage-2 CLI ({gpu}): {steps2} steps at B="
        f"{dm2cfg['batch_size']} over {S2_EPOCHS} epochs in {wall2:.1f} s; "
        f"train loss {[round(x, 4) for x in losses2]}; epoch_sec "
        f"{[round(r['epoch_sec'], 3) for r in epochs2]}; step waited on the "
        f"loader {[round(w, 3) for w in summary['loader_wait_sec']]} s an "
        f"epoch; launches {launches['train_s2']}")

    # ---- the predict CLI on stage 2's last.ckpt, one batch ----
    cfg = load_config("predict_default", [
        f"main.checkpoint_path={run2 / 'checkpoints/last.ckpt'}",
        f"datamodule.zarr_path={tmp / 'data.zarr'}",
        f"datamodule.batch_size={B}", f"datamodule.num_pc_sample={N}",
        "datamodule.volume_size=32", f"datamodule.dataset_split={TRAIN_SPLIT}",
        f"prediction.volume_size={VOL}", f"prediction.device={dev}"])
    run3, wall3 = run_cli(predict.main, cfg, "train_predict")
    check(launches["train_predict"] == {"fps": 2, "sa_tc": 2,
                                        "dense_decode_tc": 1, "ggm": 1},
          f"predict launches {launches['train_predict']}")
    pred = json.loads((run3 / "summary.json").read_text())
    check(pred["garments"] == len(dm1.test_idxs), "predict garments")
    log(f"predict CLI on the trained stage-2 checkpoint: "
        f"{pred['garments']} garments in {wall3:.1f} s")

    # ---- a fixed full-width batch per stage, outside the CLIs ----
    batch1 = next(iter(dm1.train_dataloader()))
    cfg_m1 = pointnet2_nocs.PointNet2NOCSConfig()
    model1 = pointnet2_nocs.PointNet2NOCS(cfg_m1)
    init_like_jax_(model1, torch.Generator().manual_seed(0))
    t1 = timed_steps(
        dev, model1.to(dev),
        lambda o, b: pointnet2_nocs.get_metrics(cfg_m1, o, b)[0],
        lambda b, g: model1(b["x"], b["pos"], generator=g), batch1,
        LEARN_STEPS, (WARM_STEPS, WARM_STEPS + TIMED_STEPS))
    check(t1["step"] == {"fps": 2, "sa_tc": 0, "dense_decode_tc": 0,
                         "ggm": 0}, f"stage-1 train step launches {t1}")
    check(t1["eval"] == {"fps": 2, "sa_tc": 2, "dense_decode_tc": 0,
                         "ggm": 0}, f"stage-1 eval step launches {t1}")
    check(t1["losses"][-1] < t1["losses"][0],
          f"stage 1 does not learn one batch: {t1['losses']}")
    del model1
    dm2 = ConvImplicitWNFDataModule(**dm2cfg)
    dm2.prepare_data()
    batch2 = next(iter(dm2.train_dataloader()))
    cfg_m2 = pipeline.PipelineConfig()
    model2 = pipeline.ConvImplicitWNFPipeline(cfg_m2)
    init_like_jax_(model2, torch.Generator().manual_seed(0))
    model2.pointnet2_nocs.requires_grad_(False)
    t2 = timed_steps(
        dev, model2.to(dev),
        lambda o, b: pipeline.pipeline_loss(cfg_m2, o, b),
        lambda b, g: model2(b), batch2, WARM_STEPS + TIMED_STEPS + 1,
        (WARM_STEPS, WARM_STEPS + TIMED_STEPS))
    check(t2["step"] == {"fps": 2, "sa_tc": 2, "dense_decode_tc": 0,
                         "ggm": 0}, f"stage-2 train step launches {t2}")
    del model2
    for stage, t, b in ((1, t1, batch1), (2, t2, batch2)):
        n = len(b["x"])
        log(f"train stage {stage} on {gpu}, a fixed batch of {n}: "
            f"{t['ms']:.3f} ms a step ({n / t['ms'] * 1e3:.2f} samples/s), "
            f"peak device memory {t['peak'] / 2 ** 30:.3f} GiB; launches a "
            f"train step {t['step']}, an eval step {t['eval']}")
    log(f"stage 1 on one batch over {LEARN_STEPS} steps: loss "
        f"{t1['losses'][0]:.4f} -> {t1['losses'][-1]:.4f}")

    worst = phase_train_reference(dev)
    log(f"train phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "reference": worst,
            "ms": {1: t1["ms"], 2: t2["ms"]}}


# ---------------------------------------------------------------------------
# the acceptance run: a trained model end to end
# ---------------------------------------------------------------------------
E2E_INSTANCES = 4          # x 3 grips: the JAX tool's default data
E2E_STEPS = (400, 400)     # steps of stage 1 and stage 2 (the JAX tool's)
E2E_LAST = 20              # a stage's last steps, averaged for its check
WN_STRIDE = 64             # every 64th lattice point: 32768 of 128^3
WN_LIMIT = 1e-4            # the card's f32 winding number against f64
TIERS = ("default", "high", "highest")


def plain_kernels(sa: bool, decode: bool):
    """Inside the block, the engine's set abstraction (sa) and dense
    decode (decode) run their plain f32 versions on the card in place of
    the kernels: the f32 reference of the precision study."""
    import contextlib

    from garmentnets_tpu_torch.harness import predict_engine
    from garmentnets_tpu_torch.models import pointnet2
    from garmentnets_tpu_torch.ops.dense_decode import dense_decode_plain
    from garmentnets_tpu_torch.ops.set_abstraction import sa_fused_plain

    def sa_plain(x, pos, centers, idx, mask, layers, packed=None):
        return sa_fused_plain(x, pos, centers, idx, mask, layers)

    def decode_plain(fv, layers, S, precision, packed=None):
        return dense_decode_plain(fv, layers, S, "highest")

    @contextlib.contextmanager
    def patched():
        saved = pointnet2.sa_fused, predict_engine.dense_decode
        if sa:
            pointnet2.sa_fused = sa_plain
        if decode:
            predict_engine.dense_decode = decode_plain
        try:
            yield
        finally:
            pointnet2.sa_fused, predict_engine.dense_decode = saved
    return patched()


def mesh_chamfer_vox(a, b, S: int) -> float:
    """Symmetric chamfer (mean of both directions' nearest-vertex
    distances) between two meshes' vertices, in voxels of an S^3 lattice."""
    from scipy.spatial import cKDTree
    va, vb = a[0] * (S - 1), b[0] * (S - 1)
    return float((cKDTree(vb).query(va)[0].mean()
                  + cKDTree(va).query(vb)[0].mean()) / 2)


def parse_ply(path: pathlib.Path) -> tuple:
    """(verts [V, 3], faces [F, 3]) of an ascii PLY triangle mesh."""
    import io
    header, body = path.read_text().split("end_header\n")
    n_v = int(header.split("element vertex ")[1].split()[0])
    n_f = int(header.split("element face ")[1].split()[0])
    rows = body.splitlines()
    check(len(rows) == n_v + n_f, f"{path.name}: {len(rows)} rows")
    verts = np.loadtxt(io.StringIO("\n".join(rows[:n_v])), ndmin=2)
    faces = np.loadtxt(io.StringIO("\n".join(rows[n_v:])), dtype=np.int64,
                       ndmin=2)
    check(verts.shape == (n_v, 3) and faces.shape == (n_f, 4)
          and (faces[:, 0] == 3).all(), f"{path.name}: malformed")
    return verts, faces[:, 1:]


def e2e_winding_number(dev) -> None:
    """The 128^3 lattice of the generator's first instance (mesh_res 24)
    on the card's f32 path against the f64 numpy path at every
    WN_STRIDE-th lattice point."""
    import torch
    from garmentnets_tpu_torch.data.synthetic import make_cloth_mesh
    from garmentnets_tpu_torch.ops import geometry

    verts, faces = make_cloth_mesh(24, np.random.RandomState(0))
    ax = np.linspace(0, 1, VOL, dtype=np.float32)
    q = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    sub = q[::WN_STRIDE]
    geometry.winding_number(sub[:4096], verts, faces, backend="torch",
                            device=dev)         # warm-up
    t0 = time.perf_counter()
    card = geometry.winding_number(q, verts, faces, backend="torch",
                                   device=dev)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = geometry.winding_number(sub, verts, faces, backend="numpy")
    t_np = time.perf_counter() - t0
    err = float(np.abs(card[::WN_STRIDE] - ref).max())
    log(f"e2e winding number at {VOL}^3 ({len(q)} queries x {len(faces)} "
        f"faces, {len(geometry.pad_faces(verts, faces))} padded): card "
        f"f32 {t_card:.3f} s for the lattice (host to host); numpy f64 "
        f"{t_np / len(sub) * 1e6:.3f} us a query on {len(sub)} of them "
        f"(so ~{t_np / len(sub) * len(q):.0f} s a lattice on one host "
        f"core); max abs err {err:.3e} (limit {WN_LIMIT}); field range "
        f"{ref.min():.3f}..{ref.max():.3f}")
    check(len(sub) >= 32768 and err <= WN_LIMIT and ref.max() > 0.9,
          f"card winding number err {err}")


def e2e_precision(dev, tmp: pathlib.Path, out: pathlib.Path) -> dict:
    """The trained stage 2 on the e2e dataset's garments (split [0,0,1]:
    static sampling, the same inputs every run), against its f32
    reference on the card (the plain SA and decode):
      - the decode at each tier, SA kernel (bf16x3) as the card runs it,
        against the plain f32 decode on the same features: WNF max abs
        error, lattice points whose side of 0.5 flips, MC vertices and
        faces, the meshes' symmetric chamfer in voxels;
      - the SA kernel against the plain f32 SA, decode plain f32: NOCS
        bin argmax agreement, the NOCS point error and its change, WNF
        error, flips and mesh chamfer;
      - the predict CLI and the eval CLI on every variant (without the
        logits and the hybrid chamfer, which the study does not read;
        each eval runs while the next variant predicts): the eval's
        canonical chamfer (chamfer_symmetrical_nocs), relative to its
        reference.
    Returns {variant: its row of the table}."""
    import torch
    from garmentnets_tpu_torch.core.checkpoint import (
        load_pipeline_checkpoint)
    from garmentnets_tpu_torch.core.config import load_config
    from garmentnets_tpu_torch.data.dataset import ConvImplicitWNFDataModule
    from garmentnets_tpu_torch.harness import predict
    from garmentnets_tpu_torch.harness.predict_engine import PredictEngine

    t_phase = time.perf_counter()
    ckpt = out / "s2.ckpt"
    pcfg = load_config("predict_default", [
        f"main.checkpoint_path={ckpt}",
        f"datamodule.zarr_path={out / 'dataset.zarr'}",
        f"datamodule.batch_size={B}", f"datamodule.num_pc_sample={N}",
        f"datamodule.volume_size={VOL}", f"datamodule.dataset_split={CLI_SPLIT}",
        f"prediction.volume_size={VOL}", f"prediction.device={dev}",
        "prediction.store_pred_nocs_logits=false"])
    dm = ConvImplicitWNFDataModule(**pcfg["datamodule"])
    dm.prepare_data()
    batches = list(dm.test_dataloader())
    n_garments = sum(len(b["x"]) for b in batches)
    cfg, state = load_pipeline_checkpoint(ckpt)
    # variant: (decode tier, plain SA, plain decode, its reference)
    variants = {"f32": ("highest", True, True, None),
                "sa_bf16x3": ("highest", False, True, "f32")}
    variants.update({t: (t, False, False, "sa_bf16x3") for t in TIERS})
    res = {}
    for name, (tier, sa, dec, _) in variants.items():
        engine = PredictEngine(cfg, state, volume_size=VOL,
                               decode_precision=tier, return_volume=True,
                               device=dev, num_points=N)
        wnfs, meshes, nocs, bins = [], [], [], []
        with plain_kernels(sa, dec):
            for b in batches:
                enc = engine.encode(b["x"], b["pos"])
                meshes += engine.extract_meshes(enc)
                wnfs.append(enc["wnf_volume"])
                nocs.append(enc["pred_nocs"])
                n_bins = cfg.pointnet2.nocs_bins
                bins.append(enc["per_point_logits"].reshape(
                    *enc["per_point_logits"].shape[:2], 3,
                    n_bins).argmax(-1))
        engine.close()
        gt = torch.cat([torch.as_tensor(b["y"]) for b in batches]).to(dev)
        nocs = torch.cat(nocs)
        res[name] = dict(
            wnf=torch.cat(wnfs), meshes=meshes, bins=torch.cat(bins),
            nocs_err=float((nocs - gt).norm(dim=-1).mean()))
    rows = {}
    for name, (_, _, _, ref_name) in variants.items():
        if ref_name is None:
            continue
        r, ref = res[name], res[ref_name]
        err = float((r["wnf"] - ref["wnf"]).abs().max())
        flips = int(((r["wnf"] > 0.5) != (ref["wnf"] > 0.5)).sum())
        check(all(m is not None for m in r["meshes"] + ref["meshes"]),
              f"precision {name}: a garment without a surface")
        chamfers = [mesh_chamfer_vox(a, b, VOL)
                    for a, b in zip(r["meshes"], ref["meshes"])]
        rows[name] = dict(
            against=ref_name, wnf_max_abs_err=err, flips=flips,
            verts=sum(len(m[0]) for m in r["meshes"]),
            faces=sum(len(m[1]) for m in r["meshes"]),
            ref_verts=sum(len(m[0]) for m in ref["meshes"]),
            ref_faces=sum(len(m[1]) for m in ref["meshes"]),
            chamfer_vox_mean=float(np.mean(chamfers)),
            chamfer_vox_max=float(np.max(chamfers)),
            bins_agree=float((r["bins"] == ref["bins"]).all(-1).float()
                             .mean()),
            nocs_err=r["nocs_err"], ref_nocs_err=ref["nocs_err"])
    n_lat = res["f32"]["wnf"].numel()
    del res

    started, evals = {}, {}
    try:
        for name, (tier, sa, dec, _) in variants.items():
            cfg_v = copy.deepcopy(pcfg)
            cfg_v["prediction"]["decode_precision"] = tier
            with plain_kernels(sa, dec):
                run = predict.main(cfg_v, run_dir=str(tmp / f"prec_{name}"))
            started[name] = start_eval_cli(
                run, tmp / f"prec_{name}_eval",
                "eval.compute_hybrid_chamfer.enabled=false")
        for name, handle in started.items():
            ev_run, ev_t, ev_df, mode = finish_eval_cli(handle)
            check(ev_t["null_samples"] == 0,
                  f"precision {name}: null samples")
            evals[name] = json.loads((ev_run / "summary.json").read_text())
    finally:
        for handle in started.values():
            stop_eval_cli(handle)
    key = "chamfer_symmetrical_nocs"
    for name, row in rows.items():
        got, want = evals[name][key], evals[row["against"]][key]
        row["eval_chamfer"] = got
        row["eval_chamfer_rel"] = (got - want) / want
        log(f"e2e precision, {name} against {row['against']} (trained "
            f"stage 2, {len(batches)} batches, {n_garments} garments, "
            f"{VOL}^3): WNF max abs err {row['wnf_max_abs_err']:.3e}; side "
            f"of 0.5 "
            f"flipped at {row['flips']} of {n_lat} lattice points; MC "
            f"verts {row['verts']} (ref {row['ref_verts']}), faces "
            f"{row['faces']} (ref {row['ref_faces']}); mesh chamfer to the "
            f"reference {row['chamfer_vox_mean']:.4f} voxels (max "
            f"{row['chamfer_vox_max']:.4f}); NOCS bins agree on "
            f"{row['bins_agree'] * 100:.3f}% of points; NOCS point error "
            f"{row['nocs_err']:.6f} (ref {row['ref_nocs_err']:.6f}, change "
            f"{row['nocs_err'] - row['ref_nocs_err']:+.3e}); eval {key} "
            f"{got:.6f} (ref {want:.6f}, {row['eval_chamfer_rel'] * 100:+.3f}"
            f"%)")
    log(f"e2e precision: eval {key} per variant "
        f"{ {k: round(v[key], 6) for k, v in evals.items()} }; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return rows


SPLIT_WARM, SPLIT_STEPS = 3, 20   # in-memory stage-1 steps: warm-up, timed


def stage1_in_memory_ms(dev, zarr: pathlib.Path, steps: int) -> float:
    """ms a stage-1 train step as the acceptance run takes it (production
    width, B, its dataset and arguments, each batch copied to the card in
    the step, lr 1e-3), with the batches read into memory before the steps,
    so that no loader thread runs beside them; CUDA events over `steps`
    steps after SPLIT_WARM."""
    import torch
    from garmentnets_tpu_torch.harness.training import batch_to_device
    from garmentnets_tpu_torch.models.pointnet2_nocs import (
        PointNet2NOCSConfig)
    from garmentnets_tpu_torch.tools.e2e_synthetic import LR
    batches = stage1_batches(zarr, N, steps + SPLIT_WARM)
    train_step = stage1_train_step(
        dev, PointNet2NOCSConfig(learning_rate=LR), 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for i, b in enumerate(batches):
        if i == SPLIT_WARM:
            start.record()
        train_step(batch_to_device(b, dev), gen)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def phase_e2e(dev, tmp: pathlib.Path) -> dict:
    """The acceptance run on the card, each step fatal:
      1. e2e_winding_number: the card's winding number against numpy;
      2. tools/e2e_synthetic.main at full width (PipelineConfig(), 6000
         points, B=8, 128^3, 4 instances x 3 grips, E2E_STEPS steps a
         stage) with its launches counted: each stage's mean loss over its
         last E2E_LAST steps below half its first; the predict run without
         null samples; every eval metric finite;
      3. tools/export_meshes on its prediction.zarr: two PLY files a
         sample, parsed back, face indices in range;
      4. e2e_precision: the decode tiers and the bf16x3 SA on the trained
         model against f32 on the card;
      5. the eval CLI with the geodesic metric on: the garments on which
         it raises, counted.
    Returns {"e2e": the e2e run's launches}."""
    import torch
    from garmentnets_tpu_torch.data import zarrlite
    from garmentnets_tpu_torch.kernels import _build
    from garmentnets_tpu_torch.tools import e2e_synthetic, export_meshes

    t_phase = time.perf_counter()
    gpu = torch.cuda.get_device_name(0)
    e2e_winding_number(dev)

    out = tmp / "e2e"
    s1, s2 = E2E_STEPS
    _build.reset_launch_counts()
    r = e2e_synthetic.main(
        ["--out", str(out), "--instances", str(E2E_INSTANCES),
         "--steps1", str(s1), "--steps2", str(s2)], device=dev)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    n = E2E_INSTANCES * 3
    # the predict CLI reads the train subset, whose loader drops the last
    # partial batch (the JAX tool's prediction.subset=train)
    nb = n // B
    want = {"fps": 2 * (s1 + s2 + nb), "sa_tc": 2 * (s2 + nb),
            "dense_decode_tc": nb, "ggm": nb}
    check(launches == want,
          f"e2e launches {launches}, expected {want} (stage-1 steps FPS "
          f"x2; stage-2 steps FPS x2, SA x2; {nb} predict batches)")
    log(f"e2e on {gpu}: dataset of {n} garments at {VOL}^3 in "
        f"{r['dataset_s']:.1f} s (winding numbers on the card); launches "
        f"{launches}")
    for stage in ("stage1", "stage2"):
        st = r[stage]
        losses = st["losses"]
        last = float(np.mean(losses[-E2E_LAST:]))
        ms = st["seconds"] / st["steps"] * 1e3
        marks = [k for k in (100, 200, 300, 400) if k <= len(losses)]
        at = [round(losses[k - 1], 4) for k in marks]
        windows = [round(float(np.mean(losses[k - E2E_LAST:k])), 4)
                   for k in marks]
        log(f"e2e {stage} on {gpu}: {st['steps']} steps at B="
            f"{st['batch_size']} in {st['seconds']:.1f} s, {ms:.3f} ms a "
            f"step ({st['batch_size'] / ms * 1e3:.2f} samples/s), waited "
            f"on the loader {st['loader_wait_s'] / st['steps'] * 1e3:.3f} "
            f"ms a step; loss {losses[0]:.4f} -> mean of the last "
            f"{E2E_LAST} {last:.4f}; at steps {marks} {at}, the mean of the "
            f"{E2E_LAST} steps up to each {windows}")
        check(st["steps"] == (s1 if stage == "stage1" else s2)
              and np.isfinite(losses).all() and last < 0.5 * losses[0],
              f"e2e {stage} does not learn: {losses[0]} -> {last}")
    ms = stage1_in_memory_ms(dev, out / "dataset.zarr", SPLIT_STEPS)
    st = r["stage1"]
    log(f"e2e stage-1 steps on {gpu} with the same dataset's batches held "
        f"in memory (no loader thread beside the steps): {ms:.3f} ms a "
        f"step over {SPLIT_STEPS} steps, against "
        f"{st['seconds'] / st['steps'] * 1e3:.3f} in the acceptance run "
        "(tools/profile_train.py --loader-split splits both)")
    pred, ev = r["predict_summary"], r["eval_summary"]
    log(f"e2e predict CLI: {pred['garments']} garments, "
        f"{pred['garments_per_sec']:.3f} garments/s ({r['predict_s']:.1f} s "
        f"with its start); eval CLI {r['eval_s']:.1f} s")
    keep = {k: round(v, 6) for k, v in ev.items()
            if "chamfer" in k or "nocs_pc_error_dist" in k}
    log(f"e2e eval (chamfer/nocs): {keep}")
    bad = sorted(k for k, v in ev.items() if not np.isfinite(v))
    check(pred["garments"] == nb * B and ev["null_percentage"] == 0
          and not bad,
          f"e2e: {pred['garments']} garments, null share "
          f"{ev['null_percentage']}, non-finite eval metrics {bad}")

    zarr = r["predict_run"] / "prediction.zarr"
    samples = list(zarrlite.open(str(zarr), "r")["samples"].groups())
    written = export_meshes.export(str(zarr), str(out / "ply"))
    check(len(written) == 2 * len(samples),
          f"export: {len(written)} PLY files for {len(samples)} samples")
    n_v = n_f = 0
    for p in written:
        verts, faces = parse_ply(p)
        check(len(faces) > 0 and faces.min() >= 0
              and faces.max() < len(verts) and np.isfinite(verts).all(),
              f"{p.name}: face indices out of range")
        n_v, n_f = n_v + len(verts), n_f + len(faces)
    log(f"e2e export_meshes: {len(written)} PLY files ({n_v} vertices, "
        f"{n_f} faces after the 0.13 filter), each parsed back")

    # the geodesic count's eval runs beside the precision study
    geodesic = start_eval_cli(r["predict_run"], tmp / "geodesic_eval",
                              "eval.compute_geodesic.enabled=true")
    try:
        e2e_precision(dev, tmp, out)
        ev_run, ev_t, ev_df, mode = finish_eval_cli(
            geodesic, allowed_errors=("compute_geodesic",))
    finally:
        stop_eval_cli(geodesic)
    trips = ev_t["errors"].get("compute_geodesic", 0)
    log(f"e2e geodesic metric on the trained meshes: raised on {trips} of "
        f"{ev_t['samples']} garments ({ev_t['compute_geodesic']:.1f} s; "
        f"{mode})")
    log(f"e2e phase: {time.perf_counter() - t_phase:.1f} s")
    return {"e2e": launches}


# ---------------------------------------------------------------------------
# stage-1 training over a trajectory: the card against the card host's CPU
# ---------------------------------------------------------------------------
TRAJ_SEEDS = (0, 1, 2)
TRAJ_N, TRAJ_STEPS, TRAJ_WINDOW = 256, 40, 20
# the shipped stage-1 rate (configs/train_pointnet2_default.yaml); at the
# acceptance run's 1e-3 this small model spikes on both devices, and a
# seed's window means scatter over the whole 3-seed spread. Even at 1e-4
# the two devices' runs part by rounding as the steps go on while the
# seeds' spread narrows, so a third window would leave its bar now and
# then by chance: the phase checks the second window only
TRAJ_LR = 1e-4
# the bar of a window (window_bars), also tests/test_torch_train_trajectory.py's
TRAJ_BAR_SPREAD, TRAJ_BAR_FLOOR = 1.5, 0.02
TRAJ_TIMEOUT_S = 600.0     # the CPU's seeds, side by side in processes
# the carried step: production widths at the long CPU study's size
# (tests/test_torch_train_trajectory.py's LONG: 1000 points, lr 1e-3,
# dropout on), from the state after CARRY_STEPS card steps, where that
# study's runs first parted (steps 100-119)
CARRY_N, CARRY_STEPS, CARRY_LR = 1000, 100, 1e-3
# its bar, of each tensor's largest entry (the loss's: of the loss), with
# both devices' steps in float64: the float64 witness's bar
# (tests/test_torch_train_trajectory.F64_AGREE). In float32 the step at
# this width is not a steady comparison: a pre-activation within rounding
# of 0 (one of ~8e6 a step) takes the ReLU's other side on one device, and
# moves one row of a gradient by ~1e-3 of its largest entry
CARRY_REL = 1e-6


def trajectory_cfg():
    """Stage 1 for the trajectory: small_cfg()'s (8 bins, radii 0.2 and
    0.4, so that at TRAJ_N points most of SA1's centres choose their 64
    neighbours from more candidates than that, as at full width), dropout
    off (the card's and the CPU's random streams differ), lr TRAJ_LR."""
    import dataclasses
    return dataclasses.replace(small_cfg().pointnet2, dropout=False,
                               learning_rate=TRAJ_LR)


def stage1_batches(path: pathlib.Path, n_points: int, steps: int) -> list:
    """`steps` numpy batches of B (x, pos, y, nocs_grip_point and a
    `_valid_mask` of ones) from one shuffled Loader (seed 0) over the
    dataset at `path`, with the acceptance run's dataset arguments
    (tools/e2e_synthetic.common_kwargs: 4 views, no point noise, rotations
    in [-180, 180] degrees drawn afresh each epoch) at n_points points."""
    from garmentnets_tpu_torch.data.dataset import (
        ConvImplicitWNFDataset, Loader)
    from garmentnets_tpu_torch.tools.e2e_synthetic import (
        Scale, common_kwargs)
    ds = ConvImplicitWNFDataset(
        zarr_path=str(path), metadata_cache_dir=None, volume_size=None,
        **common_kwargs(Scale(num_points=n_points)))
    reps = steps * B // len(ds) + 1
    loader = Loader(ds, np.concatenate([np.arange(len(ds))] * reps), B,
                    shuffle=True, seed=0, drop_last=True)
    keys = ("x", "pos", "y", "nocs_grip_point")
    return [dict({k: b[k] for k in keys}, _valid_mask=np.ones(B, np.float32))
            for b, _ in zip(loader, range(steps))]


def stage1_train_step(dev, cfg, seed: int):
    """make_train_fns' stage-1 train step at `cfg` on `dev`, from flax's
    initializers drawn on the CPU from `seed`, Adam at cfg.learning_rate."""
    import torch
    from garmentnets_tpu_torch.core.random_weights import init_like_jax_
    from garmentnets_tpu_torch.harness.training import (
        make_adam, make_train_fns)
    from garmentnets_tpu_torch.models import pointnet2_nocs
    model = pointnet2_nocs.PointNet2NOCS(cfg)
    init_like_jax_(model, torch.Generator().manual_seed(seed))
    model.to(dev)
    return make_train_fns(
        model, lambda b, g: model(b["x"], b["pos"], generator=g),
        lambda o, b: pointnet2_nocs.get_metrics(cfg, o, b)[0],
        make_adam(model, cfg.learning_rate))[0]


def trajectory_losses(dev, seed: int, batches: list) -> list:
    """A train step of trajectory_cfg() on `dev` for each batch, from the
    initializers of `seed` -> the step losses."""
    import torch
    from garmentnets_tpu_torch.harness.training import batch_to_device
    train_step = stage1_train_step(dev, trajectory_cfg(), seed)
    losses = [train_step(batch_to_device(b, dev))["loss"] for b in batches]
    return torch.stack(losses).cpu().tolist()


def cpu_trajectory_losses(seed: int, batches: list, threads: int) -> list:
    """trajectory_losses on the CPU in a worker process of `threads`
    threads (phase_train_trajectory runs the seeds side by side: one
    process's small ops use 8 cores poorly)."""
    import torch
    torch.set_num_threads(threads)
    return trajectory_losses("cpu", seed, batches)


def carried_state(dev, cfg, batches: list) -> dict:
    """The port's stage 1 at `cfg` after a train step on `dev` for each
    batch, from flax's initializers drawn from seed 0 -> {"model": its
    state_dict, "adam": Adam's state_dict}, on the CPU."""
    import torch
    from garmentnets_tpu_torch.core.random_weights import init_like_jax_
    from garmentnets_tpu_torch.harness.training import (
        batch_to_device, make_adam, make_train_fns)
    from garmentnets_tpu_torch.models import pointnet2_nocs
    model = pointnet2_nocs.PointNet2NOCS(cfg)
    init_like_jax_(model, torch.Generator().manual_seed(0))
    model.to(dev)
    opt = make_adam(model, cfg.learning_rate)
    train_step, _ = make_train_fns(
        model, lambda b, g: model(b["x"], b["pos"], generator=g),
        lambda o, b: pointnet2_nocs.get_metrics(cfg, o, b)[0], opt)
    gen = torch.Generator(device=dev).manual_seed(0)
    for b in batches:
        train_step(batch_to_device(b, dev), gen)
    adam = opt.state_dict()
    adam["state"] = {i: {k: v.detach().cpu().clone() for k, v in st.items()}
                     for i, st in adam["state"].items()}
    return {"model": {k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()},
            "adam": copy.deepcopy(adam)}


def carried_step(dev, cfg, carried: dict, batch: dict):
    """One stage-1 train step (make_train_fns, Adam) at `cfg` on `dev`
    from carried_state's `carried`, in float64, FPS and the ball query
    choosing on the positions in float32 as in the float32 step (on the
    card: the FPS kernel and the card's ball-query top-k) -> (loss, {name:
    gradient}, {name: running statistic}), on the CPU."""
    import torch
    from garmentnets_tpu_torch.harness.training import (
        batch_to_device, make_adam, make_train_fns)
    from garmentnets_tpu_torch.models import pointnet2, pointnet2_nocs
    model = pointnet2_nocs.PointNet2NOCS(cfg)
    model.load_state_dict(carried["model"])
    model.to(dev, torch.float64)
    opt = make_adam(model, cfg.learning_rate)
    # a copy: Adam's step updates its state in place, and on the CPU
    # load_state_dict keeps the tensors it is given (it casts them to the
    # parameters' float64)
    opt.load_state_dict(copy.deepcopy(carried["adam"]))
    train_step, _ = make_train_fns(
        model, lambda b, g: model(b["x"], b["pos"], generator=g),
        lambda o, b: pointnet2_nocs.get_metrics(cfg, o, b)[0], opt)
    fps, bq = pointnet2.furthest_point_sampling, pointnet2.ball_query
    pointnet2.furthest_point_sampling = lambda p, n: fps(p.float(), n)
    pointnet2.ball_query = lambda p, c, r, **kw: bq(p.float(), c.float(), r,
                                                    **kw)
    try:
        loss = float(train_step(batch_to_device(
            {k: v.astype(np.float64) for k, v in batch.items()}, dev))["loss"])
    finally:
        pointnet2.furthest_point_sampling, pointnet2.ball_query = fps, bq
    return (loss, {n: p.grad.cpu() for n, p in model.named_parameters()},
            {n: t.cpu() for n, t in model.named_buffers() if "running" in n})


def window_means(losses: list) -> np.ndarray:
    """The mean loss of every TRAJ_WINDOW-step window."""
    n = len(losses) // TRAJ_WINDOW
    return np.asarray(losses[:n * TRAJ_WINDOW]).reshape(
        n, TRAJ_WINDOW).mean(1)


def window_bars(ref: np.ndarray) -> np.ndarray:
    """The reference's window means [seeds, windows] -> each window's bar:
    TRAJ_BAR_SPREAD x the range of the seeds' means, at least
    TRAJ_BAR_FLOOR of their mean."""
    return np.maximum(TRAJ_BAR_SPREAD * (ref.max(0) - ref.min(0)),
                      TRAJ_BAR_FLOOR * ref.mean(0))


def phase_train_trajectory(dev, tmp: pathlib.Path) -> dict:
    """Stage 1 trained on the card and on the card host's CPU from the
    same seeds, weights and batches (stage1_batches, TRAJ_STEPS steps
    at B, TRAJ_N points, dropout off, lr TRAJ_LR; the CPU's seeds in
    processes of their own beside the card's). Held by the trajectory
    test's rule (tests/test_torch_train_trajectory.py), with the CPU in
    JAX's place: the mean loss of every TRAJ_WINDOW-step window from step
    TRAJ_WINDOW on, for each seed, within the window's bar (window_bars
    of the CPU's means) of the CPU's mean for that seed; and on both
    devices the seeds' mean over the last window below that over the
    first. Then one step of the production widths at CARRY_N points from
    the state (weights and Adam's) after CARRY_STEPS card steps at lr
    CARRY_LR with dropout on, dropout off, on both devices in float64
    (carried_step): the loss, every gradient and every statistic within
    CARRY_REL of its largest entry. The card's path runs the FPS kernel
    (2 launches a step) and the ball query's top-k on the card. Returns
    {"trajectory": the card's launches}."""
    import torch
    from garmentnets_tpu_torch.kernels import _build
    t_phase = time.perf_counter()
    gpu = torch.cuda.get_device_name(0)
    from garmentnets_tpu_torch.data.synthetic import generate_dataset
    generate_dataset(str(tmp / "trajectory.zarr"), num_instances=4,
                     grips_per_instance=3, volume_size=16, pts_per_view=1000,
                     include_task_space=False, device="cpu")
    batches = stage1_batches(tmp / "trajectory.zarr", TRAJ_N, TRAJ_STEPS)
    threads = max(1, (os.cpu_count() or 1) // len(TRAJ_SEEDS))
    secs = {}
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(len(TRAJ_SEEDS)) as pool:
        on_cpu = pool.starmap_async(cpu_trajectory_losses, [
            (s, batches, threads) for s in TRAJ_SEEDS])
        _build.reset_launch_counts()
        card = np.stack([window_means(trajectory_losses(dev, s, batches))
                         for s in TRAJ_SEEDS])
        launches = dict(_build.LAUNCHES)
        secs["card"] = time.perf_counter() - t0
        cpu = np.stack([window_means(x)
                        for x in on_cpu.get(timeout=TRAJ_TIMEOUT_S)])
        secs["cpu"] = time.perf_counter() - t0
    means = {"card": card, "cpu": cpu}
    bars = window_bars(cpu)
    ratio = (np.abs(card - cpu) / bars)[:, 1:]
    # the carried step at the production widths
    import dataclasses
    from garmentnets_tpu_torch.models.pointnet2_nocs import (
        PointNet2NOCSConfig)
    t0 = time.perf_counter()
    carry = stage1_batches(tmp / "trajectory.zarr", CARRY_N,
                           CARRY_STEPS + 1)
    cfg = PointNet2NOCSConfig(learning_rate=CARRY_LR)
    carried = carried_state(dev, cfg, carry[:-1])
    cfg, batch = dataclasses.replace(cfg, dropout=False), carry[-1]
    card_step = carried_step(dev, cfg, carried, batch)
    launches = dict(_build.LAUNCHES)
    secs["carried, card"] = time.perf_counter() - t0
    cpu_step = carried_step("cpu", cfg, carried, batch)
    step_ratio, step_name, _, n_bars = step_ratios(card_step, cpu_step, (),
                                                   CARRY_REL)
    secs["carried"] = time.perf_counter() - t0
    for name, d in ((gpu, "card"), (f"the card host's CPU ({len(TRAJ_SEEDS)}"
                                    f" processes of {threads} threads)",
                                    "cpu")):
        log(f"stage-1 trajectory on {name} ({secs[d]:.1f} s): mean loss "
            f"of each {TRAJ_WINDOW}-step window, seeds {TRAJ_SEEDS}: "
            + "; ".join(f"{s}: {np.round(row, 4).tolist()}"
                        for s, row in zip(TRAJ_SEEDS, means[d])))
    log(f"stage-1 trajectory bars (the CPU's 3-seed spread): "
        f"{np.round(bars, 4).tolist()}; worst |card - CPU| / bar from "
        f"step {TRAJ_WINDOW} on {ratio.max():.3f}; launches {launches}")
    log(f"stage-1 carried step at the production widths, {CARRY_N} "
        f"points, B={B}, after {CARRY_STEPS} card steps at lr {CARRY_LR} "
        f"(dropout on), the step dropout off and in float64, card vs CPU: "
        f"loss {card_step[0]:.12f} vs {cpu_step[0]:.12f}; worst error / "
        f"the tensor's largest entry {step_ratio * CARRY_REL:.3e} "
        f"({step_name}; bar {CARRY_REL}, {n_bars} gradients and "
        f"statistics); card {secs['carried, card']:.1f} s, with the CPU's "
        f"step {secs['carried']:.1f} s")
    want = {"fps": 2 * (TRAJ_STEPS * len(TRAJ_SEEDS) + CARRY_STEPS + 1),
            "sa_tc": 0, "dense_decode_tc": 0, "ggm": 0}
    check(launches == want, f"trajectory launches {launches}, expected "
          f"{want}")
    check(step_ratio <= 1.0, "stage-1 carried step in float64: card and "
          f"CPU disagree ({step_name}: {step_ratio:.3f} of its bar)")
    check(np.isfinite(card).all() and np.isfinite(cpu).all()
          and card[:, -1].mean() < card[:, 0].mean()
          and cpu[:, -1].mean() < cpu[:, 0].mean(),
          "stage-1 trajectory does not learn on one of the devices")
    check(ratio.max() <= 1.0, "stage-1 trajectory: the card leaves the "
          f"CPU's bar ({ratio.max():.3f} of it)")
    log(f"trajectory phase: {time.perf_counter() - t_phase:.1f} s")
    return {"trajectory": launches}


# ---------------------------------------------------------------------------
# several cards
# ---------------------------------------------------------------------------
STRIPS = (2, 4, 8)
MULTI_BATCHES = 2          # sharded-engine batches a mesh; the first warms up
DDP_RANKS = 2
DDP_STEPS = {1: 2, 2: 3}   # steps a stage; the first one is not timed
DDP_B = {1: B, 2: 24}      # global batch a stage (the shipped configs')
DDP_TIMEOUT_S = 120.0
# the largest bar a gradient tensor of the data-parallel check may take,
# relative to its largest entry: a zero or wrong gradient fails
DDP_BAR_CAP = 0.1
WNF_LIMIT = 2e-5           # the 'high' decode's limit against f32 (TC_LIMITS)
WARP_LIMIT = 1e-3


def decode_strips(dev) -> None:
    """The tensor-core decode at 'high' in 2, 4 and 8 strips of D planes on
    one card against the whole launch, at 128^3 and 256^3: every strip
    bit-equal to its slice; the strips' summed time against the whole's."""
    import torch
    from garmentnets_tpu_torch.kernels.dense_decode_tc import (
        dense_decode_tc_cuda, pack_decoder)
    from garmentnets_tpu_torch.ops.dense_decode import coarse_first_layer
    for S in (VOL, VOL_LARGE):
        gen = torch.Generator().manual_seed(11)
        fv, layers = decode_inputs(gen, (B, 32, 32, 32), (128, 256, 256, 1),
                                   dev)
        z = coarse_first_layer(fv, layers).contiguous()
        packed = pack_decoder(layers, "high")
        whole = dense_decode_tc_cuda(z, packed, S)
        whole_ms = time_ms(lambda: dense_decode_tc_cuda(z, packed, S), 3)
        for n in STRIPS:
            per = S // n

            def run_strips():
                return [dense_decode_tc_cuda(z, packed, S, (j * per, per))
                        for j in range(n)]
            strips = run_strips()
            diff = max(float((s - whole[:, j * per:(j + 1) * per]).abs()
                             .max()) for j, s in enumerate(strips))
            ms = time_ms(run_strips, 3)
            log(f"decode strips at {S}^3 'high', B={B}: {n} strips of {per} "
                f"planes on one card, max abs diff to the whole launch "
                f"{diff:.1e}; {ms:.3f} ms summed against {whole_ms:.3f} ms "
                f"whole")
            check(diff == 0 and all(
                torch.equal(s, whole[:, j * per:(j + 1) * per])
                for j, s in enumerate(strips)),
                f"{n} decode strips at {S}^3 differ from the whole launch")
        del whole, strips


def engine_meshes(dev, cards: int) -> list:
    """(label, mesh) of the sharded engine's runs: (n, 1) and, on an even
    count, (n/2, 2) over the cards, n the largest count up to the cards
    that divides B; on one card, cuda:0 four times as (2, 2)."""
    from garmentnets_tpu_torch.parallel.mesh import Mesh, make_mesh_2d
    if cards == 1:
        return [("(2, 2) of cuda:0 listed four times (one card)",
                 Mesh([[dev] * 2] * 2, ("data", "space")))]
    n = max(d for d in range(1, cards + 1) if B % d == 0)
    out = [(f"make_mesh_2d({n}, 1)", make_mesh_2d(n, 1))]
    if cards % 2 == 0:
        h = max(d for d in range(1, cards // 2 + 1) if B % d == 0)
        out.append((f"make_mesh_2d({h}, 2)", make_mesh_2d(h, 2)))
    return out


def sharded_engine(dev, cards: int) -> tuple:
    """PredictEngine(mesh=...) at the full width of PipelineConfig(), B=8,
    N=6000, 128^3, 'high', seeded weights with a live head, against the
    one-device engine on the same batch: the WNF within WNF_LIMIT, the
    shipped brick counts, each garment's vertex count, and the warp at the
    one-device engine's vertices within WARP_LIMIT. Launches, stage ms and
    garments/s per batch. Every sharded encode runs under
    torch.cuda.set_sync_debug_mode("error"): the host must queue every
    card's work before it waits on any, so an operation that synchronizes
    fails the run. Returns the launches summed over the sharded batches."""
    import torch
    from garmentnets_tpu_torch.core.random_weights import seeded_init_
    from garmentnets_tpu_torch.harness.predict_engine import PredictEngine
    from garmentnets_tpu_torch.kernels import _build
    from garmentnets_tpu_torch.models.pipeline import (
        ConvImplicitWNFPipeline, PipelineConfig)
    cfg = PipelineConfig()
    model = ConvImplicitWNFPipeline(cfg)
    seeded_init_(model, 0)
    rng = np.random.RandomState(12)
    x = rng.rand(B, N, 3).astype(np.float32)
    pos = (rng.rand(B, N, 3) - 0.5).astype(np.float32)
    live_head_(model, x, pos, dev)
    state = model.state_dict()
    one = PredictEngine(cfg, state, volume_size=VOL, return_volume=True,
                        device=dev)
    ref = one.encode(x, pos)
    ref_meshes = one.extract_meshes(ref)
    ref_warps = one.warp_batch(ref, ref_meshes)
    ref_counts = ref["active_counts"].cpu()
    ref_verts = [0 if m is None else len(m[0]) for m in ref_meshes]
    check(all(n > 0 for n in ref_verts), f"one-device meshes {ref_verts}")
    one.close()
    total = {k: 0 for k in _build.LAUNCHES}
    for label, mesh in engine_meshes(dev, cards):
        eng = PredictEngine(cfg, state, volume_size=VOL, return_volume=True,
                            device=dev, mesh=mesh)
        n_data, n_space = eng.n_data, mesh.axis_size("space")
        devices = mesh.distinct_devices()
        for i in range(MULTI_BATCHES):
            _build.reset_launch_counts()
            torch.cuda.set_sync_debug_mode("error")
            try:
                t0 = time.perf_counter()
                enc = eng.encode(x, pos)
                t_queued = time.perf_counter()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            for d in devices:
                torch.cuda.synchronize(d)
            t1 = time.perf_counter()
            meshes = eng.extract_meshes(enc)
            t2 = time.perf_counter()
            warps = eng.warp_batch(enc, meshes)
            t3 = time.perf_counter()
            launches = dict(_build.LAUNCHES)
            for k, v in launches.items():
                total[k] += v
            want = {"fps": 2 * n_data, "sa_tc": 2 * n_data,
                    "dense_decode_tc": n_data * n_space, "ggm": n_data}
            log(f"sharded engine {label} {mesh.shape}, batch {i}: launches "
                f"{launches}; encode {(t1 - t0) * 1e3:.1f} ms (queued in "
                f"{(t_queued - t0) * 1e3:.1f}), host MC "
                f"{(t2 - t1) * 1e3:.1f}, warp {(t3 - t2) * 1e3:.1f}; "
                f"{B / (t3 - t0):.3f} garments/s in sequence")
            check(launches == want, f"sharded engine {label}: launches "
                  f"{launches}, expected {want}")
        wnf = torch.cat([sh["wnf_volume"].to(dev) for sh in enc["_shards"]])
        err = float((wnf - ref["wnf_volume"]).abs().max())
        counts = torch.cat([sh["active_counts"].cpu()
                            for sh in enc["_shards"]])
        verts = [0 if m is None else len(m[0]) for m in meshes]
        common = eng.warp_batch(enc, ref_meshes)
        werr = max(float(np.abs(w[k] - r[k]).max()) for w, r in
                   zip(common, ref_warps) for k in ("warp_field", "verts_ggm"))
        log(f"sharded engine {label} against one device: WNF max abs err "
            f"{err:.2e} (limit {WNF_LIMIT:.0e}); shipped bricks "
            f"{counts.tolist()} against {ref_counts.tolist()}; vertices "
            f"{verts} against {ref_verts}; warp at the one-device vertices "
            f"max abs err {werr:.2e} (limit {WARP_LIMIT:.0e})")
        check(err <= WNF_LIMIT, f"sharded engine {label}: WNF off by {err}")
        check(torch.equal(counts, ref_counts) or max(
            abs(a - b) for a, b in zip(verts, ref_verts)) <= 0.01 * max(
                ref_verts), f"sharded engine {label}: brick counts "
              f"{counts.tolist()} and vertices {verts} against "
              f"{ref_counts.tolist()} and {ref_verts}")
        check(werr <= WARP_LIMIT, f"sharded engine {label}: warp off by "
              f"{werr}")
        check(all(w is not None and np.isfinite(w["warp_field"]).all()
                  for w in warps), f"sharded engine {label}: warp results")
        eng.close()
        del enc, wnf
    return total


def ddp_cfg(stage: int):
    """The data-parallel step's configuration at the shipped widths: stage
    1 PointNet2NOCSConfig() with dropout off (the ranks' random streams
    differ from one process's), stage 2 PipelineConfig()."""
    from garmentnets_tpu_torch.models import pipeline, pointnet2_nocs
    if stage == 1:
        return pointnet2_nocs.PointNet2NOCSConfig(dropout=False)
    return pipeline.PipelineConfig()


def ddp_model(stage: int, cfg, group=None):
    """(model, apply_fn, loss_fn) of a data-parallel step of `stage` at
    `cfg`; stage 2's stage 1 frozen."""
    from garmentnets_tpu_torch.models import pipeline, pointnet2_nocs
    if stage == 1:
        model = pointnet2_nocs.PointNet2NOCS(cfg)
        return (model, lambda b, g: model(b["x"], b["pos"], generator=g),
                lambda o, b: pointnet2_nocs.get_metrics(cfg, o, b, group)[0])
    model = pipeline.ConvImplicitWNFPipeline(cfg)
    model.pointnet2_nocs.requires_grad_(False)
    return (model, lambda b, g: model(b),
            lambda o, b: pipeline.pipeline_loss(cfg, o, b, group))


def _digest(tensors) -> str:
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def ddp_step_run(dev, stage: int, cfg, state: dict, batch: dict,
                 steps: int, group=None, world: int = 1,
                 rank: int = 0) -> dict:
    """`steps` train steps (make_train_fns, Adam at 1e-4) of ddp_model on
    this rank's rows of `batch`: each step's global loss, device ms and a
    digest of the parameters after it; the first step's summed gradients
    (before Adam) and their digest; peak memory and launches."""
    import torch
    # cuDNN's deterministic algorithms, so that a rerun of the same step
    # repeats its gradients (max_pool3d's backward still adds atomically)
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        return _ddp_steps(dev, stage, cfg, state, batch, steps, group,
                          world, rank)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def _ddp_steps(dev, stage, cfg, state, batch, steps, group, world, rank):
    import torch
    from garmentnets_tpu_torch.harness.training import (
        batch_to_device, make_adam, make_train_fns)
    from garmentnets_tpu_torch.kernels import _build
    model, apply_fn, loss_fn = ddp_model(stage, cfg, group)
    model.load_state_dict(state)
    model.to(dev)
    opt = make_adam(model, 1e-4)
    grads = {}
    adam_step = opt.step

    def step_after_snapshot():
        if not grads:
            grads.update({n: p.grad.clone() for n, p in
                          model.named_parameters() if p.grad is not None})
        return adam_step()

    opt.step = step_after_snapshot
    train_step, _ = make_train_fns(model, apply_fn, loss_fn, opt, group)
    rows = batch_to_device(batch, dev, world, rank)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launch_counts()
    out = {"loss": [], "ms": [], "params": []}
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = train_step(rows)
        end.record()
        end.synchronize()
        out["ms"].append(start.elapsed_time(end))
        out["loss"].append(float(metrics["loss"]))
        out["params"].append(_digest(model.parameters()))
    out.update(grads={n: g.cpu() for n, g in grads.items()},
               grad_digest=_digest(grads.values()),
               peak=torch.cuda.max_memory_allocated(dev),
               launches=dict(_build.LAUNCHES), device=str(dev))
    return out


def ddp_rank(out_dir: str, device_type: str, stage: int, cfg,
             state: dict, batch: dict, steps: int) -> None:
    """One rank of the data-parallel check (started by launch_ranks), on
    the card that init_distributed chose for it."""
    import torch
    import torch.distributed as dist
    rank = dist.get_rank()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device(device_type))
    out = ddp_step_run(dev, stage, cfg, state, batch, steps,
                       dist.group.WORLD, dist.get_world_size(), rank)
    torch.save(out, f"{out_dir}/rank{rank}.pt")


def data_parallel_training(dev, cards: int, tmp: pathlib.Path) -> dict:
    """Two ranks of each training stage at the shipped widths, nccl on two
    cards where there are two, else gloo with both ranks on cuda:0 (asked
    for explicitly): the ranks' parameters bit-equal after every step,
    their summed gradients bit-equal; the first step's loss and summed
    gradients within tests/test_torch_train.py's bars of one process's
    step on the same rows (loss 1e-5, gradients 1e-4 of each tensor's
    largest entry), or SPREAD_FACTOR times that step's own change under a
    1e-6 jitter of the weights or the input colours where that is larger,
    but never above DDP_BAR_CAP of the tensor's largest entry. At the
    shipped widths a train step of either stage is ill-conditioned at
    rounding level: under that jitter its gradients move by up to a few
    percent of a tensor's largest entry (a max pooling's or a bin
    argmax's choice flips), while a rerun of the same step repeats them
    to ~1e-6 of it. Returns the ranks' launches summed."""
    import torch
    from garmentnets_tpu_torch.core.random_weights import init_like_jax_
    from garmentnets_tpu_torch.parallel.mesh import launch_ranks
    backend = "nccl" if cards >= DDP_RANKS else "gloo"
    log(f"data-parallel training: {DDP_RANKS} ranks, backend {backend}"
        + ("" if backend == "nccl" else
           ", both ranks on cuda:0 (one card; gloo asked for explicitly)"))
    total = {}
    gpu = torch.cuda.get_device_name(0)
    for stage in (1, 2):
        cfg = ddp_cfg(stage)
        model = ddp_model(stage, cfg)[0]
        init_like_jax_(model, torch.Generator().manual_seed(0))
        state = {k: v.clone() for k, v in model.state_dict().items()}
        del model
        batch = train_batch(stage, seed=30 + stage, B=DDP_B[stage], N=N,
                            M=N)
        ref = ddp_step_run(dev, stage, cfg, state, batch, 1)
        rerun = ddp_step_run(dev, stage, cfg, state, batch, 1)
        gen = torch.Generator().manual_seed(3)
        jittered = {k: (v * (1 + 1e-6 * torch.randn(v.shape, generator=gen))
                        if v.is_floating_point() else v)
                    for k, v in state.items()}
        colours = batch["x"] * (1 + 1e-6 * np.random.RandomState(4).randn(
            *batch["x"].shape)).astype(np.float32)
        moved = [ddp_step_run(dev, stage, cfg, jittered, batch, 1),
                 ddp_step_run(dev, stage, cfg, state,
                              dict(batch, x=colours), 1)]
        torch.cuda.empty_cache()
        run_dir = tmp / f"ddp_s{stage}"
        run_dir.mkdir()
        t0 = time.perf_counter()
        launch_ranks(ddp_rank, DDP_RANKS, args=(
            str(run_dir), dev.type, stage, cfg, state, batch,
            DDP_STEPS[stage]), device=dev.type, backend=backend,
            timeout_s=DDP_TIMEOUT_S)
        wall = time.perf_counter() - t0
        ranks = [torch.load(run_dir / f"rank{r}.pt", weights_only=False)
                 for r in range(DDP_RANKS)]
        r0 = ranks[0]
        check(all(r["params"] == r0["params"] for r in ranks),
              f"stage {stage}: the ranks' parameters differ after a step")
        check(all(r["grad_digest"] == r0["grad_digest"] for r in ranks)
              and all(r["loss"] == r0["loss"] for r in ranks),
              f"stage {stage}: the ranks' gradients or losses differ")
        check(sorted(r0["grads"]) == sorted(ref["grads"]),
              f"stage {stage}: gradient names differ")
        # per tensor, as fractions of its largest entry: the bar, the
        # ranks' error and a rerun's change
        ratios, bars, errs, reruns, n_spread, n_cap = [], [], [], [], 0, 0
        for name, g in ref["grads"].items():
            top = float(g.abs().max())
            spread = max(float((m["grads"][name] - g).abs().max())
                         for m in moved)
            bar = max(1e-4 * top, SPREAD_FACTOR * spread)
            n_spread += bar > 1e-4 * top
            n_cap += bar > DDP_BAR_CAP * top
            bar = min(bar, DDP_BAR_CAP * top)
            err = float((r0["grads"][name] - g).abs().max())
            ratios.append((err / bar if bar > 0 else float(err > 0), name))
            if top > 0:
                bars.append((bar / top, name))
                errs.append((err / top, name))
                reruns.append((float((rerun["grads"][name] - g).abs()
                                     .max()) / top, name))
        spread = max(abs(m["loss"][0] - ref["loss"][0]) for m in moved)
        bar = max(1e-5 * abs(ref["loss"][0]), SPREAD_FACTOR * spread)
        ratios.append((abs(r0["loss"][0] - ref["loss"][0]) / bar, "loss"))
        ratios.sort(reverse=True)
        ratio, worst = ratios[0]
        for what, fr in (("bars", bars), ("ranks' errors", errs),
                         ("a rerun's changes", reruns)):
            fr.sort(reverse=True)
            log(f"ddp stage {stage}: largest {what} as a fraction of the "
                f"tensor's largest entry: "
                + ", ".join(f"{f:.3e} ({n})" for f, n in fr[:3]))
        per_step = {2: {"fps": 2, "sa_tc": 2}, 1: {"fps": 2, "sa_tc": 0}}
        want = {"fps": per_step[stage]["fps"] * DDP_STEPS[stage],
                "sa_tc": per_step[stage]["sa_tc"] * DDP_STEPS[stage],
                "dense_decode_tc": 0, "ggm": 0}
        for r in ranks:
            timed = r["ms"][1:]
            ms = statistics.median(timed)
            log(f"ddp stage {stage} on {gpu}, rank on {r['device']}: "
                f"{DDP_B[stage] // DDP_RANKS} of {DDP_B[stage]} rows, "
                f"{ms:.3f} ms a step (steps "
                f"{', '.join(f'{t:.3f}' for t in r['ms'])}), "
                f"{DDP_B[stage] / ms * 1e3:.2f} samples/s, peak "
                f"{r['peak'] / 2 ** 30:.3f} GiB; losses "
                f"{[round(x, 6) for x in r['loss']]}; launches "
                f"{r['launches']}")
            check(r["launches"] == want, f"ddp stage {stage} launches "
                  f"{r['launches']}, expected {want}")
            for k, v in r["launches"].items():
                total[k] = total.get(k, 0) + v
        log(f"ddp stage {stage}: one process's first step on the same "
            f"{DDP_B[stage]} rows: loss {ref['loss'][0]:.6f} ({ref['ms'][0]:.3f}"
            f" ms, cold) against {r0['loss'][0]:.6f}; worst error/bar "
            f"{ratio:.3f} ({worst}; next "
            f"{', '.join(f'{r:.3f} ({n})' for r, n in ratios[1:3])}); "
            f"{n_spread} of {len(ref['grads'])} gradient bars set by the "
            f"jitter spread, {n_cap} of them held at {DDP_BAR_CAP} of the "
            f"tensor's largest entry; replicas bit-equal after each of "
            f"{DDP_STEPS[stage]} steps; {wall:.1f} s with the ranks' start")
        check(ratio <= 1.0, f"ddp stage {stage}: {worst} off the "
              f"one-process step ({ratio:.3f} of its bar)")
    return total


def train_cli_on_cards(tmp: pathlib.Path, cards: int) -> None:
    """The stage-1 train CLI as shipped (trainer.num_devices -1) on
    trainer.device=cuda over phase_train's dataset, one epoch of one step:
    one nccl rank a card, spawned by the CLI; one checkpoint set and one
    metrics log, from rank 0, with a finite loss."""
    from garmentnets_tpu_torch.core.config import load_config
    from garmentnets_tpu_torch.harness import train_pointnet2
    cfg = load_config("train_pointnet2_default", [
        f"datamodule.zarr_path={tmp / 'data.zarr'}",
        f"datamodule.dataset_split={TRAIN_SPLIT}",
        "datamodule.volume_size=32", "trainer.device=cuda",
        "trainer.max_epochs=1", "trainer.limit_train_batches=1"])
    check(cfg["trainer"]["num_devices"] == -1,
          "the shipped trainer.num_devices changed")
    t0 = time.perf_counter()
    run = train_pointnet2.main(cfg, run_dir=str(tmp / "train_cards"))
    wall = time.perf_counter() - t0
    recs, _ = run_summary(run)
    losses = [r["train_loss"] for r in recs if "train_loss" in r]
    ckpts = sorted(p.name for p in (run / "checkpoints").iterdir())
    check(len(losses) == 1 and np.isfinite(losses[0]),
          f"train CLI on {cards} cards: losses {losses}")
    check(len([c for c in ckpts if c.startswith("epoch=")]) == 1
          and "last.ckpt" in ckpts,
          f"train CLI on {cards} cards: checkpoints {ckpts}")
    log(f"stage-1 train CLI, trainer.device=cuda, trainer.num_devices=-1: "
        f"{cards} nccl ranks, B={B} ({B // cards} rows a rank), loss "
        f"{losses[0]:.4f}, checkpoints {ckpts}, {wall:.1f} s with the "
        "ranks' start")


def phase_multi_gpu(dev, tmp: pathlib.Path) -> dict:
    """Several cards, or one card standing in for them: (1) the decode's
    D strips bit-equal to the whole launch; (2) the sharded engine against
    the one-device engine, its encodes free of host syncs; (3)
    data-parallel training on two ranks; (4) on two or more cards, the
    stage-1 train CLI as shipped, one rank a card. Returns the launches
    of the sharded engine's batches ("multi_gpu") and of the ranks of
    (3) ("ddp")."""
    import torch
    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    log(f"cards: {cards}")
    decode_strips(dev)
    engine_launches = sharded_engine(dev, cards)
    log("sharded encodes ran under torch.cuda.set_sync_debug_mode('error'):"
        " no host sync")
    ddp_launches = data_parallel_training(dev, cards, tmp)
    if cards >= 2:
        train_cli_on_cards(tmp, cards)
    else:
        log("one card: the train CLI's several nccl ranks need two or more")
    log(f"multi-GPU phase: {time.perf_counter() - t_phase:.1f} s")
    return {"multi_gpu": engine_launches, "ddp": ddp_launches}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from garmentnets_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvidia-smi: {smi}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for lib, text in sorted(_build.BUILD_LOGS.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {lib}: {line.strip()}")

    rows = phase_kernels(dev)
    launches = phase_main_path(dev)
    with tempfile.TemporaryDirectory(prefix="gn_cli_") as tmp:
        tmp = pathlib.Path(tmp)
        launches["cli"], cli_run = phase_predict_cli(dev, tmp)
        phase_eval(cli_run, tmp)
        launches.update(phase_variants(dev, tmp))
        launches.update(phase_large_volume(dev, tmp))
        launches.update(phase_train(dev, tmp)["launches"])
        launches.update(phase_multi_gpu(dev, tmp))
        launches.update(phase_e2e(dev, tmp))
    phase_serve(dev)
    phase_small_reference(dev)
    with tempfile.TemporaryDirectory(prefix="gn_traj_") as tmp:
        launches.update(phase_train_trajectory(dev, pathlib.Path(tmp)))

    # launches over the driven paths: the main path at 'high', the predict
    # CLI, the two variant batches, the 256^3 engine's batches and CLI
    # batch, the predict run on the trained checkpoint, the sharded
    # engine's batches (its decode strips) and the acceptance run (its
    # training and predict; all at 'high') for the 'high' decode row, the
    # main path's 'highest' batch for the 'highest' row, all of them, the
    # two train CLIs and the data-parallel ranks for the rest
    at_high = ("high", "cli", "holes", "task_space", "large", "large_cli",
               "train_predict", "multi_gpu", "e2e")
    for k, row in rows.items():
        if k == "dense_decode_tc":
            row["launches"] = sum(launches[p][k] for p in at_high)
        elif k == "dense_decode_tc_highest":
            row["launches"] = launches["highest"]["dense_decode_tc"]
        else:
            row["launches"] = sum(launches[p][k] for p in at_high + (
                "highest", "train_s1", "train_s2", "ddp", "trajectory"))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in rows.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
