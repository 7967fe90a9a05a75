#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (garmentnets_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero without one. Phases, each fatal:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA kernel (csrc/*.cu, nvcc for sm_90a, one process per
     source, all at once) and the host marching-cubes library, into
     garmentnets_tpu_torch/_build/;
  3. kernels against their plain PyTorch versions at the main path's
     full-width shapes, with times (CUDA events, median), the least time
     the card could take (bound) and, where one PyTorch call computes the
     same function, that call's time;
  4. the main path: PredictEngine at the full width of PipelineConfig()
     (B=8, N=6000, 128^3 WNF) with seeded random weights, driving
     encode -> extract_meshes -> warp_batch with the launch counts reset
     just before and read just after; then the same engine at a tiny size
     on the card against the CPU path;
  5. a `kernels` JSON line, the nvidia-smi line, and the final JSON line.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

B, N, VOL = 8, 6000, 128
N_BATCHES = 4          # main-path batches; the first one warms up
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
TF32_FLOPS = 495e12         # H100 SXM TF32 tensor cores, dense


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


# ---------------------------------------------------------------------------
def phase_kernels(dev) -> dict:
    """Each kernel against its plain version at full-width shapes."""
    import torch
    import torch.nn.functional as F
    from garmentnets_tpu_torch.kernels.dense_decode import dense_decode_cuda
    from garmentnets_tpu_torch.kernels.fps import furthest_point_sampling_cuda
    from garmentnets_tpu_torch.kernels.ggm import ggm_cuda
    from garmentnets_tpu_torch.ops.dense_decode import (
        coarse_first_layer, dense_decode_plain)
    from garmentnets_tpu_torch.ops.gaussian import ggm_plain, ggm_taps
    from garmentnets_tpu_torch.ops.pointcloud import (
        furthest_point_sampling_plain, gather_rows)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(1)
    rows = {}

    # ---- FPS: SA1 [8,6000,3] -> 3000, SA2 [8,3000,3] -> 750 ----
    pos1 = (torch.rand(B, N, 3, generator=gen) - 0.5).to(dev)
    fps = dict(ms=0.0, plain_ms=0.0, bound=0.0, err=0)
    pos = pos1
    for n_pts, m in ((N, N // 2), (N // 2, N // 8)):
        k = furthest_point_sampling_cuda(pos, m)
        p = furthest_point_sampling_plain(pos, m)
        torch.cuda.synchronize()
        mism = int((k != p).sum())
        log(f"fps [{B},{n_pts},3]->{m}: {mism} index mismatches")
        check(mism == 0, f"fps indices differ at N={n_pts}")
        fps["err"] = max(fps["err"], int((k - p).abs().max()))
        ms = time_ms(lambda: furthest_point_sampling_cuda(pos, m), 10)
        pms = time_ms(lambda: furthest_point_sampling_plain(pos, m), 2)
        bnd, _ = bound_ms(B * n_pts * 12 + B * m * 8,
                          B * (m - 1) * n_pts * 9, F32_FLOPS)
        log(f"fps N={n_pts} M={m}: kernel {ms:.3f} ms, plain {pms:.3f} ms, "
            f"bound {bnd:.4f} ms")
        fps["ms"] += ms
        fps["plain_ms"] += pms
        fps["bound"] += bnd
        pos = gather_rows(pos, k).contiguous()
    rows["fps"] = dict(
        name="fps", route="cuda", source="garmentnets_tpu_torch/csrc/fps.cu",
        replaces="garmentnets_tpu/kernels/fps_pallas.py:65",
        max_abs_err=float(fps["err"]), ms=fps["ms"],
        plain_ms=fps["plain_ms"], bound_ms=fps["bound"],
        bound_by="operations", library_ms=None)

    # ---- dense decode: [8,32,32,32,128] -> [8,128,128,128], 128-256-256-1 --
    widths = (128, 256, 256, 1)
    fv, layers = decode_inputs(gen, (B, 32, 32, 32), widths, dev)
    z = coarse_first_layer(fv, layers).contiguous()
    k = dense_decode_cuda(z, layers, VOL)
    p = dense_decode_plain(fv, layers, VOL)
    torch.cuda.synchronize()
    err = float((k - p).abs().max())
    std = float(p.std())
    log(f"dense decode: max abs err {err:.3e} (limit 1e-4), output std "
        f"{std:.3e}, range [{float(p.min()):.3f}, {float(p.max()):.3f}]")
    check(std >= 0.1, "dense decode check field is flat")
    check(err <= 1e-4 and bool(torch.isfinite(k).all()),
          "dense decode disagrees with its plain version")
    ms = time_ms(lambda: dense_decode_cuda(z, layers, VOL), 5)
    pms = time_ms(lambda: dense_decode_plain(fv, layers, VOL), 2)
    vox = B * VOL ** 3
    G, c1 = fv.shape[1], widths[1]
    # the trilinear upsample at its separable minimum: three 2-tap passes
    # (3 flops per output channel) producing S*G*G, S*S*G and S^3 points
    up_ops = 3 * c1 * B * (VOL * G * G + VOL * VOL * G + VOL ** 3)
    mid_ops = sum(2 * a * b_ for a, b_ in zip(widths[1:-2], widths[2:-1]))
    ops = up_ops + vox * (3 * c1 + mid_ops + 3 * sum(widths[2:-1])
                          + 2 * widths[-2] + 3)
    n_bytes = z.numel() * 4 + vox * 4 + sum(
        t.numel() * 4 for lay in layers[1:] for t in lay)
    bnd, by = bound_ms(n_bytes, ops, F32_FLOPS)
    bnd_tc, _ = bound_ms(n_bytes, ops, TF32_FLOPS)
    log(f"dense decode: kernel {ms:.3f} ms, plain {pms:.3f} ms, bound "
        f"{bnd:.3f} ms ({by}, f32 CUDA cores; {bnd_tc:.3f} ms at the TF32 "
        f"tensor-core rate), {ops / 1e12:.3f} TFLOP, "
        f"{ops / (ms * 1e-3) / 1e12:.2f} TFLOP/s achieved")
    rows["dense_decode"] = dict(
        name="dense_decode", route="cuda",
        source="garmentnets_tpu_torch/csrc/dense_decode.cu",
        replaces="garmentnets_tpu/ops/dense_decode_pallas.py:123",
        max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bnd, bound_by=by,
        library_ms=None)
    del z, fv, k, p

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
    bnd, by = bound_ms(2 * vol.numel() * 4,
                       vol.numel() * (8 * taps * 2 + 6), F32_FLOPS)
    log(f"ggm: kernel {ms:.3f} ms, plain {pms:.3f} ms, conv3d {lms:.3f} ms "
        f"(max abs err {lib_err:.1e}), bound {bnd:.4f} ms ({by}), "
        f"{2 * vol.numel() * 4 / (ms * 1e-3) / 1e9:.0f} GB/s achieved")
    rows["ggm"] = dict(
        name="ggm", route="cuda", source="garmentnets_tpu_torch/csrc/ggm.cu",
        replaces="garmentnets_tpu/ops/gaussian_pallas.py:93",
        max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bnd, bound_by=by,
        library_ms=lms)
    return rows


def phase_main_path(dev) -> dict:
    """PredictEngine at the full width of PipelineConfig() on the card."""
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
    launches = dict(_build.LAUNCHES)
    engine.close()
    log(f"main path launches over {N_BATCHES} batches: {launches}")
    check(launches == {"fps": 2 * N_BATCHES, "dense_decode": N_BATCHES,
                       "ggm": N_BATCHES},
          f"unexpected launch counts {launches}")

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
    log(f"main path on {torch.cuda.get_device_name(0)}: {gps:.3f} "
        f"garments/s (B={B}, N={N}, {VOL}^3, "
        f"{N_BATCHES - 1} timed batches, stages run in sequence); "
        f"median ms per batch: encode {med['encode']:.1f}, host MC "
        f"{med['meshes']:.1f}, warp {med['warp']:.1f}; verts per garment "
        f"{nverts[0]}; shipped bricks on the random net's WNF: "
        f"{real_counts.tolist()}")
    return launches


def phase_small_reference(dev) -> None:
    """A tiny engine on the card against the same engine on the CPU. The
    seed gives a WNF that varies and crosses the iso level, so the WNF and
    ggm comparisons compare something."""
    import torch
    from garmentnets_tpu_torch.core.random_weights import seeded_init_
    from garmentnets_tpu_torch.harness.predict_engine import PredictEngine
    from garmentnets_tpu_torch.models.pipeline import (
        ConvImplicitWNFPipeline, PipelineConfig)
    from garmentnets_tpu_torch.models.pointnet2_nocs import (
        PointNet2NOCSConfig)
    cfg = PipelineConfig(
        pointnet2=PointNet2NOCSConfig(nocs_bins=8, sa1_r=0.2, sa2_r=0.4),
        volume_agg_nn_channels=(137, 64, 32), grid_shape=(16, 16, 16),
        unet_in_channels=32, unet_out_channels=32, unet_f_maps=8,
        unet_num_levels=2, unet_num_groups=4,
        volume_decoder_channels=(32, 16, 1),
        surface_decoder_channels=(32, 16, 3))
    model = ConvImplicitWNFPipeline(cfg)
    seeded_init_(model, 4)
    rng = np.random.RandomState(4)
    x = rng.rand(2, 256, 3).astype(np.float32)
    pos = (rng.rand(2, 256, 3) - 0.5).astype(np.float32)
    out = {}
    for d in (dev, "cpu"):
        eng = PredictEngine(cfg, model.state_dict(), volume_size=32,
                            return_volume=True, mc_threads=1, device=d)
        out[str(d)] = {k: v.cpu() for k, v in eng.encode(x, pos).items()
                       if torch.is_tensor(v)}
    g, c = out[str(dev)], out["cpu"]
    wnf_std = float(c["wnf_volume"].std())
    check(wnf_std >= 1e-2 and float(c["wnf_ggm"].abs().max()) > 0,
          f"small-input WNF is flat (std {wnf_std:.2e}): compares nothing")
    same_nocs = bool(torch.equal(g["pred_nocs"], c["pred_nocs"]))
    errs = {k: float((g[k] - c[k]).abs().max())
            for k in ("feature_volume", "wnf_volume", "wnf_ggm")}
    log(f"small input, card vs CPU: NOCS bins identical {same_nocs}, "
        f"WNF std {wnf_std:.3e}, shipped bricks "
        f"{c['active_counts'].tolist()}, max abs err {errs}")
    check(same_nocs, "NOCS bins differ between card and CPU")
    check(all(e <= 1e-3 for e in errs.values()),
          "card and CPU paths disagree on a small input")


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
    phase_small_reference(dev)

    for k, row in rows.items():
        row["launches"] = launches[k]
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
