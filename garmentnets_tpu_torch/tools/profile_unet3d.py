"""Which engines run the stage-2 U-Net's f32 3D convolutions, how fast
they run, and under which way of asking for them.

    python -m garmentnets_tpu_torch.tools.profile_unet3d [--batch 24] \
        [--eval-batch 8] [--reps 10] [--unet ResidualUNet3D] \
        [--out profile_unet3d.json]
    python -m garmentnets_tpu_torch.tools.profile_unet3d --device cpu \
        --batch 2 --eval-batch 1 --cmp-batch 1 --volume 8 --reps 1

The U-Net is the pipeline's (models/unet3d.UNet3D at PipelineConfig's
widths: 'gcr', f_maps 32, 4 levels, 128 channels in and out, 32^3; with
--unet ResidualUNet3D, pytorch-3dunet's residual U-Net at its class
defaults: f_maps 64, 5 levels), run as UNet3D.forward runs it, from a
[B, D, H, W, C] volume to one. Every candidate computes in f32 with TF32
off (cuDNN's allow_tf32 off, matmul precision "highest"); they differ
only in how the convolutions are asked for:

- heuristic: NCDHW, cudnn.benchmark off (cuDNN's heuristic picks), each
  convolution a plain nn.Conv3d: the port before SwapGradConv3d;
- search: as heuristic with cudnn.benchmark on (PyTorch times up to
  cudnn.benchmark_limit engines at each new shape and keeps the fastest);
- ndhwc: the volume and the weights in torch.channels_last_3d, heuristic;
- search+ndhwc: both;
- port: SwappedWgradConv3d, models/unet3d.SwapGradConv3d with the
  filter gradient of the swapped problem on cuDNN
  (unet3d.swapped_weight_grad; the input gradient as a forward
  convolution), heuristic: the port before the filter-gradient kernel;
- kernel: the U-Net as the port runs it: SwapGradConv3d with the filter
  gradient on the port's kernel (unet3d.weight_grad: csrc/conv3d_wgrad.cu
  on a card, the swapped problem on the CPU).

PyTorch keeps the plans it chose for the life of the process, so each
candidate runs in a process of its own, where every search starts cold.
Prints, each candidate:
- the set-up: the first call of each convolution at each direction (where
  the search runs), then the first forward+backward of the U-Net at
  --batch and its first eval forward at --eval-batch, each less a warm
  one, and the peak memory;
- the U-Net's forward and backward device ms at --batch (CUDA events,
  mean of --reps), the eval forward (no_grad) at --eval-batch, the share
  of the 67 TFLOP/s f32 roofline of each, and the number and device ms of
  `aten::copy_` calls in one forward+backward (layout copies);
- for each convolution (UNet3D's 14 3x3x3 and its final 1x1x1;
  ResidualUNet3D's 27 and its final one; not the transposed ones): the
  device ms of its forward, dgrad (input gradient) and wgrad (filter
  gradient), each alone at the U-Net's shapes and strides (as the
  candidate asks for it: aten.convolution_backward asked for one
  gradient, or unet3d.input_grad / weight_grad), the kernel that
  takes most of it (torch.profiler key_averages) and its share of the f32
  roofline (2 k^3 B V Cin Cout operations a direction);
- the largest difference of its output, input gradient and parameter
  gradients at --cmp-batch from heuristic's, over the largest magnitude.
The `flags` process asks which flags the backward reads: one convolution
(the U-Net's first, at a batch no other call uses) with its forward under
the search and its backward outside it, and the other way round, beside
both directions under each; the backward's kernels each time; and
whether a heuristic call at a shape the search has seen takes the
searched plan.
Writes everything as JSON to --out. Needs a CUDA device; --device cpu
runs the same code at a tiny size to find faults (no cuDNN there, and its
numbers mean nothing).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from garmentnets_tpu_torch.models import unet3d
from garmentnets_tpu_torch.models.pipeline import UNETS, PipelineConfig
from garmentnets_tpu_torch.tools.profile_encode import _device_ms

F32_PEAK = 67e12          # FLOP/s of f32 outside the tensor cores (H100 SXM)
CL = torch.channels_last_3d
NCDHW = torch.contiguous_format


class SwappedWgradConv3d(unet3d.SwapGradConv3d):
    """SwapGradConv3d whose filter gradient is the swapped problem on every
    device (unet3d.swapped_weight_grad): the port before the
    filter-gradient kernel."""
    wgrad = staticmethod(unet3d.swapped_weight_grad)

    def forward(self, x):
        return unet3d._SwapGrad.apply(x, self.weight, self.bias,
                                      self.padding, self.wgrad)


# name: (cudnn.benchmark, layout, the module of each 3x3x3 convolution)
CANDIDATES = {
    "heuristic": (False, NCDHW, torch.nn.Conv3d),
    "search": (True, NCDHW, torch.nn.Conv3d),
    "ndhwc": (False, CL, torch.nn.Conv3d),
    "search+ndhwc": (True, CL, torch.nn.Conv3d),
    "port": (False, NCDHW, SwappedWgradConv3d),
    "kernel": (False, NCDHW, unet3d.SwapGradConv3d),
}
# pytorch-3dunet's ResidualUNet3D class defaults (the residual cell's)
RESIDUAL = dict(f_maps=64, num_levels=5)
DIRECTIONS = ("fprop", "dgrad", "wgrad")


@contextlib.contextmanager
def cudnn_flags(benchmark: bool):
    """f32 with TF32 off, cuDNN's search on or off."""
    c = torch.backends.cudnn
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with c.flags(enabled=c.enabled, benchmark=benchmark,
                     deterministic=False, allow_tf32=False):
            yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


class _Clock:
    """Device ms between marks: CUDA events on a card, the host clock
    (after a wait) on the CPU."""

    def __init__(self, dev):
        self.dev = dev

    def mark(self):
        if self.dev.type == "cuda":
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b) -> float:
        if self.dev.type == "cuda":
            b.synchronize()
            return a.elapsed_time(b)
        return (b - a) * 1e3


def _top_kernels(fn, dev, calls: int = 2) -> list:
    """[(kernel name, share of the device time)] of `calls` calls of fn,
    the largest first, down to 5% (no kernels on the CPU). A profile that
    caught no kernel on a card is taken once more."""
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    for _ in range(2):
        _sync(dev)
        with profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            _sync(dev)
        rows = [(e.key, _device_ms(e)) for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA")
                and _device_ms(e) > 0]
        if rows or dev.type != "cuda":
            break
    total = sum(ms for _, ms in rows) or 1.0
    return [(k, ms / total) for k, ms in sorted(rows, key=lambda r: -r[1])
            if ms / total >= 0.05]


def _copies(fn, dev) -> tuple:
    """(calls, device ms) of aten::copy_ in one call of fn."""
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        fn()
        _sync(dev)
    for e in prof.key_averages():
        if e.key == "aten::copy_":
            ms = getattr(e, "device_time_total",
                         getattr(e, "cuda_time_total", 0.0))
            return int(e.count), ms / 1e3
    return 0, 0.0


def build_unet(dev, layout, conv_cls=unet3d.SwapGradConv3d, seed: int = 0,
               unet: str = "UNet3D") -> torch.nn.Module:
    """The pipeline's U-Net (unet "UNet3D") or the residual one
    ("ResidualUNet3D", RESIDUAL's widths), each SwapGradConv3d replaced
    by a conv_cls with the same weights (nn.Conv3d: the port before
    SwapGradConv3d)."""
    c = PipelineConfig()
    torch.manual_seed(seed)
    widths = (dict(f_maps=c.unet_f_maps, num_levels=c.unet_num_levels)
              if unet == "UNet3D" else RESIDUAL)
    net = UNETS[unet](c.unet_in_channels, c.unet_out_channels,
                             layer_order=c.unet_layer_order,
                             num_groups=c.unet_num_groups,
                             **widths).to(dev)
    if conv_cls is not unet3d.SwapGradConv3d:
        for m in list(net.modules()):
            conv = getattr(m, "conv", None)
            if isinstance(conv, unet3d.SwapGradConv3d):
                other = conv_cls(
                    conv.in_channels, conv.out_channels, conv.kernel_size,
                    padding=conv.padding,
                    bias=conv.bias is not None).to(dev)
                other.load_state_dict(conv.state_dict())
                m.conv = other
    return net.to(memory_format=layout)


def unet_apply(net: torch.nn.Module, x, layout):
    """UNet3D.forward with the volume in `layout` inside:
    [B, D, H, W, C] -> [B, D, H, W, C_out]."""
    h = x.permute(0, 4, 1, 2, 3)
    if layout is not CL:
        h = h.contiguous()
    h = net.abstract_3d_unet(h)
    return h.permute(0, 2, 3, 4, 1).contiguous()


def conv_specs(net, x, layout) -> list:
    """Each Conv3d's input, weight and output shapes and strides, in
    module order, from one forward (no grad) of unet_apply."""
    specs, hooks = [], []
    for name, m in net.named_modules():
        if isinstance(m, torch.nn.Conv3d):
            def hook(mod, args, out, name=name):
                specs.append({
                    "name": name.replace("abstract_3d_unet.", ""),
                    "x": (tuple(args[0].shape), args[0].stride()),
                    "w": (tuple(mod.weight.shape), mod.weight.stride()),
                    "y": (tuple(out.shape), out.stride()),
                    "padding": tuple(mod.padding),
                    "swap": isinstance(mod, unet3d.SwapGradConv3d)})
            hooks.append(m.register_forward_hook(hook))
    with torch.no_grad():
        unet_apply(net, x, layout)
    for h in hooks:
        h.remove()
    return specs


def wgrad_shapes(unet: str, batch: int, volume: int) -> list:
    """The distinct (B, Cin, Cout, side) of `unet`'s 3x3x3 convolutions
    (the filter-gradient kernel's problems) at a [batch, volume^3] input,
    in module order, from a forward on the meta device."""
    with torch.device("meta"):
        specs = conv_specs(build_unet("meta", NCDHW, unet=unet),
                           torch.empty(batch, volume, volume, volume,
                                       PipelineConfig().unet_in_channels),
                           NCDHW)
    shapes = []
    for s in specs:
        shape = (s["x"][0][0], s["x"][0][1], s["w"][0][0], s["x"][0][2])
        if s["swap"] and shape not in shapes:
            shapes.append(shape)
    return shapes


def conv_flops(spec) -> float:
    """2 k^3 B V Cin Cout: the operations of one direction."""
    (b, cin, *_), (cout, _, *k) = spec["x"][0], spec["w"][0]
    vox = 1
    for s in spec["y"][0][2:]:
        vox *= s
    kk = 1
    for s in k:
        kk *= s
    return 2.0 * kk * b * vox * cin * cout


def _strided(shape_stride, dev, gen):
    shape, stride = shape_stride
    t = torch.empty_strided(shape, stride, device=dev)
    return t.normal_(generator=gen)


def conv_direction_fns(spec, dev, gen, conv_cls) -> dict:
    """The forward, input gradient and filter gradient of one convolution:
    the gradients as conv_cls takes them where the U-Net's module is a
    SwapGradConv3d, else aten.convolution_backward asked for one."""
    x = _strided(spec["x"], dev, gen)
    w = _strided(spec["w"], dev, gen)
    gy = _strided(spec["y"], dev, gen)
    p, s1, z = list(spec["padding"]), [1, 1, 1], [0, 0, 0]
    fns = {"fprop": lambda: F.conv3d(x, w, None, 1, spec["padding"])}
    if spec["swap"]:
        wgrad = getattr(conv_cls, "wgrad", unet3d.weight_grad)
        fns["dgrad"] = lambda: unet3d.input_grad(gy, w, spec["padding"])
        fns["wgrad"] = lambda: wgrad(gy, x, w, spec["padding"])
        return fns

    def grad(mask):
        return lambda: torch.ops.aten.convolution_backward(
            gy, x, w, None, s1, p, s1, False, z, 1, mask)
    fns["dgrad"] = grad([True, False, False])
    fns["wgrad"] = grad([False, True, False])
    return fns


def timed(fn, clock, reps: int) -> float:
    fn()                                   # the search, at a new shape
    a = clock.mark()
    for _ in range(reps):
        fn()
    return clock.ms(a, clock.mark()) / reps


def _max_rel(a, b) -> float:
    scale = float(b.abs().max()) or 1.0
    return float((a - b).abs().max()) / scale


def _first_s(fn, dev) -> float:
    """Host seconds of one call of fn, waited for: at a new shape under
    the search, the search's cost."""
    _sync(dev)
    t0 = time.perf_counter()
    fn()
    _sync(dev)
    return time.perf_counter() - t0


def run_candidate(name: str, args, dev) -> dict:
    """One candidate in a fresh process: each convolution alone first (its
    first call at each direction is where the search, if on, runs and is
    timed), then the whole U-Net and its eval forward, then the output
    and gradients at --cmp-batch for the comparison."""
    benchmark, layout, conv_cls = CANDIDATES[name]
    clock = _Clock(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    c = PipelineConfig()
    V, C = args.volume, c.unet_in_channels
    out = {"candidate": name}
    with torch.device("meta"):     # the shapes and strides, no plan cached
        specs = conv_specs(build_unet("meta", layout, conv_cls,
                                      unet=args.unet),
                           torch.empty(args.batch, V, V, V, C), layout)
    with cudnn_flags(benchmark):
        convs = []
        for spec in specs:
            row = {"name": spec["name"], "flops": conv_flops(spec),
                   "x": spec["x"][0], "w": spec["w"][0]}
            for d, fn in conv_direction_fns(spec, dev, gen, conv_cls).items():
                row[d + "_first_s"] = _first_s(fn, dev)
                row[d + "_ms"] = timed(fn, clock, args.reps)
                row[d + "_kernels"] = _top_kernels(fn, dev)
            convs.append(row)
        out["convs"] = convs

        net = build_unet(dev, layout, conv_cls, unet=args.unet)
        x = torch.randn(args.batch, V, V, V, C, device=dev, generator=gen)
        x.requires_grad_(True)
        gy = torch.randn(args.batch, V, V, V, c.unet_out_channels,
                         device=dev, generator=gen)

        def step():
            unet_apply(net, x, layout).backward(gy)

        out["first_step_s"] = _first_s(step, dev)
        out["warm_step_s"] = _first_s(step, dev)
        fwd = bwd = 0.0
        for _ in range(args.reps):
            a = clock.mark()
            y = unet_apply(net, x, layout)
            b = clock.mark()
            y.backward(gy)
            e = clock.mark()
            fwd += clock.ms(a, b)
            bwd += clock.ms(b, e)
        out["forward_ms"], out["backward_ms"] = (fwd / args.reps,
                                                 bwd / args.reps)
        out["copies"] = _copies(step, dev)
        out["step_kernels"] = _top_kernels(step, dev, calls=1)

        xe = torch.randn(args.eval_batch, V, V, V, C, device=dev,
                         generator=gen)
        with torch.no_grad():
            def evaluate():
                unet_apply(net, xe, layout)
            out["first_eval_s"] = _first_s(evaluate, dev)
            out["warm_eval_s"] = _first_s(evaluate, dev)
            out["eval_forward_ms"] = timed(evaluate, clock, args.reps)
        if dev.type == "cuda":
            out["peak_bytes"] = int(torch.cuda.max_memory_allocated())

        # the output and gradients at a small batch, for the comparison
        cmp_net = build_unet(dev, layout, conv_cls, seed=2, unet=args.unet)
        g2 = torch.Generator(device=dev).manual_seed(3)
        xc = torch.randn(args.cmp_batch, V, V, V, C, device=dev,
                         generator=g2).requires_grad_(True)
        gc = torch.randn(args.cmp_batch, V, V, V, c.unet_out_channels,
                         device=dev, generator=g2)
        yc = unet_apply(cmp_net, xc, layout)
        yc.backward(gc)
        torch.save({"output": yc.detach().cpu(), "input": xc.grad.cpu(),
                    **{k: p.grad.contiguous().cpu()
                       for k, p in cmp_net.named_parameters()}},
                   os.path.join(args.tmp, f"{name}.pt"))
    return out


def run_flags(args, dev) -> dict:
    """The backward's kernels of the U-Net's first convolution when the
    search is on in its forward only, in its backward only, in both, in
    neither; each at a batch of its own, so that no plan is cached."""
    c = PipelineConfig()
    V, C = args.volume, c.unet_in_channels
    gen = torch.Generator(device=dev).manual_seed(4)
    conv = torch.nn.Conv3d(C, C, 3, padding=1, bias=False).to(dev)
    out = {}
    cases = {"neither": (False, False), "both": (True, True),
             "forward_only": (True, False), "backward_only": (False, True)}
    for i, (case, (fwd_search, bwd_search)) in enumerate(cases.items()):
        b = max(1, args.batch - 1 - i)
        x = torch.randn(b, C, V, V, V, device=dev, generator=gen)
        x.requires_grad_(True)
        with cudnn_flags(fwd_search):
            y = conv(x)
        gy = torch.randn_like(y)

        def backward():
            with cudnn_flags(bwd_search):
                torch.autograd.grad(y, (x, conv.weight), gy,
                                    retain_graph=True)
        out[case] = {"batch": b, "backward_kernels": _top_kernels(
            backward, dev)}
    names = {k: sorted(n for n, _ in v["backward_kernels"])
             for k, v in out.items()}
    if names["neither"] != names["both"]:
        out["backward_reads_flags_at_backward_time"] = (
            names["forward_only"] == names["neither"]
            and names["backward_only"] == names["both"])
    else:
        out["backward_reads_flags_at_backward_time"] = None  # same engines

    # a heuristic call at a shape the search has seen
    b = max(1, args.batch - 5)
    x = torch.randn(b, C, V, V, V, device=dev, generator=gen)
    with cudnn_flags(True):
        searched = _top_kernels(lambda: conv(x), dev)
    with cudnn_flags(False):
        after = _top_kernels(lambda: conv(x), dev)
    out["heuristic_after_search"] = {"searched": searched, "after": after,
                                     "same": [n for n, _ in searched]
                                     == [n for n, _ in after]}
    return out


def _short(name: str, n: int = 64) -> str:
    return name if len(name) <= n else name[:n - 1] + "~"


def _kernel(ks) -> str:
    return _short(ks[0][0]) if ks else "-"


def _share(flops: float, ms: float) -> float:
    return 100.0 * flops / (ms * 1e-3) / F32_PEAK if ms > 0 else 0.0


def report(res: dict, args) -> None:
    print(f"device: {res['device']}; {res['smi']}; torch "
          f"{res['torch']}, CUDA {res['cuda']}, cuDNN {res['cudnn']}")
    print(f"{args.unet} at B={args.batch}, {args.volume}^3, f32 with TF32 "
          f"off; eval forward at B={args.eval_batch}; shares of "
          f"{F32_PEAK / 1e12:.0f} TFLOP/s")
    heur = res["candidates"]["heuristic"]
    total = sum(r["flops"] for r in heur["convs"])
    total_e = total * args.eval_batch / args.batch
    print(f"{'candidate':21s} {'fwd ms':>7s} {'bwd ms':>7s} {'f+b ms':>7s}"
          f" {'f+b %':>5s} {'eval ms':>7s} {'eval %':>6s} {'copies':>10s}"
          f" {'first s f/d/w':>17s} {'step s':>6s} {'eval s':>6s}"
          f" {'peak GB':>7s} {'max rel diff':>12s}")
    for name, r in res["candidates"].items():
        fb = r["forward_ms"] + r["backward_ms"]
        first = "/".join(
            f"{sum(row[d + '_first_s'] for row in r['convs']):.1f}"
            for d in DIRECTIONS)
        print(f"{name:21s} {r['forward_ms']:7.2f} {r['backward_ms']:7.2f}"
              f" {fb:7.2f} {_share(3 * total, fb):5.1f}"
              f" {r['eval_forward_ms']:7.2f}"
              f" {_share(total_e, r['eval_forward_ms']):6.1f}"
              f" {r['copies'][0]:4d}/{r['copies'][1]:5.1f}"
              f" {first:>17s}"
              f" {r['first_step_s'] - r['warm_step_s']:6.2f}"
              f" {r['first_eval_s'] - r['warm_eval_s']:6.2f}"
              f" {r.get('peak_bytes', 0) / 1e9:7.2f}"
              f" {res['diff'].get(name, 0.0):12.3e}")
    print("(first s: the first calls of each direction, convolution by "
          "convolution, where a search runs; step s and eval s: the U-Net's "
          "first call less a warm one, after them)")
    for name, r in res["candidates"].items():
        print(f"\n{name}: per convolution, ms (share of the f32 roofline), "
              "first call s, the leading kernel")
        for row in r["convs"]:
            io = f"{row['x'][1]}->{row['w'][0]}"
            print(f"  {row['name']:36s} {io:>9s}"
                  f" {row['flops'] / 1e9:7.1f} GFLOP")
            for d in DIRECTIONS:
                ms = row[d + "_ms"]
                print(f"    {d}: {ms:8.3f} ({_share(row['flops'], ms):5.1f}%)"
                      f" {row[d + '_first_s']:6.2f} s"
                      f"  {_kernel(row[d + '_kernels'])}")
        sums = {d: sum(row[d + "_ms"] for row in r["convs"])
                for d in DIRECTIONS}
        print("  sum: " + ", ".join(
            f"{d} {ms:.2f} ms ({_share(total, ms):.1f}%)"
            for d, ms in sums.items()))
        print("  step's leading kernels: " + "; ".join(
            f"{_short(k, 48)} {100 * s:.0f}%" for k, s in r["step_kernels"]))
    f = res.get("flags")
    if f is None:
        return
    print("\nflags the backward reads (first convolution, kernels by case):")
    for case in ("neither", "both", "forward_only", "backward_only"):
        print(f"  {case:14s} B={f[case]['batch']}: " + "; ".join(
            _short(k, 56) for k, _ in f[case]["backward_kernels"]))
    print(f"  backward reads cuDNN's flags at backward time: "
          f"{f['backward_reads_flags_at_backward_time']}")
    h = f["heuristic_after_search"]
    print(f"  a heuristic call after a searched one at the same shape "
          f"takes the searched plan: {h['same']} "
          f"({_kernel(h['searched'])} / {_kernel(h['after'])})")


def _card(dev) -> tuple:
    if dev.type != "cuda":
        return "cpu", "no nvidia-smi"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError) as e:
        smi = f"nvidia-smi failed: {e}"
    return torch.cuda.get_device_name(0), smi


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--eval-batch", type=int, default=8)
    ap.add_argument("--cmp-batch", type=int, default=2)
    ap.add_argument("--volume", type=int, default=32)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--unet", default="UNet3D", choices=tuple(UNETS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="profile_unet3d.json")
    ap.add_argument("--candidates", default=",".join(CANDIDATES),
                    help="comma-separated; heuristic is always run")
    ap.add_argument("--no-flags", action="store_true",
                    help="leave out the flags process")
    ap.add_argument("--child", default=None,
                    choices=tuple(CANDIDATES) + ("flags",))
    ap.add_argument("--tmp", default=None)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_unet3d: no CUDA device (--device cpu "
                         "for a dry run)")
    if args.child is not None:
        res = (run_flags(args, dev) if args.child == "flags"
               else run_candidate(args.child, args, dev))
        with open(os.path.join(args.tmp, f"{args.child}.json"), "w") as f:
            json.dump(res, f)
        return

    base = list(argv if argv is not None else sys.argv[1:])
    res = {"candidates": {}, "diff": {}}
    res["device"], res["smi"] = _card(dev)
    res.update(torch=torch.__version__, cuda=torch.version.cuda,
               cudnn=torch.backends.cudnn.version())
    with tempfile.TemporaryDirectory() as tmp:
        names = ["heuristic"] + [n for n in args.candidates.split(",")
                                 if n != "heuristic"]
        for n in names:
            if n not in CANDIDATES:
                raise SystemExit(f"unknown candidate {n!r}")
        for child in names + ([] if args.no_flags else ["flags"]):
            t0 = time.perf_counter()
            subprocess.run([sys.executable, "-m", __spec__.name, *base,
                            "--child", child, "--tmp", tmp], check=True)
            print(f"{child}: {time.perf_counter() - t0:.1f} s",
                  file=sys.stderr, flush=True)
            with open(os.path.join(tmp, f"{child}.json")) as f:
                got = json.load(f)
            if child == "flags":
                res["flags"] = got
            else:
                res["candidates"][child] = got
        ref = torch.load(os.path.join(tmp, "heuristic.pt"))
        for name in names:
            got = torch.load(os.path.join(tmp, f"{name}.pt"))
            res["diff"][name] = max(_max_rel(got[k], ref[k]) for k in ref)
    report(res, args)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
