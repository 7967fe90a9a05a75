"""Plain PyTorch reference of the GarmentNets pipeline, for judging how the
port trains.

Written from the published architecture (PointNet++ NOCS stage 1, volume
aggregation, 3D U-Net 'gcr', implicit WNF decoders) in plain torch
operations, float32, with no kernel, cache or batching of the port. It
reads the weights by the public reference's state-dict key names, so the
benchmark hands the same seeded tensors to both sides. Nothing of the
port is imported.

Forward functions take `p`, a dict of tensors keyed like the reference
Lightning state dict under a prefix, and `train`: in training mode every
BatchNorm normalizes with the batch statistics (over the valid neighbour
slots in a set abstraction), biased variance, and returns its running
statistics updated with momentum 0.1 and the unbiased variance in
`bn_out`; in eval mode it uses the running statistics.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
DROPOUT_RATE = 0.5
BALL_K = 64


# ---------------------------------------------------------------------------
# point sampling and grouping
# ---------------------------------------------------------------------------
def fps(pos: torch.Tensor, m: int) -> torch.Tensor:
    """Furthest point sampling from index 0, first-occurrence argmax of the
    running minimum of squared distances (dx*dx + dy*dy + dz*dz)."""
    B, N, _ = pos.shape
    idx = torch.zeros((B, m), dtype=torch.int64, device=pos.device)
    min_d = torch.full((B, N), float("inf"), device=pos.device,
                       dtype=pos.dtype)
    rows = torch.arange(B, device=pos.device)
    last = idx[:, 0]
    for i in range(1, m):
        d = pos - pos[rows, last][:, None, :]
        d = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        min_d = torch.minimum(min_d, d)
        last = torch.argmax(min_d, dim=-1)
        idx[:, i] = last
    return idx


def gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src [B, N, C], idx [B, ...] -> [B, ..., C]."""
    B, _, C = src.shape
    flat = idx.reshape(B, -1)
    return torch.gather(src, 1, flat[..., None].expand(-1, -1, C)).reshape(
        *idx.shape, C)


def ball_query(points, centers, radius: float, k: int = BALL_K,
               chunk: int = 256):
    """The k nearest points within `radius` of each center, by the exact
    squared distance, ties to the lower index; slots beyond the points
    within the radius are masked off."""
    N = points.shape[1]
    r2 = float(np.float32(radius) ** 2)
    idx_out, mask_out = [], []
    for c in torch.split(centers, chunk, dim=1):
        d = points[:, None, :, :] - c[:, :, None, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        d2, idx = torch.sort(d2, dim=-1, stable=True)
        idx_out.append(idx[..., :k])
        mask_out.append(d2[..., :k] <= r2)
    return torch.cat(idx_out, 1), torch.cat(mask_out, 1)


def sq_dists(a, b):
    """|a - b|^2 [B, M, N] by the matrix-product expansion
    |a|^2 - 2 a.b + |b|^2, as torch.cdist and the published PointNet++
    implementations compute it for the nearest-neighbour search."""
    return ((a * a).sum(-1, keepdim=True) - 2.0 * torch.bmm(a, b.transpose(1, 2))
            + (b * b).sum(-1)[:, None, :])


def knn_interpolate(feat, src_pos, dst_pos, k: int):
    """Inverse squared distance weights over the k nearest sources."""
    d2 = sq_dists(dst_pos, src_pos)
    kk = min(k, src_pos.shape[1])
    d2k, idx = torch.topk(d2, kk, dim=-1, largest=False)
    w = 1.0 / torch.clamp(d2k, min=1e-16)
    f = gather(feat, idx)
    return (w[..., None] * f).sum(2) / w.sum(2, keepdim=True)


# ---------------------------------------------------------------------------
# MLP with BatchNorm
# ---------------------------------------------------------------------------
def _layer_count(p: dict, prefix: str) -> int:
    n = 0
    while f"{prefix}{n}.0.weight" in p:
        n += 1
    return n


def batch_norm(x, p, prefix, train: bool, bn_out: Optional[dict],
               mask=None):
    w, b = p[prefix + "weight"], p[prefix + "bias"]
    if not train:
        mean, var = p[prefix + "running_mean"], p[prefix + "running_var"]
        return (x - mean) / torch.sqrt(var + BN_EPS) * w + b
    dims = tuple(range(x.dim() - 1))
    if mask is None:
        n = float(x[..., 0].numel())
        mean = x.mean(dims)
        var = ((x - mean) ** 2).mean(dims)
        n1 = max(n - 1.0, 1.0)
    else:
        m = mask.to(x.dtype)[..., None]
        n = torch.clamp(m.sum(), min=1.0)
        mean = (x * m).sum(dims) / n
        var = (((x - mean) ** 2) * m).sum(dims) / n
        n1 = torch.clamp(n - 1.0, min=1.0)
    if bn_out is not None:
        with torch.no_grad():
            bn_out[prefix + "running_mean"] = (
                (1 - BN_MOMENTUM) * p[prefix + "running_mean"]
                + BN_MOMENTUM * mean.detach())
            bn_out[prefix + "running_var"] = (
                (1 - BN_MOMENTUM) * p[prefix + "running_var"]
                + BN_MOMENTUM * (var * n / n1).detach())
    return (x - mean) / torch.sqrt(var + BN_EPS) * w + b


def mlp(x, p, prefix, train=False, bn_out=None, mask=None):
    """Per layer Linear -> ReLU -> BatchNorm, keys `{prefix}{i}.0.*` and
    `{prefix}{i}.2.*`."""
    for i in range(_layer_count(p, prefix)):
        x = torch.relu(F.linear(x, p[f"{prefix}{i}.0.weight"],
                                p[f"{prefix}{i}.0.bias"]))
        if f"{prefix}{i}.2.weight" in p:
            x = batch_norm(x, p, f"{prefix}{i}.2.", train, bn_out, mask)
    return x


def dropout(h, train: bool, generator):
    """Keep with probability 1 - rate, scaled by 1 / (1 - rate); the mask
    drawn from `generator` by one torch.rand of h's shape."""
    if not train:
        return h
    keep = 1.0 - DROPOUT_RATE
    u = torch.rand(h.shape, generator=generator, device=h.device,
                   dtype=h.dtype)
    return torch.where(u < keep, h / keep, torch.zeros_like(h))


# ---------------------------------------------------------------------------
# stage 1: PointNet++ NOCS
# ---------------------------------------------------------------------------
def set_abstraction(x, pos, p, prefix, ratio, radius, train, bn_out):
    B, N, C = x.shape
    m = int(N * ratio)
    centers = gather(pos, fps(pos, m))
    idx, mask = ball_query(pos, centers, radius)
    nbr = gather(torch.cat([x, pos], -1), idx)
    h = torch.cat([nbr[..., :C], nbr[..., C:] - centers[:, :, None]], -1)
    h = mlp(h, p, prefix + "conv.local_nn.", train, bn_out,
            mask if train else None)
    h = h.masked_fill(~mask[..., None], float("-inf"))
    return h.amax(2), centers


def stage1(p: dict, cfg: dict, x, pos, train=False, bn_out=None,
           generator=None, prefix="") -> dict:
    """PointNet2NOCS forward -> per-point features and logits, global
    logits. cfg: the stage-1 model block (ratios, radii, k, dropout)."""
    q = prefix
    drop = train and cfg["dropout"]
    sa1_x, sa1_pos = set_abstraction(x, pos, p, q + "sa1_module.",
                                     cfg["sa1_ratio"], cfg["sa1_r"], train,
                                     bn_out)
    sa2_x, sa2_pos = set_abstraction(sa1_x, sa1_pos, p, q + "sa2_module.",
                                     cfg["sa2_ratio"], cfg["sa2_r"], train,
                                     bn_out)
    sa3_x = mlp(torch.cat([sa2_x, sa2_pos], -1), p, q + "sa3_module.nn.",
                train, bn_out).amax(1)
    sa3_pos = pos.new_zeros((pos.shape[0], 1, 3))
    h = knn_interpolate(sa3_x[:, None], sa3_pos, sa2_pos, cfg["fp3_k"])
    fp3 = mlp(torch.cat([h, sa2_x], -1), p, q + "fp3_module.nn.", train,
              bn_out)
    h = knn_interpolate(fp3, sa2_pos, sa1_pos, cfg["fp2_k"])
    fp2 = mlp(torch.cat([h, sa1_x], -1), p, q + "fp2_module.nn.", train,
              bn_out)
    h = knn_interpolate(fp2, sa1_pos, pos, cfg["fp1_k"])
    fp1 = mlp(torch.cat([h, x], -1), p, q + "fp1_module.nn.", train, bn_out)
    h = dropout(torch.relu(F.linear(fp1, p[q + "lin1.weight"],
                                    p[q + "lin1.bias"])), drop, generator)
    feat = dropout(F.linear(h, p[q + "lin2.weight"], p[q + "lin2.bias"]),
                   drop, generator)
    logits = F.linear(feat, p[q + "lin3.weight"], p[q + "lin3.bias"])
    g = dropout(torch.relu(sa3_x), drop, generator)
    g = dropout(F.linear(g, p[q + "global_lin1.weight"],
                         p[q + "global_lin1.bias"]), drop, generator)
    glog = F.linear(g, p[q + "global_lin2.weight"], p[q + "global_lin2.bias"])
    return {"features": feat, "logits": logits, "global_logits": glog}


def grid_idx(points, n: int):
    """Voxel index of points in [0, 1]^3 on an n^3 grid (truncation, then
    clamped)."""
    return torch.clamp((points * (n - 1)).to(torch.int64), 0, n - 1)


def nocs_bins(logits, bins: int):
    """Argmax bin's voxel-center NOCS point and its softmax probability,
    per axis."""
    lb = logits.reshape(*logits.shape[:-1], bins, 3)
    i = torch.argmax(lb, dim=-2)
    conf = torch.gather(torch.softmax(lb, -2), -2, i[..., None, :])[..., 0, :]
    return i.to(torch.float32) * (1.0 / (bins - 1)), conf


def bin_cross_entropy(logits, gt, bins: int):
    lb = logits.reshape(*logits.shape[:-1], bins, 3)
    logp = torch.log_softmax(lb, -2)
    return -torch.gather(logp, -2, grid_idx(gt, bins)[..., None, :]).mean()


# ---------------------------------------------------------------------------
# stage 2: aggregation, U-Net, decoders
# ---------------------------------------------------------------------------
def aggregate(p, features, nocs, sim_points, confidence, grid: int,
              train=False, bn_out=None):
    """Per-point MLP over [features, offset in the cell, sim point,
    confidence], max over each cell of a grid^3 volume -> [B, g, g, g, C]."""
    idx = grid_idx(nocs, grid)
    offset = nocs - idx.to(torch.float32) * (1.0 / (grid - 1))
    h = mlp(torch.cat([features, offset, sim_points, confidence], -1), p,
            "volume_agg.local_nn.", train, bn_out)
    B, N, C = h.shape
    flat = (idx[..., 0] * grid + idx[..., 1]) * grid + idx[..., 2]
    out = h.new_full((B, grid ** 3, C), float("-inf"))
    out = out.scatter_reduce(1, flat[..., None].expand(-1, -1, C), h, "amax")
    out = out.masked_fill(out == float("-inf"), 0.0)
    return out.reshape(B, grid, grid, grid, C)


def _single_conv(x, p, prefix, groups):
    gw = p[prefix + "groupnorm.weight"]
    x = F.group_norm(x, groups if gw.numel() >= groups else 1, gw,
                     p[prefix + "groupnorm.bias"], eps=1e-5)
    return torch.relu(F.conv3d(x, p[prefix + "conv.weight"], padding=1))


def unet3d(p, vol, groups: int, levels: int):
    """'gcr' U-Net: [B, D, H, W, C] -> [B, D, H, W, C_out]."""
    x = vol.permute(0, 4, 1, 2, 3)
    base = "unet_3d.abstract_3d_unet."
    skips = []
    for i in range(levels):
        if i:
            x = F.max_pool3d(x, 2)
        for j in (1, 2):
            x = _single_conv(x, p, f"{base}encoders.{i}.basic_module."
                             f"SingleConv{j}.", groups)
        skips.insert(0, x)
    for i, skip in enumerate(skips[1:]):
        x = x.repeat_interleave(2, 2).repeat_interleave(2, 3)
        x = x.repeat_interleave(2, 4)
        x = torch.cat([skip, x], 1)
        for j in (1, 2):
            x = _single_conv(x, p, f"{base}decoders.{i}.basic_module."
                             f"SingleConv{j}.", groups)
    x = F.conv3d(x, p[base + "final_conv.weight"], p[base + "final_conv.bias"])
    return x.permute(0, 2, 3, 4, 1)


def trilinear(volume, query):
    """volume [B, D, H, W, C], query [B, M, 3] in [0, 1] (axis 0 along D),
    align-corners, clamped to the volume -> [B, M, C]."""
    B, D, H, W, C = volume.shape
    dims = torch.tensor([D - 1, H - 1, W - 1], device=volume.device)
    q = torch.minimum(torch.clamp(query * dims.to(query.dtype), min=0.0),
                      dims.to(query.dtype))
    lo = torch.floor(q)
    f = q - lo
    lo = lo.to(torch.int64)
    hi = torch.minimum(lo + 1, dims)
    flat = volume.reshape(B, D * H * W, C)
    out = 0.0
    for cx in (0, 1):
        ix = hi[..., 0] if cx else lo[..., 0]
        wx = f[..., 0] if cx else 1 - f[..., 0]
        for cy in (0, 1):
            iy = hi[..., 1] if cy else lo[..., 1]
            wy = f[..., 1] if cy else 1 - f[..., 1]
            for cz in (0, 1):
                iz = hi[..., 2] if cz else lo[..., 2]
                wz = f[..., 2] if cz else 1 - f[..., 2]
                lin = (ix * H + iy) * W + iz
                v = torch.gather(flat, 1, lin[..., None].expand(-1, -1, C))
                out = out + (wx * wy * wz)[..., None] * v
    return out


def decoder(p, prefix, fv, query, train=False, bn_out=None):
    """Implicit decoder: the feature at the query (the reference samples
    its [B, C, X, Y, Z] volume with the query unflipped, i.e. at
    V[qz, qy, qx]) through the MLP."""
    return mlp(trilinear(fv, query.flip(-1)), p, prefix + "mlp.", train,
               bn_out)


# ---------------------------------------------------------------------------
# training losses and Adam
# ---------------------------------------------------------------------------
def stage1_loss(out, batch, cfg):
    bins = cfg["nocs_bins"]
    return (cfg["nocs_loss_weight"]
            * bin_cross_entropy(out["logits"], batch["y"], bins)
            + cfg["grip_point_loss_weight"]
            * bin_cross_entropy(out["global_logits"],
                                batch["nocs_grip_point"], bins))


def stage2_forward_loss(p, cfg, batch, grid, groups, levels, train=True,
                        bn_out=None, s1=None):
    """Stage 2's training loss on a batch -> (loss, s1): s1 the frozen
    stage 1's features and logits it used, its own (eval mode, no
    gradient) unless given."""
    if s1 is None:
        with torch.no_grad():
            s1 = stage1(p, cfg["pointnet2"], batch["x"], batch["pos"],
                        prefix="pointnet2_nocs.")
    nocs, conf = nocs_bins(s1["logits"], cfg["pointnet2"]["nocs_bins"])
    vol = aggregate(p, s1["features"], nocs, batch["pos"], conf, grid, train,
                    bn_out)
    fv = unet3d(p, vol, groups, levels)
    pv = decoder(p, "volume_decoder.", fv, batch["volume_query_points"],
                 train, bn_out)[..., 0]
    ps = decoder(p, "surface_decoder.", fv, batch["surf_query_points"],
                 train, bn_out)
    vl = ((pv - batch["gt_volume_value"]) ** 2).mean()
    sl = ((ps - batch["gt_sim_points"]) ** 2).mean()
    return (cfg["volume_loss_weight"] * vl + cfg["surface_loss_weight"] * sl,
            s1)


def nocs_gap(logits_got, logits_ref, bins: int):
    """(sum, count) over point axes of the gap between two stage-1 answers:
    the confidence gap where the NOCS bins agree, 1 where they differ."""
    n_g, c_g = nocs_bins(logits_got, bins)
    n_r, c_r = nocs_bins(logits_ref, bins)
    same = (n_g - n_r).abs() <= 0.25 / (bins - 1)
    return float(torch.where(same, (c_g - c_r).abs(), 1.0).sum()), same.numel()


class Adam:
    """Adam as optax.adam (b1 0.9, b2 0.999, eps 1e-8 outside the root)."""

    def __init__(self, params: dict, lr: float, betas=(0.9, 0.999),
                 eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[k].sqrt() / math.sqrt(c2) + self.eps
            params[k].sub_(self.lr / c1 * self.m[k] / denom)


class precision:
    """float32 matmuls and convolutions for the reference (TF32 off), or
    TF32 for the control (the nearest precision below float32); the
    previous settings restored after."""

    def __init__(self, tf32: bool):
        self.tf32 = tf32

    def __enter__(self):
        self.prev = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32,
                     torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        torch.set_float32_matmul_precision("high" if self.tf32 else "highest")

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, prec) = self.prev
        torch.set_float32_matmul_precision(prec)
