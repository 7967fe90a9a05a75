"""Device-side brick extraction for host marching cubes (torch port of the
production path of garmentnets_tpu/ops/isosurface.py).

The volume is quantized to int8 once and reshaped into non-overlapping 4^3
"bricks" (64 B each, brick-major layout). The shipped set is the
support-active blocks (5^3 min/max pooling, window 5 stride 4: a cube
straddles iff an adjacent voxel pair in some block's support straddles)
dilated by one block in each negative-face direction, so every corner of
every straddling cube lands in a shipped brick. The C++ marching-cubes
kernel (ops/marching_cubes.marching_cubes_bricks) discovers the straddling
cubes from the bricks itself. Records are packed into fixed-size uint8
pages whose first page carries the per-garment counts in a header row; the
byte layout is the JAX package's, so the two are byte-identical.

The per-brick straddle masks (`with_masks`, used at >= 192^3) are not
ported yet.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

VAL_QUANT_SCALE = 254.0  # int8: (v - level) * 254 in [-127, 127]
BLOCK = 4          # voxels per brick edge


def _quantize_vals(vals: torch.Tensor, level: float) -> torch.Tensor:
    """int8 side-preserving quantization: q >= 1 iff v > level, so the
    host's dequantized inside-test reproduces the device's float decision
    exactly. Rounds half to even, like jnp.round."""
    q = torch.round((vals - level) * VAL_QUANT_SCALE)
    q = torch.where(vals > level, torch.clamp(q, min=1.0),
                    torch.clamp(q, max=0.0))
    return torch.clamp(q, -127, 127).to(torch.int8)


def extract_active_bricks(wnf: torch.Tensor, level: float, brick_cap: int):
    """wnf [B, S, S, S] -> (brick_idx [B, brick_cap] int32 flat index into
    the (S/4)^3 block grid (-1 pad), brick_vals [B, brick_cap, 64] int8
    quantized 4^3 voxel values in local C-order, counts [B] int32).

    S must be a multiple of 4. counts may exceed brick_cap (the host then
    falls back to the full-volume path)."""
    B, S = wnf.shape[0], wnf.shape[1]
    if S % BLOCK:
        raise ValueError(f"volume size {S} is not a multiple of {BLOCK}")
    nb = S // BLOCK
    # support activity: 5^3 min/max pooling, stride 4, high-edge pad 1
    x = wnf[:, None]
    pad = (0, 1, 0, 1, 0, 1)
    bmax = F.max_pool3d(F.pad(x, pad, value=float("-inf")), 5, BLOCK)
    bmin = -F.max_pool3d(F.pad(-x, pad, value=float("-inf")), 5, BLOCK)
    active = ((bmin <= level) & (bmax > level)).to(torch.float32)
    # ship set: block b is shipped iff some block in b - {0,1}^3 is active
    shipped = F.max_pool3d(F.pad(active, (1, 0, 1, 0, 1, 0)), 2, 1) > 0
    flat = shipped.reshape(B, nb ** 3)
    counts = flat.sum(dim=1).to(torch.int32)

    # compaction: ascending sort of (shipped ? idx : 2^30)
    cap = min(brick_cap, nb ** 3)
    idx = torch.arange(nb ** 3, dtype=torch.int32, device=wnf.device)
    keys = torch.where(flat, idx[None, :], torch.full_like(idx, 2 ** 30))
    brick_idx = torch.sort(keys, dim=1).values[:, :cap]
    valid = (torch.arange(1, cap + 1, device=wnf.device)[None, :]
             <= counts[:, None])

    # brick-major int8 layout + contiguous row gather
    q = _quantize_vals(wnf, level)
    bricks = q.reshape(B, nb, BLOCK, nb, BLOCK, nb, BLOCK)
    bricks = bricks.permute(0, 1, 3, 5, 2, 4, 6).reshape(B, nb ** 3, 64)
    safe_idx = torch.where(valid, brick_idx, 0).to(torch.int64)
    vals = torch.gather(bricks, 1, safe_idx[..., None].expand(-1, -1, 64))
    brick_idx = torch.where(valid, brick_idx, -1)
    if cap < brick_cap:
        brick_idx = F.pad(brick_idx, (0, brick_cap - cap), value=-1)
        vals = F.pad(vals, (0, 0, 0, brick_cap - cap))
    return brick_idx, vals, counts


def _le_bytes(v: torch.Tensor) -> torch.Tensor:
    """int32 [...] -> its 4 little-endian bytes [..., 4] uint8."""
    u = v.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([(u >> (8 * i)) & 0xFF for i in range(4)],
                       dim=-1).to(torch.uint8)


def pack_brick_pages(base: torch.Tensor, vals_q: torch.Tensor, page: int,
                     counts=None) -> tuple:
    """(base [B, cap] int32, payload [B, cap, K] int8) -> tuple of
    [B, page, 4+K] uint8 pages (4 little-endian index bytes + K payload
    bytes per record). With `counts`, page 0 gains a header row
    ([B, 1+page, 4+K]) whose first 4 bytes carry the count little-endian.
    cap must be a multiple of page."""
    B, cap = base.shape
    if cap % page:
        raise ValueError(f"brick cap {cap} is not a multiple of page {page}")
    packed = torch.cat([_le_bytes(base), vals_q.view(torch.uint8)], dim=-1)
    pages = list(torch.split(packed, page, dim=1))
    if counts is not None:
        rec = packed.shape[-1]
        hdr = F.pad(_le_bytes(counts), (0, rec - 4))[:, None, :]
        pages[0] = torch.cat([hdr, pages[0]], dim=1)
    return tuple(pages)


def read_page_counts(page0) -> np.ndarray:
    """Decode the [B] int32 record counts from a header-stamped page 0."""
    h = np.asarray(page0)[:, 0, :4].astype(np.uint32)
    return (h[:, 0] | (h[:, 1] << 8) | (h[:, 2] << 16)
            | (h[:, 3] << 24)).view(np.int32)


def unpack_brick_pages(pages, header: bool = False):
    """Host inverse of pack_brick_pages over the fetched page prefix:
    (brick_idx [B, n*page] int32, payload [B, n*page, K] int8).
    header=True strips the page-0 count row."""
    arrs = [np.asarray(p) for p in pages]
    if header and arrs:
        arrs[0] = arrs[0][:, 1:]
    buf = np.concatenate(arrs, axis=1)
    base = (buf[:, :, 0].astype(np.uint32)
            | (buf[:, :, 1].astype(np.uint32) << 8)
            | (buf[:, :, 2].astype(np.uint32) << 16)
            | (buf[:, :, 3].astype(np.uint32) << 24)).view(np.int32)
    return base, buf[:, :, 4:].view(np.int8)


def split_brick_payload(payload):
    """(vals_q [.., 64] int8, cube_masks [.., 8] uint8 or None) from a
    brick page payload (72-byte records carry straddle masks)."""
    if payload.shape[-1] == 64:
        return payload, None
    if payload.shape[-1] != 72:
        raise ValueError(f"unexpected brick record width {payload.shape}")
    return payload[..., :64], payload[..., 64:].view(np.uint8)
