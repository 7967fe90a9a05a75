"""Device-side isosurface extraction for host marching cubes (torch port of
garmentnets_tpu/ops/isosurface.py; every byte layout is the JAX package's,
so the two are byte-identical).

Three formats, from the oldest to the engine's:

- extract_active_cubes: per-cube records (origin voxel index + 8 corner
  values, f16 or int8), compacted over the (S-1)^3 cube grid.
- extract_active_bricks (the engine's path): the volume is quantized to
  int8 once and reshaped into non-overlapping 4^3 "bricks" (64 B each,
  brick-major layout). The shipped set is the support-active blocks (5^3
  min/max pooling, window 5 stride 4: a cube straddles iff an adjacent
  voxel pair in some block's support straddles) dilated by one block in
  each negative-face direction, so every corner of every straddling cube
  lands in a shipped brick. The C++ marching-cubes kernel
  (ops/marching_cubes.marching_cubes_bricks) discovers the straddling
  cubes from the bricks itself, or reads them from the per-brick straddle
  masks that `with_masks` appends (the engine's default at >= 192^3).
- extract_crossing_edges: the iso-crossing grid edges of the shipped
  bricks (the marching-cubes vertices, 1:1) in a canonical (brick rank,
  slot) order that the C++ kernel's vertex ranks reproduce.

Records travel in fixed-size uint8 pages; page 0 of the brick pages
carries the per-garment counts in a header row. Corner order is
marching_cubes.CUBE_CORNERS.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from garmentnets_tpu_torch.ops.marching_cubes import CUBE_CORNERS

VAL_QUANT_SCALE = 254.0  # int8: (v - level) * 254 in [-127, 127]
BLOCK = 4          # voxels per brick edge
EDGE_SLOTS = 192   # 3 directions x 64 local edge origins per brick


def _quantize_vals(vals: torch.Tensor, level: float) -> torch.Tensor:
    """int8 side-preserving quantization: q >= 1 iff v > level, so the
    host's dequantized inside-test reproduces the device's float decision
    exactly. Rounds half to even, like jnp.round."""
    q = torch.round((vals - level) * VAL_QUANT_SCALE)
    q = torch.where(vals > level, torch.clamp(q, min=1.0),
                    torch.clamp(q, max=0.0))
    return torch.clamp(q, -127, 127).to(torch.int8)


def dequantize_vals(vals, level: float) -> np.ndarray:
    """Host inverse of the int8 quantization (a float array is returned as
    float32)."""
    vals = np.asarray(vals)
    if vals.dtype == np.int8:
        return vals.astype(np.float32) / VAL_QUANT_SCALE + level
    return vals.astype(np.float32)


def _cube_straddle(wnf: torch.Tensor, level: float) -> torch.Tensor:
    """[B, S, S, S] -> [B, S-1, S-1, S-1] bool: the cube whose origin is
    each voxel has corners on both sides of the level (v > level)."""
    s = wnf.shape[1] - 1
    inside = wnf > level
    corners = [inside[:, dx:s + dx, dy:s + dy, dz:s + dz]
               for dx, dy, dz in CUBE_CORNERS]
    any_in = functools.reduce(torch.logical_or, corners)
    all_in = functools.reduce(torch.logical_and, corners)
    return any_in & ~all_in


def _brick_major(vol: torch.Tensor, nb: int) -> torch.Tensor:
    """[B, S, S, S] -> [B, nb^3, 64]: 4^3 bricks in block C-order, each in
    local voxel C-order."""
    B = vol.shape[0]
    v = vol.reshape(B, nb, BLOCK, nb, BLOCK, nb, BLOCK)
    return v.permute(0, 1, 3, 5, 2, 4, 6).reshape(B, nb ** 3, 64)


def extract_active_cubes(wnf: torch.Tensor, level: float, cap: int,
                         quantize: bool = False):
    """wnf [B, S, S, S] -> (base_idx [B, cap] int32 flat C-order index of
    each straddling cube's origin voxel (-1 pad), vals [B, cap, 8] corner
    values (f16, or int8 side-preserving with `quantize`), counts [B]
    int32). counts may exceed cap."""
    B, S = wnf.shape[0], wnf.shape[1]
    s = S - 1
    flat = _cube_straddle(wnf, level).reshape(B, s ** 3)
    counts = flat.sum(dim=1).to(torch.int32)
    # compaction: the k-th straddling cube is the first index whose prefix
    # count reaches k + 1
    csum = torch.cumsum(flat.to(torch.int32), dim=1, dtype=torch.int32)
    targets = torch.arange(1, cap + 1, dtype=torch.int32, device=wnf.device)
    cube_idx = torch.searchsorted(csum, targets.expand(B, cap).contiguous())
    cube_idx = torch.where(targets[None, :] <= counts[:, None], cube_idx, -1)
    cz = cube_idx % s
    cy = (cube_idx // s) % s
    cx = cube_idx // (s * s)
    base = (cx * S + cy) * S + cz
    corner_off = torch.as_tensor(
        (CUBE_CORNERS[:, 0] * S + CUBE_CORNERS[:, 1]) * S
        + CUBE_CORNERS[:, 2], device=wnf.device)
    gather_idx = torch.clamp(base, min=0)[..., None] + corner_off
    vals = torch.gather(wnf.reshape(B, -1), 1,
                        gather_idx.reshape(B, -1)).reshape(B, cap, 8)
    base = torch.where(cube_idx >= 0, base, -1).to(torch.int32)
    if quantize:
        return base, _quantize_vals(vals, level), counts
    return base, vals.to(torch.float16), counts


def extract_active_bricks(wnf: torch.Tensor, level: float, brick_cap: int,
                          with_masks: bool = False):
    """wnf [B, S, S, S] -> (brick_idx [B, brick_cap] int32 flat index into
    the (S/4)^3 block grid (-1 pad), brick_vals [B, brick_cap, 64] int8
    quantized 4^3 voxel values in local C-order, counts [B] int32).

    S must be a multiple of 4. counts may exceed brick_cap (the host then
    falls back to the full-volume path). with_masks=True appends each
    brick's 64-bit cube-straddle mask as 8 little-endian bytes
    (brick_vals becomes [B, brick_cap, 72]; bit loc is the cube whose
    origin is local voxel loc), which lets the C++ kernel skip its
    rejection scan (marching_cubes_bricks(cube_masks=...))."""
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
    bricks = _brick_major(_quantize_vals(wnf, level), nb)
    if with_masks:
        # the straddle of each cube's forward 2^3 window, valid windows
        # only (high-edge voxels are no cube origins), padded with False
        straddle = torch.zeros_like(wnf, dtype=torch.bool)
        straddle[:, :S - 1, :S - 1, :S - 1] = _cube_straddle(wnf, level)
        bits = _brick_major(straddle, nb).reshape(B, nb ** 3, 8, 8)
        shifts = torch.arange(8, dtype=torch.uint8, device=wnf.device)
        mask_bytes = (bits.to(torch.uint8) << shifts).sum(
            dim=-1, dtype=torch.uint8)                   # [B, nb^3, 8]
        bricks = torch.cat([bricks, mask_bytes.view(torch.int8)], dim=-1)
    width = bricks.shape[-1]
    safe_idx = torch.where(valid, brick_idx, 0).to(torch.int64)
    vals = torch.gather(bricks, 1, safe_idx[..., None].expand(-1, -1, width))
    brick_idx = torch.where(valid, brick_idx, -1)
    if cap < brick_cap:
        brick_idx = F.pad(brick_idx, (0, brick_cap - cap), value=-1)
        vals = F.pad(vals, (0, 0, 0, brick_cap - cap))
    return brick_idx, vals, counts


def bricks_to_cube_list(brick_idx, brick_vals_q, level: float,
                        volume_size: int):
    """Host brick -> straddling-cube list of one garment (the numpy mirror
    of the C++ kernel's cube discovery): brick_idx [n] int32 block-grid
    indices, brick_vals_q [n, 64] int8 -> (cube_base [m] int64 flat voxel
    index of each cube origin, cube_vals [m, 8] float32), as
    extract_active_cubes gives them on the dequantized field."""
    S = volume_size
    nb = S // BLOCK
    brick_idx = np.asarray(brick_idx)
    keep = brick_idx >= 0
    brick_idx = brick_idx[keep].astype(np.int64)
    vals_q = np.asarray(brick_vals_q)[keep]
    if len(brick_idx) == 0:
        return (np.zeros((0,), np.int64), np.zeros((0, 8), np.float32))
    row_of = np.full(nb ** 3, -1, np.int64)
    row_of[brick_idx] = np.arange(len(brick_idx))
    # global voxel coordinates of every local voxel of every shipped brick
    bz = brick_idx % nb
    by = (brick_idx // nb) % nb
    bx = brick_idx // (nb * nb)
    loc = np.arange(BLOCK)
    lx, ly, lz = np.meshgrid(loc, loc, loc, indexing="ij")
    gx = bx[:, None] * BLOCK + lx.reshape(-1)[None, :]     # [n, 64]
    gy = by[:, None] * BLOCK + ly.reshape(-1)[None, :]
    gz = bz[:, None] * BLOCK + lz.reshape(-1)[None, :]
    # candidate cube origins (not on the high grid edge)
    cand = ((gx <= S - 2) & (gy <= S - 2) & (gz <= S - 2)).reshape(-1)
    cgx, cgy, cgz = (a.reshape(-1)[cand] for a in (gx, gy, gz))
    # 8 corner values through the brick rows; a missing brick skips the cube
    cx = cgx[:, None] + CUBE_CORNERS[None, :, 0]
    cy = cgy[:, None] + CUBE_CORNERS[None, :, 1]
    cz = cgz[:, None] + CUBE_CORNERS[None, :, 2]
    nbrick = row_of[((cx // BLOCK) * nb + (cy // BLOCK)) * nb
                    + (cz // BLOCK)]                       # [m, 8]
    ok = (nbrick >= 0).all(axis=1)
    local = ((cx % BLOCK) * BLOCK + (cy % BLOCK)) * BLOCK + (cz % BLOCK)
    qv = np.zeros((len(cgx), 8), np.int8)
    qv[ok] = vals_q[nbrick[ok], local[ok]]
    cube_vals = dequantize_vals(qv, level)
    inside = cube_vals > level
    active = ok & inside.any(axis=1) & ~inside.all(axis=1)
    base = (cgx.astype(np.int64) * S + cgy) * S + cgz
    return base[active], cube_vals[active]


def extract_crossing_edges(wnf: torch.Tensor, level: float,
                           brick_idx: torch.Tensor, edge_cap: int):
    """The crossing grid edges of the shipped bricks in canonical (brick
    rank, slot) order, slot = direction * 64 + local voxel of the edge's
    origin (its smaller endpoint).

    wnf [B, S, S, S], brick_idx [B, brick_cap] from extract_active_bricks
    (-1 pad) -> (edge_counts [B] int32, vert_pos [B, edge_cap, 3] float32:
    each edge's iso-crossing point in normalized lattice coordinates,
    grid index / (S - 1), zero-padded). counts may exceed edge_cap."""
    B, S = wnf.shape[0], wnf.shape[1]
    nb = S // BLOCK
    cap = brick_idx.shape[1]
    inside = wnf > level
    flags = []
    for axis in range(3):
        # the crossing flag of the edge leaving each voxel along `axis`;
        # the last slice has no outgoing edge
        x = inside ^ torch.roll(inside, -1, dims=axis + 1)
        x.select(axis + 1, S - 1).fill_(False)
        flags.append(_brick_major(x, nb))
    cross = torch.cat(flags, dim=-1)                      # [B, nb^3, 192]
    safe = torch.clamp(brick_idx, min=0).to(torch.int64)
    rows = torch.gather(cross, 1, safe[..., None].expand(-1, -1, EDGE_SLOTS))
    rows = rows & (brick_idx >= 0)[..., None]

    # compaction over the (brick rank, slot) order: a crossing edge's rank
    # is its output index
    csum = torch.cumsum(rows.reshape(B, cap * EDGE_SLOTS).to(torch.int32),
                        dim=1, dtype=torch.int32)
    counts = csum[:, -1]
    targets = torch.arange(1, edge_cap + 1, dtype=torch.int32,
                           device=wnf.device)
    pos = torch.searchsorted(csum, targets.expand(B, edge_cap).contiguous())
    pos = torch.clamp(pos, max=cap * EDGE_SLOTS - 1)
    br = pos // EDGE_SLOTS
    slot = pos % EDGE_SLOTS
    picked = torch.gather(safe, 1, br)
    d = slot // 64
    loc = slot % 64
    bx = (picked // (nb * nb)) * BLOCK + (loc >> 4)
    by = ((picked // nb) % nb) * BLOCK + ((loc >> 2) & 3)
    bz = (picked % nb) * BLOCK + (loc & 3)
    o_flat = (bx * S + by) * S + bz
    step = torch.where(d == 0, S * S, torch.where(d == 1, S, 1))
    wnf_flat = wnf.reshape(B, -1)
    va = torch.gather(wnf_flat, 1, o_flat)
    vb = torch.gather(wnf_flat, 1, o_flat + step)
    denom = torch.where(vb != va, vb - va, torch.ones_like(va))
    t = torch.clamp((level - va) / denom, 0.0, 1.0)
    base = torch.stack([bx, by, bz], dim=-1).to(torch.float32)
    offs = torch.stack([d == 0, d == 1, d == 2], dim=-1).to(torch.float32)
    # times the f32 reciprocal, as XLA compiles the JAX package's division
    vert = (base + t[..., None] * offs) * (1.0 / (S - 1))
    valid = targets[None, :] <= counts[:, None]
    vert = torch.where(valid[..., None], vert, torch.zeros_like(vert))
    return counts, vert


def crossing_edge_mask_np(brick_idx, brick_vals_q, level: float,
                          volume_size: int) -> np.ndarray:
    """Numpy mirror of the canonical crossing-edge enumeration for one
    garment: a [n_bricks, 192] bool mask in (brick rank, slot) order; the
    rank of a True entry in C-order is the device's edge index."""
    S = volume_size
    nb = S // BLOCK
    brick_idx = np.asarray(brick_idx)
    keep = brick_idx >= 0
    bidx = brick_idx[keep].astype(np.int64)
    vals = np.asarray(brick_vals_q)[keep]
    n = len(bidx)
    mask = np.zeros((len(brick_idx), EDGE_SLOTS), bool)
    if n == 0:
        return mask
    row_of = np.full(nb ** 3, -1, np.int64)
    row_of[bidx] = np.arange(n)
    inside = vals >= 1                      # side-preserving: q>=1 <=> v>level
    bz = bidx % nb
    by = (bidx // nb) % nb
    bx = bidx // (nb * nb)
    loc = np.arange(BLOCK)
    lx, ly, lz = np.meshgrid(loc, loc, loc, indexing="ij")
    lx, ly, lz = (a.reshape(-1) for a in (lx, ly, lz))
    gx = bx[:, None] * BLOCK + lx[None, :]
    gy = by[:, None] * BLOCK + ly[None, :]
    gz = bz[:, None] * BLOCK + lz[None, :]
    for d, (dx, dy, dz) in enumerate(((1, 0, 0), (0, 1, 0), (0, 0, 1))):
        ex, ey, ez = gx + dx, gy + dy, gz + dz
        ok = (ex <= S - 1) & (ey <= S - 1) & (ez <= S - 1)
        nbrick = row_of[np.clip(((ex // BLOCK) * nb + (ey // BLOCK)) * nb
                                + (ez // BLOCK), 0, nb ** 3 - 1)]
        ok &= nbrick >= 0
        # a crossing edge's far endpoint lies in a shipped brick (a corner
        # brick of a straddling cube), so rows with ok=False never cross
        other = np.zeros_like(inside, dtype=bool)
        li = ((ex % BLOCK) * BLOCK + (ey % BLOCK)) * BLOCK + (ez % BLOCK)
        other[ok] = inside[nbrick[ok], li[ok]]
        # local origins run in C-order, so the columns are in slot order
        rows = np.flatnonzero(keep)
        mask[rows, d * 64:(d + 1) * 64] = ok & (inside != other)
    return mask


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


def pack_active_pages(base: torch.Tensor, vals_q: torch.Tensor,
                      page: int) -> tuple:
    """Per-cube record pages [B, page, 12] uint8 (4 index + 8 int8 corner
    bytes), without a header."""
    return pack_brick_pages(base, vals_q, page)


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


def unpack_active_pages(pages, level: float):
    """Inverse of pack_active_pages, corner values dequantized:
    (base [B, n*page] int32, vals [B, n*page, 8] float32)."""
    base, payload = unpack_brick_pages(pages)
    return base, dequantize_vals(payload, level)


def split_brick_payload(payload):
    """(vals_q [.., 64] int8, cube_masks [.., 8] uint8 or None) from a
    brick page payload (72-byte records carry straddle masks)."""
    if payload.shape[-1] == 64:
        return payload, None
    if payload.shape[-1] != 72:
        raise ValueError(f"unexpected brick record width {payload.shape}")
    return payload[..., :64], payload[..., 64:].view(np.uint8)
