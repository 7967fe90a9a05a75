"""Synthetic garment dataset generator (reference zarr schema).

The port's copy of garmentnets_tpu/data/synthetic.py, on the port's own
marching cubes (the same ops/cpp/marching.cpp) and its plain gaussian
gradient magnitude on a CPU tensor: the same seed writes the same
dataset, so a machine without JAX can make its own data.

The reference trains on the CLOTH3D-derived garmentnets_dataset.zarr, which is
not redistributable with this repo; this module fabricates structurally
identical data — hanging-cloth meshes with NOCS correspondence, multi-view
point clouds, winding-number-field volumes, and GT marching-cube meshes —
written in the exact on-disk schema (SURVEY.md §2.4):

  samples/<key>: attrs {scale, gender, sample_id, garment_name,
                        grip_vertex_idx}
    point_cloud/{point, nocs, rgb, sizes}
    mesh/{cloth_verts, cloth_nocs_verts, cloth_faces_tri}
    marching_cube_mesh/{marching_cube_verts, marching_cube_faces,
                        is_vertex_on_surface}
    volume/nocs_winding_number_field/<size>
  summary/{cloth_aabb_union, cloth_canonical_aabb_union}

Used by the port's tests and chip_smoke.py; also a reproducible template
for users converting their own data.
"""
from __future__ import annotations

import numpy as np
import torch

from garmentnets_tpu_torch.data import zarrlite
from garmentnets_tpu_torch.ops import geometry
from garmentnets_tpu_torch.ops.gaussian import gaussian_gradient_magnitude
from garmentnets_tpu_torch.ops.marching_cubes import marching_cubes


def make_cloth_mesh(res: int = 12, rng: np.random.RandomState | None = None,
                    thickness: float = 0.08):
    """Wavy cloth slab in NOCS space: a CLOSED thin shell (two offset sheets
    + boundary walls), like a real garment's winding-number support — the
    WNF is ~1 inside and ~0 outside, so the 0.5 iso always crosses."""
    rng = rng or np.random.RandomState(0)
    u = np.linspace(0.2, 0.8, res)
    v = np.linspace(0.15, 0.85, res)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    amp = 0.04 + 0.03 * rng.rand()
    phase = rng.rand() * np.pi
    zz = 0.5 + amp * np.sin(uu * 9 + phase) * np.cos(vv * 7)
    n = res * res
    top = np.stack([uu.ravel(), vv.ravel(),
                    zz.ravel() + thickness / 2], axis=1)
    bot = np.stack([uu.ravel(), vv.ravel(),
                    zz.ravel() - thickness / 2], axis=1)
    nocs_verts = np.concatenate([top, bot]).astype(np.float32)

    quads = []
    for i in range(res - 1):
        for j in range(res - 1):
            a = i * res + j
            quads.append([a, a + 1, a + res + 1, a + res])          # top
            b = a + n
            quads.append([b, b + res, b + res + 1, b + 1])          # bottom
    # boundary walls stitch the two sheets into a closed surface
    ring = ([i * res for i in range(res)]                           # j = 0
            + [(res - 1) * res + j for j in range(1, res)]          # i = max
            + [i * res + (res - 1) for i in range(res - 2, -1, -1)]
            + [j for j in range(res - 2, 0, -1)])                   # i = 0
    for k in range(len(ring)):
        a, b = ring[k], ring[(k + 1) % len(ring)]
        quads.append([a, b, b + n, a + n])
    faces = geometry.quads2tris(np.asarray(quads, np.int64))
    faces = np.ascontiguousarray(faces[:, ::-1])   # outward orientation
    return nocs_verts, faces


def make_tube_mesh(res: int = 12, rng: np.random.RandomState | None = None,
                   thickness: float = 0.06):
    """Skirt-like closed tube shell in NOCS space: a second garment
    CATEGORY with a different topology than the cloth slab (genus-1 tube
    vs flat sheet), exercising category-level generality the way the
    reference's 6 CLOTH3D categories do. Outer wall with a wavy radius
    profile, inner wall offset by `thickness`, stitched by top/bottom cap
    rings into a closed surface (WNF ~1 inside the wall material).
    """
    rng = rng or np.random.RandomState(0)
    nz = res
    ntheta = max(8, res)
    z = np.linspace(0.15, 0.85, nz)
    theta = np.arange(ntheta) / ntheta * 2 * np.pi
    zz, tt = np.meshgrid(z, theta, indexing="ij")
    # radius flares toward the hem, with a gentle angular wave
    base_r = 0.16 + 0.14 * (0.85 - zz) / 0.7
    wave = 1.0 + (0.05 + 0.05 * rng.rand()) * np.sin(
        3 * tt + rng.rand() * np.pi)
    r_out = base_r * wave
    r_in = r_out - thickness

    def ring_pts(r):
        return np.stack([0.5 + r * np.cos(tt), 0.5 + r * np.sin(tt), zz],
                        axis=-1).reshape(-1, 3)

    outer = ring_pts(r_out)
    inner = ring_pts(r_in)
    nocs_verts = np.concatenate([outer, inner]).astype(np.float32)
    n = nz * ntheta

    def vid(i, j, inner_wall=False):
        return (n if inner_wall else 0) + i * ntheta + (j % ntheta)

    quads = []
    for i in range(nz - 1):
        for j in range(ntheta):
            quads.append([vid(i, j), vid(i, j + 1),
                          vid(i + 1, j + 1), vid(i + 1, j)])        # outer
            quads.append([vid(i, j, True), vid(i + 1, j, True),
                          vid(i + 1, j + 1, True), vid(i, j + 1, True)])
    for j in range(ntheta):  # caps stitch outer<->inner at both ends
        quads.append([vid(0, j), vid(0, j, True),
                      vid(0, j + 1, True), vid(0, j + 1)])
        quads.append([vid(nz - 1, j), vid(nz - 1, j + 1),
                      vid(nz - 1, j + 1, True), vid(nz - 1, j, True)])
    faces = geometry.quads2tris(np.asarray(quads, np.int64))
    # orientation self-check: the winding number at a wall-interior point
    # (mid-height, between the outer and inner walls at theta=0) must be
    # ~+1; flip all faces if this construction wound inward
    mid_r = (r_out[nz // 2, 0] + r_in[nz // 2, 0]) / 2
    probe = np.asarray([[0.5 + mid_r, 0.5, z[nz // 2]]], np.float32)
    w = float(geometry.winding_number(probe, nocs_verts, faces)[0])
    if w < 0:
        faces = np.ascontiguousarray(faces[:, ::-1])
    return nocs_verts, faces


GARMENT_MAKERS = {
    "SynthCloth": make_cloth_mesh,
    "SynthSkirt": make_tube_mesh,
}


def deform_to_sim(nocs_verts: np.ndarray, grip_idx: int,
                  rng: np.random.RandomState, scale: float = 0.6):
    """Hang the cloth from grip vertex: gravity droop in gripper frame.

    Output sim verts have the grip vertex at the origin (reference convention:
    'point cloud is in gripper frame', networks/pointnet2_nocs.py:237).
    """
    g = nocs_verts[grip_idx]
    rel = nocs_verts - g
    r = np.linalg.norm(rel[:, :2], axis=1)
    droop = -0.6 * r - 0.15 * r ** 2
    # keep the map injective (no fold-through): mild lateral contraction and
    # z compression, so the deformed shell stays a valid closed surface and
    # its sim-space winding number field is well-defined in [0, 1]
    sim = np.stack([
        rel[:, 0] * (1 - 0.25 * r),
        rel[:, 1] * (1 - 0.25 * r),
        rel[:, 2] * 0.55 + droop,
    ], axis=1) * scale
    sim += rng.normal(0, 0.002, sim.shape)
    sim[grip_idx] = 0.0
    return sim.astype(np.float32)


def _render_views(sim_verts, nocs_verts, faces, num_views, pts_per_view, rng):
    """Per-view surface point clouds with NOCS labels + rgb colors."""
    pts, nocs, rgb, sizes = [], [], [], []
    for v in range(num_views):
        bc, fi = geometry.mesh_sample_barycentric(
            sim_verts, faces, pts_per_view,
            seed=int(rng.randint(0, 2 ** 31)))
        p = geometry.barycentric_interpolation(bc, sim_verts, faces[fi])
        n = geometry.barycentric_interpolation(bc, nocs_verts, faces[fi])
        pts.append(p + rng.normal(0, 0.001, p.shape))
        nocs.append(n)
        rgb.append((np.clip(n, 0, 1) * 255).astype(np.uint8))
        sizes.append(pts_per_view)
    return (np.concatenate(pts).astype(np.float32),
            np.concatenate(nocs).astype(np.float32),
            np.concatenate(rgb), np.asarray(sizes, np.int64))


def generate_dataset(path, num_instances: int = 3, grips_per_instance: int = 2,
                     volume_size: int = 32, mesh_res: int = 12,
                     pts_per_view: int = 2000, num_views: int = 4,
                     seed: int = 0,
                     include_task_space: bool = True,
                     garment_types: tuple = ("SynthCloth",),
                     device="cuda") -> zarrlite.Group:
    """Write a synthetic dataset zarr; returns the root group.

    include_task_space: also emit sim_nocs_winding_number_field (one
    volume_size^3 winding evaluation PER GRIP in a second pass); disable
    for large volumes when only the canonical-space groups are needed.
    garment_types: categories to cycle through per instance (keys of
    GARMENT_MAKERS — the reference trains per CLOTH3D category; pass
    several for a mixed-category dataset). device: where a lattice whose
    winding number takes ops/geometry's device path (queries x faces above
    WN_DEVICE_FROM, e.g. 128^3 against ~2k faces) is computed: the card
    unless the caller names the CPU; smaller lattices stay in host numpy."""
    root = zarrlite.open(path, "w")
    samples = root.require_group("samples")
    rng = np.random.RandomState(seed)

    aabbs, nocs_aabbs = [], []
    sim_records = []
    for inst in range(num_instances):
        garment_name = garment_types[inst % len(garment_types)]
        nocs_verts, faces = GARMENT_MAKERS[garment_name](mesh_res, rng)
        # GT WNF volume of the canonical mesh (shared across grips)
        vg_axes = np.linspace(0, 1, volume_size, dtype=np.float32)
        qx, qy, qz = np.meshgrid(vg_axes, vg_axes, vg_axes, indexing="ij")
        q = np.stack([qx.ravel(), qy.ravel(), qz.ravel()], axis=1)
        wnf = geometry.winding_number(
            q, nocs_verts, faces, device=device).reshape((volume_size,) * 3)
        # GT marching-cube mesh from the WNF (on-surface flag via smoothed
        # gradient magnitude, like the reference's offline generation,
        # common/marching_cubes_util.py:5-35)
        spacing = 1.0 / (volume_size - 1)
        try:
            mc_verts, mc_faces, _, _ = marching_cubes(
                wnf, 0.5, spacing=(spacing,) * 3)
            ggm = gaussian_gradient_magnitude(
                torch.from_numpy(wnf), 0.5).numpy()
            vidx = np.clip((mc_verts / spacing).astype(np.int64), 0,
                           volume_size - 1)
            on_surf = ggm[vidx[:, 0], vidx[:, 1], vidx[:, 2]] > 0.25
        except ValueError:
            mc_verts = np.zeros((1, 3), np.float32)
            mc_faces = np.zeros((1, 3), np.int64)
            on_surf = np.zeros((1,), bool)

        for grip in range(grips_per_instance):
            grip_idx = int(rng.randint(len(nocs_verts)))
            scale = float(0.5 + 0.3 * rng.rand())
            sim_verts = deform_to_sim(nocs_verts, grip_idx, rng, scale)
            p, n, c, sizes = _render_views(
                sim_verts, nocs_verts, faces, num_views, pts_per_view, rng)

            key = f"{inst:05d}_{grip:02d}"
            g = samples.require_group(key)
            g.attrs.put({
                "scale": scale,
                "gender": 0,
                "sample_id": f"inst_{inst:05d}",
                "garment_name": garment_name,
                "grip_vertex_idx": grip_idx,
            })
            pc = g.require_group("point_cloud")
            pc.array("point", p, compressor="blosc")
            pc.array("nocs", n, compressor="blosc")
            pc.array("rgb", c, compressor="blosc")
            pc.array("sizes", sizes)
            mesh = g.require_group("mesh")
            mesh.array("cloth_verts", sim_verts, compressor="blosc")
            mesh.array("cloth_nocs_verts", nocs_verts, compressor="blosc")
            mesh.array("cloth_faces_tri", faces.astype(np.int32), compressor="blosc")
            mcg = g.require_group("marching_cube_mesh")
            mcg.array("marching_cube_verts", mc_verts, compressor="blosc")
            mcg.array("marching_cube_faces", mc_faces.astype(np.int32))
            mcg.array("is_vertex_on_surface", on_surf)
            vol = g.require_group("volume")
            wnf_g = vol.require_group("nocs_winding_number_field")
            # Blosc-zstd like the real CLOTH3D zarrs (and ~7x faster
            # to decode than zlib — the GT-volume read dominates
            # stage-2 __getitem__ time, tools/bench_input.py)
            wnf_g.array(str(volume_size), wnf.astype(np.float32),
                        compressor="blosc")
            sim_records.append((g, sim_verts, faces))

            aabbs.append(geometry.get_aabb(sim_verts))
            nocs_aabbs.append(geometry.get_aabb(nocs_verts))

    summary = root.require_group("summary")
    aabbs = np.asarray(aabbs)
    nocs_aabbs = np.asarray(nocs_aabbs)
    aabb_union = np.stack(
        [aabbs[:, 0].min(0), aabbs[:, 1].max(0)]).astype(np.float32)
    summary.array("cloth_aabb_union", aabb_union)
    summary.array("cloth_canonical_aabb_union", np.stack(
        [nocs_aabbs[:, 0].min(0), nocs_aabbs[:, 1].max(0)]).astype(
            np.float32))

    # second pass: the task-space GT volume (reference volume group
    # 'sim_nocs_winding_number_field') is the WNF of the SIM-space mesh
    # normalized by the dataset-level union AABB, which only exists after
    # all grips are generated
    if not include_task_space:
        return root
    normalizer = geometry.AABBGripNormalizer(aabb_union)
    vg_axes = np.linspace(0, 1, volume_size, dtype=np.float32)
    qx, qy, qz = np.meshgrid(vg_axes, vg_axes, vg_axes, indexing="ij")
    q = np.stack([qx.ravel(), qy.ravel(), qz.ravel()], axis=1)
    for g, sim_verts, faces in sim_records:
        sim_wnf = geometry.winding_number(
            q, normalizer(sim_verts).astype(np.float32), faces,
            device=device).reshape((volume_size,) * 3)
        sg = g["volume"].require_group("sim_nocs_winding_number_field")
        sg.array(str(volume_size), sim_wnf.astype(np.float32),
                 compressor="blosc")
    return root
