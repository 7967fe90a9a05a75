"""The port's data layer against the JAX package's copies: zarrlite and the
Blosc codec (bytes on disk), the synthetic data generator, the numpy
geometry and grid sampling the dataset draws with, the dataset and its
datamodule, collate and Loader, the metadata cache, the run logger and
the run directory helpers.

A dataset written by the port and one written by the JAX package at the
same seed are compared first; every later test reads the port's copy
through both packages. The two generators agree byte for byte here: the
flags of `is_vertex_on_surface` are held equal outright, and the test
says so if a ggm value near 0.25 ever splits them.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from garmentnets_tpu.core import config as jconfig
from garmentnets_tpu.core import logging as jlogging
from garmentnets_tpu.data import blosc_codec as jblosc
from garmentnets_tpu.data import dataset as jds
from garmentnets_tpu.data import synthetic as jsyn
from garmentnets_tpu.data import zarrlite as jz
from garmentnets_tpu.ops import geometry as jgeo
from garmentnets_tpu.ops.gaussian import gaussian_gradient_magnitude as jggm
from garmentnets_tpu.ops.grid_sample import grid_sample_trilinear_np as jgs
from garmentnets_tpu.utils import cache as jcache
from garmentnets_tpu_torch.core import config as tconfig
from garmentnets_tpu_torch.core import logging as tlogging
from garmentnets_tpu_torch.data import blosc_codec as tblosc
from garmentnets_tpu_torch.data import dataset as tds
from garmentnets_tpu_torch.data import synthetic as tsyn
from garmentnets_tpu_torch.data import zarrlite as tz
from garmentnets_tpu_torch.ops import geometry as tgeo
from garmentnets_tpu_torch.ops.gaussian import ggm_plain
from garmentnets_tpu_torch.ops.grid_sample import grid_sample_trilinear_np as tgs
from garmentnets_tpu_torch.utils import cache as tcache

VOL = 16
GEN = dict(num_instances=3, grips_per_instance=2, volume_size=VOL,
           mesh_res=8, pts_per_view=300, seed=5,
           garment_types=("SynthCloth", "SynthSkirt"))

DM = dict(metadata_cache_dir=None, batch_size=2, num_workers=0,
          num_pc_sample=256, num_volume_sample=64, num_surface_sample=48,
          num_mc_surface_sample=0, surface_sample_ratio=0.5,
          surface_sample_std=0.05, surface_normal_noise_ratio=0.25,
          surface_normal_std=0.01, enable_augumentation=True,
          random_rot_range=[-180, 180], num_views=3, pc_noise_std=0.002,
          volume_size=VOL, volume_group="nocs_winding_number_field",
          tsdf_clip_value=None, volume_absolute_value=False,
          include_volume=True, static_epoch_seed=True,
          dataset_split=[1, 1, 1], split_seed=3)


def _files(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    jsyn.generate_dataset(str(d / "jax.zarr"), **GEN)
    tsyn.generate_dataset(str(d / "torch.zarr"), **GEN)
    return d / "jax.zarr", d / "torch.zarr"


# ---------------------------------------------------------------------------
# zarrlite and Blosc
# ---------------------------------------------------------------------------
def _arrays():
    rng = np.random.RandomState(0)
    return {
        "f32": np.cumsum(rng.randn(40, 7), axis=0).astype(np.float32),
        "i32": rng.randint(-9, 9, (33, 3)).astype(np.int32),
        "u8": rng.randint(0, 255, (50, 3)).astype(np.uint8),
        "bool": rng.rand(77) > 0.5,
        "f64": rng.randn(5, 4, 3),
        "str": np.asarray(["a", "bc", "def"]),
        "empty": np.zeros((0, 3), np.float32),
        "scalar": np.float32(2.5),
    }


@pytest.mark.parametrize("compressor", [None, "zlib", "blosc"])
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_zarrlite_chunks_identical_and_cross_readable(tmp_path, writer,
                                                      compressor):
    """An array written by either copy (several chunks where chunks are
    given) has the same .zarray and chunk bytes as the other copy's, and
    the other copy reads it back bit-equal."""
    mods = {"torch": tz, "jax": jz}
    other = "jax" if writer == "torch" else "torch"
    for name, mod in mods.items():
        g = mod.open(str(tmp_path / f"{name}.zarr"), "w")
        g.attrs.put({"k": 1, "x": np.float64(0.5)})
        for key, arr in _arrays().items():
            chunks = (16,) + arr.shape[1:] if arr.ndim and len(arr) > 16 \
                else None
            if key == "str":
                g.array(key, arr, compressor=None)
            else:
                g.array(key, arr, chunks=chunks, compressor=compressor)
    assert _files(tmp_path / "torch.zarr") == _files(tmp_path / "jax.zarr")
    back = mods[other].open(str(tmp_path / f"{writer}.zarr"), "r")
    assert back.attrs.asdict() == {"k": 1, "x": 0.5}
    for key, arr in _arrays().items():
        got = np.asarray(back[key])
        assert got.dtype == np.asarray(arr).dtype, key
        np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("force_python", [False, True])
def test_blosc_bytes_identical(force_python):
    """Both codecs compress the same buffer to the same bytes (libblosc
    where it loads, and the pure-Python engine) and decode each other's."""
    if not force_python and not (tblosc._LIB is not None
                                 and jblosc._LIB is not None):
        pytest.skip("libblosc not loaded")
    rng = np.random.RandomState(1)
    for arr in (np.cumsum(rng.randn(3000)).astype(np.float32),
                rng.randint(0, 5, 5000).astype(np.int64)):
        buf = arr.tobytes()
        for shuffle in (0, 1, 2):
            a = tblosc.compress(buf, arr.itemsize, "zstd", 6, shuffle,
                                force_python=force_python)
            b = jblosc.compress(buf, arr.itemsize, "zstd", 6, shuffle,
                                force_python=force_python)
            assert a == b
            assert bytes(tblosc.decompress(b, force_python)) == buf
            assert bytes(jblosc.decompress(a, force_python)) == buf
    assert tblosc.available() == jblosc.available()


def test_zarrlite_copy_matches(datasets, tmp_path):
    """zarrlite.copy of a sample group (attrs and arrays) writes the same
    files in both copies."""
    for name, mod in (("t", tz), ("j", jz)):
        src = mod.open(str(datasets[1]), "r")["samples/00000_00"]
        dst = mod.open(str(tmp_path / f"{name}.zarr"), "w")
        mod.copy(src, dst, name="copied")
    assert _files(tmp_path / "t.zarr") == _files(tmp_path / "j.zarr")


# ---------------------------------------------------------------------------
# synthetic generator
# ---------------------------------------------------------------------------
def test_synthetic_generator_matches_jax(datasets):
    """Same groups, arrays, attrs and dtypes; WNF volumes within 1e-6;
    marching-cubes meshes equal; is_vertex_on_surface equal (a flag may
    only differ where the two ggm values straddle 0.25 within 1e-6)."""
    jroot, troot = (tz.open(str(p), "r") for p in datasets)
    jk = [k for k, _ in jroot["samples"].groups()]
    assert jk == [k for k, _ in troot["samples"].groups()] and len(jk) == 6
    for k in jk:
        jg, tg = jroot["samples"][k], troot["samples"][k]
        assert jg.attrs.asdict() == tg.attrs.asdict()
        for sub in ("point_cloud", "mesh", "marching_cube_mesh"):
            for name, arr in jg[sub].arrays():
                got = tg[sub][name]
                assert got.dtype == arr.dtype, (k, sub, name)
                if name == "is_vertex_on_surface":
                    continue
                np.testing.assert_array_equal(got[:], arr[:],
                                              err_msg=f"{k}/{sub}/{name}")
        for group in ("nocs_winding_number_field",
                      "sim_nocs_winding_number_field"):
            a = jg[f"volume/{group}/{VOL}"][:]
            b = tg[f"volume/{group}/{VOL}"][:]
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
        wnf = jg[f"volume/nocs_winding_number_field/{VOL}"][:]
        flags_j = jg["marching_cube_mesh/is_vertex_on_surface"][:]
        flags_t = tg["marching_cube_mesh/is_vertex_on_surface"][:]
        split = flags_j != flags_t
        if split.any():
            verts = jg["marching_cube_mesh/marching_cube_verts"][:]
            vidx = np.clip((verts / (1.0 / (VOL - 1))).astype(np.int64), 0,
                           VOL - 1)[split]
            g = np.asarray(jggm(wnf, 0.5))[vidx[:, 0], vidx[:, 1],
                                           vidx[:, 2]]
            assert np.all(np.abs(g - 0.25) <= 1e-6), g
    for name in ("cloth_aabb_union", "cloth_canonical_aabb_union"):
        np.testing.assert_array_equal(troot[f"summary/{name}"][:],
                                      jroot[f"summary/{name}"][:])


def test_synthetic_ggm_on_cpu_tensor_matches_jax():
    """The generator's on-surface flags come from the port's plain ggm on
    a CPU tensor; on a generator WNF it agrees with the JAX ggm within
    1e-6."""
    verts, faces = tsyn.make_cloth_mesh(8, np.random.RandomState(2))
    ax = np.linspace(0, 1, VOL, dtype=np.float32)
    q = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    wnf = tgeo.winding_number(q, verts, faces).reshape((VOL,) * 3)
    np.testing.assert_array_equal(
        wnf, jgeo.winding_number(q, verts, faces, backend="numpy").reshape(
            (VOL,) * 3))
    np.testing.assert_allclose(ggm_plain(torch.from_numpy(wnf), 0.5).numpy(),
                               np.asarray(jggm(wnf, 0.5)), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# geometry and grid sampling
# ---------------------------------------------------------------------------
def test_geometry_numpy_functions_match_jax():
    rng = np.random.RandomState(3)
    verts, faces = tsyn.make_tube_mesh(10, rng)
    aabb = tgeo.get_aabb(verts)
    np.testing.assert_array_equal(aabb, jgeo.get_aabb(verts))
    for t, j in ((tgeo.AABBNormalizer(aabb), jgeo.AABBNormalizer(aabb)),
                 (tgeo.AABBGripNormalizer(aabb),
                  jgeo.AABBGripNormalizer(aabb))):
        np.testing.assert_array_equal(t(verts), j(verts))
        np.testing.assert_array_equal(t.inverse(verts), j.inverse(verts))
    np.testing.assert_array_equal(tgeo.double_area(verts, faces),
                                  jgeo.double_area(verts, faces))
    np.testing.assert_array_equal(tgeo.per_vertex_normals(verts, faces),
                                  jgeo.per_vertex_normals(verts, faces))
    bc, fi = tgeo.mesh_sample_barycentric(verts, faces, 500, seed=4)
    jbc, jfi = jgeo.mesh_sample_barycentric(verts, faces, 500, seed=4)
    np.testing.assert_array_equal(bc, jbc)
    np.testing.assert_array_equal(fi, jfi)
    np.testing.assert_array_equal(
        tgeo.barycentric_interpolation(bc, verts, faces[fi]),
        jgeo.barycentric_interpolation(jbc, verts, faces[jfi]))
    quads = rng.randint(0, 50, (20, 4))
    np.testing.assert_array_equal(tgeo.quads2tris(quads),
                                  jgeo.quads2tris(quads))
    q = rng.rand(300, 3).astype(np.float32)
    np.testing.assert_array_equal(
        tgeo.winding_number(q, verts, faces, chunk=64),
        jgeo.winding_number(q, verts, faces, chunk=64, backend="numpy"))


@pytest.mark.parametrize("shape", [(9, 7, 5), (6, 6, 6, 3)])
def test_grid_sample_np_matches_jax(shape):
    rng = np.random.RandomState(len(shape))
    vol = rng.randn(*shape).astype(np.float32)
    q = (rng.rand(200, 3) * 1.2 - 0.1).astype(np.float32)   # some outside
    np.testing.assert_array_equal(tgs(vol, q), jgs(vol, q))


# ---------------------------------------------------------------------------
# dataset, datamodule, collate, Loader
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def modules(datasets):
    path = str(datasets[1])
    out = []
    for mod in (jds, tds):
        dm = mod.ConvImplicitWNFDataModule(zarr_path=path, **DM)
        dm.prepare_data()
        out.append(dm)
    return out


def _assert_samples_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_datamodule_splits_identical(modules):
    jdm, tdm = modules
    for split in ("train_idxs", "val_idxs", "test_idxs"):
        np.testing.assert_array_equal(getattr(tdm, split),
                                      getattr(jdm, split))
    assert len(tdm.test_idxs) > 0 and len(tdm.val_idxs) > 0
    assert list(tdm.groups_df.index) == list(jdm.groups_df.index)
    np.testing.assert_array_equal(tdm.val_dataset.cloth_sim_aabb,
                                  jdm.val_dataset.cloth_sim_aabb)


@pytest.mark.parametrize("idx", [0, 3, 5])
def test_dataset_getitem_bit_equal(modules, idx):
    """Augmentation on, static_epoch_seed=True, every sampler of the
    dataset on (views, volume with surface-mixed queries, surface samples
    with normal noise, point noise, rotation, the volume itself)."""
    jdm, tdm = modules
    _assert_samples_equal(jdm.val_dataset[idx], tdm.val_dataset[idx])


def test_dataset_mc_surface_sample_bit_equal(datasets):
    path = str(datasets[1])
    kw = dict(DM, num_mc_surface_sample=32, num_surface_sample=32,
              num_volume_sample=0, include_volume=False)
    for idx in (1, 4):
        _assert_samples_equal(
            jds.ConvImplicitWNFDataset(path, **kw)[idx],
            tds.ConvImplicitWNFDataset(path, **kw)[idx])


def test_collate_and_loader_batches_identical(modules):
    """collate of the same samples, and whole Loader epochs (shuffled with
    worker threads, and in order), batch for batch."""
    jdm, tdm = modules
    items = [tdm.val_dataset[i] for i in (0, 2, 4)]
    _assert_samples_equal(jds.collate(items), tds.collate(items))
    idxs = np.arange(len(tdm.val_dataset))
    for kw in (dict(shuffle=True, seed=7, num_workers=2),
               dict(shuffle=False, drop_last=True)):
        jl = jds.Loader(jdm.val_dataset, idxs, 2, **kw)
        tl = tds.Loader(tdm.val_dataset, idxs, 2, **kw)
        assert len(jl) == len(tl)
        for _ in range(2):       # two epochs: the shuffle order moves on
            jb, tb = list(jl), list(tl)
            assert len(jb) == len(tb) == len(tl)
            for a, b in zip(jb, tb):
                _assert_samples_equal(a, b)


def test_test_dataloader_batches_identical(modules):
    jdm, tdm = modules
    for a, b in zip(jdm.test_dataloader(), tdm.test_dataloader()):
        _assert_samples_equal(a, b)


@pytest.mark.parametrize("count,rank", [(None, None), (2, 0), (2, 1),
                                        (3, 2)])
def test_process_shard_matches_jax(modules, count, rank):
    """shard_by_process: without a process group the port takes (1, 0),
    as a single JAX process does; explicit shards are equal."""
    jdm, tdm = modules
    idxs = np.arange(11)
    for dm in modules:
        dm.kwargs["shard_by_process"] = True
    try:
        np.testing.assert_array_equal(tdm._process_shard(idxs, count, rank),
                                      jdm._process_shard(idxs, count, rank))
    finally:
        for dm in modules:
            dm.kwargs.pop("shard_by_process")


@pytest.mark.parametrize("which", ["train", "val", "test"])
def test_shard_by_process_one_process_unchanged(modules, tmp_path, which):
    """One process (no process group, JAX's process_count() == 1): with
    shard_by_process on, a loader is not sharded by process, reads the
    indices in the order it reads them with the flag off (and, on the
    static val and test sets, yields the same batches), and the Trainer
    keeps each batch whole as its global batch."""
    from garmentnets_tpu_torch.harness.training import Trainer
    _, tdm = modules
    off = getattr(tdm, f"{which}_dataloader")()
    tdm.kwargs["shard_by_process"] = True
    try:
        assert not tdm.process_sharded()
        on = getattr(tdm, f"{which}_dataloader")()
    finally:
        tdm.kwargs.pop("shard_by_process")
    assert not on.process_sharded
    for attr in ("batch_size", "shuffle", "seed", "drop_last"):
        assert getattr(on, attr) == getattr(off, attr), attr
    np.testing.assert_array_equal(on.idxs, off.idxs)
    batches = list(on)
    assert len(batches) == len(off) > 0
    if which != "train":        # train samples are drawn anew each time
        for a, b in zip(batches, off):
            _assert_samples_equal(a, b)
    trainer = Trainer(max_epochs=1, run_dir=str(tmp_path), device="cpu")
    rows, n = trainer._rows(batches[0], on)
    assert n == len(batches[0]["x"])
    assert rows["_valid_mask"].tolist() == [1.0] * n
    np.testing.assert_array_equal(rows["x"].numpy(), batches[0]["x"])


def test_metadata_cache_matches_jax(datasets, tmp_path):
    """metadata_cache_dir: the groups table comes from the cache on the
    second build, and equals the uncached one and the JAX dataset's."""
    path = str(datasets[1])
    kw = dict(DM, metadata_cache_dir=str(tmp_path / "cache"))
    first = tds.ConvImplicitWNFDataset(path, **kw).groups_df
    assert len(list((tmp_path / "cache").glob("*.pkl"))) == 1
    calls = []
    cached = tcache.file_attr_cache(path, cache_dir=str(tmp_path / "cache"))(
        lambda: calls.append(1))()
    assert not calls and cached is not None
    again = tds.ConvImplicitWNFDataset(path, **kw).groups_df
    ref = jds.ConvImplicitWNFDataset(path, **kw).groups_df
    assert first.equals(again) and first.equals(ref)
    assert jcache.SourceStampCache(str(tmp_path))._stamp(
        pathlib.Path(path)) == tcache.SourceStampCache(
            str(tmp_path))._stamp(pathlib.Path(path))


# ---------------------------------------------------------------------------
# run logger and run directory
# ---------------------------------------------------------------------------
def test_run_logger_and_run_dir_match_jax(tmp_path):
    cfg = {"a": {"b": [1, 2], "c": None}, "d": "x"}
    for name, cmod, lmod in (("t", tconfig, tlogging),
                             ("j", jconfig, jlogging)):
        run = cmod.make_run_dir(run_dir=str(tmp_path / name))
        log = lmod.make_logger(run, {"backend": "local", "name": "run"})
        log.log({"x": 1.5, "n": np.float32(2.0), "s": "k", "arr": [1]},
                step=3)
        log.summary["garments"] = 4
        log.close()
        cmod.dump_config(cfg, run, extra={"meta": {"m": 1}})
    for f in ("summary.json", "config.yaml"):
        t = (tmp_path / "t" / f).read_text().replace(str(tmp_path / "t"), "")
        j = (tmp_path / "j" / f).read_text().replace(str(tmp_path / "j"), "")
        assert t == j, f
    rec = [json.loads(x) for x in
           (tmp_path / "t" / "metrics.jsonl").read_text().splitlines()]
    assert rec[0]["x"] == 1.5 and rec[0]["n"] == 2.0 and "arr" not in rec[0]
    with pytest.raises(ValueError, match="unknown logger.backend"):
        tlogging.make_logger(tmp_path / "u", {"backend": "tb"})


def test_make_run_dir_timestamped(tmp_path):
    a = tconfig.make_run_dir(base=str(tmp_path))
    b = tconfig.make_run_dir(base=str(tmp_path))
    assert a != b and a.is_dir() and b.is_dir()
    assert a.parent == b.parent and a.parent.parent == tmp_path
