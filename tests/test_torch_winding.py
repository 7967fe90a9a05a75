"""The port's winding number (ops/geometry.py) against the JAX package's,
on the CPU: the torch device path (f32 stock ops, backend='torch',
device='cpu') against the JAX device path `_winding_number_jax` and both
against the f64 numpy path, within 1e-5, on seeded queries around the
synthetic generator's two garment meshes; the padded faces add nothing;
'auto' takes numpy up to the JAX package's 1e8 queries x faces and the
device path above it, and the generator passes its device through (the
generator's bytes at the test sizes are held to the JAX generator's in
tests/test_torch_data.py)."""
import numpy as np
import pytest

from garmentnets_tpu.ops import geometry as jgeo
from garmentnets_tpu_torch.data import synthetic
from garmentnets_tpu_torch.data import zarrlite
from garmentnets_tpu_torch.ops import geometry as tgeo

TOL = 1e-5
MESHES = {"cloth": (synthetic.make_cloth_mesh, 8),
          "tube": (synthetic.make_tube_mesh, 9)}


def _queries(seed: int = 3) -> np.ndarray:
    """Seeded points in and around the unit cube, and a lattice corner
    set (points on the garments' planes of symmetry included)."""
    rng = np.random.RandomState(seed)
    ax = np.linspace(0, 1, 9, dtype=np.float32)
    lattice = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"),
                       -1).reshape(-1, 3)
    scatter = (rng.rand(1500, 3) * 1.2 - 0.1).astype(np.float32)
    return np.concatenate([lattice, scatter])


@pytest.fixture(scope="module", params=sorted(MESHES))
def fields(request):
    make, res = MESHES[request.param]
    verts, faces = make(res, np.random.RandomState(1))
    q = _queries()
    return dict(
        verts=verts, faces=faces, q=q,
        torch=tgeo.winding_number(q, verts, faces, backend="torch",
                                  device="cpu"),
        jax=jgeo._winding_number_jax(q, verts, faces, chunk=512),
        numpy=tgeo.winding_number(q, verts, faces, backend="numpy"))


def test_torch_path_matches_jax_device_path(fields):
    assert fields["torch"].dtype == np.float32
    assert fields["torch"].shape == (len(fields["q"]),)
    np.testing.assert_allclose(fields["torch"], fields["jax"], rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("side", ["torch", "jax"])
def test_device_paths_match_numpy_f64(fields, side):
    """The field reaches the garment's inside (~1) and outside (~0), and
    both f32 paths are within 1e-5 of the f64 one."""
    ref = fields["numpy"]
    assert ref.max() > 0.9 and ref.min() < 0.1
    np.testing.assert_allclose(fields[side], ref, rtol=0, atol=TOL)


def test_padded_faces_give_the_same_field(fields):
    """pad_faces fills the faces up to a multiple of 1024 with
    repeated-vertex triangles, as JAX pads them: zero solid angle, so the
    f64 field over the padded soup equals the field over the same soup
    unpadded."""
    def soup_field(multiple):
        tri = tgeo.pad_faces(fields["verts"], fields["faces"], multiple)
        soup = np.arange(3 * len(tri)).reshape(-1, 3)
        field = tgeo.winding_number(fields["q"], tri.reshape(-1, 3).astype(
            np.float64), soup, backend="numpy")
        return len(tri), field

    n_pad, padded = soup_field(1024)
    n, plain = soup_field(1)
    assert n_pad % 1024 == 0 and n_pad > n == len(fields["faces"])
    np.testing.assert_allclose(padded, plain, rtol=0, atol=1e-12)
    np.testing.assert_allclose(plain, fields["numpy"], rtol=0, atol=TOL)


def test_torch_path_chunks_agree(fields):
    """A few queries a chunk gives the field of the default chunk."""
    q = fields["q"][:500]
    small = tgeo._winding_number_torch(q, fields["verts"], fields["faces"],
                                       device="cpu", chunk=97)
    np.testing.assert_allclose(small, fields["torch"][:500], rtol=0,
                               atol=1e-6)


def test_auto_switches_at_the_jax_threshold(monkeypatch):
    """'auto' stays in numpy up to WN_DEVICE_FROM = 1e8 queries x faces
    (the JAX package's threshold) and takes the device path above it on
    the caller's device; an unknown backend is refused."""
    verts, faces = synthetic.make_cloth_mesh(8, np.random.RandomState(1))
    assert tgeo.WN_DEVICE_FROM == 10 ** 8
    calls = []

    def spy(q, v, f, device):
        calls.append((len(q), str(device)))
        return np.zeros(len(q), np.float32)

    monkeypatch.setattr(tgeo, "_winding_number_torch", spy)
    q = np.zeros((11, 3), np.float32)
    tgeo.winding_number(q[:10], verts, faces, device="cpu")
    assert calls == []
    monkeypatch.setattr(tgeo, "WN_DEVICE_FROM", 10 * len(faces))
    tgeo.winding_number(q[:10], verts, faces, device="cpu")
    assert calls == []
    tgeo.winding_number(q[:11], verts, faces, device="cpu")
    assert calls == [(11, "cpu")]
    with pytest.raises(ValueError, match="backend"):
        tgeo.winding_number(q[:2], verts, faces, backend="jax")


def test_generator_takes_the_device_path_when_large(tmp_path, monkeypatch):
    """At the tests' sizes generate_dataset stays in numpy (its bytes are
    the numpy path's); with the threshold lowered below a 16^3 lattice it
    computes its volumes on the device it is given (here the CPU): the
    same WNF as the numpy dataset within 1e-5."""
    kw = dict(num_instances=1, grips_per_instance=1, volume_size=16,
              mesh_res=8, pts_per_view=100, seed=0,
              include_task_space=True)
    device_path = tgeo._winding_number_torch

    def refuse(*args, **kwargs):
        raise AssertionError("the device path below the threshold")

    monkeypatch.setattr(tgeo, "_winding_number_torch", refuse)
    synthetic.generate_dataset(str(tmp_path / "np.zarr"), device="cpu", **kw)
    monkeypatch.setattr(tgeo, "_winding_number_torch", device_path)
    monkeypatch.setattr(tgeo, "WN_DEVICE_FROM", 1000)
    synthetic.generate_dataset(str(tmp_path / "dev.zarr"), device="cpu",
                               **kw)
    for group in ("nocs_winding_number_field",
                  "sim_nocs_winding_number_field"):
        key = f"samples/00000_00/volume/{group}/16"
        a = zarrlite.open(str(tmp_path / "np.zarr"), "r")[key][:]
        b = zarrlite.open(str(tmp_path / "dev.zarr"), "r")[key][:]
        assert a.max() > 0.9
        assert not np.array_equal(a, b)
        np.testing.assert_allclose(b, a, rtol=0, atol=TOL)
