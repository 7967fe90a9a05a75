"""The port's device meshes and sharding helpers (parallel/mesh.py) against
the JAX package's, the dense decode on a D range, and the refusals of the
multi-device entry points, on the CPU.

A card count is faked where a test needs one (torch.cuda.device_count);
no CUDA call is made."""
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_port_util as pu  # noqa: E402

from garmentnets_tpu.parallel import mesh as jax_mesh  # noqa: E402
from garmentnets_tpu_torch.harness import training  # noqa: E402
from garmentnets_tpu_torch.harness.predict_engine import (  # noqa: E402
    PredictEngine, mesh_grid)
from garmentnets_tpu_torch.ops.dense_decode import (  # noqa: E402
    PRECISIONS, dense_decode, dense_decode_plain, dense_decode_sharded)
from garmentnets_tpu_torch.parallel import mesh  # noqa: E402


@pytest.fixture
def eight_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)


def test_make_mesh_takes_each_card_once(eight_cards):
    m = mesh.make_mesh()
    assert m.axis_names == ("data",) and m.shape == {"data": 8}
    assert list(m.devices) == [torch.device("cuda", i) for i in range(8)]
    m = mesh.make_mesh(3, axis_name="space")
    assert m.shape == {"space": 3} and m.size == 3


def test_make_mesh_2d_space_is_the_inner_axis_as_jax(eight_cards):
    """Device (i, j) of make_mesh_2d(2, 4) is the same device index in
    both packages: "space" varies fastest."""
    ours = mesh.make_mesh_2d(2, 4)
    ref = jax_mesh.make_mesh_2d(2, 4)
    assert ours.axis_names == tuple(ref.axis_names) == ("data", "space")
    assert ours.shape == dict(ref.shape)
    np.testing.assert_array_equal(
        np.vectorize(lambda d: d.index)(ours.devices),
        np.vectorize(lambda d: d.id)(ref.devices))


def test_mesh_allows_repeated_devices_and_grids_them():
    m = mesh.Mesh([["cpu"] * 4] * 2, ("data", "space"))
    assert m.shape == {"data": 2, "space": 4} and m.size == 8
    assert m.distinct_devices() == [torch.device("cpu")]
    assert mesh_grid(m).shape == (2, 4)
    assert mesh_grid(mesh.Mesh(["cpu"] * 3, ("space",))).shape == (1, 3)
    assert mesh_grid(mesh.Mesh(["cpu"] * 3, ("data",))).shape == (3, 1)
    with pytest.raises(ValueError, match="axes"):
        mesh.Mesh(["cpu"] * 4, ("data", "space"))
    with pytest.raises(ValueError, match="'data' and 'space'"):
        mesh_grid(mesh.Mesh(["cpu"] * 2, ("model",)))


@pytest.mark.parametrize("make", [
    lambda: mesh.make_mesh(9), lambda: mesh.make_mesh_2d(3, 3),
    lambda: mesh.available_devices(0)])
def test_more_devices_than_present_are_refused(eight_cards, make):
    with pytest.raises(ValueError, match="num_devices=(9|0)"):
        make()


@pytest.mark.parametrize("target", [5, 8])
def test_pad_batch_to_equals_jax(target):
    rng = np.random.RandomState(0)
    batch = {"x": rng.randn(5, 7, 3).astype(np.float32),
             "idx": np.arange(5, dtype=np.int64)}
    ours, real = mesh.pad_batch_to(batch, target)
    ref, ref_real = jax_mesh.pad_batch_to(batch, target)
    assert real == ref_real == 5
    for k in batch:
        np.testing.assert_array_equal(ours[k], ref[k])
        assert ours[k].dtype == ref[k].dtype
    with pytest.raises(ValueError, match="5 rows to 4"):
        mesh.pad_batch_to(batch, 4)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_shard_rows_cover_in_order(n):
    batch = {"a": np.arange(8 * 3).reshape(8, 3),
             "t": torch.arange(8.0)}
    shards = [mesh.shard_rows(batch, n, i) for i in range(n)]
    for k in batch:
        parts = [np.asarray(s[k]) for s in shards]
        assert all(len(p) == 8 // n for p in parts)
        np.testing.assert_array_equal(np.concatenate(parts),
                                      np.asarray(batch[k]))
    with pytest.raises(ValueError, match="does not divide into 3"):
        mesh.shard_rows(batch, 3, 0)


def test_batch_to_device_pads_and_masks_each_rank():
    batch = {"x": np.arange(3 * 2, dtype=np.float32).reshape(3, 2)}
    rows = [training.batch_to_device(batch, "cpu", 2, r) for r in (0, 1)]
    np.testing.assert_array_equal(rows[0]["x"].numpy(), batch["x"][:2])
    np.testing.assert_array_equal(rows[1]["x"].numpy(),
                                  batch["x"][[2, 0]])
    assert [r["_valid_mask"].tolist() for r in rows] == [[1, 1], [1, 0]]
    one = training.batch_to_device(batch, "cpu")
    assert one["_valid_mask"].tolist() == [1, 1, 1]


def _decode_setup(seed=0, B=2, C=16, widths=(32, 32)):
    rng = np.random.RandomState(seed)
    fv = torch.from_numpy(rng.randn(B, 8, 8, 8, C).astype(np.float32))
    chans = (C,) + widths + (1,)
    layers = [tuple(torch.from_numpy(a.astype(np.float32)) for a in (
        rng.randn(i, o) / np.sqrt(i), 0.1 * rng.randn(o),
        0.5 + rng.rand(o), 0.1 * rng.randn(o)))
        for i, o in zip(chans[:-1], chans[1:])]
    return fv, layers


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("n_strips", [2, 4, 8])
def test_decode_strip_equals_slice_of_whole_bit_for_bit(precision,
                                                        n_strips):
    """Each strip of the plain decode (and the strips over a CPU "space"
    axis) equals its slice of the whole decode bit for bit."""
    fv, layers = _decode_setup()
    S = 16
    whole = dense_decode_plain(fv, layers, S, precision)
    per = S // n_strips
    for j in range(n_strips):
        strip = dense_decode_plain(fv, layers, S, precision,
                                   d_range=(j * per, per))
        assert strip.shape == (2, per, S, S)
        assert torch.equal(strip, whole[:, j * per:(j + 1) * per]), j
        assert torch.equal(dense_decode(fv, layers, S, precision,
                                        d_range=(j * per, per)), strip)
    assert torch.equal(dense_decode_sharded(fv, layers, S, precision,
                                            ["cpu"] * n_strips), whole)


def test_decode_range_and_space_axis_are_checked():
    fv, layers = _decode_setup()
    for bad in ((-1, 2), (15, 2), (0, 0)):
        with pytest.raises(ValueError, match="D range"):
            dense_decode_plain(fv, layers, 16, d_range=bad)
    with pytest.raises(ValueError, match="volume_size=16 does not divide "
                       "over the 3-way 'space' axis"):
        dense_decode_sharded(fv, layers, 16, "highest", ["cpu"] * 3)


def _strip_voxels(B, S, d_begin, d_count, rows):
    """The voxels (b, d, h, w) that a strip launch of
    csrc/dense_decode_tc.cu writes, and where: its tile -> line -> voxel
    arithmetic, written out in Python."""
    tiles_per_line = -(-S // rows)
    seen = {}
    for tile in range(B * d_count * S * tiles_per_line):
        wt, ln = tile % tiles_per_line, tile // tiles_per_line
        h, ln = ln % S, ln // S
        dd = ln % d_count
        d, b = d_begin + dd, ln // d_count
        for w in range(wt * rows, min(wt * rows + rows, S)):
            seen[(b, d, h, w)] = ((b * d_count + dd) * S + h) * S + w
    return seen


@pytest.mark.parametrize("d_begin,d_count,rows", [
    (0, 16, 64), (4, 4, 64), (12, 4, 128), (6, 1, 64)])
def test_strip_tile_map_covers_the_strip_once(d_begin, d_count, rows):
    """Every voxel of the strip is written exactly once, to its place in
    the [B, d_count, S, S] output, and no other voxel is touched."""
    B, S = 2, 16
    seen = _strip_voxels(B, S, d_begin, d_count, rows)
    want = {(b, d, h, w) for b in range(B)
            for d in range(d_begin, d_begin + d_count)
            for h in range(S) for w in range(S)}
    assert set(seen) == want
    assert sorted(seen.values()) == list(range(B * d_count * S * S))


def test_engine_refuses_a_space_axis_that_does_not_divide_the_volume():
    """Refused at construction, before any weight is read."""
    with pytest.raises(ValueError, match=f"volume_size={pu.VOL} does not "
                       "divide over the mesh's 3-way 'space' axis"):
        PredictEngine(pu.torch_cfg(), {}, volume_size=pu.VOL, device="cpu",
                      mesh=mesh.Mesh([["cpu"] * 3] * 2, ("data", "space")))


def test_engine_refuses_a_batch_the_data_axis_does_not_divide():
    eng = PredictEngine(
        pu.torch_cfg(), pu.torch_model(pu.jax_variables()).state_dict(),
        volume_size=pu.VOL, device="cpu",
        mesh=mesh.Mesh(["cpu"] * 2, ("data",)))
    x = pu.inputs()
    with pytest.raises(ValueError, match="a batch of 1 rows does not "
                       "divide over the mesh's 2-way 'data' axis"):
        eng.encode(x["x"][:1], x["pos"][:1])
    eng.close()


def test_service_refuses_a_batch_size_the_data_axis_does_not_divide():
    from garmentnets_tpu_torch.harness.serve import PredictService
    with pytest.raises(ValueError, match="server.batch_size=3 does not "
                       "divide over the mesh's 2-way 'data' axis"):
        PredictService("unused.ckpt", batch_size=3, device="cpu",
                       mesh=mesh.Mesh(["cpu"] * 2, ("data",)))


@pytest.mark.parametrize("num_devices,device", [
    (0, "cpu"), (-3, "cpu"), (0, "cuda"), (9, "cuda"), (2, "cuda:0")])
def test_trainer_num_devices_refusals_name_the_key(eight_cards, num_devices,
                                                   device):
    with pytest.raises(ValueError,
                       match=f"trainer.num_devices={num_devices}"):
        training.resolve_num_devices(num_devices, device)


def test_trainer_num_devices_resolution(eight_cards):
    assert training.resolve_num_devices(-1, "cuda") == 8
    assert training.resolve_num_devices(-1, "cpu") == 1
    assert training.resolve_num_devices(2, "cpu") == 2
    assert training.resolve_num_devices(8, "cuda") == 8
    # a named card is one rank's device: -1 is that card alone
    assert training.resolve_num_devices(-1, "cuda:3") == 1
    assert training.resolve_num_devices(1, "cuda:3") == 1


def test_trainer_without_process_group_refuses_several_ranks(tmp_path):
    with pytest.raises(ValueError, match="trainer.num_devices=2: several "
                       "ranks need a process group"):
        training.Trainer(1, str(tmp_path), num_devices=2, device="cpu")


def test_init_distributed_refuses_more_ranks_than_cards(monkeypatch):
    """nccl takes one card a rank: two ranks on one card are refused
    unless the caller asks for gloo."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks on 1 CUDA device"):
        mesh.init_distributed(init_method="tcp://127.0.0.1:1",
                              world_size=2, rank=0, device="cuda")


def test_all_reduce_sum_is_the_identity_without_a_group():
    x = torch.randn(3, requires_grad=True)
    y = mesh.all_reduce_sum(x)
    assert y is x
