"""The traffic generator is a function of the seed."""
import numpy as np

from benchmark.harness import manifest, traffic

BIG = 2 ** 31 + 12345


def _train(stage: int):
    bench = manifest.load()
    name = {1: "train1-b8", 2: "train2-b24"}[stage]
    tr = manifest.traffic_of(manifest.cell(bench, name))
    return dict(tr, batches=2, points=300, volume_samples=50 * (stage - 1),
                surface_samples=40 * (stage - 1))


def test_train_batches_repeat_with_the_seed_and_rows_differ():
    for stage in (1, 2):
        tr = _train(stage)
        a = traffic.train_batches(tr, 3, BIG)
        b = traffic.train_batches(tr, 3, BIG)
        for ba, bb in zip(a, b):
            assert ba.keys() == bb.keys()
            assert all(np.array_equal(ba[k], bb[k]) for k in ba)
        rows = np.concatenate([x["pos"].reshape(3, -1) for x in a])
        assert len(np.unique(rows, axis=0)) == len(rows)
        assert not np.array_equal(
            traffic.train_batches(tr, 3, BIG + 1)[0]["pos"], a[0]["pos"])


def test_garment_points_lie_on_the_surface():
    from benchmark.harness import garment
    rng = np.random.default_rng(0)
    pts = garment.surface_points(rng, 500, 0.0)
    assert (garment.wnf_at(pts) > 0.45).mean() > 0.95

