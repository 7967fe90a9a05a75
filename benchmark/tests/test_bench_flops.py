"""The yardstick's counts against hand counts at small shapes."""
import pytest

from benchmark.harness import flops, manifest


def test_mlp_counts_products_once_and_the_epilogue():
    w = flops.mlp(10, (3, 4, 5))
    assert w.tc == 2 * (3 * 4 + 4 * 5) * 10
    assert w.cc == 4 * (4 + 5) * 10


def test_least_time_takes_the_largest_bound():
    w = flops.Work(989e12, 67e12 / 2, 3.35e12 / 4)
    assert w.least_s() == pytest.approx(1.0)
    w = flops.Work(0, 0, 3.35e12)
    assert w.least_s() == pytest.approx(1.0)


def test_unet3d_hand_count():
    # one level, 1 -> 2 channels on a 2^3 grid: two 3x3x3 convs
    # (1 -> 1, then 1 -> 2: c1 = max(2 // 2, 1) = 1), the 1x1x1 conv to 3
    w = flops.unet3d(1, 1, 3, 2, 1, 2)
    vox = 8
    assert w.tc == 2 * 27 * (1 * 1 + 1 * 2) * vox + 2 * 2 * 3 * vox
    assert w.cc == ((8 * 1 + 1) + (8 * 1 + 2)) * vox + 3 * vox


def test_train_sample_counts_three_passes_of_the_trained_parts():
    bench = manifest.load()
    cfg = manifest.config_of(bench, manifest.cell(bench, "train2-b24"))
    s1 = flops.stage1(cfg["model"], 1, 6000).flops
    assert flops.train_sample(cfg, 1, 6000, 0, 0) == 3 * s1
    s2 = flops.train_sample(cfg, 2, 6000, 6000, 6000)
    assert s2 > s1 and (s2 - s1) % 3 == 0
