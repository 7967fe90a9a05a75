"""A run with the timed path broken underneath comes out not correct: the
harness is driven through everything but its look for a card, on the CPU,
at a size a test run can hold (tests/small.py), once for each fault a
cell can have."""
import time

import pytest
import torch

from benchmark.harness import cell, manifest
from benchmark.tests.small import small_cell

SEED = 2 ** 31 + 99


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _run(name: str) -> dict:
    return cell.run(manifest.load(), name, SEED, 1.5,
                    False, time.perf_counter(), **small_cell(name))


@pytest.mark.parametrize("name", ["train1-b8", "train2-b24"])
def test_train_step_that_leaves_the_state_unchanged(monkeypatch, name):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    res = _run(name)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("name", ["train1-b8", "train2-b24"])
def test_train_step_on_half_the_batch(monkeypatch, name):
    from garmentnets_tpu_torch.harness import training
    orig = training.batch_to_device

    def half(batch, device, world_size=1, rank=0):
        b = len(batch["x"]) // 2
        return orig({k: v[:b] for k, v in batch.items()}, device,
                    world_size, rank)

    monkeypatch.setattr(training, "batch_to_device", half)
    res = _run(name)
    assert not res["correct"], res["compared"]


def _after_each_step(monkeypatch, fault):
    """Plant `fault(model, state_before)` after every call of the train
    step that make_train_fns builds."""
    from garmentnets_tpu_torch.harness import training
    orig = training.make_train_fns

    def planted(model, *args, **kwargs):
        train_step, *rest = orig(model, *args, **kwargs)

        def step(*a, **k):
            before = {n: t.detach().clone()
                      for n, t in model.state_dict().items()}
            out = train_step(*a, **k)
            with torch.no_grad():
                fault(model, before)
            return out
        return (step, *rest)

    monkeypatch.setattr(training, "make_train_fns", planted)


@pytest.mark.parametrize("name", ["train1-b8", "train2-b24"])
def test_train_step_that_leaves_the_batchnorm_statistics_unchanged(
        monkeypatch, name):
    """A fault on a minority of the leaves (BatchNorm momentum 0): the
    worst leaf's change sees it."""
    def frozen(model, before):
        for n, b in model.named_buffers():
            if "running_" in n:
                b.copy_(before[n])

    _after_each_step(monkeypatch, frozen)
    res = _run(name)
    assert not res["correct"], res["compared"]
    c = res["compared"]["change_gap"]
    assert c["value"] > c["limit"]


def test_train_step_whose_update_runs_backwards(monkeypatch):
    """An Adam step of the right size in the wrong direction: the first
    gradient reads right, the second step's loss does not. (train1-b8
    compares no second-step loss; at its own size the worst leaf's change
    sees this fault, at this size it does not: PERF.md.)"""
    name = "train2-b24"
    def backwards(model, before):
        for n, p in model.named_parameters():
            if p.requires_grad:
                p.mul_(-1).add_(before[n], alpha=2)

    _after_each_step(monkeypatch, backwards)
    res = _run(name)
    assert not res["correct"], res["compared"]
    c = res["compared"]["loss2_gap"]
    assert c["value"] > c["limit"]
