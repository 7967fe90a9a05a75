"""The plain reference agrees with the port's first training step at a
small size on the CPU; on a card, the control (the reference in the
program's place at TF32) and each planted fault come out not correct by
the harness's own decision."""
import time

import pytest
import torch

from benchmark.harness import cell, manifest
from benchmark.tests.small import small_cell

SEED = 2 ** 31 + 7


@pytest.mark.parametrize("name", ["train1-b8", "train2-b24"])
def test_first_step_agrees_with_the_port_on_the_cpu(name):
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        kw = small_cell(name)
        numbers = {}
        cell.run(manifest.load(), name, SEED, 1.0, False, time.perf_counter(),
                 numbers_out=numbers, **kw)
    finally:
        torch.set_num_threads(prev)
    first = ["loss1_gap"] + [k for k in ("stage1_nocs_gap_mean",
                                         "stage1_feature_gap")
                             if k in kw["limits"]]
    for k in first:
        assert numbers[k] <= kw["limits"][k], (k, numbers[k])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["train1-b8", "train2-b24"])
def test_control_and_faults_fail_the_train_cells_on_a_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    from benchmark.tools import readings
    kw = small_cell(name)
    got = readings.control_train(kw["config"], kw["traffic"], SEED, "cuda")
    kinds = ["control_tf32", "fault_half_batch", "fault_state_unchanged",
             "fault_stats_frozen"]
    if "loss2_gap" in kw["limits"]:
        kinds += ["fault_update_reversed"]
    for kind in kinds:
        assert not cell.decide(got[kind], kw["limits"])[1], kind
