"""Each cell's control comes out not correct at the cell's own size, on
three seeds: the runner's lower precision put in the program's place (the
program's int8 towers for the embed cells, its int8_qat towers for
fine-tuning, a TF32 product and ``topk`` for the fp32 search; the CPU has
no TF32 and a tiny model not the cell's rounding, so the test runs on the
card). ``perfbench/readings.py --control-seeds`` reads the same numbers
that PERF.md gives beside each limit."""

import time

import pytest
import torch

from perfbench import harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the control is read at the cell's own size, on a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 1, 2**32 + 3, 3 * 2**31 + 5])
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(card, workload, seed):
    result = harness.run(harness.load_cell(workload), seed, 2.0, False, card,
                         time.perf_counter(), control=True, log=lambda msg: None)
    assert not result["correct"], result["checks"]
