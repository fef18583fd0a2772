"""A run of each cell on the CPU at a tiny size, past the harness's look
for a card, with each fault the cell can have planted underneath
(``perfbench/faults.py``): it comes out not correct, and a number that
the fault fails is one that the same run without the fault passes, so the
check catches the fault itself. (The limits are the cell's own, set at
its full size; a tiny model's sound run need not pass every one.)"""

import time

import pytest
import torch

from perfbench import harness
from perfbench.tests.tiny import tiny_cfg, tiny_cell  # noqa: F401 (fixtures)
from perfbench.faults import FAULTS, planted

CELLS = [w["name"] for w in harness.manifest()["workloads"]]
SEED = 2**31 + 12345


def _run(cell):
    return harness.run(cell, SEED, 0.3, False, torch.device("cpu"), time.perf_counter(),
                       log=lambda msg: None)


def _failed(result) -> set:
    return {k for k, c in result["checks"].items() if not c["value"] <= c["limit"]}


@pytest.mark.parametrize("workload, fault", [
    (w, f) for w in CELLS
    for f in FAULTS[harness.load_cell(w).mix["runner"]]])
def test_fault_is_caught(tiny_cell, workload, fault):
    cell = tiny_cell(workload)
    sound = _run(cell)
    assert list(sound)[-1] == "checks"
    with planted(cell.mix["runner"], fault):
        faulty = _run(cell)
    assert not faulty["correct"], faulty["checks"]
    assert _failed(faulty) - _failed(sound), (sound["checks"], faulty["checks"])
