"""The check fails where it must: the reference in bfloat16 in the
program's place (the control), and a run with the timed path broken
underneath (`lib/faults.py`), at 64x40 on the CPU."""

import pytest
import torch

from portbench.calibrate import readings
from portbench.lib import faults, harness, traffic
from portbench.tests import small

ENTRY_CELL = {}
for _name in small.CELLS:
    ENTRY_CELL.setdefault(harness.load_cell(_name).mix["entry"], _name)


def _fails(numbers: dict, limits: dict) -> list:
    return [k for k, v in numbers.items() if v > limits[k]]


@pytest.mark.parametrize("name", sorted(set(ENTRY_CELL.values())))
def test_control_fails_the_check(name):
    cell = small.cell(name)
    (_, numbers, _), = readings(cell, [small.SEED], 0, torch.device("cpu"), control=True)
    assert _fails(numbers, cell.limits), numbers


@pytest.mark.parametrize("name, fault", [(name, fault) for entry, name in sorted(ENTRY_CELL.items())
                                         for fault in traffic.entry_module(entry).FAULTS])
def test_a_broken_run_is_not_correct(name, fault):
    cell = small.cell(name)
    with faults.planted(fault, cell.mix["entry"]):
        result, _ = harness.execute(cell, small.SEED, 0.1, False, "cpu")
    assert not result["correct"], result["checks"]
