"""On the card, at the cells' own size: the program within its limits and
the control outside them, for one seed of each entry."""

import pytest
import torch

from portbench.calibrate import readings
from portbench.lib import harness

CELLS = ("bvh.pt", "bvh.whitted", "bvh.grad")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the cells run at 1280x720 on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_program_within_and_control_outside_the_limits(card, name):
    cell = harness.load_cell(name)
    units = 32 if cell.mix["entry"] == "whitted_frames" else 0
    (_, sound, _), = readings(cell, [5000000001], units, card)
    assert all(v <= cell.limits[k] for k, v in sound.items()), sound
    (_, control, _), = readings(cell, [5000000001], 0, card, control=True)
    assert any(not v <= cell.limits[k] for k, v in control.items()), control
