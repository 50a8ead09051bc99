"""The control of each cell's comparison (the plain reference with TF32
matrix products in the program's place) fails at least one number, and
the program passes them all, at a size a CPU test holds.  On the chip
``python -m spectrobench.calibrate --control`` reads both at the cells'
own sizes."""

import time

import pytest
import torch

from spectrobench import manifest, run
from spectrobench.tests.conftest import SMALL


@pytest.mark.parametrize("cell,units", [("mars15_lte.forward", 2),
                                        ("mars15_lte.retrieve", 1)])
def test_the_control_fails_and_the_program_passes(cell, units):
    man = manifest.load(pending=True)
    rec = run.run_cell(cell, 23, 0.1, False, torch.device("cpu"),
                       time.time(), man, overrides=SMALL, max_units=units,
                       control=True)
    lim = manifest.limits(cell)
    prog, ctrl = rec["check"]["program"], rec["check"]["control"]
    assert all(prog[k] <= lim[k] for k in lim), prog
    assert any(ctrl[k] > lim[k] for k in lim), ctrl
