"""A run with the timed path broken underneath comes out not correct
(`harness/faults.py`): a unit altered where the decode produces it, the
durations altered where they are rounded, a waveform altered where the
vocoder produces it. CPU, tiny width, the look for a card skipped."""

import pytest

import run
from conftest import tiny
from harness import faults


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("workload", ["f32.bulk", "bf16.bulk"])
def test_planted_fault_is_not_correct(workload, fault):
    cell = tiny(workload)
    with faults.planted(fault):
        res = run.execute(cell, 2**31 + 21, 0.5, device="cpu")
    assert res["correct"] is False
    check = res["checks"][faults.FAULTS[fault][3]]
    assert check["value"] > check["limit"]
