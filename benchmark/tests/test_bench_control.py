"""The controls: the system with its own lower-precision paths switched on,
or the reference's generator in a lower precision in the vocoder's place
(the configuration's "controls"), comes out not correct. On the card at
the cell's own size. On the CPU, which has no TF32, the bf16
configuration's e4m3 vocoder control at the published widths on a few
short requests, where it fails the waveform's number (a tiny width's
waveform is all but constant and shows no precision)."""

import pytest

import run
from harness import spec


def test_bf16_control_fails_on_the_cpu():
    cell = spec.load("bf16.bulk")
    cell.traffic = {**cell.traffic, "requests_per_call": 3,
                    "warmup": {"calls": 1},
                    "chars": {"dist": "uniform", "min": 20, "max": 40}}
    seed = 2**31 + 5
    sound = run.execute(cell, seed, 0.2, device="cpu")
    assert sound["correct"] is True
    res = run.execute(cell, seed, 0.2, device="cpu",
                      override=cell.config["controls"]["fp8"])
    assert res["correct"] is False
    assert res["checks"]["wave_err"]["value"] > \
        res["checks"]["wave_err"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload,seconds", [("f32.bulk", 13),
                                              ("bf16.bulk", 8)])
def test_controls_fail_at_the_cells_size_on_card(card, workload, seconds):
    cell = spec.load(workload)
    seed = 2**31 + 77
    assert run.execute(cell, seed, seconds)["correct"] is True
    for name, override in cell.config["controls"].items():
        res = run.execute(cell, seed, seconds, override=override)
        assert res["correct"] is False, name
