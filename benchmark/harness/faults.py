"""Faults planted in the timed path, underneath the benchmark, where each
answer is produced: a unit altered where the decode takes its argmax,
one frame more for every token where durations are rounded, a waveform
1% louder where the generator returns it. A run with any of them has to
come out not correct (`tests/test_bench_faults.py`, and `readings.py
--fault` on the card)."""

import contextlib
import importlib
from unittest import mock


def _alter_first_unit(real):
    def infer_codes(*args, **kwargs):
        out = real(*args, **kwargs)
        codes = out[0].clone()
        codes[:, 0] = (codes[:, 0] + 1) % 1000
        return (codes,) + tuple(out[1:])
    return infer_codes


def _one_more_frame(real):
    def durations_from_log_pred(log_dur):
        return real(log_dur) + 1
    return durations_from_log_pred


def _louder(real):
    def apply_code_generator(*args, **kwargs):
        return real(*args, **kwargs) * 1.01
    return apply_code_generator


# name: (module, function, wrapper, the number it has to fail)
FAULTS = {
    "unit": ("parrot_tts_tpu_torch.models.tte.parrot", "infer_codes",
             _alter_first_unit, "unit_gap"),
    "frame": ("parrot_tts_tpu_torch.ops.length_regulator",
              "durations_from_log_pred", _one_more_frame, "dur_gap"),
    "louder": ("parrot_tts_tpu_torch.models.vocoder.generator",
               "apply_code_generator", _louder, "wave_err"),
}


@contextlib.contextmanager
def planted(name: str | None):
    """The fault `name` in place for the block (None: none)."""
    if name is None:
        yield
        return
    module, function, wrap, _ = FAULTS[name]
    mod = importlib.import_module(module)
    with mock.patch.object(mod, function, wrap(getattr(mod, function))):
        yield
