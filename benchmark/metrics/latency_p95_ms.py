"""95th percentile over every request due in the window of the time from
its due time to its waveform's return, in ms (open mixes)."""

from harness import readers


def read(run):
    return readers.latency_ms(run, 95)
