"""The vocoder stage's wall time (ParrotTTS.last_stats vocoder_s, waveforms
on the host) summed over the window, per audio second served, in ms."""

from harness import readers


def read(run):
    return readers.stage_ms_per_audio_s(run, "vocoder_s")
