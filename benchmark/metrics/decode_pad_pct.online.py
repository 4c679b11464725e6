"""Share of the decoder frames of ParrotTTS.plan's decode batches (rows x
decoder length) that return no unit: 1 - units / frames, in %."""

from harness import readers


def read(run):
    return readers.decode_pad_pct(run)
