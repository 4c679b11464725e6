"""The whole serve: the model operations of every request at its own
tokens, frames and units, at the peak of its type, over the summed wall
time of the tts() calls, in %."""

from harness import readers


def read(run):
    return readers.mfu(run)
