"""Audio seconds returned by every tts() call of the window, over the time
from the window's opening to the last call's return (closed mixes)."""

from harness import readers


def read(run):
    return readers.audio_s_per_s(run)
