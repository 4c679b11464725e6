"""Seconds from the process's start to the window's opening: weights, the
system's construction, kernel builds, warm-up."""


def read(run):
    return run.setup_s
