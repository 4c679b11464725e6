"""Device busy time (the union of every device operation's interval) over
the requests served in the traced window, in ms."""

from harness import readers


def read(run):
    return readers.busy_ms_per_request(run)
