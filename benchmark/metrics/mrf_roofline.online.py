"""Row 6 (csrc/fused_mrf.cu): the bound of the window's fused MRF stages at
each request's trimmed samples over the kernel's device time, in %."""

from harness import readers


def read(run):
    return readers.mrf_roofline(run)
