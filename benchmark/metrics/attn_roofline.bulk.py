"""Row 1 (csrc/flash_attn_fwd.cu, kernel and pre-pass): the bound of the
window's attention at each row's valid length over the kernels' device
time, in %."""

from harness import readers


def read(run):
    return readers.attn_roofline(run)
