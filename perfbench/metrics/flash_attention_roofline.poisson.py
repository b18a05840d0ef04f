"""Kernels: causal attention's least time over the valid lengths, over the
flash kernels' device time, in %."""
from perfbench import readers


def read(rec):
    return readers.flash_roofline(rec)
