"""Kernels: the routed experts' least time over the rows routed, over the
Super Kernel's device time, in %."""
from perfbench import readers


def read(rec):
    return readers.super_gmm_roofline(rec)
