"""Device: share of the traced window with no operation on the device, in %."""
from perfbench import readers


def read(rec):
    return readers.device_idle_pct(rec)
