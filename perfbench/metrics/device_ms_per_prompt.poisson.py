"""Device: busy ms of the traced window per prompt completed in it."""
from perfbench import readers


def read(rec):
    return readers.device_ms_per_prompt(rec)
