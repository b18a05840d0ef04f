"""Engine: 90th percentile of the window's requests' wait, due time to
their batch's first attention dispatch, in ms."""
from perfbench import readers


def read(rec):
    return readers.queue_wait_p90_ms(rec)
