"""Executor: the port's host-sync counter over the window, per batch-layer
the executor logged."""
from perfbench import readers


def read(rec):
    return readers.host_syncs_per_batch_layer(rec)
