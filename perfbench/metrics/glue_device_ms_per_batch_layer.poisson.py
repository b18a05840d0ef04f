"""Model glue: device ms of every operation that is neither a kernel of the
port nor a cuBLAS product, per batch-layer."""
from perfbench import readers


def read(rec):
    return readers.glue_ms_per_batch_layer(rec)
