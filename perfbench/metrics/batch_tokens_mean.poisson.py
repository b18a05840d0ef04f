"""Engine: real prompt tokens per executor job completed in the window."""
from perfbench import readers


def read(rec):
    return readers.batch_tokens_mean(rec)
