"""The whole step: model FLOPs of the prompts completed in the traced
window over the window at the bf16 peak, in %."""
from perfbench import readers


def read(rec):
    return readers.mfu_pct(rec)
