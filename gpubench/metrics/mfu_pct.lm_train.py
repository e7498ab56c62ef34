"""Counted FLOPs of the traced lm_train window over the window times the peak the kind states, in %."""
from gbench import readers


def read(rec):
    return readers.mfu_pct(rec)
