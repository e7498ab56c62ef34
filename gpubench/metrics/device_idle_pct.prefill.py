"""Share of the traced prefill window in which the card ran nothing, in %."""
from gbench import readers


def read(rec):
    return readers.device_idle_pct(rec)
