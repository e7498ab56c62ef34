"""K4 (csrc/flash_attention.cu) over its operation bound, per recorded launch, in a prefill, in %."""
from gbench import readers


def read(rec):
    return readers.roofline_pct(rec, {"K4": "fa_forward"}, "k4_launches")
