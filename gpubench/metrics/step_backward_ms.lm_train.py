"""Device ms per LM train step in the program's span train.backward (remat recompute included)."""
from gbench import spans


def read(rec):
    return spans.span_ms(rec, "train.backward")
