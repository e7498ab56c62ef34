"""Device ms per LM train step in the program's span train.optimizer (clipping and AdamW)."""
from gbench import spans


def read(rec):
    return spans.span_ms(rec, "train.optimizer")
