"""Device ms per LM train step in lm.attn.backward (FlashAttention.backward: the float32 attention VJP)."""
from gbench import spans


def read(rec):
    return spans.span_ms(rec, "lm.attn.backward")
