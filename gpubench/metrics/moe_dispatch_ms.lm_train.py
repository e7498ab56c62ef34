"""Device ms per LM train step in lm.moe.route and lm.moe.dispatch (models/layers.py::moe_ffn), remat recompute included."""
from gbench import spans


def read(rec):
    return spans.span_ms(rec, "lm.moe.route", "lm.moe.dispatch")
