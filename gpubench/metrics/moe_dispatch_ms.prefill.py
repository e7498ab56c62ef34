"""Device ms per prefill request in lm.moe.route and lm.moe.dispatch (models/layers.py::moe_ffn)."""
from gbench import spans


def read(rec):
    return spans.span_ms(rec, "lm.moe.route", "lm.moe.dispatch")
