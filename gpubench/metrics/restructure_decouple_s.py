"""Host seconds of the cold frontend's decouple stage (core/restructure.py), summed over metapaths, at set-up."""
from gbench import spans


def read(rec):
    return spans.setup_span_s(rec, "frontend.restructure.decouple")
