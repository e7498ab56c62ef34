"""Device ms per HGNN train step in the NA spans: hgnn.na (forward, gather to scatter) and hgnn.na.backward (the NA Functions' backward)."""
from gbench import spans


def read(rec):
    return spans.span_ms(rec, "hgnn.na", "hgnn.na.backward")
