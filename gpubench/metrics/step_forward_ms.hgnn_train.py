"""Device ms per HGNN train step in the program's span train.forward (train/hgnn_step.py::value_and_grad)."""
from gbench import spans


def read(rec):
    return spans.span_ms(rec, "train.forward")
