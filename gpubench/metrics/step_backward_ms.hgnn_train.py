"""Device ms per HGNN train step in the program's span train.backward (torch.autograd.grad of the loss)."""
from gbench import spans


def read(rec):
    return spans.span_ms(rec, "train.backward")
