"""Device ms per prefill request in kernels.k4, around each K4 launch (kernels/flash_attention.py::_fa_forward), without the profiler."""
from gbench import spans


def read(rec):
    return spans.span_ms(rec, "kernels.k4")
