"""Device kernels the profiler recorded per HGNN train step."""
from gbench import readers


def read(rec):
    return readers.launches_per_step(rec)
