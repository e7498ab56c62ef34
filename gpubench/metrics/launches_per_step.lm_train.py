"""Device kernels the profiler recorded per LM train step."""
from gbench import readers


def read(rec):
    return readers.launches_per_step(rec)
