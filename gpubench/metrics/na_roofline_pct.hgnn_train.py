"""K1 and K2 (csrc/na_kernels.cu) over their byte bounds, per recorded launch, in a train step, in %."""
from gbench import readers


def read(rec):
    return readers.roofline_pct(rec, {"K1": "seg_sum_rows_kernel", "K2": "softmax_stats_rows_kernel"}, "na_launches")
