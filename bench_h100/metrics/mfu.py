"""Analytic FLOPs of the stretch's images over its wall time, as a share of the card's dense peak."""

from bench_h100.metrics import common


def read(trace):
    return common.mfu(trace, train=trace.mix["kind"] == "train")
