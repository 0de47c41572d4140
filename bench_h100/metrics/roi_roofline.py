"""K2's (and in training K3's) share of its bytes roofline at the cell's shapes."""

from bench_h100.metrics import common


def read(trace):
    return common.roi_roofline(trace, train=trace.mix["kind"] == "train")
