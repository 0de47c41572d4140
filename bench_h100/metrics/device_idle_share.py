"""Share of the traced stretch in which no device operation ran."""

from bench_h100.metrics import common


def read(trace):
    return common.idle_share(trace)
