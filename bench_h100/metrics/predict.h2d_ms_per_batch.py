"""Device time of the host-to-device copies a predict batch."""

from bench_h100.metrics import common


def read(trace):
    return common.per_unit_ms(trace, common.COPY_IN, trace.batches)
