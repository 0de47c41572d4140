"""Device time of the optimizer's multi_tensor_apply kernels a train step."""

from bench_h100.metrics import common


def read(trace):
    return common.per_unit_ms(trace, common.OPTIMIZER, trace.steps)
