"""Device time of the convolutions (cuDNN's and hand-written, their layout transposes included) an image."""

from bench_h100.metrics import common


def read(trace):
    return common.per_image_ms(trace, common.CONV)
