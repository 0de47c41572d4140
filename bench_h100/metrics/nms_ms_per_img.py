"""Device time of K1's two kernels (IoU mask, scan) an image."""

from bench_h100.metrics import common


def read(trace):
    return common.per_image_ms(trace, common.NMS)
