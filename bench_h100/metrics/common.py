"""Arithmetic the metric readers share."""

from __future__ import annotations

from typing import Optional, Sequence

from bench_h100.yardstick import bounds, flops, peaks

CONV = ("conv (cuDNN)", "conv (hand-written)")
NMS = ("nms_keep_mask",)
COPY_IN = ("host-to-device copy",)
OPTIMIZER = ("optimizer",)
ROI_FORWARD = "roi_pool_taps_kernel"
ROI_BACKWARD = "roi_pool_taps_bwd_kernel"


def per_image_ms(trace, layers: Sequence[str]) -> Optional[float]:
    """Device milliseconds of the layers' operations an image of the stretch."""
    return per_unit_ms(trace, layers, trace.images)


def per_unit_ms(trace, layers: Sequence[str], units: int) -> Optional[float]:
    """Device milliseconds of the layers' operations a batch or a step."""
    s = trace.layer_seconds(layers)
    if s <= 0 or units <= 0:
        return None
    return 1e3 * s / units


def wait_share(trace) -> Optional[float]:
    """The train loop's main thread waiting for staged batches, as a share
    of its epochs' time (`Engine.last_epoch_trace`)."""
    if not trace.epochs:
        return None
    return 100.0 * sum(e["wait_s"] for e in trace.epochs) / max(sum(e["total_s"] for e in trace.epochs), 1e-9)


def idle_share(trace) -> Optional[float]:
    if trace.busy_s <= 0 or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def mfu(trace, train: bool) -> Optional[float]:
    """Analytic FLOPs of the stretch's images over its wall time, as a
    share of the card's dense peak in the configuration's compute type."""
    if trace.images <= 0 or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    model, mix = trace.config["model"], trace.mix
    rois = model["detector"]["proposal_batch_size"] if train else model["rpn"]["post_nms_infer"]
    peak = peaks.BF16_FLOPS if model["compute_dtype"] == "bfloat16" else peaks.F32_FLOPS
    work = flops.flops_per_image(model, mix["canvas"], rois, train) * trace.images
    return 100.0 * work / trace.window_s / peak


def roi_roofline(trace, train: bool) -> Optional[float]:
    """Least time of the stretch's K2 (and, in training, K3) launches, from
    the bytes each moves at the cell's shapes, over their device time."""
    model, mix = trace.config["model"], trace.mix
    ch, cw = mix["canvas"]
    s = model["anchors"]["feature_pixels"]
    vgg = model["backbone"] == "vgg16"
    h, w = (ch // s, cw // s) if vgg else (-(-ch // s), -(-cw // s))
    c = 512 if vgg else 1024
    item = 2 if model["compute_dtype"] == "bfloat16" else 4
    b = mix["batch"]
    p = model["detector"]["proposal_batch_size"] if train else model["rpn"]["post_nms_infer"]
    least = taken = 0.0
    for name, fn in ((ROI_FORWARD, bounds.forward_bytes), (ROI_BACKWARD, bounds.backward_bytes)):
        n, t = trace.kernel_stats(name)
        least += n * bounds.seconds(fn(b, h, w, c, p, item))
        taken += t
    if taken <= 0:
        return None
    return 100.0 * least / taken
