"""Device operations by layer, and the card's busy time.

`LAYERS` is a frozen copy of the port's `utils/profiling.PROFILE_LAYERS`:
a device operation belongs to the first group one of whose patterns its
name contains. Busy time is the length of the union of the device
intervals, so work on two streams at once (the train loop's copy stream
beside the step's kernels) counts once.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

LAYERS = (
    ("nms_keep_mask", ("nms_iou_mask_kernel", "nms_scan_kernel")),
    ("roi_pool_taps_bwd", ("roi_pool_taps_bwd_kernel",)),
    ("roi_pool_taps", ("roi_pool_taps_kernel",)),
    ("roi_pool_fused", ("roi_pool_fused_kernel",)),
    ("conv (hand-written)", (
        "conv3x3_f32_kernel", "conv3x3_im2col_f32_kernel", "conv3x3_bf16_kernel", "conv3x3_im2col_bf16_kernel",
    )),
    ("host-to-device copy", ("Memcpy HtoD",)),
    ("max pool", ("max_pool",)),
    ("conv (cuDNN)", (
        "fprop", "dgrad", "wgrad", "implicit_gemm", "convolve", "winograd", "nchwToNhwc", "nhwcToNchw",
    )),
    ("matmul (cuBLAS, and cuDNN GEMMs)", ("gemm", "nvjet")),
    ("optimizer", ("multi_tensor_apply",)),
    ("sort", ("Sort", "sort", "radix")),
    ("elementwise and small ops", (
        "elementwise", "copy", "Memset", "Memcpy", "reduce", "Reduce", "softmax", "index", "gather",
        "scatter", "scan", "cat",
    )),
)


def layer_of(name: str) -> str:
    return next((layer for layer, pats in LAYERS if any(s in name for s in pats)), "other")


def union_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, cur_start, cur_end = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers, in order."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]
