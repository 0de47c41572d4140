"""Profiling and memory diagnostics on a CUDA device.

The JAX package's `utils/profiling.py` in PyTorch:

  * `trace(logdir)`: a `torch.profiler` trace (host and CUDA activity) of
    everything inside the context, written into `logdir` as a Chrome trace
    (open in Perfetto or chrome://tracing); the CLI's --profile-dir.
  * `device_memory_summary()`: the caching allocator's live and peak bytes
    and the card's memory, per device.
  * `step_memory_analysis(step, arguments)`: one step's memory, with the
    keys of the JAX package's `compiled_memory_analysis` (see there).
  * `nan_guard()`: autograd anomaly mode with NaN checks, and
    `check_finite` for each step's losses; the CLI's --debug-nans.
  * `device_profile(fn)`: the card's busy time, idle share and kernel
    launches over warm calls of `fn`, by layer (`PROFILE_LAYERS`); what
    the stage-isolation scripts and `chip_smoke.py` print beside a time.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional, Sequence

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything inside the context with `torch.profiler` (CPU
    activity, and CUDA activity where a card is present) and write the
    Chrome trace to `logdir/trace.json`. Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def device_memory_summary(device=None) -> Dict[str, Dict[str, float]]:
    """Per CUDA device ("cuda:0", ...): `bytes_in_use_mb` and
    `peak_bytes_in_use_mb` (the caching allocator's live tensors, now and at
    the peak since the last reset) and `bytes_limit_mb` (the card's memory).
    Empty without a card, or for a CPU `device`, whose allocator keeps no
    such statistics (as the JAX package's summary is on a CPU)."""
    if not torch.cuda.is_available():
        return {}
    if device is not None and torch.device(device).type != "cuda":
        return {}
    if device is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        d = torch.device(device)
        devices = [d if d.index is not None else torch.device("cuda", torch.cuda.current_device())]
    stats = {}
    for d in devices:
        mem = torch.cuda.memory_stats(d)
        _, total = torch.cuda.mem_get_info(d)
        stats[str(d)] = {
            "bytes_in_use_mb": mem.get("allocated_bytes.all.current", 0) / 2**20,
            "peak_bytes_in_use_mb": mem.get("allocated_bytes.all.peak", 0) / 2**20,
            "bytes_limit_mb": total / 2**20,
        }
    return stats


def _mb(tensors: Sequence[torch.Tensor]) -> float:
    return sum(t.numel() * t.element_size() for t in tensors) / 2**20


def step_memory_analysis(step: Callable[[], object], arguments: Sequence[torch.Tensor]) -> Dict[str, Optional[float]]:
    """Run `step()` once and return its memory in MiB under the keys of the
    JAX package's `compiled_memory_analysis`:

      * `argument_mb`: the bytes of `arguments` (the parameters, the
        optimizer state and the batch; the step updates the parameters and
        the state in place, so they are not outputs again);
      * `output_mb`: the bytes of the tensors `step()` returns;
      * `temp_mb`: the peak the caching allocator reached during the step
        above what was allocated before it, after
        `torch.cuda.reset_peak_memory_stats`: activations, gradients and
        scratch. None on a CPU device, whose allocator keeps no peak: it is
        not measured there;
      * `generated_code_mb`: 0.0. PyTorch runs compiled kernels; it builds
        no program of the step's own.
    """
    dev = arguments[0].device
    temp = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = step()
        torch.cuda.synchronize(dev)
        temp = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
    else:
        out = step()
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return {
        "temp_mb": temp,
        "argument_mb": _mb(arguments),
        "output_mb": _mb([t for t in outs if torch.is_tensor(t)]),
        "generated_code_mb": 0.0,
    }


@contextlib.contextmanager
def nan_guard():
    """Raise at the first NaN: autograd anomaly mode with NaN checks (a
    backward function that returns NaN raises, naming the forward op that
    made it), and `Engine.train_epoch` checks each step's losses with
    `check_finite`. Both read values on the host, so the train loop runs
    uncaptured inside (`models/faster_rcnn.CapturedStep`). The previous
    anomaly setting is restored on exit."""
    old = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(*old)


def check_finite(losses: torch.Tensor, first_step: int) -> None:
    """Raise FloatingPointError if a row of `losses` ((n, 4), one row a step
    from `first_step` on) holds a NaN or an infinity."""
    bad = ~torch.isfinite(losses).all(dim=-1)
    if bool(bad.any()):
        step = first_step + int(bad.nonzero()[0, 0])
        raise FloatingPointError(f"non-finite loss at step {step}: {losses[bad][0].tolist()}")


# Layer of a device kernel in `device_profile`: the first group one of whose
# patterns its name contains.
PROFILE_LAYERS = (
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
    # Other GEMMs: cuBLAS's (fc layers, heads), and in the f32 train step also
    # cuDNN's GEMM-named conv-backward kernels (the complex-f32 ones are its
    # FFT convolution); top_kernels_ms in the output tells them apart.
    ("matmul (cuBLAS, and cuDNN GEMMs)", ("gemm", "nvjet")),
    ("optimizer", ("multi_tensor_apply",)),
    ("sort", ("Sort", "sort", "radix")),
    ("elementwise and small ops", (
        "elementwise", "copy", "Memset", "Memcpy", "reduce", "Reduce", "softmax", "index", "gather",
        "scatter", "scan", "cat",
    )),
)


PROFILE_ATTEMPTS = 3


def device_profile(fn: Callable[[], object], reps: int = 3) -> Dict[str, object]:
    """`torch.profiler` over `reps` warm calls of `fn` (one call warms it
    first), ended by a synchronize: the wall time a call with the profiler
    on, the card's busy time a call (the sum of its kernels' and copies'
    device time), its idle share (1 - busy / wall), the device operations a
    call, and the busy time by layer (`PROFILE_LAYERS`) and by kernel.

    Without a card nothing is run and every number is "not measured". On
    the card the profiler now and then traces no device operation of a
    window (seen in one window of a `chip_smoke.py` run); such a window is
    profiled again, up to PROFILE_ATTEMPTS windows in all, and after that
    its device numbers are "not measured"."""
    if not torch.cuda.is_available():
        return dict.fromkeys(("wall_ms_per_call_profiler_on", "device_busy_ms_per_call", "device_idle_share",
                              "device_ops_per_call", "by_layer_ms", "top_kernels_ms"), "not measured")
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        out = _profile_window(fn, reps)
        if out["device_busy_ms_per_call"] != "not measured":
            break
    return out


def _profile_window(fn: Callable[[], object], reps: int) -> Dict[str, object]:
    """One torch.profiler window of `reps` warm calls of `fn` on the card."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    by_layer: Dict[str, float] = {}
    launches, kernels = 0, []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.self_device_time_total <= 0:
            continue
        if evt.key.startswith("Optimizer."):
            continue  # torch.optim's annotation: a device range over kernels counted on their own
        layer = next((name for name, pats in PROFILE_LAYERS if any(s in evt.key for s in pats)), "other")
        ms = evt.self_device_time_total / 1e3 / reps
        by_layer[layer] = by_layer.get(layer, 0.0) + ms
        launches += evt.count
        kernels.append((ms, layer, evt.key[:90]))
    busy = sum(by_layer.values())
    measured = busy > 0
    return {
        "wall_ms_per_call_profiler_on": wall_ms,
        "device_busy_ms_per_call": busy if measured else "not measured",
        "device_idle_share": max(0.0, 1.0 - busy / wall_ms) if measured else "not measured",
        "device_ops_per_call": launches / reps if measured else "not measured",
        "by_layer_ms": dict(sorted(by_layer.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": [[ms, layer, name] for ms, layer, name in sorted(kernels, reverse=True)[:12]],
    }
