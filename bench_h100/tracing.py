"""The traced stretch of a `--trace 1` run: torch.profiler over a steady
part of the window, kept in memory (no trace file), reduced to what the
metric readers and the result line's `breakdown` read."""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from bench_h100.yardstick import kernels


class Profiler:
    """torch.profiler (host and device activity) between `start` and
    `stop`, on the calling thread. `trace()` reduces what it recorded."""

    def __init__(self):
        self._prof = None
        self.started = self.stopped = False
        self.host_s = 0.0
        self.started_at = 0.0

    @staticmethod
    def warm_up() -> None:
        """Start and stop the profiler once: its first start initialises
        CUPTI and takes seconds, which belongs to set-up, not the stretch."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        with profile(activities=activities):
            torch.zeros(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)
            if torch.cuda.is_available():
                torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self.started = True
        self._t0 = self.started_at = time.perf_counter()

    def stop(self) -> None:
        if self.started and not self.stopped:
            self.host_s = time.perf_counter() - self._t0
            self._prof.__exit__(None, None, None)
            self.stopped = True

    def events(self):
        return self._prof.profiler.kineto_results.events() if self.stopped else []


class Trace:
    """Device operations of the stretch, and what it covered.

    `ops`: (name, start_s, end_s) of every device operation, clipped to the
    stretch; `window_s`: the stretch's length (from its first to its last
    host event); `busy_s`: the union of the device intervals; `images`,
    `batches`, `steps`: the work the stretch covered, counted by the
    harness; `epochs`: the window's `Engine.last_epoch_trace` dicts (train
    cells); `config`, `mix`: the cell's configuration and traffic files.
    """

    def __init__(self, events, config: dict, mix: dict, images: int = 0, batches: int = 0, steps: int = 0,
                 epochs: Sequence[dict] = ()):
        self.config, self.mix = config, mix
        self.images, self.batches, self.steps = images, batches, steps
        self.epochs = list(epochs)
        host: List[Tuple[str, float, float]] = []
        device: List[Tuple[str, float, float]] = []
        for e in events:
            start = e.start_ns() * 1e-9
            end = start + e.duration_ns() * 1e-9
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                device.append((e.name(), start, end))
            else:
                host.append((e.name(), start, end))
        self.host = host
        if host:
            lo, hi = min(s for _, s, _ in host), max(e for _, _, e in host)
        elif device:
            lo, hi = min(s for _, s, _ in device), max(e for _, _, e in device)
        else:
            lo = hi = 0.0
        self.lo, self.hi = lo, hi
        self.ops = [(n, max(s, lo), min(e, hi)) for n, s, e in device if min(e, hi) > max(s, lo)]
        self.window_s = hi - lo
        self.busy_s = kernels.union_seconds((s, e) for _, s, e in self.ops)

    def layer_seconds(self, layers: Sequence[str]) -> float:
        if not hasattr(self, "_by_layer"):
            names: Dict[str, str] = {}
            self._by_layer: Dict[str, float] = defaultdict(float)
            for n, s, e in self.ops:
                if n not in names:
                    names[n] = kernels.layer_of(n)
                self._by_layer[names[n]] += e - s
        return sum(self._by_layer.get(layer, 0.0) for layer in layers)

    def kernel_stats(self, name: str) -> Tuple[int, float]:
        """(launches, device seconds) of the kernels whose name contains `name`."""
        hits = [e - s for n, s, e in self.ops if name in n]
        return len(hits), sum(hits)

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the idle gaps
        summed by the innermost host operation open at each gap's middle."""
        by_op: Dict[str, float] = defaultdict(float)
        for n, s, e in self.ops:
            by_op[n[:120]] += e - s
        by_host: Dict[str, float] = defaultdict(float)
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        for a, b in kernels.gaps(((s, e) for _, s, e in self.ops), self.lo, self.hi):
            mid = 0.5 * (a + b)
            inner: Optional[Tuple[str, float, float]] = None
            # Host operations nest, so the innermost open one started
            # shortly before the middle: look back over the last few.
            i = bisect.bisect_right(starts, mid)
            for h in host[max(0, i - 256):i][::-1]:
                if h[2] >= mid and (inner is None or h[2] - h[1] < inner[2] - inner[1]):
                    inner = h
            by_host[inner[0][:120] if inner else "no traced host operation"] += b - a
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}
