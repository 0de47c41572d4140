"""K1, the greedy-NMS keep-mask kernel, at the main paths' shapes.

For each case below the script holds the kernel's keep-mask against
`nms_keep_mask_plain`'s (they must be identical, or it exits 1), then prints
one JSON line: the kernel's time (`ms`, the mean of `--reps` warm calls of
`ops/nms.nms_keep_mask`, CUDA events), the accepts, and the peak device
memory the call adds (`peak_bytes`: its scratch and its output). With
`--profile` each device kernel's time per call, from torch.profiler.

  rpn          4 x 6000 -> 300 at IoU 0.7: the RPN's NMS in predict
  per_class    80 x 300 -> 300 at IoU 0.3: predict's per-class NMS (4 images x 20 classes)
  train        4 x 12000 -> 2000 at IoU 0.7: the RPN's NMS in a train step
  train_scene  the train case on boxes piled onto a few objects an image

Inputs are made on the host from a seeded numpy generator, in score order,
with one box in ten invalid. `spread` boxes lie uniformly over a 600x800
image, 16-300 pixels a side: at IoU 0.7 nearly every box is accepted, so
the cut at max_keep ends the scan early. `clustered` boxes are jittered
copies of 4-16 objects' boxes, as an RPN's proposals pile onto the objects
of a real scene: most are suppressed, the accepts stall below max_keep,
and the scan walks every candidate.

The script imports only `fasterrcnn_torch.ops.nms` and `profile_conv.time_ms`
from the package, so it can time another checkout's kernel on the same
inputs: `PYTHONPATH=<checkout> python fasterrcnn_torch/scripts/profile_nms.py`.

Usage (on the card; no fallback):
    python -m fasterrcnn_torch.scripts.profile_nms [--reps 20] [--profile]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np

IMAGE_HW = (600.0, 800.0)

# label -> (problems, boxes a problem, IoU threshold, max_keep, box layout)
CASES = {
    "rpn": (4, 6000, 0.7, 300, "spread"),
    "per_class": (80, 300, 0.3, 300, "spread"),
    "train": (4, 12000, 0.7, 2000, "spread"),
    "train_scene": (4, 12000, 0.7, 2000, "clustered"),
}


def sorted_boxes(rng, n, k, img_h=IMAGE_HW[0], img_w=IMAGE_HW[1]):
    """(n, k, 4) f32 corner boxes in score order, spread over an image."""
    cy = rng.uniform(0, img_h, (n, k))
    cx = rng.uniform(0, img_w, (n, k))
    h = rng.uniform(16, 300, (n, k))
    w = rng.uniform(16, 300, (n, k))
    return np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1).astype(np.float32)


def clustered_boxes(rng, n, k, img_h=IMAGE_HW[0], img_w=IMAGE_HW[1]):
    """(n, k, 4) f32 corner boxes in score order, piled onto 4-16 objects an
    image: each box is one object's box with its centre moved by up to ~10%
    of the object's size and each side scaled by ~exp(N(0, 0.15))."""
    out = np.empty((n, k, 4), np.float32)
    for p in range(n):
        m = int(rng.integers(4, 17))
        oh = rng.uniform(40, 0.6 * img_h, m)
        ow = rng.uniform(40, 0.6 * img_w, m)
        oy = rng.uniform(oh / 2, img_h - oh / 2)
        ox = rng.uniform(ow / 2, img_w - ow / 2)
        obj = rng.integers(0, m, k)
        h = oh[obj] * np.exp(rng.normal(0, 0.15, k))
        w = ow[obj] * np.exp(rng.normal(0, 0.15, k))
        cy = oy[obj] + 0.1 * oh[obj] * rng.normal(0, 1, k)
        cx = ox[obj] + 0.1 * ow[obj] * rng.normal(0, 1, k)
        out[p] = np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1)
    return out


def case_inputs(rng, label):
    """(boxes (n, k, 4) f32, valid (n, k) bool) of one case, as numpy."""
    n, k, _, _, layout = CASES[label]
    boxes = (sorted_boxes if layout == "spread" else clustered_boxes)(rng, n, k)
    return boxes, rng.uniform(size=(n, k)) > 0.1


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0].strip()


def kernel_times(fn, reps: int) -> Dict[str, float]:
    """Device ms per call of each kernel that fn launches (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {
        evt.key[:60]: evt.self_device_time_total / 1e3 / reps
        for evt in prof.key_averages()
        if evt.device_type == torch.autograd.DeviceType.CUDA and evt.self_device_time_total > 0
    }


def run(reps: int, profile: bool) -> List[Dict]:
    import torch
    from fasterrcnn_torch.ops import nms as nms_ops
    from fasterrcnn_torch.scripts.profile_conv import time_ms

    dev = torch.device("cuda")
    rows = []
    for label, (n, k, thr, max_keep, layout) in CASES.items():
        boxes_np, valid_np = case_inputs(np.random.default_rng(0), label)
        boxes, valid = torch.from_numpy(boxes_np).to(dev), torch.from_numpy(valid_np).to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        got = nms_ops.nms_keep_mask(boxes, valid, thr, max_keep)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - resident
        want = nms_ops.nms_keep_mask_plain(boxes, valid, thr, max_keep)
        mismatches = int((got != want).sum())
        row = dict(
            case=label, shape=[n, k], iou_threshold=thr, max_keep=max_keep, boxes=layout,
            accepts=int(got.sum()), mismatches=mismatches,
            ms=time_ms(lambda: nms_ops.nms_keep_mask(boxes, valid, thr, max_keep), reps),
            peak_bytes=peak,
        )
        if profile:
            row["kernel_ms"] = kernel_times(lambda: nms_ops.nms_keep_mask(boxes, valid, thr, max_keep), reps)
        print(json.dumps(row), flush=True)
        rows.append(row)
        if mismatches:
            print(f"profile_nms: {label}: {mismatches} keep-mask entries differ from the plain version",
                  file=sys.stderr, flush=True)
            sys.exit(1)
    return rows


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--profile", action="store_true", help="also each device kernel's time (torch.profiler)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_nms: no CUDA device")
    card = card_line()
    print(f"card: {card}", flush=True)
    rows = run(args.reps, args.profile)
    print(f"card: {card}", flush=True)
    return rows


if __name__ == "__main__":
    main()
