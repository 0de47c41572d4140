"""K2 and K3, the RoI crop+pool kernels, at the main paths' shapes.

For each case below the script holds the kernel against its plain version
(K2 identical to `roi_pool_features`; K3 within `backward_close` of
`roi_pool_taps_bwd_plain`; otherwise it exits 1), then prints one JSON line
per (kernel, case, dtype, map): the time of the wrapper's call (`ms`, the
mean of `--reps` warm calls, CUDA events: for K3 that includes zeroing the
f32 accumulator and the cast back), the least time the card could take
(`bound_ms`, computed from this run's inputs as `chip_smoke.py` computes it)
and the share of the bound (`bound_ms / ms`). With `--profile`, each device
kernel's time per call, from torch.profiler.

  predict  K2 at (4, 38, 50, 512) x 300 RoIs an image: the predict path
  train    K3 at (4, 38, 50, 512) x 128 RoIs an image: the train step
  c1024    both at (4, 38, 50, 1024), x 300 and x 128: ResNet's C4 width

Each in f32 and bf16, on a normal map (`normal`) and on a ReLU'd one
(`relu`, as VGG's conv5_3 output is). The map and the cotangent are normal
draws; the RoIs are drawn as `chip_smoke.py` draws them (corners spread
over a 600x800 image, 16 to half the image a side, some past its top-left
edge) on the 37x50 real grid of the 38x50 canvas map.

The script imports only `fasterrcnn_torch.ops.roi` and
`profile_conv.time_ms` from the package, so it can time another checkout's
kernels on the same inputs:
`PYTHONPATH=<checkout> python fasterrcnn_torch/scripts/profile_roi.py`.

Usage (on the card; no fallback):
    python -m fasterrcnn_torch.scripts.profile_roi [--reps 20] [--profile] [--cases predict,train,c1024]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
IMAGE_HW = (600.0, 800.0)
REAL_GRID = (37, 50)  # the real feature grid of a 600x800 image on the 38x50 canvas map

MAP_BHW = (4, 38, 50)
# label -> ((kernel, C, RoIs an image), ...)
CASES = {
    "predict": (("roi_pool_taps", 512, 300),),
    "train": (("roi_pool_taps_bwd", 512, 128),),
    "c1024": (("roi_pool_taps", 1024, 300), ("roi_pool_taps_bwd", 1024, 128)),
}


def draw_rois(rng, b: int, p: int, img_h: float = IMAGE_HW[0], img_w: float = IMAGE_HW[1]) -> np.ndarray:
    """(b, p, 4) f32 pixel corners (y1, x1, y2, x2), as chip_smoke.py draws them."""
    y1 = rng.uniform(-20, img_h * 0.8, (b, p))
    x1 = rng.uniform(-20, img_w * 0.8, (b, p))
    rois = np.stack(
        [y1, x1, y1 + rng.uniform(16, img_h * 0.5, (b, p)), x1 + rng.uniform(16, img_w * 0.5, (b, p))], -1
    )
    return rois.astype(np.float32)


def roi_norm(b: int, img_h: float = IMAGE_HW[0], img_w: float = IMAGE_HW[1]) -> np.ndarray:
    return np.tile([[(REAL_GRID[0] - 1) / img_h, (REAL_GRID[1] - 1) / img_w]], (b, 1)).astype(np.float32)


def inside_samples(rois, norm, h: int, w: int) -> int:
    """Bilinear samples, of the 14x14 per RoI, that fall inside the map."""
    import torch

    steps = torch.tensor([s / 13 for s in range(14)], dtype=torch.float32, device=rois.device)
    r = rois * norm[:, (0, 1, 0, 1)][:, None, :]
    ys = r[..., 0:1] + (r[..., 2:3] - r[..., 0:1]) * steps
    xs = r[..., 1:2] + (r[..., 3:4] - r[..., 1:2]) * steps
    in_y = ((ys >= 0) & (ys <= h - 1)).sum(-1)
    in_x = ((xs >= 0) & (xs <= w - 1)).sum(-1)
    return int((in_y * in_x).sum().item())


def tied_inside_samples(fm, rois, norm) -> int:
    """Sample values inside the map that equal their 2x2 window's max: the
    samples the backward scatters from."""
    import torch
    from fasterrcnn_torch.ops import roi as roi_ops

    b, h, w, c = fm.shape
    p = rois.shape[1]
    ys, xs = roi_ops._sample_positions(rois, norm)
    inside = ((ys >= 0) & (ys <= h - 1))[..., :, None] & ((xs >= 0) & (xs <= w - 1))[..., None, :]
    window = roi_ops.crop_and_resize(fm, rois, norm).reshape(b, p, 7, 2, 7, 2, c)
    tied = (window == window.amax(dim=(3, 5), keepdim=True)).reshape(b, p, 14, 14, c)
    return int((tied & inside[..., None]).sum().item())


def _bound(bytes_moved: float, ops: float) -> Dict[str, object]:
    by_bytes, by_ops = bytes_moved / HBM_BYTES_PER_S, ops / F32_FLOPS
    return dict(bound_ms=1e3 * max(by_bytes, by_ops), bound_by="bytes" if by_bytes >= by_ops else "operations")


def forward_bound(fm, rois, norm) -> Dict[str, object]:
    """K2's least time: the map, RoIs and norm read once and the output
    written once, or its operations (each sample inside the map: 2 rows of
    2 y-taps and 2 x-taps, 3 operations a tap pair; then 3 maxes an output)."""
    b, h, w, c = fm.shape
    p = rois.shape[1]
    item = fm.element_size()
    ops = c * (9 * inside_samples(rois, norm, h, w) + 3 * b * p * 49)
    return _bound(b * h * w * c * item + b * p * 16 + b * 8 + b * p * 49 * c * item, ops)


def backward_bound(fm, rois, norm) -> Dict[str, object]:
    """K3's least time: the map, the cotangent, RoIs and norm read once and
    the map's cotangent written once, or its operations (the forward's
    samples recomputed: 9 a sample inside and 3 maxes an output; ties: 4
    comparisons, 3 adds and a division an output; each tied sample inside:
    2 x-weight and 4 y-weight products and 4 adds). Also the floor with the
    kernel's f32 accumulator: zeroed, added into and read once more, and for
    a bf16 map the cast's write."""
    b, h, w, c = fm.shape
    p = rois.shape[1]
    item = fm.element_size()
    outputs = b * p * 49 * c
    ops = 9 * inside_samples(rois, norm, h, w) * c + 11 * outputs + 10 * tied_inside_samples(fm, rois, norm)
    bytes_moved = 2 * b * h * w * c * item + outputs * item + b * p * 16 + b * 8
    accumulator = 2 * b * h * w * c * 4 + (b * h * w * c * 4 if item == 2 else 0)
    return dict(**_bound(bytes_moved, ops),
                bound_with_f32_accumulator_ms=1e3 * (bytes_moved + accumulator) / HBM_BYTES_PER_S)


def backward_close(got, want):
    """K3's tolerance: the kernel makes the plain version's argmax and tie
    decisions (both recompute the forward's samples bit for bit) but adds
    into the map with atomics, in an order that changes from run to run,
    and sums each sample row's x-taps for a column before its y-taps, where
    the plain version sums all x-taps of the row first. So each value may
    differ by 1e-5 of the largest; in bf16, after the one cast at the end,
    also by one bf16 step (2^-7 of the value). Returns (ok, max abs err)."""
    import torch

    rtol = 2.0**-7 if want.dtype == torch.bfloat16 else 0.0
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool((err <= 1e-5 * want.abs().max() + rtol * want.abs()).all())
    return ok, float(err.max())


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


def run(reps: int, profile: bool, cases: Sequence[str]) -> List[Dict]:
    import torch
    from fasterrcnn_torch.ops import roi as roi_ops
    from fasterrcnn_torch.scripts.profile_conv import time_ms

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' einsums must round as f32
    rows = []
    b, h, w = MAP_BHW
    for label in cases:
        for kernel, c, p in CASES[label]:
            rng = np.random.default_rng(0)
            fm32 = torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(np.float32)).to(dev)
            rois = torch.from_numpy(draw_rois(rng, b, p)).to(dev)
            norm = torch.from_numpy(roi_norm(b)).to(dev)
            g32 = torch.from_numpy(rng.normal(size=(b, p, 7, 7, c)).astype(np.float32)).to(dev)
            for layout in ("normal", "relu"):
                for dtype in (torch.float32, torch.bfloat16):
                    fm = (torch.relu(fm32) if layout == "relu" else fm32).to(dtype)
                    g = g32.to(dtype)
                    if kernel == "roi_pool_taps":
                        def fn():
                            return roi_ops.roi_pool_taps(fm, rois, norm)
                        got, want = fn(), roi_ops.roi_pool_features(fm, rois, norm)
                        ok, err = torch.equal(got, want), float((got.float() - want.float()).abs().max())
                        bound = forward_bound(fm, rois, norm)
                    else:
                        def fn():
                            return roi_ops.roi_pool_taps_bwd(fm, rois, norm, g)
                        ok, err = backward_close(fn(), roi_ops.roi_pool_taps_bwd_plain(fm, rois, norm, g))
                        bound = backward_bound(fm, rois, norm)
                    ms = time_ms(fn, reps)
                    row = dict(
                        kernel=kernel, case=label, dtype=str(dtype).replace("torch.", ""), map=layout,
                        shape=[b, h, w, c, p], max_abs_err=err, ms=ms, **bound, bound_share=bound["bound_ms"] / ms,
                    )
                    if profile:
                        row["kernel_ms"] = kernel_times(fn, reps)
                    print(json.dumps(row), flush=True)
                    rows.append(row)
                    if not ok:
                        print(f"profile_roi: {kernel} {label} {dtype} {layout}: differs from the plain version "
                              f"(max abs err {err!r})", file=sys.stderr, flush=True)
                        sys.exit(1)
    return rows


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--profile", action="store_true", help="also each device kernel's time (torch.profiler)")
    ap.add_argument("--cases", default=",".join(CASES), help="comma-separated subset of " + ",".join(CASES))
    args = ap.parse_args(argv)
    cases = [c for c in args.cases.split(",") if c]
    unknown = set(cases) - set(CASES)
    if unknown:
        ap.error(f"unknown cases {sorted(unknown)}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_roi: no CUDA device")
    card = card_line()
    print(f"card: {card}", flush=True)
    rows = run(args.reps, args.profile, cases)
    print(f"card: {card}", flush=True)
    return rows


if __name__ == "__main__":
    main()
