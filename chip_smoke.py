#!/usr/bin/env python3
"""Drive the PyTorch port (`fasterrcnn_torch`) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):
  1. card: require CUDA; print the card's name and power limit.
  2. build: compile every CUDA kernel of the port (K1-K6) from the sources
     in the checkout (one nvcc per source, in parallel); print the count of
     HGMMA (tensor-core warpgroup MMA) instructions in each conv library,
     and of those with a TF32 modifier (the f32 paths' 3xTF32 products), of
     128-bit global loads in K2's and K4's and of vector f32 reductions in
     K3's, and fail if any is 0.
  3. kernel parity: each kernel against its plain PyTorch version on the
     card, at its paths' shapes: NMS keep-masks identical, and identical
     again on a second launch, at the cases of
     `fasterrcnn_torch.scripts.profile_nms`: the predict RPN shape
     (4 x 6000 -> 300), the per-class shape (80 x 300), the train RPN shape
     (4 x 12000 -> 2000) on spread boxes and, as `train_scene`, on boxes
     piled onto a few objects (accepts stall below max_keep), each with its
     mask scratch and peak memory; RoI crop+pool, taps (K2)
     and the fused kernel's rounding (K4, on K2's column walk), on a
     (4, 38, 50, 512) map x 300 RoIs identical in f32 and in bf16 (each
     rounds where its TPU kernel rounds, and so does its plain version, so
     no value may differ), and K2 equal to K4 in f32; the RoI backward on
     the same map x 128 RoIs (the train shape), normal and ReLU'd, f32 and
     bf16, within the tolerance of `backward_close`; K2, K3 and K4 again at
     C=1024, at C=1030 (scalar lanes) and on a map one element past a
     16-byte boundary, and K2 and K4 on a (1, 38, 160, 512) map; the conv
     kernels K5 (blocks 5, 4 and 3: 4x38x50x512 -> 512, 4x76x100x512 ->
     512, 4x152x200x256 -> 256) and K6 (block 2, 4x304x400x128 -> 128,
     and conv2_1's 64 -> 128), f32 and
     bf16 (both on the tensor cores, f32 as 3xTF32), with and without ReLU,
     within `profile_conv.conv_close`, each case launched twice and required
     to give the same bits; CUDA
     inputs that
     require grad get a grad_fn from roi_pool_taps (its backward launches
     K3) and from both convs (their backward equals the plain version's).
     Beside each kernel its plain version, and for K5 and K6 the library
     convolution, are timed; K5 and K6 also alone, on operands packed once.
  4. reference: the tiny config (full-width VGG-16, 128x160 canvas) on the
     card against the same model on the CPU (plain versions), stage by stage
     on identical inputs, then the whole predict; then one train step's
     losses and gradients, with the same weights and the same draws, on a
     batch from its own seeded generator (`scripts/reference_train.py`).
  5. main path, predict: the default ModelConfig (VGG-16, 21 classes, caps
     6000 -> 300) at full width through Engine, on a 608x800 canvas, B=4,
     seeded random weights and images: predict at score thresholds 0.05 and
     0.0, one predict_image, and one bf16 predict; the kernels' launch
     counts must rise. TF32 is off for every parity phase.
  6. main path, train: the default ModelConfig at full width through
     Engine.train_step and Engine.train_epoch, B=4 synthetic 600x800
     samples on the 608x800 canvas: the f32 loss must fall over 10 steps on
     one batch, with all four losses positive at the first step; two steps
     of train_epoch; bf16 train steps; K1-K3 must launch.
  5b. the fused RoI op (K4's path): `roi_pool_fused`, the public op, on
     the predict path's own f32 feature map and RPN proposals; it must
     launch K4 and equal `roi_pool_fused_plain` and `roi_pool_taps` there,
     bit for bit, and on the same map cast to bf16 equal
     `roi_pool_fused_plain`.
  6b. conv A/B (K5's and K6's path): `fasterrcnn_torch.scripts.profile_conv`
     at --batch 4, bf16 and f32: every row timed, K5 and K6 launched (phase
     3 holds each kernel against its plain version at each of these
     shapes).
  7. timing: Engine.predict and Engine.train_step on the host's batch, ms
     per batch and img/s (f32 with TF32 off, f32 with cuDNN TF32 on, bf16),
     and the peak memory of the f32 call. Each kernel's time, with CUDA
     events beside its plain version's and its bound, is taken in phase 3.
  8. profile: torch.profiler over warm Engine.predict calls and warm
     Engine.train_step calls, f32 and bf16 with TF32 off: device time by
     layer, idle share, device ops per call.
Each path runs with every kernel's launch count set to 0 just before it and
read just after. Then, on the last lines: the card line, one JSON line of
the kernels, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
# H100 SXM TF32 tensor cores (494.7 TFLOP/s dense) spent three times for
# each f32-grade product: the fastest f32 rate, which 3xTF32 convs can reach.
TF32X3_FLOPS = 494.7e12 / 3

# The conv kernels' parity shapes, (B, H, W, C, Cout): VGG-16 blocks 5, 4
# and 3 (K5), block 2 and conv2_1 (K6), at the 608x800 canvas. They hold
# every shape the conv A/B gives each kernel at --batch 4.
CONV_CASES = (
    ("conv3x3", "block5", (4, 38, 50, 512, 512)),
    ("conv3x3", "block4", (4, 76, 100, 512, 512)),
    ("conv3x3", "block3", (4, 152, 200, 256, 256)),
    ("conv3x3_im2col", "block2", (4, 304, 400, 128, 128)),
    ("conv3x3_im2col", "conv2_1", (4, 304, 400, 64, 128)),
)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def nms_iou_tests(boxes, valid, keep, iou_threshold: float) -> int:
    """IoU tests the greedy scan makes on these inputs: each accept i tests
    every later valid box that no earlier accept has suppressed.

    A box j is tested by the accepts before it up to and including the first
    one that suppresses it (all of them if none does)."""
    import torch
    from fasterrcnn_torch.ops import boxes as box_ops

    n, k = keep.shape
    pos = torch.arange(k, device=keep.device)
    tests = 0
    for p in range(n):
        acc = keep[p].nonzero().squeeze(1)  # accepted indices, ascending
        if acc.numel() == 0:
            continue
        hit = (box_ops.iou_matrix(boxes[p, acc], boxes[p]) > iou_threshold) & (pos[None, :] > acc[:, None])
        first = torch.where(hit.any(0), hit.to(torch.uint8).argmax(0), acc.numel())
        before = torch.searchsorted(acc, pos)  # accepts with a lower index than j
        tests += int(torch.minimum(before, first + 1)[valid[p]].sum().item())
    return tests


# f32 operations of one IoU test with the later box's area computed once per
# box (3 operations): 4 min/max, 2 side lengths, 2 clamps at 0, 1 product,
# 3 for the union, 1 division, 1 comparison.
NMS_OPS_PER_TEST = 14


def phase_kernel_parity(dev, rng):
    import torch
    from fasterrcnn_torch.ops import nms as nms_ops
    from fasterrcnn_torch.scripts import profile_nms
    from fasterrcnn_torch.scripts.profile_conv import time_ms

    results = {}
    for label, (n, k, thr, max_keep, layout) in profile_nms.CASES.items():
        # The clustered case has a generator of its own, so the phases after
        # this one draw the same inputs with or without it.
        boxes_np, valid_np = profile_nms.case_inputs(rng if layout == "spread" else np.random.default_rng(5), label)
        boxes, valid = torch.from_numpy(boxes_np).to(dev), torch.from_numpy(valid_np).to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        got = nms_ops.nms_keep_mask(boxes, valid, thr, max_keep)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - resident
        want = nms_ops.nms_keep_mask_plain(boxes, valid, thr, max_keep)
        again = nms_ops.nms_keep_mask(boxes, valid, thr, max_keep)
        torch.cuda.synchronize()
        mismatches = int((got != want).sum().item())
        print(f"nms_keep_mask {label} ({n}x{k}, {layout} boxes, thr {thr}, keep {max_keep}): "
              f"{int(got.sum())} accepts, {mismatches} mask mismatches (tolerance: identical); "
              f"mask scratch {nms_ops.mask_bytes(n, k)} bytes, peak device memory of the call {peak} bytes "
              f"(torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated()})", flush=True)
        check(mismatches == 0, f"nms_keep_mask {label}: {mismatches} keep-mask entries differ")
        check(torch.equal(again, got), f"nms_keep_mask {label}: a second launch gave other bits")
        ms = time_ms(lambda: nms_ops.nms_keep_mask(boxes, valid, thr, max_keep), 20)
        plain_ms = time_ms(lambda: nms_ops.nms_keep_mask_plain(boxes, valid, thr, max_keep), 2)
        bytes_moved = n * k * (16 + 1 + 1)
        tests = nms_iou_tests(boxes, valid, got, thr)
        ops = NMS_OPS_PER_TEST * tests + 3 * int(valid.sum().item())
        print(f"  {tests} IoU tests, {ops} f32 operations", flush=True)
        results[label] = dict(
            max_abs_err=float(mismatches), ms=ms, plain_ms=plain_ms,
            bound_ms=1e3 * max(bytes_moved / HBM_BYTES_PER_S, ops / F32_FLOPS),
            bound_by="bytes" if bytes_moved / HBM_BYTES_PER_S >= ops / F32_FLOPS else "operations",
            accepts=int(got.sum()), iou_tests=tests, shape=[n, k], boxes=layout, peak_bytes=peak,
        )

    img_h, img_w = 600.0, 800.0  # real grid 37 x 50 of the 38 x 50 canvas map
    fm32 = torch.from_numpy(rng.normal(size=(4, 38, 50, 512)).astype(np.float32)).to(dev)
    results.update(roi_forward_parity(dev, rng, fm32, img_h, img_w))
    results.update(roi_backward_parity(dev, rng, fm32, img_h, img_w))
    # Its own generator: the phases after this one draw what they drew before it.
    results.update(roi_edge_parity(dev, np.random.default_rng(6)))
    check_grad_fn(dev, rng)
    results.update(conv_parity(dev))
    check_conv_grad_fn(dev)
    return results


def roi_forward_parity(dev, rng, fm32, img_h, img_w, p=300):
    """K2 and K4 against their plain versions, and against each other, at
    the predict shape: 300 RoIs an image."""
    import torch
    from fasterrcnn_torch.ops import roi as roi_ops
    from fasterrcnn_torch.scripts import profile_roi
    from fasterrcnn_torch.scripts.profile_conv import time_ms

    b, h, w, c = fm32.shape
    results = {}
    rois = torch.from_numpy(profile_roi.draw_rois(rng, b, p, img_h, img_w)).to(dev)
    norm = torch.tensor([[(37 - 1) / img_h, (50 - 1) / img_w]] * b, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        fm = fm32.to(dtype)
        got = roi_ops.roi_pool_taps(fm, rois, norm)
        want = roi_ops.roi_pool_features(fm, rois, norm)
        torch.cuda.synchronize()
        check(got.dtype == dtype and got.shape == (b, p, 7, 7, c), f"roi_pool_taps {dtype}: {got.dtype} {tuple(got.shape)}")
        err = float((got.float() - want.float()).abs().max().item())
        mismatches = int((got != want).sum().item())
        print(f"roi_pool_taps {dtype} ({b}x{h}x{w}x{c}, {p} RoIs, lane width {roi_ops.lane_width(c, fm)}): "
              f"max_abs_err {err!r}, {mismatches} of {got.numel()} values differ (tolerance: identical)", flush=True)
        check(mismatches == 0, f"roi_pool_taps {dtype}: {mismatches} values differ, max_abs_err {err}")
        ms = time_ms(lambda: roi_ops.roi_pool_taps(fm, rois, norm), 20)
        plain_ms = time_ms(lambda: roi_ops.roi_pool_features(fm, rois, norm), 3)
        # K2 and K4 compute one function, so they share its bound.
        bound = profile_roi.forward_bound(fm, rois, norm)
        tag = "f32" if dtype == torch.float32 else "bf16"
        results[f"roi_{tag}"] = dict(
            max_abs_err=err, mismatches=mismatches, ms=ms, plain_ms=plain_ms, **bound, shape=[b, h, w, c, p],
        )

        fused = roi_ops.roi_pool_fused(fm, rois, norm)
        fused_want = roi_ops.roi_pool_fused_plain(fm, rois, norm)
        torch.cuda.synchronize()
        check(fused.dtype == dtype and fused.shape == got.shape, f"roi_pool_fused {dtype}: {fused.dtype}")
        err = float((fused.float() - fused_want.float()).abs().max().item())
        mismatches = int((fused != fused_want).sum().item())
        vs_taps = float((fused.float() - got.float()).abs().max().item())
        print(f"roi_pool_fused {dtype} ({b}x{h}x{w}x{c}, {p} RoIs): max_abs_err {err!r}, "
              f"{mismatches} of {fused.numel()} values differ (tolerance: identical); against roi_pool_taps "
              f"max_abs_err {vs_taps!r}" + (" (tolerance: identical)" if dtype == torch.float32 else
                                            " (bf16: K4 rounds the x-sum once, K2 each x-tap too)"), flush=True)
        check(mismatches == 0, f"roi_pool_fused {dtype}: {mismatches} values differ, max_abs_err {err}")
        if dtype == torch.float32:
            check(torch.equal(fused, got), f"roi_pool_fused vs roi_pool_taps f32: max_abs_err {vs_taps}")
        results[f"fused_{tag}"] = dict(
            max_abs_err=err, mismatches=mismatches, vs_taps_max_abs_err=vs_taps,
            ms=time_ms(lambda: roi_ops.roi_pool_fused(fm, rois, norm), 10),
            plain_ms=time_ms(lambda: roi_ops.roi_pool_fused_plain(fm, rois, norm), 3),
            **bound, shape=[b, h, w, c, p],
        )
    return results


def roi_edge_parity(dev, rng):
    """K2 and K4 identical to their plain versions (and K4 to K2 in f32),
    and K3 within `backward_close`, in f32 and bf16, where the lanes change:
    ResNet's C=1024 at the predict (K2, K4) and train (K3) RoI counts,
    C=1030 (no whole 16-byte lane: scalar lanes), and a map that starts one
    element past a 16-byte boundary; and K2 and K4 on a (1, 38, 160, 512)
    map x 300 RoIs, wider than a dense-sheet K4 could hold in shared memory."""
    import torch
    from fasterrcnn_torch.ops import roi as roi_ops
    from fasterrcnn_torch.scripts import profile_roi

    h, img_h = 38, 600.0
    results = {}
    cases = (("c1024", 4, 50, 1024, False), ("c1030", 4, 50, 1030, False), ("misaligned", 4, 50, 512, True),
             ("w160", 1, 160, 512, False))
    for label, b, w, c, misaligned in cases:
        img_w = 16.0 * w  # 800 at w = 50; the real grid is 37 x w
        norm = torch.tensor([[(37 - 1) / img_h, (w - 1) / img_w]] * b, device=dev)
        fm32 = torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(np.float32)).to(dev)
        passes = [(300, ("roi_pool_taps", "roi_pool_fused"))]
        if label != "w160":
            passes.append((128, ("roi_pool_taps_bwd",)))
        for p, kernels in passes:
            rois = torch.from_numpy(profile_roi.draw_rois(rng, b, p, img_h, img_w)).to(dev)
            g32 = torch.from_numpy(rng.normal(size=(b, p, 7, 7, c)).astype(np.float32)).to(dev)
            for dtype in (torch.float32, torch.bfloat16):
                fm = fm32.to(dtype)
                if misaligned:
                    fm = torch.empty(fm.numel() + 1, dtype=dtype, device=dev)[1:].view(fm.shape).copy_(fm)
                lanes = roi_ops.lane_width(c, fm)
                for kernel in kernels:
                    tag = f"{label}_{kernel}_{'f32' if dtype == torch.float32 else 'bf16'}"
                    rule = "identical"
                    if kernel == "roi_pool_taps":
                        taps = got = roi_ops.roi_pool_taps(fm, rois, norm)
                        want = roi_ops.roi_pool_features(fm, rois, norm)
                        ok, err = torch.equal(got, want), float((got.float() - want.float()).abs().max())
                    elif kernel == "roi_pool_fused":
                        got, want = roi_ops.roi_pool_fused(fm, rois, norm), roi_ops.roi_pool_fused_plain(fm, rois, norm)
                        ok, err = torch.equal(got, want), float((got.float() - want.float()).abs().max())
                        if dtype == torch.float32:
                            ok = ok and torch.equal(got, taps)
                            rule = "identical, and identical to roi_pool_taps"
                    else:
                        g = g32.to(dtype)
                        ok, err = profile_roi.backward_close(roi_ops.roi_pool_taps_bwd(fm, rois, norm, g),
                                                             roi_ops.roi_pool_taps_bwd_plain(fm, rois, norm, g))
                        rule = "backward_close"
                    torch.cuda.synchronize()
                    print(f"{kernel} {tag} ({b}x{h}x{w}x{c}, {p} RoIs, lane width {lanes}, map at "
                          f"{fm.data_ptr() % 16} bytes past 16): max_abs_err {err!r} (tolerance: {rule})", flush=True)
                    check(ok, f"{kernel} {tag}: outside tolerance, max_abs_err {err}")
                    results[tag] = dict(max_abs_err=err, lane_width=lanes, shape=[b, h, w, c, p])
    return results


def roi_backward_parity(dev, rng, fm32, img_h, img_w):
    """K3 against its plain version at the train shape: 128 RoIs an image."""
    import torch
    from fasterrcnn_torch.ops import roi as roi_ops
    from fasterrcnn_torch.scripts import profile_roi
    from fasterrcnn_torch.scripts.profile_conv import time_ms

    b, h, w, c = fm32.shape
    p = 128
    rois = torch.from_numpy(profile_roi.draw_rois(rng, b, p, img_h, img_w)).to(dev)
    norm = torch.tensor([[(37 - 1) / img_h, (50 - 1) / img_w]] * b, device=dev)
    g32 = torch.from_numpy(rng.normal(size=(b, p, 7, 7, c)).astype(np.float32)).to(dev)
    results = {}
    for relu in (False, True):
        base = torch.relu(fm32) if relu else fm32
        for dtype in (torch.float32, torch.bfloat16):
            fm, g = base.to(dtype), g32.to(dtype)
            got = roi_ops.roi_pool_taps_bwd(fm, rois, norm, g)
            want = roi_ops.roi_pool_taps_bwd_plain(fm, rois, norm, g)
            torch.cuda.synchronize()
            check(got.dtype == dtype and got.shape == fm.shape, f"roi_pool_taps_bwd {dtype}: {got.dtype}")
            ok, err = profile_roi.backward_close(got, want)
            label = f"roi_bwd_{'f32' if dtype == torch.float32 else 'bf16'}{'_relu' if relu else ''}"
            print(f"roi_pool_taps_bwd {label} ({b}x{h}x{w}x{c}, {p} RoIs): max_abs_err {err!r} "
                  f"(max |plain| {float(want.float().abs().max())!r}; tolerance 1e-5 of it"
                  f"{' + 2^-7 of each value' if dtype == torch.bfloat16 else ''})", flush=True)
            check(ok, f"roi_pool_taps_bwd {label}: outside tolerance, max_abs_err {err}")
            results[label] = dict(
                max_abs_err=err,
                ms=time_ms(lambda: roi_ops.roi_pool_taps_bwd(fm, rois, norm, g), 20),
                plain_ms=time_ms(lambda: roi_ops.roi_pool_taps_bwd_plain(fm, rois, norm, g), 3),
                **profile_roi.backward_bound(fm, rois, norm),
                tied_inside_samples=profile_roi.tied_inside_samples(fm, rois, norm), shape=[b, h, w, c, p],
            )
    return results


def check_grad_fn(dev, rng):
    """On the card, roi_pool_taps of a map that requires grad is
    differentiable, and its backward goes through the backward kernel."""
    import torch
    from fasterrcnn_torch.ops import roi as roi_ops

    fm = torch.from_numpy(rng.normal(size=(2, 12, 16, 256)).astype(np.float32)).to(dev).requires_grad_()
    rois = torch.tensor([[[10.0, 20.0, 120.0, 150.0]] * 3] * 2, device=dev)
    norm = torch.tensor([[0.05, 0.06]] * 2, device=dev)
    before = roi_ops.roi_pool_taps_bwd.launches
    out = roi_ops.roi_pool_taps(fm, rois, norm)
    check(out.grad_fn is not None, "roi_pool_taps on the card returned no grad_fn")
    out.sum().backward()
    torch.cuda.synchronize()
    check(roi_ops.roi_pool_taps_bwd.launches == before + 1, "roi_pool_taps backward did not launch K3")
    check(fm.grad is not None and bool(fm.grad.abs().sum() > 0), "roi_pool_taps backward gave no gradient")
    print(f"roi_pool_taps grad_fn {type(out.grad_fn).__name__}; backward launched roi_pool_taps_bwd", flush=True)


def conv_parity(dev):
    """K5 and K6 against conv3x3_plain (cuDNN on f32 copies, TF32 off) at
    CONV_CASES, f32 and bf16, with and without ReLU, within `conv_close`;
    then their times beside the plain version's and the library call's
    (cuDNN conv + bias + ReLU on channels_last tensors, the A/B's
    yardstick)."""
    import torch
    from fasterrcnn_torch.ops import conv as conv_ops
    from fasterrcnn_torch.scripts.profile_conv import conv_close, library_conv, time_ms

    gen = torch.Generator(device=dev).manual_seed(3)
    results = {}
    for name, label, (b, h, w, c, cout) in CONV_CASES:
        x32 = torch.randn((b, h, w, c), generator=gen, device=dev)
        w32 = 0.05 * torch.randn((cout, c, 3, 3), generator=gen, device=dev)
        b32 = torch.randn((cout,), generator=gen, device=dev)
        fn = getattr(conv_ops, name)
        for dtype in (torch.float32, torch.bfloat16):
            tag = "f32" if dtype == torch.float32 else "bf16"
            x, wt, bias = x32.to(dtype), w32.to(dtype), b32.to(dtype)
            errs = []
            for relu in (True, False):
                got = fn(x, wt, bias, relu=relu)
                want = conv_ops.conv3x3_plain(x, wt, bias, relu=relu)
                torch.cuda.synchronize()
                check(got.dtype == dtype and got.shape == (b, h, w, cout), f"{name} {label} {tag}: {got.dtype}")
                ok, err, peak, steps = conv_close(got, want)
                errs.append(err)
                if dtype == torch.float32:
                    # Of the outputs that differ, the share nearer zero than the
                    # plain version's: ~0.5 if the kernel's f32 sums round
                    # without bias, towards 1 if they truncate.
                    moved = got != want
                    toward_zero = float(((got.abs() < want.abs()) & moved).sum() / moved.sum().clamp_min(1))
                print(f"{name} {label} {tag} relu={relu} {(b, h, w, c, cout)}: max_abs_err {errs[-1]!r} "
                      f"(max |plain| {peak!r}; tolerance "
                      + (f"1e-5 of the largest + one bf16 step of the value: {steps!r} steps)"
                         if dtype == torch.bfloat16 else
                         f"1e-4 of the largest); {toward_zero!r} of the differing outputs lie nearer zero"),
                      flush=True)
                check(ok, f"{name} {label} {tag} relu={relu}: outside tolerance, max_abs_err {errs[-1]}")
                # A ring stage, or a TF32 A fragment, overwritten while a wgmma reads it would differ.
                check(torch.equal(fn(x, wt, bias, relu=relu), got), f"{name} {label} {tag}: second launch differs")
            reps = 10 if h * w * c * cout < 1e9 else 4
            item = x.element_size()
            flops = 2.0 * b * h * w * 9 * c * cout
            peak_rate = TF32X3_FLOPS if dtype == torch.float32 else BF16_FLOPS
            bytes_moved = (b * h * w * (c + cout) + wt.numel() + cout) * item
            w_cl = wt.contiguous(memory_format=torch.channels_last)
            operands = conv_ops.kernel_operands(name, x, wt)
            row = results[f"{label}_{tag}"] = dict(
                max_abs_err=max(errs),
                ms=time_ms(lambda: fn(x, wt, bias), reps),
                # The kernel alone, on operands packed once: the wrapper's
                # call adds the weight packing and the host's own time.
                kernel_only_ms=time_ms(lambda: conv_ops.launch_kernel(name, *operands, bias, True), reps),
                plain_ms=time_ms(lambda: conv_ops.conv3x3_plain(x, wt, bias), 3),
                bound_ms=1e3 * max(bytes_moved / HBM_BYTES_PER_S, flops / peak_rate),
                bound_by="bytes" if bytes_moved / HBM_BYTES_PER_S >= flops / peak_rate else "operations",
                library_ms=time_ms(lambda: library_conv(x, w_cl, bias), 20),
                shape=[b, h, w, c, cout],
                design="wgmma" if dtype == torch.bfloat16 else "wgmma 3xTF32",
            )
            if dtype == torch.float32:
                row["bound_cuda_cores_ms"] = 1e3 * flops / F32_FLOPS  # the slower f32 rate, under its own name
                row["toward_zero_share"] = toward_zero  # of the relu=False outputs that differ
            print(f"  {name} {label} {tag}: {row['ms']!r} ms (kernel alone {row['kernel_only_ms']!r}), "
                  f"plain {row['plain_ms']!r} ms, library {row['library_ms']!r} ms, bound {row['bound_ms']!r} ms"
                  + (f" (CUDA cores {row['bound_cuda_cores_ms']!r} ms)" if "bound_cuda_cores_ms" in row else ""),
                  flush=True)
    return results


def check_conv_grad_fn(dev):
    """On the card, conv3x3 and conv3x3_im2col of inputs that require grad
    are differentiable, and their backward equals autograd of the plain
    version (it is that autograd, recomputed): within 1e-4 of the largest."""
    import torch
    from fasterrcnn_torch.ops import conv as conv_ops

    gen = torch.Generator(device=dev).manual_seed(4)
    inputs = [torch.randn(s, generator=gen, device=dev) for s in ((2, 12, 16, 64), (96, 64, 3, 3), (96,))]
    g = torch.randn((2, 12, 16, 96), generator=gen, device=dev)
    grads = {}
    for name in ("conv3x3", "conv3x3_im2col", "conv3x3_plain"):
        fn = getattr(conv_ops, name)
        leaves = [t.clone().requires_grad_() for t in inputs]
        out = fn(*leaves)
        check(out.grad_fn is not None, f"{name} on the card returned no grad_fn")
        out.backward(g)
        grads[name] = [t.grad for t in leaves]
    torch.cuda.synchronize()
    for name in ("conv3x3", "conv3x3_im2col"):
        err = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(grads[name], grads["conv3x3_plain"]))
        print(f"{name} grad_fn: backward against autograd of conv3x3_plain, worst relative max err {err!r}", flush=True)
        check(err <= 1e-4, f"{name} backward: {err}")


def phase_reference(dev, rng):
    """Tiny config on the card vs on the CPU, with identical weights."""
    import torch
    from fasterrcnn_torch.config import AnchorConfig, ModelConfig, RPNConfig
    from fasterrcnn_torch.models import faster_rcnn as frcnn
    from fasterrcnn_torch.models.rpn import generate_proposals

    cfg = ModelConfig(
        anchors=AnchorConfig(areas=(24.0 * 24, 48.0 * 48, 96.0 * 96)),
        rpn=RPNConfig(pre_nms_infer=200, post_nms_infer=64),
    )
    cpu = frcnn.FasterRCNN(cfg)
    frcnn.init_params(cpu, seed=0)
    cpu.eval()
    card = frcnn.FasterRCNN(cfg)
    card.load_state_dict(cpu.state_dict())
    card = card.to(dev, memory_format=torch.channels_last).eval()
    images = torch.from_numpy(rng.integers(0, 255, (2, 128, 160, 3), dtype=np.uint8))
    hw = torch.tensor([[120.0, 150.0], [112.0, 160.0]])
    images[0, 120:] = 0
    images[0, :, 150:] = 0
    images[1, 112:] = 0

    def close(name, got, want, atol):
        err = float((got.cpu().float() - want.float()).abs().max().item())
        print(f"reference {name}: max_abs_err {err!r} (atol {atol})", flush=True)
        check(err <= atol, f"reference {name}: card vs CPU max_abs_err {err} > {atol}")

    with torch.inference_mode():
        fm_c, lg_c, dl_c = cpu.features_and_rpn(images)
        fm_g, lg_g, dl_g = card.features_and_rpn(images.to(dev))
        for name, g, w in (("feature map", fm_g, fm_c), ("rpn logits", lg_g, lg_c), ("rpn deltas", dl_g, dl_c)):
            close(name, g, w, 1e-4)

        grid = frcnn.anchor_grid_for(cfg, 128, 160)
        args = (cfg.rpn.pre_nms_infer, cfg.rpn.post_nms_infer, cfg.rpn.nms_iou_threshold, cfg.rpn.min_proposal_side)

        def proposals(device, logits, deltas):
            h = hw.to(device)
            mask = frcnn.proposal_masks(cfg, grid, h)[0]
            centers = torch.as_tensor(grid.centers, device=device)
            return generate_proposals(logits.to(device), deltas.to(device), centers, mask, h[:, 0], h[:, 1], *args)

        p_c = proposals("cpu", lg_c, dl_c)
        p_g = proposals(dev, lg_c, dl_c)
        check(torch.equal(p_g.valid.cpu(), p_c.valid), "reference proposals: valid masks differ")
        close("proposal boxes", p_g.boxes, p_c.boxes, 1e-4)

        cls_c, box_c = cpu.detect_rois(fm_c, p_c.boxes, hw)
        cls_g, box_g = card.detect_rois(fm_c.to(dev), p_c.boxes.to(dev), hw.to(dev))
        close("class logits", cls_g, cls_c, 1e-4)
        close("box deltas", box_g, box_c, 1e-4)

    # The whole predict: the card's RPN outputs differ from the CPU's in the
    # last bits, which may reorder near-equal scores; require agreement on
    # all but 1% of the detection slots and closeness where both are valid.
    d_c = frcnn.make_predict_fn(cpu, 128, 160)(images, hw, score_threshold=0.0)
    d_g = frcnn.make_predict_fn(card, 128, 160)(images.to(dev), hw.to(dev), score_threshold=0.0)
    both = (d_g.valid.cpu() > 0) & (d_c.valid > 0)
    agree = float((d_g.valid.cpu() == d_c.valid).float().mean().item())
    print(f"reference predict: {int(d_c.valid.sum())} CPU detections, valid agreement {agree!r}", flush=True)
    check(d_c.valid.sum() > 0 and agree >= 0.99, f"reference predict: valid agreement {agree}")
    close("detection scores", d_g.scores.cpu()[both], d_c.scores[both], 1e-4)


def phase_reference_train(dev, seed=0):
    """One train step's losses and gradients, card vs CPU
    (`scripts/reference_train.run_draw`): same weights, same draws, and a
    batch from its own seeded generator. Losses within 1e-4 relative;
    gradients per tensor in relative norm |g_card - g_cpu| / |g_cpu| <= 3e-3:
    the backbones differ in the last bits (TF32 off), and on the ReLU'd
    feature map a tie between two samples may be exact on one side only, so
    a cotangent splits on one side alone."""
    from fasterrcnn_torch.scripts import reference_train

    row = reference_train.run_draw(dev, seed)
    print(f"reference train losses: card {row['losses_card']!r}, CPU {row['losses_cpu']!r}", flush=True)
    for name, a, c in zip(("rpn_class", "rpn_regression", "detector_class", "detector_regression"),
                          row["losses_card"], row["losses_cpu"]):
        check(c > 0 and abs(a - c) <= 1e-4 * abs(c), f"reference train {name}: card {a} vs CPU {c}")
    print(f"reference train gradients (seed {seed}): worst relative norm {row['worst']!r} ({row['worst_tensor']}; "
          f"tolerance {reference_train.TOLERANCE}) over {row['tensors']} tensors", flush=True)
    check(row["worst"] <= reference_train.TOLERANCE, f"reference train gradients: {row['worst_tensor']} at {row['worst']}")


# Real image extents on the 608x800 canvas, all smaller than it.
MAIN_EXTENTS = ((600, 792), (576, 768), (592, 704), (544, 784))


def main_path_images(rng, extents, canvas):
    b = len(extents)
    images = np.zeros((b, *canvas, 3), np.uint8)
    for i, (h, w) in enumerate(extents):
        images[i, :h, :w] = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    return images, np.asarray(extents, np.float32)


def check_detections(det, b, max_det, image_hw, label):
    import torch

    check(tuple(det.boxes.shape) == (b, 20, max_det, 4), f"{label}: boxes {tuple(det.boxes.shape)}")
    check(tuple(det.scores.shape) == (b, 20, max_det), f"{label}: scores {tuple(det.scores.shape)}")
    check(tuple(det.valid.shape) == (b, 20, max_det), f"{label}: valid {tuple(det.valid.shape)}")
    for t in det:
        check(bool(torch.isfinite(t).all()), f"{label}: non-finite output")
    v = det.valid > 0
    hw = torch.as_tensor(image_hw, device=det.boxes.device)
    lim = (hw - 1.0)[:, None, None, :].repeat(1, 1, 1, 2)
    check(bool(((det.boxes >= 0) & (det.boxes <= lim)).all(dim=-1)[v].all()), f"{label}: box outside image")
    check(bool(((det.scores > 0) & (det.scores <= 1)).eq(v).all()), f"{label}: scores vs valid")
    return int(v.sum())


def path_launches(counters, required, label):
    """Every kernel's launches on the path just run; each of `required`
    must have launched."""
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"{label} launches: {launches}", flush=True)
    for name in required:
        check(launches[name] > 0, f"{label}: kernel {name} was never launched")
    return launches


def phase_main_path(dev, rng, counters, canvas=(608, 800), extents=MAIN_EXTENTS):
    """The predict path, with every launch count in `counters` set to 0
    before it; it must launch K1 and K2."""
    import torch
    from fasterrcnn_torch.config import ModelConfig
    from fasterrcnn_torch.data.voc import Sample
    from fasterrcnn_torch.engine import Engine

    b = len(extents)
    images, image_hw = main_path_images(rng, extents, canvas)
    t0 = time.perf_counter()
    engine = Engine(ModelConfig(), seed=0)
    engine16 = Engine(ModelConfig(compute_dtype="bfloat16"), seed=0)
    print(f"engines built in {time.perf_counter() - t0:.1f} s", flush=True)

    for fn in counters:
        fn.launches = 0
    det05 = engine.predict(images, image_hw, score_threshold=0.05)
    det0 = engine.predict(images, image_hw, score_threshold=0.0)
    h0, w0 = extents[0]
    sample = Sample(image_u8=images[0, :h0, :w0], image_hw=(h0, w0), gt_boxes=[], filepath="random")
    per_image = engine.predict_image(sample, score_threshold=0.0)
    det16 = engine16.predict(images, image_hw, score_threshold=0.0)
    torch.cuda.synchronize()
    launches = path_launches(counters, ("nms_keep_mask", "roi_pool_taps"), "main path")

    n05 = check_detections(det05, b, 300, image_hw, "predict f32 @0.05")
    n0 = check_detections(det0, b, 300, image_hw, "predict f32 @0.0")
    n16 = check_detections(det16, b, 300, image_hw, "predict bf16 @0.0")
    print(f"detections: f32 @0.05 {n05}, f32 @0.0 {n0}, bf16 @0.0 {n16}", flush=True)
    check(n0 > 0 and n16 > 0, "predict at score threshold 0.0 found no detections")
    check(sorted(per_image) == list(range(1, 21)), "predict_image: class keys")
    check(all(r.ndim == 2 and r.shape[1] == 5 and np.isfinite(r).all() for r in per_image.values()),
          "predict_image: rows")
    # predict_image runs image 0 alone (B=1), where cuDNN may pick another
    # algorithm than at B=4: near-equal scores may reorder, so the counts
    # need only be close.
    n_img = sum(len(r) for r in per_image.values())
    n_batch = int((det0.valid[0] > 0).sum())
    print(f"predict_image: {n_img} detections over 20 classes (batched image 0: {n_batch})", flush=True)
    check(abs(n_img - n_batch) <= max(2, n_batch // 20), "predict_image disagrees with predict on image 0")
    return engine, engine16, images, image_hw, launches


def phase_main_path_train(counters, steps=10):
    """The default config's train path at full width through Engine, with
    every launch count in `counters` set to 0 before it; it must launch
    K1-K3."""
    import torch
    from fasterrcnn_torch.config import ModelConfig
    from fasterrcnn_torch.data.pipeline import make_host_batch
    from fasterrcnn_torch.data.synthetic import SyntheticDataset
    from fasterrcnn_torch.engine import Engine

    cfg = ModelConfig()
    t0 = time.perf_counter()
    engine = Engine(cfg, seed=0)
    engine16 = Engine(ModelConfig(compute_dtype="bfloat16"), seed=0)
    print(f"train engines built in {time.perf_counter() - t0:.1f} s", flush=True)
    batch = make_host_batch(list(SyntheticDataset(num_samples=4, seed=0)), (608, 800), cfg.max_gt_boxes)

    for fn in counters:
        fn.launches = 0
    totals = []
    for i in range(steps):
        losses = engine.train_step(batch)
        values = [v.item() for v in losses]
        check(all(np.isfinite(values)), f"train step {i}: non-finite losses {values}")
        if i == 0:
            check(all(v > 0 for v in values), f"train step 0: a loss is not positive: {values}")
        totals.append(sum(values))
    print(f"train f32, one batch repeated: total loss by step {totals!r}", flush=True)
    check(totals[-1] < totals[0], f"train f32: the loss did not fall over {steps} steps: {totals}")
    stats = engine.train_epoch(SyntheticDataset(num_samples=8, seed=1), batch_size=4, max_steps=2)
    means = stats.means()
    print(f"train_epoch f32, 2 steps: {means}", flush=True)
    check(stats._count == 2 and all(np.isfinite(v) for v in means.values()), f"train_epoch: {means}")
    values16 = []
    for _ in range(2):
        values16.append([v.item() for v in engine16.train_step(batch)])
    print(f"train bf16, 2 steps: {values16!r}", flush=True)
    check(all(np.isfinite(values16).ravel()), "train bf16: non-finite losses")
    check(all(p.dtype == torch.float32 for p in engine16.model.parameters()), "bf16 engine: parameters not f32")
    torch.cuda.synchronize()
    launches = path_launches(counters, ("nms_keep_mask", "roi_pool_taps", "roi_pool_taps_bwd"), "train path")
    return engine, engine16, batch, launches


def phase_fused_roi_op(engine, images, image_hw, counters):
    """K4's path: the public op `roi_pool_fused` on the f32 predict path's
    own feature map and RPN proposals (B=4 on the 608x800 canvas, 300
    proposals an image), as a user comparing it with `roi_pool_taps` calls
    it. It must launch K4 and, in f32, equal both its plain version and the
    taps kernel there, bit for bit; on the same map cast to bf16 (after the
    counted run) it must equal its plain version."""
    import torch
    from fasterrcnn_torch.models import faster_rcnn as frcnn
    from fasterrcnn_torch.ops import roi as roi_ops

    model, dev = engine.model, engine.device
    grid = frcnn.anchor_grid_for(model.cfg, *images.shape[1:3])
    with torch.inference_mode():
        hw = torch.as_tensor(image_hw, device=dev)
        fm, props = frcnn.infer_proposals(
            model, grid, torch.as_tensor(grid.centers, device=dev), torch.as_tensor(images, device=dev), hw
        )
        norm = model.roi_norm(hw)
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0
        fused = roi_ops.roi_pool_fused(fm, props.boxes, norm)
        torch.cuda.synchronize()
        launches = path_launches(counters, ("roi_pool_fused",), "fused RoI op path")
        plain = roi_ops.roi_pool_fused_plain(fm, props.boxes, norm)
        taps = roi_ops.roi_pool_taps(fm, props.boxes, norm)
        fm16 = fm.bfloat16()
        fused16 = roi_ops.roi_pool_fused(fm16, props.boxes, norm)
        plain16 = roi_ops.roi_pool_fused_plain(fm16, props.boxes, norm)
    check(fm.dtype == torch.float32 and bool(torch.isfinite(fused).all()), f"fused RoI op: {fm.dtype}, non-finite")
    print(f"fused RoI op on the predict path's map {tuple(fm.shape)} (max |map| {float(fm.abs().max())!r}, "
          f"max |pooled| {float(fused.abs().max())!r}) and {tuple(props.boxes.shape)} proposals: max_abs_err "
          f"against roi_pool_fused_plain {float((fused - plain).abs().max())!r}, against roi_pool_taps "
          f"{float((fused - taps).abs().max())!r} (tolerance: identical to both)", flush=True)
    check(torch.equal(fused, plain), "fused RoI op: differs from roi_pool_fused_plain")
    check(torch.equal(fused, taps), "fused RoI op: differs from roi_pool_taps in f32")
    err16 = float((fused16.float() - plain16.float()).abs().max())
    print(f"fused RoI op on the same map cast to bf16: max_abs_err against roi_pool_fused_plain {err16!r} "
          f"(tolerance: identical)", flush=True)
    check(torch.equal(fused16, plain16), "fused RoI op: bf16 differs from roi_pool_fused_plain")
    return launches


def phase_conv_ab(counters, card):
    """K5's and K6's path: the conv A/B entry point at B=4 in bf16 and in
    f32, with every launch count set to 0 before it. Every row must carry a
    time and both kernels must launch."""
    import torch
    from fasterrcnn_torch.scripts import profile_conv

    for fn in counters:
        fn.launches = 0
    rows = [row for dtype in ("bfloat16", "float32")
            for row in profile_conv.main(["--batch", "4", "--reps", "5", "--dtype", dtype])]
    torch.cuda.synchronize()
    launches = path_launches(counters, ("conv3x3", "conv3x3_im2col"), "conv A/B path")
    want = {(name, "library") for name, *_ in profile_conv.SHAPES}
    want |= {("block5", "conv3x3"), ("block4", "conv3x3"), ("block3", "conv3x3"), ("block2", "im2col")}
    want = {(*row, dtype) for row in want for dtype in ("bfloat16", "float32")}
    got = {(r["layer"], r["impl"], r["dtype"]) for r in rows}
    check(got == want and len(rows) == len(want), f"conv A/B rows: {sorted(got)}")
    for r in rows:
        check("error" not in r and np.isfinite(r["ms"]) and r["ms"] > 0, f"conv A/B row without a time: {r}")
    print(json.dumps({"conv_ab": rows, "card": card}), flush=True)
    return rows, launches


def phase_timing_train(engine, engine16, batch, card, reps=12):
    """Warm Engine.train_step calls on the host's batch, each ended by a
    device synchronize: the host-to-device copy is included."""
    import torch

    b, ch, cw = batch.images.shape[:3]

    def time_step(eng, label):
        for _ in range(2):
            eng.train_step(batch)
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            eng.train_step(batch)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        med = statistics.median(times)
        print(f"Engine.train_step {label}: B={b} {ch}x{cw}, median {med!r} ms/step over {reps} "
              f"(min {min(times)!r}, max {max(times)!r}), {1e3 * b / med!r} img/s [{card}]", flush=True)
        return {"median_ms": med, "min_ms": min(times), "max_ms": max(times), "img_per_s": 1e3 * b / med}

    out = {"f32_tf32_off": time_step(engine, "f32 (cuDNN and matmul TF32 off)")}
    torch.backends.cudnn.allow_tf32 = True
    out["f32_cudnn_tf32_on"] = time_step(engine, "f32 (cuDNN TF32 on, matmul TF32 off)")
    torch.backends.cudnn.allow_tf32 = False
    out["bf16"] = time_step(engine16, "bf16")
    torch.cuda.reset_peak_memory_stats()
    out["resident_bytes"] = torch.cuda.memory_allocated()  # weights and optimizer states of both engines
    engine.train_step(batch)
    torch.cuda.synchronize()
    out["f32_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    return out


def phase_timing(engine, engine16, images, image_hw, card):
    """Warm Engine.predict calls on the host's uint8 batch, each ended by a
    device synchronize: the host-to-device copy of the batch is included."""
    import torch

    b, ch, cw = images.shape[:3]

    def time_predict(eng, label, reps=12):
        for _ in range(2):
            eng.predict(images, image_hw)
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            eng.predict(images, image_hw)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        med = statistics.median(times)
        print(f"Engine.predict {label}: B={b} {ch}x{cw}, median {med!r} ms/batch over {reps} "
              f"(min {min(times)!r}, max {max(times)!r}), {1e3 * b / med!r} img/s [{card}]", flush=True)
        return {"median_ms": med, "min_ms": min(times), "max_ms": max(times), "img_per_s": 1e3 * b / med}

    out = {"f32_tf32_off": time_predict(engine, "f32 (cuDNN and matmul TF32 off)")}
    torch.backends.cudnn.allow_tf32 = True
    out["f32_cudnn_tf32_on"] = time_predict(engine, "f32 (cuDNN TF32 on, matmul TF32 off)")
    torch.backends.cudnn.allow_tf32 = False
    out["bf16"] = time_predict(engine16, "bf16")
    torch.cuda.reset_peak_memory_stats()
    out["resident_bytes"] = torch.cuda.memory_allocated()  # both engines' weights
    engine.predict(images, image_hw)
    torch.cuda.synchronize()
    out["f32_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    return out


# Layer of a device kernel in the profile: the first group one of whose
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


def phase_profile(calls, card, reps=3):
    """Device time by layer over warm calls of each entry of `calls` (label
    -> function; torch.profiler, TF32 off), the device's idle share and the
    kernel launches per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for label, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / reps
        by_layer, launches, kernels = {}, 0, []
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
        out[label] = {
            "wall_ms_per_call_profiler_on": wall_ms,
            "device_busy_ms_per_call": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms) if busy > 0 else "not measured",
            "device_ops_per_call": launches / reps,
            "by_layer_ms": dict(sorted(by_layer.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms": [[ms, layer, name] for ms, layer, name in sorted(kernels, reverse=True)[:12]],
        }
        print(f"profile {label}: {json.dumps(out[label])} [{card}]", flush=True)
    return out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "fasterrcnn_torch")):
        fail(f"no fasterrcnn_torch package beside {__file__}")
    sys.path.insert(0, root)
    from fasterrcnn_torch.ops import conv as conv_ops
    from fasterrcnn_torch.ops import nms as nms_ops
    from fasterrcnn_torch.ops import roi as roi_ops
    from fasterrcnn_torch.ops.kernels import _build

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off for cuDNN convs and matmuls in every parity phase", flush=True)

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s wall "
          f"({', '.join(f'{k} {v['seconds']:.1f} s' for k, v in logs.items())})", flush=True)
    for name, info in logs.items():
        for line in str(info["log"]).splitlines():
            if any(key in line for key in ("registers", "spill", "smem", "wgmma", "Performance Loss")):
                print(f"  ptxas {name}: {line.strip()}", flush=True)
    conv_sass = {name: _build.sass_opcodes(name) for name in ("conv3x3", "conv3x3_im2col")}
    hgmma = {name: sum(n for op, n in ops.items() if op.split(".")[0] == "HGMMA") for name, ops in conv_sass.items()}
    hgmma_tf32 = {name: sum(n for op, n in ops.items() if op.split(".")[0] == "HGMMA" and "TF32" in op.split("."))
                  for name, ops in conv_sass.items()}
    print(f"HGMMA instructions (cuobjdump -sass): {hgmma}, of them TF32 (the f32 paths): {hgmma_tf32}; "
          f"{ {k: {op: n for op, n in v.items() if op.startswith('HGMMA')} for k, v in conv_sass.items()} }", flush=True)
    check(all(n > 0 for n in hgmma.values()), f"a conv library holds no HGMMA: {hgmma}")
    check(all(n > 0 for n in hgmma_tf32.values()), f"a conv library holds no TF32 HGMMA: {hgmma_tf32}")
    roi_sass = {name: _build.sass_opcodes(name) for name in ("roi_pool_taps", "roi_pool_taps_bwd", "roi_pool_fused")}
    vector_loads = {name: sum(n for op, n in roi_sass[name].items() if op.startswith("LDG") and ".128" in op)
                    for name in ("roi_pool_taps", "roi_pool_fused")}
    vector_reductions = sum(n for op, n in roi_sass["roi_pool_taps_bwd"].items()
                            if op.startswith(("RED", "ATOM")) and re.search(r"\.F32x[24]\b", op))
    print(f"128-bit global loads (LDG.*.128): {vector_loads}; roi_pool_taps_bwd: {vector_reductions} "
          f"vector f32 reductions (RED/ATOM *.F32x2 and *.F32x4) (cuobjdump -sass); global memory opcodes "
          f"{ {k: {op: n for op, n in v.items() if op.startswith(('LDG', 'STG', 'RED', 'ATOM'))} for k, v in roi_sass.items()} }",
          flush=True)
    check(all(n > 0 for n in vector_loads.values()) and vector_reductions > 0,
          "the RoI libraries hold no 128-bit loads or vector reductions")

    counters = (
        nms_ops.nms_keep_mask, roi_ops.roi_pool_taps, roi_ops.roi_pool_taps_bwd, roi_ops.roi_pool_fused,
        conv_ops.conv3x3, conv_ops.conv3x3_im2col,
    )
    rng = np.random.default_rng(0)
    for fn in counters:
        fn.launches = 0
    parity = phase_kernel_parity(dev, rng)
    torch.cuda.synchronize()
    parity_launches = {fn.__name__: fn.launches for fn in counters}
    phase_reference(dev, rng)
    phase_reference_train(dev)
    # Each path runs, is timed and profiled with only its own engines on
    # the card, so each peak memory counts that path alone.
    engine, engine16, images, image_hw, launches = phase_main_path(dev, rng, counters)
    fused_launches = phase_fused_roi_op(engine, images, image_hw, counters)
    timing = phase_timing(engine, engine16, images, image_hw, card)
    print(json.dumps({"predict_timing": timing, "card": card}), flush=True)
    phase_profile({
        "predict f32": lambda: engine.predict(images, image_hw),
        "predict bf16": lambda: engine16.predict(images, image_hw),
    }, card)
    del engine, engine16
    torch.cuda.empty_cache()
    train_engine, train_engine16, batch, train_launches = phase_main_path_train(counters)
    train_timing = phase_timing_train(train_engine, train_engine16, batch, card)
    print(json.dumps({"train_timing": train_timing, "card": card}), flush=True)
    phase_profile({
        "train f32": lambda: train_engine.train_step(batch),
        "train bf16": lambda: train_engine16.train_step(batch),
    }, card)
    del train_engine, train_engine16
    torch.cuda.empty_cache()
    _, conv_launches = phase_conv_ab(counters, card)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    paths = {"predict": launches, "train": train_launches, "fused_roi_op": fused_launches,
             "conv_ab": conv_launches, "parity": parity_launches}

    def by_path(name):
        return {path: counts[name] for path, counts in paths.items()}

    kernels = [
        {
            "name": "nms_keep_mask",
            "route": "cuda",
            "source": "fasterrcnn_torch/ops/kernels/csrc/nms_keep_mask.cu",
            "replaces": "fasterrcnn_tpu/ops/pallas/nms_pallas.py:31",
            "launches": launches["nms_keep_mask"],
            **{k: parity["rpn"][k] for k in keys},
            "library_ms": None,
            "shape": parity["rpn"]["shape"],
            "launches_by_path": by_path("nms_keep_mask"),
            **{label: parity[label] for label in ("per_class", "train", "train_scene")},
        },
        {
            "name": "roi_pool_taps",
            "route": "cuda",
            "source": "fasterrcnn_torch/ops/kernels/csrc/roi_pool_taps.cu",
            "replaces": "fasterrcnn_tpu/ops/pallas/roi_pallas.py:157",
            "launches": launches["roi_pool_taps"],
            **{k: parity["roi_f32"][k] for k in keys},
            "library_ms": None,
            "shape": parity["roi_f32"]["shape"],
            "launches_by_path": by_path("roi_pool_taps"),
            "ldg128_instructions": vector_loads["roi_pool_taps"],
            "bf16": parity["roi_bf16"],
            **{k: v for k, v in parity.items() if k.endswith(("_roi_pool_taps_f32", "_roi_pool_taps_bf16"))},
        },
        {
            "name": "roi_pool_taps_bwd",
            "route": "cuda",
            "source": "fasterrcnn_torch/ops/kernels/csrc/roi_pool_taps_bwd.cu",
            "replaces": "fasterrcnn_tpu/ops/pallas/roi_pallas.py:297",
            "launches": train_launches["roi_pool_taps_bwd"],
            **{k: parity["roi_bwd_f32"][k] for k in keys},
            "library_ms": None,
            "shape": parity["roi_bwd_f32"]["shape"],
            "launches_by_path": by_path("roi_pool_taps_bwd"),
            "vector_reduction_instructions": vector_reductions,
            **{k: parity[k] for k in ("roi_bwd_bf16", "roi_bwd_f32_relu", "roi_bwd_bf16_relu")},
            **{k: v for k, v in parity.items() if k.endswith(("_roi_pool_taps_bwd_f32", "_roi_pool_taps_bwd_bf16"))},
        },
        {
            "name": "roi_pool_fused",
            "route": "cuda",
            "source": "fasterrcnn_torch/ops/kernels/csrc/roi_pool_fused.cu",
            "replaces": "fasterrcnn_tpu/ops/pallas/roi_pallas.py:65",
            "launches": fused_launches["roi_pool_fused"],
            **{k: parity["fused_f32"][k] for k in keys},
            "library_ms": None,
            "shape": parity["fused_f32"]["shape"],
            "launches_by_path": by_path("roi_pool_fused"),
            "ldg128_instructions": vector_loads["roi_pool_fused"],
            "bf16": parity["fused_bf16"],
            **{k: v for k, v in parity.items() if k.endswith(("_roi_pool_fused_f32", "_roi_pool_fused_bf16"))},
        },
        {
            "name": "conv3x3",
            "route": "cuda",
            "source": "fasterrcnn_torch/ops/kernels/csrc/conv3x3.cu",
            "replaces": "fasterrcnn_tpu/ops/pallas/conv_pallas.py:63",
            "launches": conv_launches["conv3x3"],
            **{k: parity["block5_f32"][k] for k in (*keys, "library_ms", "shape")},
            "launches_by_path": by_path("conv3x3"),
            "hgmma_instructions": hgmma["conv3x3"],
            "hgmma_tf32_instructions": hgmma_tf32["conv3x3"],
            "bf16": parity["block5_bf16"],
            **{label: {"f32": parity[f"{label}_f32"], "bf16": parity[f"{label}_bf16"]} for label in ("block4", "block3")},
        },
        {
            "name": "conv3x3_im2col",
            "route": "cuda",
            "source": "fasterrcnn_torch/ops/kernels/csrc/conv3x3_im2col.cu",
            "replaces": "fasterrcnn_tpu/ops/pallas/conv_pallas.py:229",
            "launches": conv_launches["conv3x3_im2col"],
            **{k: parity["block2_f32"][k] for k in (*keys, "library_ms", "shape")},
            "launches_by_path": by_path("conv3x3_im2col"),
            "hgmma_instructions": hgmma["conv3x3_im2col"],
            "hgmma_tf32_instructions": hgmma_tf32["conv3x3_im2col"],
            "bf16": parity["block2_bf16"],
            "conv2_1": {"f32": parity["conv2_1_f32"], "bf16": parity["conv2_1_bf16"]},
        },
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
