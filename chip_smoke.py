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
     C=1024, at C=1030 (scalar lanes), on a map one element past a
     16-byte boundary and on the eval path's 800x608 and 608x928 canvases'
     maps, (4, 50, 38, 512) and (4, 38, 58, 512), and K2 and K4 on a
     (1, 38, 160, 512) map; the conv
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
     The same for ResNet-50 at the tiny config, its train step in
     from-scratch mode (train_all: bn3 scales 0, nothing frozen).
  5. main path, predict: the default ModelConfig (VGG-16, 21 classes, caps
     6000 -> 300) at full width through Engine, on a 608x800 canvas, B=4,
     seeded random weights and images: predict at score thresholds 0.05 and
     0.0, one predict_image, and bf16 predicts at both; the kernels' launch
     counts must rise. TF32 is off for every parity phase.
  6. main path, train: the default ModelConfig at full width through
     Engine.train_step and Engine.train_epoch, B=4 synthetic 600x800
     samples on the 608x800 canvas: the f32 loss must fall over 10 steps on
     one batch, with all four losses positive at the first step; two steps
     of train_epoch; bf16 train steps; K1-K3 must launch.
  6r. ResNet-101 at full width through Engine, B=4 on the 608x800 canvas,
     seeded random weights: the predict path as phase 5 (frozen mode, f32
     with TF32 off and bf16, score thresholds 0.05 and 0.0, the feature
     map's largest |value| printed); K2 and K3 on that path's own
     (4, 38, 50, 1024) maps and proposals, f32 and bf16, K2 identical to its
     plain version and K3 within `backward_close`, each timed; predict
     timing and profile; the train path as phase 6 in from-scratch mode
     (train_all), 10 f32 steps on one batch with a falling loss, two of
     train_epoch, two bf16 steps, K1-K3 launched; train timing and profile;
     then one f32 predict each of ResNet-50 and ResNet-152 on the same
     images, K1 and K2 launched.
  6x. exact RoIPool (roi_mode "exact_pool"), VGG-16 and ResNet-101 at full
     width through Engine on phase 5's images and phase 6's batch: predict
     f32 (TF32 off) and bf16 at score thresholds 0.05 and 0.0; on that
     path's own maps and proposals `roi_pool_exact` identical to the same
     function on CPU copies in f32 and bf16, and its f32 map cotangent of a
     seeded cotangent within 1e-6 of the CPU's largest |value|; 5 f32 train
     steps with a falling loss (ResNet-101 from scratch, train_all), two of
     train_epoch, two bf16; K1 launched, K2 and K3 not; predict and train
     times and peak device memory beside the crop path's of this run.
  6o. overfit proxy: `fasterrcnn_torch.scripts.overfit_sanity` at its recipe
     (150 epochs on 4 synthetic images) for VGG-16 and ResNet-50, each with
     the crop and with exact RoIPool; each must reach 90% train mAP.
  6e. the train loop as the JAX package runs it (`Engine.train_epoch`:
     packed steps and K-step blocks, each a CUDA graph): graph against
     eager on the every-box tiny config (`scripts/reference_train.
     graph_against_eager`: step 0 identical; the teacher-forced programs'
     later losses and parameters, in the closest of five replays, within
     twice the eager replicas' largest gap; learning rates and generator offsets those of the eager run; the
     trajectories' later losses and final parameters printed beside the
     eager runs' spread); VGG-16 and ResNet-101 (from scratch)
     at full width, f32 and bf16, K=8, B=4, 5 blocks of 600x800 samples
     held in memory, a cold and a warm epoch: epoch img/s beside eager
     train_step img/s, `last_epoch_trace`, a replayed block's device idle
     share, K1-K3 counted in each graph with its replays, losses finite and
     falling; the CLI's --memory-stats --profile-dir --debug-nans at the
     tiny config (the JAX CLI's three lines, a trace naming K1-K3); and
     `scripts/bench.py` once (BENCH_TRIALS=1, BENCH_EPOCH_TRIALS=1), one
     JSON line of finite rates.
  5b. the fused RoI op (K4's path): `roi_pool_fused`, the public op, on
     the predict path's own f32 feature map and RPN proposals; it must
     launch K4 and equal `roi_pool_fused_plain` and `roi_pool_taps` there,
     bit for bit, and on the same map cast to bf16 equal
     `roi_pool_fused_plain`.
  6b. conv A/B (K5's and K6's path): `fasterrcnn_torch.scripts.profile_conv`
     at --batch 4, bf16 and f32: every row timed, K5 and K6 launched (phase
     3 holds each kernel against its plain version at each of these
     shapes).
  6c. eval and CLI: `python -m fasterrcnn_torch` (its `main`, in this
     process) at the default ModelConfig() on a VOC tree that
     `data/synthetic_voc.py` writes (trainval 8, test 16, VOC-like sizes:
     the 608x800, 800x608 and 608x928 canvases), inside a temporary
     directory:
     --train for one epoch at batch 4 and learning rate 1e-5 with
     --save-to, --save-best-to, --log-csv and --checkpoint-dir, then --eval --load-from the saved
     weights, then --predict-to-file on a test JPEG. Every file must exist;
     the mAPs must lie in [0, 100], and --eval must print the train's final
     eval's mAP to the digit (same weights, same split); an engine loaded
     from the saved weights must hold the epoch-1 checkpoint's bit for bit;
     the train path must launch K1-K3 and the eval path K1 and K2. Then
     --eval --backbone resnet101 --load-from a torchvision-layout ResNet-101
     file the script writes from a seed: the file must load, the mAP lie in
     [0, 100], and K1 and K2 launch. Then --eval --custom-roi-pool
     --load-from the saved weights: the mAP in [0, 100], K1 launched, K2
     not. Then
     Engine.evaluate's throughput over the test split, fed by the reader
     (JPEG decode in the prefetch thread) and fed decoded samples; which
     decoder the reader used (the native one wherever libjpeg links, else
     PIL).
  6d. data parallelism (`parallel/mesh.py`, `Engine(mesh=...)`): two ranks
     sharing cuda:0 over gloo (NCCL refuses two ranks on one card; this
     checks correctness, not scaling), ModelConfig() at full width, B=4
     (two rows a rank), against one rank in this process from the same
     seeds: one K=8 block of `train_epoch` (step 0's losses within 1e-4,
     the later steps and the block's updates reported beside a second
     one-rank run's: a whole trajectory on the card is chaotic), a
     teacher-forced step from the one-rank run's trained weights (losses
     within 1e-4, updates within 3e-3 in relative norm), both ranks'
     parameters identical bit for bit, and `Engine.evaluate` of the seed-0
     weights over phase 6c's VOC tree (mAP above 0 and equal on both
     ranks and one rank); each rank's K1-K3 launches, set to 0 before, must
     rise; the backend, the one-rank step as one graph and split as the
     ranks run it, the ranks' step with and without the all-reduce, in ms.
  6t. tensor parallelism (`parallel/tp.py`, `Engine(mesh=...)` on a tp
     mesh): ranks sharing cuda:0 over gloo, against one rank in this
     process from the same seeds, B=4, f32 with TF32 off. dp=1 x tp=2 (phase
     6d's two ranks, re-grouped after their dp run) for ModelConfig() and
     ResNet-101 (train_all): step 0's losses
     within 1e-4; a teacher-forced step's losses within 1e-4 and updates
     within 3e-3 in relative norm; the replicated tensors identical bit for
     bit on both ranks, the gathered states equal and each rank's tensors
     their shards; `Engine.predict` (score threshold 0) with the same valid
     slots as one rank's, the largest gaps printed; `Engine.evaluate` over
     phase 6c's tree with the mAP of one rank on every rank; a bf16
     predict's gap to one rank's printed; the packed step's ms with and
     without the tp collectives. dp=2 x tp=2 (four ranks), VGG-16: the
     teacher-forced step and the mAP. Every rank's K1-K3 launches must
     rise.
  6s. stage isolation: `scripts/profile_inference.py` and
     `scripts/profile_train.py` through their `main` at B=4, VGG-16 f32,
     LO/HI 2/4 (each stage's slope and device busy time); each prefix
     identical (torch.equal) to the whole program's value at that point
     (predict's proposals and class logits; the train step's loss under
     no_grad, after its backward and from make_train_step, against
     compute_losses' from the same draws); `scripts/gradcheck_roi_vjp.py`'s
     three checks at C=512 (B=4, P=128), its two gates required. K1-K3
     must launch.
  7. timing (VGG-16 and ResNet-101, each after its paths): Engine.predict
     and Engine.train_step on the host's batch, ms
     per batch and img/s (f32 with TF32 off, f32 with cuDNN TF32 on, bf16),
     and the peak memory of the f32 call. Each kernel's time, with CUDA
     events beside its plain version's and its bound, is taken in phase 3.
  8. profile (VGG-16 and ResNet-101): torch.profiler over warm
     Engine.predict calls and warm
     Engine.train_step calls, f32 and bf16 with TF32 off: device time by
     layer, idle share, device ops per call.
Each path runs with every kernel's launch count set to 0 just before it and
read just after. Then, on the last lines: the card line, one JSON line of
the kernels, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
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
    element past a 16-byte boundary; K2 and K4 on a (1, 38, 160, 512)
    map x 300 RoIs, wider than a dense-sheet K4 could hold in shared memory;
    and K2, K4 (300 RoIs) and K3 (128 RoIs) on the eval path's two other
    canvases: 800x608, a (4, 50, 38, 512) map taller than it is wide, with
    RoIs drawn for 800x600 images, and 608x928, a (4, 38, 58, 512) map, with
    RoIs drawn for 600x900 images."""
    import torch
    from fasterrcnn_torch.ops import roi as roi_ops
    from fasterrcnn_torch.scripts import profile_roi

    results = {}
    # (label, B, map (H, W), C, misaligned, image (h, w), real grid (h, w)):
    # the real grid is VGG-16's, the image's sides divided by 16, floored.
    cases = (("c1024", 4, (38, 50), 1024, False, (600.0, 800.0), (37, 50)),
             ("c1030", 4, (38, 50), 1030, False, (600.0, 800.0), (37, 50)),
             ("misaligned", 4, (38, 50), 512, True, (600.0, 800.0), (37, 50)),
             ("w160", 1, (38, 160), 512, False, (600.0, 2560.0), (37, 160)),
             ("tall", 4, (50, 38), 512, False, (800.0, 600.0), (50, 37)),
             ("wide", 4, (38, 58), 512, False, (600.0, 900.0), (37, 56)))
    for label, b, (h, w), c, misaligned, (img_h, img_w), (grid_h, grid_w) in cases:
        norm = torch.tensor([[(grid_h - 1) / img_h, (grid_w - 1) / img_w]] * b, device=dev)
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


def phase_reference(dev, rng, backbone="vgg16"):
    """Tiny config on the card vs on the CPU, with identical weights. For a
    ResNet the tolerances of the maps and head outputs are 1e-4 of the CPU
    values' largest magnitude (at least 1e-4): its 16-49 residual blocks
    carry the two devices' last-bit differences into values of ~10."""
    import torch
    from fasterrcnn_torch.config import AnchorConfig, ModelConfig, RPNConfig
    from fasterrcnn_torch.models import faster_rcnn as frcnn
    from fasterrcnn_torch.models.rpn import generate_proposals

    cfg = ModelConfig(
        backbone=backbone,
        anchors=AnchorConfig(areas=(24.0 * 24, 48.0 * 48, 96.0 * 96)),
        rpn=RPNConfig(pre_nms_infer=200, post_nms_infer=64),
    )
    scaled = backbone.startswith("resnet")
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

    def close(name, got, want, atol, relative=False):
        if relative:
            atol *= max(1.0, float(want.abs().max()))
        err = float((got.cpu().float() - want.float()).abs().max().item())
        print(f"reference {backbone} {name}: max_abs_err {err!r} (atol {atol!r})", flush=True)
        check(err <= atol, f"reference {backbone} {name}: card vs CPU max_abs_err {err} > {atol}")

    with torch.inference_mode():
        fm_c, lg_c, dl_c = cpu.features_and_rpn(images)
        fm_g, lg_g, dl_g = card.features_and_rpn(images.to(dev))
        for name, g, w in (("feature map", fm_g, fm_c), ("rpn logits", lg_g, lg_c), ("rpn deltas", dl_g, dl_c)):
            close(name, g, w, 1e-4, scaled)

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
        close("class logits", cls_g, cls_c, 1e-4, scaled)
        close("box deltas", box_g, box_c, 1e-4, scaled)

    # The whole predict: the card's RPN outputs differ from the CPU's in the
    # last bits, which may reorder near-equal scores; require agreement on
    # all but 1% of the detection slots and closeness where both are valid.
    d_c = frcnn.make_predict_fn(cpu, 128, 160)(images, hw, score_threshold=0.0)
    d_g = frcnn.make_predict_fn(card, 128, 160)(images.to(dev), hw.to(dev), score_threshold=0.0)
    both = (d_g.valid.cpu() > 0) & (d_c.valid > 0)
    agree = float((d_g.valid.cpu() == d_c.valid).float().mean().item())
    print(f"reference {backbone} predict: {int(d_c.valid.sum())} CPU detections, valid agreement {agree!r}",
          flush=True)
    check(d_c.valid.sum() > 0 and agree >= 0.99, f"reference {backbone} predict: valid agreement {agree}")
    close("detection scores", d_g.scores.cpu()[both], d_c.scores[both], 1e-4)


def phase_reference_train(dev, seed=0, backbone="vgg16", train_all=False):
    """One train step's losses and gradients, card vs CPU
    (`scripts/reference_train.run_draw`): same weights, same draws, and a
    batch from its own seeded generator. Losses within 1e-4 relative;
    gradients per tensor in relative norm |g_card - g_cpu| / |g_cpu| <= 3e-3:
    the backbones differ in the last bits (TF32 off), and on the ReLU'd
    feature map a tie between two samples may be exact on one side only, so
    a cotangent splits on one side alone."""
    from fasterrcnn_torch.scripts import reference_train

    label = f"reference train {backbone}{' train_all' if train_all else ''}"
    row = reference_train.run_draw(dev, seed, backbone=backbone, train_all=train_all)
    print(f"{label} losses: card {row['losses_card']!r}, CPU {row['losses_cpu']!r}", flush=True)
    for name, a, c in zip(("rpn_class", "rpn_regression", "detector_class", "detector_regression"),
                          row["losses_card"], row["losses_cpu"]):
        check(c > 0 and abs(a - c) <= 1e-4 * abs(c), f"{label} {name}: card {a} vs CPU {c}")
    print(f"{label} gradients (seed {seed}): worst relative norm {row['worst']!r} ({row['worst_tensor']}; "
          f"tolerance {reference_train.TOLERANCE}) over {row['tensors']} tensors", flush=True)
    check(row["worst"] <= reference_train.TOLERANCE, f"{label} gradients: {row['worst_tensor']} at {row['worst']}")


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


def path_launches(counters, required, label, absent=()):
    """Every kernel's launches on the path just run; each of `required`
    must have launched, and none of `absent`."""
    return check_launches({fn.__name__: fn.launches for fn in counters}, required, label, absent)


def check_launches(launches, required, label, absent=()):
    """`path_launches` of counts taken elsewhere (by a rank)."""
    print(f"{label} launches: {launches}", flush=True)
    for name in required:
        check(launches[name] > 0, f"{label}: kernel {name} was never launched")
    for name in absent:
        check(launches[name] == 0, f"{label}: kernel {name} was launched {launches[name]} times, off its path")
    return launches


def feature_map_peak(engine, images):
    """The largest |value| of the engine's feature map of `images`: a fresh
    deep ResNet (bn3 scale 1) grows its activations block by block, and a
    blow-up shows here as a number before it shows as NaN detections."""
    import torch

    with torch.inference_mode():
        fm, _, _ = engine.model.features_and_rpn(torch.as_tensor(images, device=engine.device))
        return float(fm.float().abs().max())


def phase_main_path(dev, rng, counters, canvas=(608, 800), extents=MAIN_EXTENTS, cfg=None, label="main path",
                    images=None):
    """The predict path of `cfg` (default: ModelConfig(), VGG-16), f32 and
    bf16, with every launch count in `counters` set to 0 before it; it must
    launch K1 and K2 (K1 and not K2 under roi_mode "exact_pool"). The
    images are drawn from `rng`, or given as (images, image_hw)."""
    import dataclasses

    import torch
    from fasterrcnn_torch.config import ModelConfig
    from fasterrcnn_torch.data.voc import Sample
    from fasterrcnn_torch.engine import Engine

    cfg = cfg or ModelConfig()
    b = len(extents)
    images, image_hw = images if images is not None else main_path_images(rng, extents, canvas)
    t0 = time.perf_counter()
    engine = Engine(cfg, seed=0)
    engine16 = Engine(dataclasses.replace(cfg, compute_dtype="bfloat16"), seed=0)
    print(f"{label}: {cfg.backbone} engines built in {time.perf_counter() - t0:.1f} s", flush=True)

    for fn in counters:
        fn.launches = 0
    det05 = engine.predict(images, image_hw, score_threshold=0.05)
    det0 = engine.predict(images, image_hw, score_threshold=0.0)
    h0, w0 = extents[0]
    sample = Sample(image_u8=images[0, :h0, :w0], image_hw=(h0, w0), gt_boxes=[], filepath="random")
    per_image = engine.predict_image(sample, score_threshold=0.0)
    det16_05 = engine16.predict(images, image_hw, score_threshold=0.05)
    det16 = engine16.predict(images, image_hw, score_threshold=0.0)
    torch.cuda.synchronize()
    if cfg.roi_mode == "exact_pool":
        launches = path_launches(counters, ("nms_keep_mask",), label, absent=("roi_pool_taps", "roi_pool_taps_bwd"))
    else:
        launches = path_launches(counters, ("nms_keep_mask", "roi_pool_taps"), label)

    n05 = check_detections(det05, b, 300, image_hw, f"{label} predict f32 @0.05")
    n0 = check_detections(det0, b, 300, image_hw, f"{label} predict f32 @0.0")
    n16_05 = check_detections(det16_05, b, 300, image_hw, f"{label} predict bf16 @0.05")
    n16 = check_detections(det16, b, 300, image_hw, f"{label} predict bf16 @0.0")
    print(f"{label} detections: f32 @0.05 {n05}, f32 @0.0 {n0}, bf16 @0.05 {n16_05}, bf16 @0.0 {n16}; "
          f"max |feature map| f32 {feature_map_peak(engine, images)!r}, bf16 {feature_map_peak(engine16, images)!r}",
          flush=True)
    check(n0 > 0 and n16 > 0, "predict at score threshold 0.0 found no detections")
    check(sorted(per_image) == list(range(1, 21)), "predict_image: class keys")
    check(all(r.ndim == 2 and r.shape[1] == 5 and np.isfinite(r).all() for r in per_image.values()),
          "predict_image: rows")
    # predict_image runs image 0 alone (B=1), where cuDNN may pick another
    # algorithm than at B=4: near-equal scores may reorder, so the counts
    # need only be close.
    n_img = sum(len(r) for r in per_image.values())
    n_batch = int((det0.valid[0] > 0).sum())
    print(f"{label} predict_image: {n_img} detections over 20 classes (batched image 0: {n_batch})", flush=True)
    check(abs(n_img - n_batch) <= max(2, n_batch // 20), f"{label}: predict_image disagrees with predict on image 0")
    return engine, engine16, images, image_hw, launches


def phase_main_path_train(counters, steps=10, cfg=None, label="train path"):
    """The train path of `cfg` (default: ModelConfig(), VGG-16) at full
    width through Engine, with every launch count in `counters` set to 0
    before it; it must launch K1-K3 (K1 and neither K2 nor K3 under
    roi_mode "exact_pool")."""
    import dataclasses

    import torch
    from fasterrcnn_torch.config import ModelConfig
    from fasterrcnn_torch.data.pipeline import make_host_batch
    from fasterrcnn_torch.data.synthetic import SyntheticDataset
    from fasterrcnn_torch.engine import Engine

    cfg = cfg or ModelConfig()
    t0 = time.perf_counter()
    engine = Engine(cfg, seed=0)
    engine16 = Engine(dataclasses.replace(cfg, compute_dtype="bfloat16"), seed=0)
    print(f"{label}: {cfg.backbone} engines built in {time.perf_counter() - t0:.1f} s", flush=True)
    batch = make_host_batch(list(SyntheticDataset(num_samples=4, seed=0)), (608, 800), cfg.max_gt_boxes)

    for fn in counters:
        fn.launches = 0
    totals = []
    for i in range(steps):
        losses = engine.train_step(batch)
        values = [v.item() for v in losses]
        check(all(np.isfinite(values)), f"{label} step {i}: non-finite losses {values}")
        if i == 0:
            check(all(v > 0 for v in values), f"{label} step 0: a loss is not positive: {values}")
        totals.append(sum(values))
    print(f"{label} f32, one batch repeated: total loss by step {totals!r}", flush=True)
    check(totals[-1] < totals[0], f"{label} f32: the loss did not fall over {steps} steps: {totals}")
    stats = engine.train_epoch(SyntheticDataset(num_samples=8, seed=1), batch_size=4, max_steps=2)
    means = stats.means()
    print(f"{label} train_epoch f32, 2 steps: {means}", flush=True)
    check(stats._count == 2 and all(np.isfinite(v) for v in means.values()), f"{label} train_epoch: {means}")
    values16 = []
    for _ in range(2):
        values16.append([v.item() for v in engine16.train_step(batch)])
    print(f"{label} bf16, 2 steps: {values16!r}", flush=True)
    check(all(np.isfinite(values16).ravel()), f"{label} bf16: non-finite losses")
    check(all(p.dtype == torch.float32 for p in engine16.model.parameters()), "bf16 engine: parameters not f32")
    torch.cuda.synchronize()
    if cfg.roi_mode == "exact_pool":
        launches = path_launches(counters, ("nms_keep_mask",), label, absent=("roi_pool_taps", "roi_pool_taps_bwd"))
    else:
        launches = path_launches(counters, ("nms_keep_mask", "roi_pool_taps", "roi_pool_taps_bwd"), label)
    return engine, engine16, batch, launches


def path_roi_parity(engine, engine16, images, image_hw, p_bwd=128):
    """K2 and K3 against their plain versions on a predict path's own maps
    and RPN proposals (the f32 engine's map for f32, the bf16 engine's for
    bf16): K2 identical on every proposal, K3 within `backward_close` on the
    first `p_bwd` proposals of each image (the train path's RoI count) with
    a seeded cotangent; each timed beside its plain version and its bound."""
    import torch
    from fasterrcnn_torch.models import faster_rcnn as frcnn
    from fasterrcnn_torch.ops import roi as roi_ops
    from fasterrcnn_torch.scripts import profile_roi
    from fasterrcnn_torch.scripts.profile_conv import time_ms

    dev, name = engine.device, engine.model.cfg.backbone
    grid = frcnn.anchor_grid_for(engine.model.cfg, *images.shape[1:3])
    centers = torch.as_tensor(grid.centers, device=dev)
    x, hw = torch.as_tensor(images, device=dev), torch.as_tensor(image_hw, device=dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    results = {}
    for tag, eng in (("f32", engine), ("bf16", engine16)):
        with torch.inference_mode():
            fm, props = frcnn.infer_proposals(eng.model, grid, centers, x, hw)
            norm, boxes = eng.model.roi_norm(hw), props.boxes
            got, want = roi_ops.roi_pool_taps(fm, boxes, norm), roi_ops.roi_pool_features(fm, boxes, norm)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            mismatches = int((got != want).sum())
            b, h, w, c = fm.shape
            print(f"roi_pool_taps on the {name} predict path's own {tag} map {tuple(fm.shape)} (max |map| "
                  f"{float(fm.float().abs().max())!r}) and {tuple(boxes.shape)} proposals: max_abs_err {err!r}, "
                  f"{mismatches} of {got.numel()} values differ (tolerance: identical)", flush=True)
            check(fm.dtype == (torch.float32 if tag == "f32" else torch.bfloat16), f"{name} {tag} map: {fm.dtype}")
            check(mismatches == 0, f"roi_pool_taps on the {name} {tag} path: {mismatches} values differ")
            rois = boxes[:, :p_bwd].contiguous()
            g = torch.randn((b, p_bwd, 7, 7, c), generator=gen, device=dev).to(fm.dtype)
            ok, err_bwd = profile_roi.backward_close(roi_ops.roi_pool_taps_bwd(fm, rois, norm, g),
                                                     roi_ops.roi_pool_taps_bwd_plain(fm, rois, norm, g))
            print(f"roi_pool_taps_bwd on the {name} {tag} map and its first {p_bwd} proposals an image: "
                  f"max_abs_err {err_bwd!r} (tolerance: backward_close)", flush=True)
            check(ok, f"roi_pool_taps_bwd on the {name} {tag} path: outside tolerance, max_abs_err {err_bwd}")
            fwd = results[f"roi_pool_taps_{tag}"] = dict(
                max_abs_err=err, mismatches=mismatches,
                ms=time_ms(lambda: roi_ops.roi_pool_taps(fm, boxes, norm), 20),
                plain_ms=time_ms(lambda: roi_ops.roi_pool_features(fm, boxes, norm), 3),
                **profile_roi.forward_bound(fm, boxes, norm), shape=[b, h, w, c, boxes.shape[1]],
            )
            bwd = results[f"roi_pool_taps_bwd_{tag}"] = dict(
                max_abs_err=err_bwd,
                ms=time_ms(lambda: roi_ops.roi_pool_taps_bwd(fm, rois, norm, g), 20),
                plain_ms=time_ms(lambda: roi_ops.roi_pool_taps_bwd_plain(fm, rois, norm, g), 3),
                **profile_roi.backward_bound(fm, rois, norm), shape=[b, h, w, c, p_bwd],
            )
        for kernel, row in (("roi_pool_taps", fwd), ("roi_pool_taps_bwd", bwd)):
            print(f"  {kernel} {tag} on the {name} path: {row['ms']!r} ms, plain {row['plain_ms']!r} ms, "
                  f"bound {row['bound_ms']!r} ms ({row['bound_by']})", flush=True)
    return results


def phase_predict_only(counters, backbone, images, image_hw):
    """One f32 predict of `backbone` at score threshold 0.0 through Engine,
    with every launch count set to 0 before it; it must launch K1 and K2."""
    import torch
    from fasterrcnn_torch.config import ModelConfig
    from fasterrcnn_torch.engine import Engine

    engine = Engine(ModelConfig(backbone=backbone), seed=0)
    for fn in counters:
        fn.launches = 0
    det = engine.predict(images, image_hw, score_threshold=0.0)
    torch.cuda.synchronize()
    label = f"{backbone} predict path"
    launches = path_launches(counters, ("nms_keep_mask", "roi_pool_taps"), label)
    n = check_detections(det, len(images), 300, image_hw, f"{label} f32 @0.0")
    print(f"{label}: {n} detections f32 @0.0; max |feature map| {feature_map_peak(engine, images)!r}", flush=True)
    check(n > 0, f"{label}: no detections at score threshold 0.0")
    del engine
    torch.cuda.empty_cache()
    return launches


def torchvision_resnet_state(rng, backbone):
    """A torchvision-layout ResNet state dict made from a seed (the names
    and shapes of torchvision.models.resnet*: conv weights, BN gamma, beta,
    running mean, positive running variance, num_batches_tracked, the
    1000-way fc): lecun-normal convs and small bn3 gammas, as trained
    ResNets have, so that the 33 or more blocks keep finite activations."""
    import torch
    from fasterrcnn_torch.models.resnet import ARCHITECTURES

    state = {}

    def conv(name, co, ci, k):
        std = (1.0 / (ci * k * k)) ** 0.5
        state[f"{name}.weight"] = torch.from_numpy(rng.normal(0.0, std, (co, ci, k, k)).astype(np.float32))

    def bn(name, c, gamma=(0.5, 1.0)):
        for key, values in (("weight", rng.uniform(*gamma, c)), ("bias", rng.normal(0.0, 0.1, c)),
                            ("running_mean", rng.normal(0.0, 0.2, c)), ("running_var", rng.uniform(0.5, 2.0, c))):
            state[f"{name}.{key}"] = torch.from_numpy(values.astype(np.float32))
        state[f"{name}.num_batches_tracked"] = torch.tensor(0)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    in_ch = 64
    for stage, (n, width) in enumerate(zip(ARCHITECTURES[backbone], (64, 128, 256, 512)), start=1):
        for i in range(n):
            pre = f"layer{stage}.{i}"
            conv(f"{pre}.conv1", width, in_ch, 1)
            bn(f"{pre}.bn1", width)
            conv(f"{pre}.conv2", width, width, 3)
            bn(f"{pre}.bn2", width)
            conv(f"{pre}.conv3", 4 * width, width, 1)
            bn(f"{pre}.bn3", 4 * width, gamma=(0.0, 0.2))
            if i == 0:
                conv(f"{pre}.downsample.0", 4 * width, in_ch, 1)
                bn(f"{pre}.downsample.1", 4 * width)
            in_ch = 4 * width
    state["fc.weight"] = torch.from_numpy(rng.normal(0.0, 0.01, (1000, 2048)).astype(np.float32))
    state["fc.bias"] = torch.zeros(1000)
    return state


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


def exact_pool_parity(engine, engine16, images, image_hw, p_bwd=128):
    """`roi_pool_exact` on an exact-pool predict path's own maps and RPN
    proposals (the f32 engine's map for f32, the bf16 engine's for bf16)
    against the same function on CPU copies: identical values (gathers and
    maxes do not round); in f32 also the map cotangent of a seeded
    cotangent on the first `p_bwd` proposals an image (the train path's RoI
    count), within 1e-6 of the CPU's largest |value| (the card's sums over
    RoIs are atomic adds, the CPU's run in order). Each timed (CUDA events,
    the op's one host read of the widest bin included) with the peak device
    memory of its call."""
    import torch
    from fasterrcnn_torch.models import faster_rcnn as frcnn
    from fasterrcnn_torch.ops import roi as roi_ops
    from fasterrcnn_torch.scripts.profile_conv import time_ms

    dev, name = engine.device, engine.model.cfg.backbone
    scale = 1.0 / engine.model.spec.feature_pixels
    grid = frcnn.anchor_grid_for(engine.model.cfg, *images.shape[1:3])
    centers = torch.as_tensor(grid.centers, device=dev)
    x, hw = torch.as_tensor(images, device=dev), torch.as_tensor(image_hw, device=dev)
    gen = torch.Generator(device=dev).manual_seed(10)

    def peak_of(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - resident

    results = {}
    for tag, eng in (("f32", engine), ("bf16", engine16)):
        with torch.inference_mode():
            fm, props = frcnn.infer_proposals(eng.model, grid, centers, x, hw)
        fm, boxes = fm.clone(), props.boxes.clone()
        b, h, w, c = fm.shape
        with torch.no_grad():
            got, peak = peak_of(lambda: roi_ops.roi_pool_exact(fm, boxes, scale))
            t0 = time.perf_counter()
            want = roi_ops.roi_pool_exact(fm.cpu(), boxes.cpu(), scale)
            cpu_s = time.perf_counter() - t0
        mismatches = int((got.cpu() != want).sum())
        err = float((got.cpu().float() - want.float()).abs().max())
        print(f"roi_pool_exact on the {name} exact-pool predict path's own {tag} map {tuple(fm.shape)} and "
              f"{tuple(boxes.shape)} proposals: {mismatches} of {got.numel()} values differ from the CPU's, "
              f"max_abs_err {err!r} (tolerance: identical); CPU {cpu_s:.1f} s", flush=True)
        check(got.dtype == fm.dtype and mismatches == 0, f"roi_pool_exact on the {name} {tag} path: card vs CPU")
        with torch.no_grad():
            row = results[tag] = dict(
                max_abs_err=err, mismatches=mismatches, peak_bytes=peak, shape=[b, h, w, c, boxes.shape[1]],
                ms=time_ms(lambda: roi_ops.roi_pool_exact(fm, boxes, scale), 10),
            )
        if tag == "f32":
            rois = boxes[:, :p_bwd].contiguous()
            g = torch.randn((b, p_bwd, 7, 7, c), generator=gen, device=dev)
            grads = []
            for device in (dev, torch.device("cpu")):
                leaf = fm.detach().to(device).requires_grad_()
                roi_ops.roi_pool_exact(leaf, rois.to(device), scale).backward(g.to(device))
                grads.append(leaf.grad.cpu())
            scale_ref = float(grads[1].abs().max())
            err_bwd = float((grads[0] - grads[1]).abs().max())
            print(f"roi_pool_exact map cotangent on the {name} f32 map and its first {p_bwd} proposals an image: "
                  f"max_abs_err {err_bwd!r} against the CPU's (max |CPU| {scale_ref!r}; tolerance 1e-6 of it)",
                  flush=True)
            check(err_bwd <= 1e-6 * scale_ref, f"roi_pool_exact backward on the {name} path: {err_bwd}")
            bins, rows, cols, chunk = roi_ops._exact_plan(fm, rois, scale, 7)
            _, peak_bwd = peak_of(lambda: roi_ops.roi_pool_exact_bwd(fm, bins, g, rows, cols, chunk))
            row.update(bwd_max_abs_err=err_bwd, bwd_peak_bytes=peak_bwd, bwd_rois=p_bwd, rows=rows, cols=cols,
                       chunk=chunk, bwd_ms=time_ms(lambda: roi_ops.roi_pool_exact_bwd(fm, bins, g, rows, cols, chunk), 5))
        print(f"  roi_pool_exact {tag} on the {name} path: {row['ms']!r} ms, peak {row['peak_bytes']} bytes"
              + (f"; backward at {p_bwd} RoIs an image {row['bwd_ms']!r} ms, peak {row['bwd_peak_bytes']} bytes "
                 f"(widest bin {row['rows']} rows x {row['cols']} columns, {row['chunk']} RoIs a chunk)"
                 if tag == "f32" else ""), flush=True)
    return results


def phase_exact_pool(dev, counters, card, images, image_hw, crop):
    """Phase 6x: roi_mode "exact_pool" at full width, VGG-16 and ResNet-101,
    through Engine on phase 5's images: the predict path (f32 with TF32 off
    and bf16, score thresholds 0.05 and 0.0) and `exact_pool_parity` on its
    own maps, predict timing; then the train path on phase 6's batch (5 f32
    steps with a falling loss, ResNet-101 in from-scratch mode as phase 6r),
    train timing. Each path must launch K1 and neither K2 nor K3. Times and
    peak memory are printed beside the crop path's of this run (`crop`)."""
    import dataclasses

    import torch
    from fasterrcnn_torch.config import ModelConfig

    out, launches = {}, {}
    for backbone in ("vgg16", "resnet101"):
        cfg = ModelConfig(backbone=backbone, roi_mode="exact_pool")
        engine, engine16, _, _, launches[f"{backbone}_exact_predict"] = phase_main_path(
            dev, None, counters, cfg=cfg, label=f"{backbone} exact_pool predict path", images=(images, image_hw))
        parity = exact_pool_parity(engine, engine16, images, image_hw)
        timing = phase_timing(engine, engine16, images, image_hw, card)
        del engine, engine16
        torch.cuda.empty_cache()
        t_engine, t_engine16, batch, launches[f"{backbone}_exact_train"] = phase_main_path_train(
            counters, steps=5, cfg=dataclasses.replace(cfg, train_all=backbone != "vgg16"),
            label=f"{backbone} exact_pool train path")
        train_timing = phase_timing_train(t_engine, t_engine16, batch, card)
        del t_engine, t_engine16
        torch.cuda.empty_cache()
        out[backbone] = {"roi_pool_exact": parity, "predict_timing": timing, "train_timing": train_timing}
        for call, exact, base in (("Engine.predict", timing, crop[backbone]["predict"]),
                                  ("Engine.train_step", train_timing, crop[backbone]["train"])):
            print(f"{backbone} {call} exact_pool vs crop: f32 TF32 off {exact['f32_tf32_off']['median_ms']!r} vs "
                  f"{base['f32_tf32_off']['median_ms']!r} ms, cuDNN TF32 {exact['f32_cudnn_tf32_on']['median_ms']!r} vs "
                  f"{base['f32_cudnn_tf32_on']['median_ms']!r} ms, bf16 {exact['bf16']['median_ms']!r} vs "
                  f"{base['bf16']['median_ms']!r} ms; f32 peak device memory {exact['f32_peak_mem_bytes']} vs "
                  f"{base['f32_peak_mem_bytes']} bytes (resident {exact['resident_bytes']} vs "
                  f"{base['resident_bytes']}) [{card}]", flush=True)
    print(json.dumps({"exact_pool": out, "card": card}), flush=True)
    return out, launches


def phase_overfit(counters, card, epochs=150):
    """Phase 6o: `fasterrcnn_torch.scripts.overfit_sanity` at its recipe on
    the card, VGG-16 and ResNet-50 each with the crop and with exact
    RoIPool; each must reach 90% train mAP (the script exits below it) and
    launch K1, and K2 and K3 on the crop runs only. The script reads its
    backbone and epochs from OVERFIT_BACKBONE and OVERFIT_EPOCHS."""
    import torch
    from fasterrcnn_torch.scripts import overfit_sanity

    os.environ["OVERFIT_EPOCHS"] = str(epochs)
    results, launches = {}, {}
    t0 = time.perf_counter()
    for backbone, roi_mode in (("vgg16", "crop"), ("resnet50", "crop"), ("vgg16", "exact_pool"),
                               ("resnet50", "exact_pool")):
        label = f"overfit {backbone} {roi_mode}"
        for fn in counters:
            fn.launches = 0
        t1 = time.perf_counter()
        os.environ["OVERFIT_BACKBONE"] = backbone
        mAP = overfit_sanity.main(device="cuda", roi_mode=roi_mode)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        crop = roi_mode == "crop"
        launches[f"overfit_{backbone}_{roi_mode}"] = path_launches(
            counters, ("nms_keep_mask", "roi_pool_taps", "roi_pool_taps_bwd") if crop else ("nms_keep_mask",), label,
            absent=() if crop else ("roi_pool_taps", "roi_pool_taps_bwd"))
        results[f"{backbone}_{roi_mode}"] = {"map_pct": mAP, "epochs": epochs, "seconds": seconds}
        print(f"{label}: train-set mAP {mAP!r}% after {epochs} epochs in {seconds:.1f} s (bar 90%) [{card}]",
              flush=True)
    print(json.dumps({"overfit": results, "seconds": time.perf_counter() - t0, "card": card}), flush=True)
    return results, launches


def phase_graph_vs_eager(card):
    """Phase 6e, first part: the captured train programs against eager
    steps (`scripts/reference_train.graph_against_eager`: the every-box
    tiny config, f32, TF32 off; step 0 of the two `train_epoch`
    trajectories, the teacher-forced programs, and the packed program's
    learning rates and generator offsets against the eager run's). Every
    check must hold."""
    from fasterrcnn_torch.scripts.reference_train import graph_against_eager

    out = graph_against_eager()
    print(f"graph against eager: {json.dumps(out)} [{card}]", flush=True)
    check(not out["failures"], f"graph against eager: {out['failures']}")
    return out


def profile_block(label, step, images, aux, card):
    """Device busy time and idle share of one replayed program (torch.profiler)."""
    return phase_profile({label: lambda: step(images, aux)}, card, reps=1)[label]


def phase_train_loop(counters, card, k=8, blocks=5, b=4):
    """Phase 6e, second part: `Engine.train_epoch` at full width, VGG-16
    (`ModelConfig()`) and ResNet-101 in from-scratch mode, f32 (TF32 off)
    and bf16, over k * blocks batches of b synthetic 600x800 samples (the
    608x800 canvas), held in memory: a cold epoch (the captures), then a
    warm one. Each prints the warm epoch's img/s beside eager
    `Engine.train_step` img/s on one of its batches, `last_epoch_trace`, the
    device idle share of one replayed k-step block, and K1-K3's launches:
    counted at capture and added at each replay. Losses must be finite and
    fall from the first block to the last."""
    import dataclasses

    import torch
    from fasterrcnn_torch.config import ModelConfig
    from fasterrcnn_torch.data.pipeline import make_host_batch
    from fasterrcnn_torch.data.synthetic import SyntheticDataset
    from fasterrcnn_torch.engine import Engine
    from fasterrcnn_torch.models.faster_rcnn import pack_aux
    from fasterrcnn_torch.scripts.reference_train import StepRows

    os.environ["FRCNN_SCAN_STEPS"] = str(k)
    samples = list(SyntheticDataset(num_samples=k * blocks * b, seed=5))
    n = len(samples)
    results, launches = {}, {}
    for name, cfg in (("vgg16", ModelConfig()), ("resnet101", ModelConfig(backbone="resnet101", train_all=True))):
        for dtype in ("float32", "bfloat16"):
            label = f"train loop {name} {dtype}"
            engine = Engine(dataclasses.replace(cfg, compute_dtype=dtype), seed=0)
            for fn in counters:
                fn.launches = 0
            cold, warm = StepRows(), StepRows()
            t0 = time.perf_counter()
            engine.train_epoch(samples, b, stats=cold)
            cold_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            engine.train_epoch(samples, b, stats=warm)
            warm_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            tag = f"train_loop_{name}_{'f32' if dtype == 'float32' else 'bf16'}"
            launches[tag] = path_launches(counters, ("nms_keep_mask", "roi_pool_taps", "roi_pool_taps_bwd"), label)
            scan = engine.scan_step_for((608, 800), k).captured_step
            check(len(scan.graphs) == 1 and scan.replays == 2 * blocks,
                  f"{label}: {scan.replays} replays of the {k}-step graph, expected {2 * blocks}")
            rows = np.array(cold.rows + warm.rows)
            totals = rows.sum(axis=1)
            check(rows.shape == (2 * n // b, 4) and np.isfinite(rows).all(), f"{label}: loss rows {rows.shape}")
            first, last = float(totals[:k].mean()), float(totals[-k:].mean())
            check(last < first, f"{label}: the loss did not fall (first block {first}, last {last})")
            trace = dict(engine.last_epoch_trace)
            hb = make_host_batch(samples[:b], (608, 800), cfg.max_gt_boxes)
            for _ in range(2):
                engine.train_step(hb)
            torch.cuda.synchronize()
            times = []
            for _ in range(8):
                t0 = time.perf_counter()
                engine.train_step(hb)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            step_ips = b / statistics.median(times)
            block = [make_host_batch(samples[i * b:(i + 1) * b], (608, 800), cfg.max_gt_boxes) for i in range(k)]
            images = torch.as_tensor(np.stack([h.images for h in block]), device="cuda")
            aux = torch.as_tensor(np.stack([pack_aux(h, i) for i, h in enumerate(block)]), device="cuda")
            prof = profile_block(f"{label} {k}-step replay", engine.scan_step_for((608, 800), k), images, aux, card)
            results[tag] = {
                "epoch_images_per_sec": n / warm_s, "epoch_images_per_sec_cold": n / cold_s,
                "step_images_per_sec": step_ips, "epoch_vs_step": n / warm_s / step_ips,
                "last_epoch_trace": trace, "block_device_idle_share": prof["device_idle_share"],
                "block_device_busy_ms": prof["device_busy_ms_per_call"], "block_wall_ms": prof["wall_ms_per_call_profiler_on"],
                "capture_launches": dict(scan.launches), "replays": scan.replays,
                "first_block_loss": first, "last_block_loss": last,
            }
            print(f"{label}: epoch {n / warm_s!r} img/s warm ({n / cold_s!r} cold, captures included), eager "
                  f"train_step {step_ips!r} img/s, epoch_vs_step {n / warm_s / step_ips!r}; trace {trace}; "
                  f"{k}-step replay idle share {prof['device_idle_share']!r}; K1-K3 in the graph {scan.launches}, "
                  f"{scan.replays} replays; mean loss first block {first!r}, last {last!r} [{card}]", flush=True)
            del engine, scan
            torch.cuda.empty_cache()
    os.environ.pop("FRCNN_SCAN_STEPS")
    print(json.dumps({"train_loop": results, "card": card}), flush=True)
    return results, launches


def libjpeg_present() -> bool:
    """Whether g++ compiles and links a program against libjpeg here."""
    import tempfile

    src = "#include <cstddef>\n#include <cstdio>\n#include <jpeglib.h>\nint main() { jpeg_decompress_struct c; (void)c; }\n"
    with tempfile.TemporaryDirectory() as d:
        try:
            r = subprocess.run(["g++", "-x", "c++", "-", "-ljpeg", "-o", os.path.join(d, "a.out")], input=src,
                               text=True, capture_output=True, timeout=120)
        except OSError:
            return False
    return r.returncode == 0


def phase_cli_diagnostics(counters, card):
    """Phase 6e: `python -m fasterrcnn_torch --train --tiny --synthetic 8
    --memory-stats --profile-dir <tmp> --debug-nans`: the JAX CLI's three
    lines must print, the loop must say it runs uncaptured, and the trace
    must name K1-K3's kernels (the debug run's steps launch them eagerly)."""
    import tempfile

    import torch

    for fn in counters:
        fn.launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_prof_") as tmp:
        prof = os.path.join(tmp, "prof")
        out = run_cli(["--train", "--tiny", "--synthetic", "8", "--batch-size", "4", "--eval-batch-size", "4",
                       "--periodic-eval-samples", "2", "--memory-stats", "--profile-dir", prof, "--debug-nans"])
        torch.cuda.synchronize()
        trace = open(os.path.join(prof, "trace.json")).read()
    lines = [line for line in out.splitlines()
             if line.startswith(("Device memory     :", "Train step memory :", "Wrote profiler trace to",
                                 "Train loop        :"))]
    for line in lines:
        print(f"  cli: {line}", flush=True)
    for prefix in ("Device memory     : cuda:0 in_use=", "Train step memory : canvas=(128, 160) temp=",
                   f"Wrote profiler trace to {prof}", "Train loop        : uncaptured"):
        check(any(line.startswith(prefix) for line in lines), f"CLI diagnostics: no line starting {prefix!r}")
    kernels = {name: trace.count(name) for name in (
        "nms_iou_mask_kernel", "nms_scan_kernel", "roi_pool_taps_kernel", "roi_pool_taps_bwd_kernel")}
    print(f"CLI diagnostics: the trace ({len(trace)} bytes) names {kernels} [{card}]", flush=True)
    check(all(kernels.values()), f"the profiler trace does not name every kernel of K1-K3: {kernels}")
    return path_launches(counters, ("nms_keep_mask", "roi_pool_taps", "roi_pool_taps_bwd"), "CLI diagnostics")


def phase_bench(counters, card):
    """Phase 6e: `fasterrcnn_torch/scripts/bench.py` once, BENCH_TRIALS=1
    BENCH_EPOCH_TRIALS=1: one JSON line with finite, positive rates."""
    from fasterrcnn_torch.scripts import bench

    for fn in counters:
        fn.launches = 0
    env = {"BENCH_TRIALS": "1", "BENCH_EPOCH_TRIALS": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            bench.main()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    lines = buf.getvalue().strip().splitlines()
    check(len(lines) == 1, f"bench printed {len(lines)} lines, expected one")
    record = json.loads(lines[0])
    print(f"bench ({time.perf_counter() - t0:.1f} s): {lines[0]}", flush=True)
    rates = ("value", "train_images_per_sec", "epoch_images_per_sec", "epoch_images_per_sec_cold", "epoch_vs_step",
             "resnet101_images_per_sec", "resnet101_train_images_per_sec")
    check(all(isinstance(record.get(k), (int, float)) and np.isfinite(record[k]) and record[k] > 0 for k in rates),
          f"bench: a rate is missing or not finite: { {k: record.get(k) for k in rates} }")
    launches = path_launches(counters, ("nms_keep_mask", "roi_pool_taps", "roi_pool_taps_bwd"), "bench")
    return record, launches


def phase_stage_isolation(counters, card, b=4, lo=2, hi=4):
    """Phase 6s: the stage-isolation profiles (`scripts/profile_inference.py`,
    `scripts/profile_train.py`, their `profile` on their `setup`) at B=4,
    VGG-16 f32 (TF32 off), LO/HI 2/4: every stage's slope and device busy
    time. Then, on the same setups, each prefix against the whole program:
    stage 2's proposals and stage 3's class logits identical to those inside
    `make_predict_fn`; the train step's loss under no_grad (stage 2), after
    its backward (stage 3) and from `make_train_step` (stage 4) identical to
    `compute_losses`' with autograd on, from the same draws. Then the RoI
    VJP gradient check (`scripts/gradcheck_roi_vjp.py`) at C=512 with its
    two gates. K1 and K2 must launch on the predict stages, K1-K3 on the
    train stages and in the gradient check."""
    import torch
    from fasterrcnn_torch.models.faster_rcnn import compute_losses
    from fasterrcnn_torch.scripts import gradcheck_roi_vjp, profile_inference, profile_train

    t0 = time.perf_counter()
    for fn in counters:
        fn.launches = 0
    flags = ["--batch", str(b), "--lo", str(lo), "--hi", str(hi), "--dtype", "float32"]
    opts = profile_inference.build_parser("PROF_BATCH", b, lo, hi, "").parse_args(flags)
    s = profile_inference.setup(opts)
    rows = {"predict": profile_inference.profile(s, opts)}
    with profile_inference.predict_internals(s.engine.model) as seen:
        profile_inference.stage_predict(s)
    _, props = profile_inference.stage_proposals(s)
    logits, _ = profile_inference.stage_detect(s)
    check(all(torch.equal(got, want) for got, want in zip(props, seen["proposals"])),
          "stage isolation: stage 2's proposals differ from the predict program's")
    check(torch.equal(logits, seen["logits"]), "stage isolation: stage 3's logits differ from the predict program's")
    del s, props, logits, seen
    torch.cuda.empty_cache()
    t = profile_train.setup(opts)
    rows["train"] = profile_train.profile(t, opts)
    t.engine.model.train()
    want = compute_losses(t.engine.model, t.batch, t.grid, draws=t.draws)[0].detach()
    losses = {"no_grad": profile_train.stage_losses(t), "backward": profile_train.stage_backward(t),
              "train_step": profile_train.stage_step(t).total}
    t.restore()
    check(all(torch.equal(v, want) for v in losses.values()),
          f"stage isolation: a train stage's loss differs from compute_losses' {want.item()!r}: "
          f"{ {k: v.item() for k, v in losses.items()} }")
    print(f"stage isolation: prefixes equal the programs' values (proposals, logits, loss {want.item()!r})", flush=True)
    del t
    torch.cuda.empty_cache()
    for kind, table in rows.items():
        for row in table:
            check(np.isfinite(row["slope_ms"]) and row["slope_ms"] > 0, f"stage isolation, {kind}: no slope: {row}")
        print(f"stage isolation {kind} (B={b}, f32, TF32 off): "
              + "; ".join(f"{r['stage']} {r['slope_ms']!r} ms, device busy {r['device_busy_ms']!r}" for r in table)
              + f" [{card}]", flush=True)
    grad = gradcheck_roi_vjp.gradcheck("cuda", c=512)
    check(grad["ok"], f"RoI VJP gradient check failed its gates: {grad}")
    print(f"RoI VJP gradcheck C=512: {json.dumps(grad)} [{card}]", flush=True)
    launches = path_launches(counters, ("nms_keep_mask", "roi_pool_taps", "roi_pool_taps_bwd"), "stage isolation")
    print(f"phase 6s took {time.perf_counter() - t0:.1f} s", flush=True)
    return {"rows": rows, "gradcheck": grad}, launches


def run_cli(args):
    """`python -m fasterrcnn_torch` in this process (`cli.main(args)`),
    its standard output captured; the lines a user reads for the result are
    echoed. An error in the CLI is not caught."""
    from fasterrcnn_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(args)
    out = buf.getvalue()
    for line in out.splitlines():
        if line.startswith(("Epoch", "Mean Average Precision", "Saved", "Wrote", "Loaded")):
            print(f"  cli: {line}", flush=True)
    return out


def printed_maps(out):
    return re.findall(r"Mean Average Precision = ([0-9.]+)%", out)


def write_voc_tree(tmp, trainval=8, test=16):
    """The VOC tree of phases 6c and 6d, from `data/synthetic_voc.py`
    (VOC-like sizes, which land in the 608x800, 800x608 and 608x928
    canvases)."""
    from fasterrcnn_torch.data import synthetic_voc

    return synthetic_voc.generate_voc_dataset(os.path.join(tmp, "VOC2007"), {"trainval": trainval, "test": test},
                                              seed=0)


def phase_eval_cli(counters, card, tmp, root, test=16, timing=256):
    """Phase 6c: the user's loop through the CLI at the default ModelConfig()
    on the VOC tree `root` (`write_voc_tree`), inside the temporary working
    directory `tmp`: --train with every output, --eval --load-from the saved
    weights, --predict-to-file. The CLI's train path must launch K1-K3 and
    its eval path (eval and predict) K1 and K2; then the eval throughput
    over a split of its own (`timing` images, another seed), with the JPEG
    decode in the prefetch thread and on decoded samples."""
    import torch
    from fasterrcnn_torch.config import ModelConfig
    from fasterrcnn_torch.data import synthetic_voc, voc
    from fasterrcnn_torch.engine import Engine

    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        common = ["--dataset-dir", root, "--eval-batch-size", "4"]
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        # --learning-rate 1e-5: at the default 1e-3 the epoch's steps push
        # every foreground score of the seeded random weights below the
        # eval's 0.05 threshold, the mAP is 0.00, and a best-weights file
        # is written only for an mAP above 0 (the reference's rule).
        train_out = run_cli(["--train", "--epochs", "1", "--batch-size", "4", "--learning-rate", "1e-5",
                             "--periodic-eval-samples", "8", "--save-to", "w.pth", "--save-best-to", "b.pth",
                             "--log-csv", "log.csv", "--checkpoint-dir", "ck", *common])
        torch.cuda.synchronize()
        print(f"cli --train: {time.perf_counter() - t0:.1f} s", flush=True)
        train_launches = path_launches(
            counters, ("nms_keep_mask", "roi_pool_taps", "roi_pool_taps_bwd"), "cli train path")
        jpeg = os.path.join(root, "JPEGImages", "test00000.jpg")
        for fn in counters:
            fn.launches = 0
        eval_out = run_cli(["--eval", "--load-from", "w.pth", *common])
        run_cli(["--predict-to-file", jpeg])
        torch.cuda.synchronize()
        eval_launches = path_launches(counters, ("nms_keep_mask", "roi_pool_taps"), "eval path")

        for name in ("w.pth", "b.pth", "log.csv", "ck/1/params.pth", "ck/1/meta.json", "predictions.png"):
            check(os.path.isfile(name), f"cli: {name} was not written")
        train_maps, eval_maps = printed_maps(train_out), printed_maps(eval_out)
        check(len(train_maps) == 2 and len(eval_maps) == 1, f"cli: mAP lines {train_maps} {eval_maps}")
        check(all(0.0 <= float(m) <= 100.0 for m in train_maps + eval_maps), "cli: mAP outside [0, 100]")
        print(f"cli mAP (seeded random weights, {test} test images): periodic eval of 8 {train_maps[0]}%, "
              f"final eval {train_maps[1]}%, --eval --load-from w.pth {eval_maps[0]}%", flush=True)
        check(eval_maps[0] == train_maps[1],
              f"cli: --eval of the saved weights printed {eval_maps[0]}%, the train's final eval {train_maps[1]}%")

        # A ResNet-101 evaluated from a torchvision-layout file, as a
        # user with torchvision's ImageNet weights runs it.
        torch.save(torchvision_resnet_state(np.random.default_rng(12), "resnet101"), "resnet101-tv.pth")
        for fn in counters:
            fn.launches = 0
        resnet_out = run_cli(["--eval", "--backbone", "resnet101", "--load-from", "resnet101-tv.pth", *common])
        torch.cuda.synchronize()
        resnet_launches = path_launches(counters, ("nms_keep_mask", "roi_pool_taps"), "cli resnet101 eval path")
        resnet_maps = printed_maps(resnet_out)
        check("Loaded torchvision ResNet backbone" in resnet_out, "cli resnet101: the torchvision file did not load")
        check(len(resnet_maps) == 1 and 0.0 <= float(resnet_maps[0]) <= 100.0, f"cli resnet101 mAP {resnet_maps}")
        print(f"cli --eval --backbone resnet101 --load-from a torchvision-layout file: mAP {resnet_maps[0]}% "
              f"({test} test images)", flush=True)

        # The saved weights evaluated with exact RoIPool, as a user runs a
        # RoIPool-trained checkpoint.
        for fn in counters:
            fn.launches = 0
        exact_out = run_cli(["--eval", "--custom-roi-pool", "--load-from", "w.pth", *common])
        torch.cuda.synchronize()
        exact_launches = path_launches(counters, ("nms_keep_mask",), "cli --custom-roi-pool eval path",
                                       absent=("roi_pool_taps", "roi_pool_taps_bwd"))
        exact_maps = printed_maps(exact_out)
        check(len(exact_maps) == 1 and 0.0 <= float(exact_maps[0]) <= 100.0, f"cli exact_pool mAP {exact_maps}")
        print(f"cli --eval --custom-roi-pool --load-from w.pth: mAP {exact_maps[0]}% ({test} test images)",
              flush=True)

        engine = Engine(ModelConfig(), seed=1)
        engine.load_weights("w.pth")
        epoch1 = torch.load(os.path.join("ck", "1", "params.pth"), map_location="cpu", weights_only=True)
        state = engine.model.state_dict()
        check(state.keys() == epoch1.keys() and all(torch.equal(state[k].cpu(), epoch1[k]) for k in state),
              "cli: the weights loaded from w.pth differ from the epoch-1 checkpoint")
        print("cli: an engine loaded from w.pth holds the epoch-1 checkpoint's weights bit for bit", flush=True)

        t0 = time.perf_counter()
        synthetic_voc.generate_voc_dataset(root, {"timing": timing}, seed=1)
        print(f"wrote the {timing}-image timing split in {time.perf_counter() - t0:.1f} s", flush=True)
        throughput = eval_throughput(engine, root, card, "timing")
    finally:
        os.chdir(cwd)
    del engine
    torch.cuda.empty_cache()
    return train_launches, eval_launches, resnet_launches, exact_launches, throughput


def block_arrays(samples, k, b, max_gt):
    """k batches of b samples on the 608x800 canvas, stacked as a K-step
    program takes them: images (k, b, 608, 800, 3) uint8, aux (k, b,
    aux_width) f32 and the batches' loss denominators (k,) f32."""
    from fasterrcnn_torch.data.pipeline import make_host_batch
    from fasterrcnn_torch.models.faster_rcnn import pack_aux

    batches = [make_host_batch(samples[i * b:(i + 1) * b], (608, 800), max_gt) for i in range(k)]
    return (np.stack([h.images for h in batches]), np.stack([pack_aux(h, i) for i, h in enumerate(batches)]),
            np.array([h.denominator for h in batches]))


def timed_ms(fn, reps, before=None):
    """Median ms of `fn()` over reps warm calls, each between two device
    synchronizes (`before()` first, outside the time)."""
    import torch

    times = []
    for _ in range(reps):
        if before is not None:
            before()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def kernel_counters():
    """The six kernel wrappers, each with its launch count."""
    from fasterrcnn_torch.ops import conv as conv_ops
    from fasterrcnn_torch.ops import nms as nms_ops
    from fasterrcnn_torch.ops import roi as roi_ops

    return (nms_ops.nms_keep_mask, roi_ops.roi_pool_taps, roi_ops.roi_pool_taps_bwd, roi_ops.roi_pool_fused,
            conv_ops.conv3x3, conv_ops.conv3x3_im2col)


def train_rows(engine, samples, b, k):
    """`Engine.train_epoch` over `samples` at FRCNN_SCAN_STEPS=k: the steps'
    loss rows (k, 4)."""
    import torch
    from fasterrcnn_torch.scripts.reference_train import StepRows

    os.environ["FRCNN_SCAN_STEPS"] = str(k)
    rows = StepRows()
    engine.train_epoch(samples, b, stats=rows)
    torch.cuda.synchronize()
    return np.array(rows.rows)


def state_digest(model) -> str:
    return state_digest_of(model.state_dict())


def split_steps(step, images, aux, dens):
    """The k steps of a block as `DataParallelStep.block` runs them, but
    without the all-reduce: each step's gradient and update programs."""
    for i in range(images.shape[0]):
        step.grad(images[i], aux[i], dens[i])
        step.update()


def dp_rank(mesh, k, b, seed, start, trained, voc_root, out_dir):
    """One rank of phase 6d, in a process of its own (`parallel/mesh.spawn`),
    TF32 off as in every parity phase: `Engine(mesh=...)` of ModelConfig()
    from seed 0; `train_epoch` over the k * b samples of `seed` at
    FRCNN_SCAN_STEPS=k (one block: k replays of the captured gradient
    program, each followed by the all-reduce and a replay of the captured
    update), the launches of every kernel counted from 0; the warm block's
    ms a step, with and without the all-reduces; `Engine.evaluate` of the weights
    file `start` over the split "test" of voc_root; then the teacher-forced
    step: the weights file `trained`, the sampling generator at seed 1, one
    packed step on b samples of seed + 1. Rank 0 writes its parameters
    after the block and after that step into out_dir."""
    import torch
    import torch.distributed as dist
    from fasterrcnn_torch.config import ModelConfig
    from fasterrcnn_torch.data import voc
    from fasterrcnn_torch.data.synthetic import SyntheticDataset
    from fasterrcnn_torch.engine import Engine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = kernel_counters()
    engine = Engine(ModelConfig(), seed=0, mesh=mesh)
    samples = list(SyntheticDataset(num_samples=k * b, seed=seed))
    for fn in counters:
        fn.launches = 0
    out = {"rows": train_rows(engine, samples, b, k),
           "train_launches": {fn.__name__: fn.launches for fn in counters}, "digest": state_digest(engine.model)}

    def save(name):
        if mesh.is_main:
            torch.save({n: t.detach().cpu() for n, t in engine.model.state_dict().items()}, os.path.join(out_dir, name))

    save("dp_block.pth")
    images, aux, dens = block_arrays(samples, k, b, engine.model_cfg.max_gt_boxes)
    images, aux = (torch.as_tensor(mesh.shard_scan_batch(a), device=mesh.device) for a in (images, aux))
    dens = torch.as_tensor(dens, device=mesh.device)
    step = engine.dp_step_for((608, 800))
    barrier = lambda: dist.barrier(group=mesh.group)  # noqa: E731
    out["step_ms"] = timed_ms(lambda: step.block(images, aux, dens), 3, barrier) / k
    out["no_allreduce_ms"] = timed_ms(lambda: split_steps(step, images, aux, dens), 3, barrier) / k
    del images, aux, dens, step
    engine.load_weights(start)
    for fn in counters:
        fn.launches = 0
    with contextlib.redirect_stdout(io.StringIO()):
        out["map"] = engine.evaluate(voc.Dataset("test", dir=voc_root, augment=False, shuffle=False, cache=False),
                                     batch_size=4, progress=False)
    torch.cuda.synchronize()
    out["eval_launches"] = {fn.__name__: fn.launches for fn in counters}
    engine.load_weights(trained)
    engine.generator.manual_seed(1)
    out["forced_rows"] = train_rows(engine, list(SyntheticDataset(num_samples=b, seed=seed + 1)), b, 1)
    out["forced_digest"] = state_digest(engine.model)
    save("dp_forced.pth")
    return out


def update_gap(after, want_after, before, labels):
    """The worst per-tensor relative norm |u - u_want| / |u_want| of the
    updates after - before of the trained tensors, and its tensor; frozen
    tensors must not move."""
    import torch

    worst, worst_name = 0.0, None
    for name, label in labels.items():
        got, want = after[name] - before[name], want_after[name] - before[name]
        if label == "frozen":
            check(not got.any() and not want.any(), f"dp: frozen {name} moved")
            continue
        gap = float(torch.linalg.vector_norm(got - want, dtype=torch.float64)
                    / torch.linalg.vector_norm(want, dtype=torch.float64))
        if gap > worst:
            worst, worst_name = gap, name
    return worst, worst_name


def dp_then_tp_rank(mesh, dp_args, tp_args):
    """The two ranks of phases 6d and 6t in one process group (a spawn
    costs each rank its start, ~20-35 s on a shared card): phase 6d's run
    (`dp_rank`) on dp=2 x tp=1, then the same ranks re-grouped as dp=1 x
    tp=2 (`mesh.regroup`) for phase 6t's (`tp_rank`)."""
    import torch
    from fasterrcnn_torch.parallel import mesh as mesh_lib

    t0 = time.perf_counter()
    dp_out = dp_rank(mesh, *dp_args)
    dp_out["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return dp_out, tp_rank(mesh_lib.regroup(mesh, 2), *tp_args)


def phase_data_parallel(counters, card, voc_root, tp_args, k=8, b=4, seed=7):
    """Phase 6d: data parallelism, two ranks sharing cuda:0 over gloo (NCCL
    refuses two ranks on one card; the phase checks correctness, not
    scaling), against one rank in this process, from the same seeds:
    ModelConfig() at full width, b=4 samples a batch (two rows a rank).

    A whole trajectory on the card is chaotic: two one-rank runs of the
    same k=8 block part by up to 5% in a loss from the second step on (K3's
    float reductions and cuDNN's backward are not deterministic, and a
    label flips; `PERF.md` §6). So, as phase 6e does, the block's
    first step is checked and the rest reported beside a second one-rank
    run, and the update is checked teacher-forced:
      * the k-step block (`dp_rank`): step 0's losses within 1e-4 of the
        one-rank run's, relative (`phase_reference_train`'s loss bound);
        the later steps' losses and the updates of the block reported beside
        a second one-rank run's; the ranks' parameters identical bit for
        bit; each rank launched K1-K3;
      * teacher-forced: every rank and one rank load the one-rank run's
        trained weights, reseed the sampling generator and take one packed
        step on the same batch: losses within 1e-4, relative; each trained
        tensor's update within 3e-3 in relative norm
        (`scripts/reference_train.TOLERANCE`, the card's gradient bound);
        frozen tensors unchanged; the ranks bit for bit alike;
      * `Engine.evaluate` of the seed-0 weights over the VOC tree's split
        "test": each rank launched K1 and K2, and the mAP above 0 and equal
        on both ranks and one rank.
    Prints the backend, the one-rank K-step graph's and the ranks' warm ms
    a step, the ranks' without the all-reduce (the ms it adds), and one
    rank's step split as the ranks run it (the gradient and the update
    programs, no all-reduce). The same two ranks then run phase 6t's
    dp=1 x tp=2 work (`dp_then_tp_rank`, `tp_rank` on `tp_args`), whose
    per-rank results are returned third."""
    import torch
    from fasterrcnn_torch.config import ModelConfig
    from fasterrcnn_torch.data import voc
    from fasterrcnn_torch.data.synthetic import SyntheticDataset
    from fasterrcnn_torch.engine import Engine
    from fasterrcnn_torch.models.faster_rcnn import DataParallelStep
    from fasterrcnn_torch.parallel import mesh as mesh_lib

    required = ("nms_keep_mask", "roi_pool_taps", "roi_pool_taps_bwd")
    samples = list(SyntheticDataset(num_samples=k * b, seed=seed))
    forced_batch = list(SyntheticDataset(num_samples=b, seed=seed + 1))
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        start, trained = os.path.join(tmp, "start.pth"), os.path.join(tmp, "trained.pth")
        runs = []
        for run in range(2):
            engine = Engine(ModelConfig(), seed=0)
            if run == 0:
                engine.save_weights(start)
            for fn in counters:
                fn.launches = 0
            rows = train_rows(engine, samples, b, k)
            runs.append((rows, {n: p.detach().cpu().clone() for n, p in engine.model.named_parameters()}))
            if run == 0:
                launches["dp1_train"] = path_launches(counters, required, "dp=1 train loop")
                engine.save_weights(trained)
                images, aux, dens = (torch.as_tensor(a, device="cuda")
                                     for a in block_arrays(samples, k, b, engine.model_cfg.max_gt_boxes))
                graph_ms = timed_ms(lambda: engine.scan_step_for((608, 800), k)(images, aux), 3) / k
                parts = DataParallelStep(engine.model, engine.optimizer, 608, 800,
                                         mesh_lib.make_mesh(1, devices=["cuda:0"]), generator=engine.generator)
                split_steps(parts, images, aux, dens)  # the captures
                parts_ms = timed_ms(lambda: split_steps(parts, images, aux, dens), 3) / k
                del parts, images, aux, dens
            del engine
            torch.cuda.empty_cache()
        (one_rows, one), (twin_rows, twin) = runs
        engine = Engine(ModelConfig(), seed=0)
        labels = dict(engine.labels)
        engine.load_weights(start)
        for fn in counters:
            fn.launches = 0
        with contextlib.redirect_stdout(io.StringIO()):
            one_map = engine.evaluate(voc.Dataset("test", dir=voc_root, augment=False, shuffle=False, cache=False),
                                      batch_size=4, progress=False)
        torch.cuda.synchronize()
        launches["dp1_eval"] = path_launches(counters, required[:2], "dp=1 eval")
        engine.load_weights(trained)
        before = {n: p.detach().cpu().clone() for n, p in engine.model.named_parameters()}
        engine.generator.manual_seed(1)
        forced_rows = train_rows(engine, forced_batch, b, 1)
        forced = {n: p.detach().cpu().clone() for n, p in engine.model.named_parameters()}
        del engine
        torch.cuda.empty_cache()

        mesh = mesh_lib.make_mesh(2, devices=["cuda:0"] * 2)
        print(f"Device mesh : dp={mesh.dp} x tp={mesh.tp}, backend={mesh.backend} (two ranks on cuda:0)", flush=True)
        t0 = time.perf_counter()
        dp_args = (k, b, seed, start, trained, voc_root, tmp)
        ranks, tp_ranks = zip(*mesh_lib.spawn(dp_then_tp_rank, mesh, args=(dp_args, tp_args), timeout=1200,
                                              collective_timeout=300))
        print(f"dp=2, then dp=1 x tp=2 (phase 6t): the ranks ran in {time.perf_counter() - t0:.1f} s (the dp=2 "
              f"run {ranks[0]['seconds']:.1f} s of it)", flush=True)
        dp_block, dp_forced = (torch.load(os.path.join(tmp, name), weights_only=True)
                               for name in ("dp_block.pth", "dp_forced.pth"))
        initial = torch.load(start, weights_only=True)

    check(mesh.backend == "gloo", f"dp=2 on one card: backend {mesh.backend}")
    for r, out in enumerate(ranks):
        launches[f"dp2_rank{r}_train"] = check_launches(out["train_launches"], required, f"dp=2 rank {r} train loop")
        launches[f"dp2_rank{r}_eval"] = check_launches(out["eval_launches"], required[:2], f"dp=2 rank {r} eval")
    for key in ("digest", "forced_digest"):
        check(ranks[0][key] == ranks[1][key], f"dp=2: the ranks' parameters differ ({key})")
    for key in ("rows", "forced_rows"):
        check(np.array_equal(ranks[0][key], ranks[1][key]), f"dp=2: the ranks' losses differ ({key})")
    rows = ranks[0]["rows"]
    check(rows.shape == one_rows.shape == (k, 4), f"dp=2 loss rows {rows.shape}, dp=1 {one_rows.shape}")

    def rel(a, want):
        return np.abs(a - want) / np.abs(want)

    step0_gap = float(rel(rows[0], one_rows[0]).max())
    forced_gap = float(rel(ranks[0]["forced_rows"], forced_rows).max())
    forced_update, forced_tensor = update_gap(dp_forced, forced, before, labels)
    maps = [out["map"] for out in ranks]
    result = {
        "backend": mesh.backend, "ranks": mesh.dp, "steps": k, "batch": b,
        "dp1_graph_ms_per_step": graph_ms, "dp1_split_ms_per_step": parts_ms,
        "dp2_ms_per_step": [out["step_ms"] for out in ranks],
        "dp2_ms_per_step_without_allreduce": [out["no_allreduce_ms"] for out in ranks],
        "allreduce_extra_ms_per_step": [out["step_ms"] - out["no_allreduce_ms"] for out in ranks],
        "block_step0_loss_gap_rel": step0_gap,
        "block_loss_gap_rel_by_step": rel(rows, one_rows).max(axis=1).tolist(),
        "twin_block_loss_gap_rel_by_step": rel(twin_rows, one_rows).max(axis=1).tolist(),
        "block_update_gap_rel_norm": update_gap(dp_block, one, initial, labels),
        "twin_block_update_gap_rel_norm": update_gap(twin, one, initial, labels),
        "forced_loss_gap_rel": forced_gap, "forced_update_gap_rel_norm": forced_update,
        "forced_update_gap_tensor": forced_tensor, "map_dp1": one_map, "map_dp2": maps,
    }
    print(f"dp=2 against dp=1 ({k}-step block, B={b}): step 0 losses within {step0_gap!r} (relative); later steps "
          f"{result['block_loss_gap_rel_by_step']}, a second dp=1 run {result['twin_block_loss_gap_rel_by_step']}; "
          f"teacher-forced step: losses within {forced_gap!r}, updates within {forced_update!r} (relative norm, "
          f"{forced_tensor}); mAP dp=1 {one_map!r}, dp=2 {maps}; ms a step: dp=1 one graph {graph_ms!r}, dp=1 split "
          f"into gradient and update graphs {parts_ms!r}, dp=2 (two ranks sharing the card) "
          f"{result['dp2_ms_per_step']}, without the all-reduce {result['dp2_ms_per_step_without_allreduce']}: the "
          f"all-reduce adds {result['allreduce_extra_ms_per_step']} [{card}]", flush=True)
    print(json.dumps({"data_parallel": result, "card": card}), flush=True)
    check(step0_gap <= 1e-4, f"dp=2 step 0 losses part from dp=1's by {step0_gap} relative")
    check(forced_gap <= 1e-4, f"dp=2 teacher-forced losses part from dp=1's by {forced_gap} relative")
    check(forced_update <= 3e-3, f"dp=2 teacher-forced updates part from dp=1's by {forced_update} ({forced_tensor})")
    check(one_map > 0.0 and maps == [one_map] * 2, f"dp=2 mAP {maps}, dp=1 {one_map}")
    return result, launches, tp_ranks


# Phase 6t's configurations: name -> ModelConfig keyword arguments. Every
# engine of the phase, the train_all ones too, starts from the seed-0
# weights of its configuration without train_all (`<name>_predict.pth`):
# train_all's init closes every bottleneck's residual branch (bn3's scale
# 0), so layer4's sharded conv1/bn1/conv2 would add nothing to the forward
# pass and get no gradient, and the tp split would go unchecked.
TP_CASES = {"vgg16": {}, "resnet101": {"backbone": "resnet101", "train_all": True}}
# Phase 6t's predict and eval score threshold: every proposal scores, so
# the seeded weights of either configuration give detections and an mAP
# above 0 to compare.
TP_THRESHOLD = 0.0


def tp_config(name, dtype="float32"):
    from fasterrcnn_torch.config import ModelConfig

    return ModelConfig(compute_dtype=dtype, **TP_CASES[name])


def split_digests(state):
    """(digest of the replicated tensors, digest of the tp-sharded ones)."""
    import hashlib

    from fasterrcnn_torch.parallel.mesh import param_spec

    digests = []
    for replicated in (True, False):
        h = hashlib.sha256()
        for name, t in state.items():
            if (param_spec(name) is None) == replicated:
                h.update(name.encode() + t.detach().cpu().contiguous().numpy().tobytes())
        digests.append(h.hexdigest())
    return tuple(digests)


def packed_arrays(samples, b, max_gt, device):
    """One packed step's images, aux and denominator on `device`, from the
    first b samples on the 608x800 canvas."""
    import torch

    images, aux, dens = block_arrays(samples, 1, b, max_gt)
    return tuple(torch.as_tensor(a[0], device=device) for a in (images, aux, dens))


def tp_rank(mesh, names, b, seed, images, image_hw, voc_root, out_dir, timed):
    """One rank of phase 6t, in a process of its own, TF32 off. For each
    configuration of `names` (TP_CASES), `Engine(mesh=...)` with the
    weights `<name>_predict.pth`: step 0, one packed step on the b samples
    of `seed` (K1-K3 counted from 0); the warm packed step's ms with and
    without the tp collectives (when `timed`; the tp all-reduce made a
    no-op for the second, so its numbers are thrown away); the weights
    `<name>_predict.pth` loaded again, then
    `Engine.predict` of `images` in f32 and, on an engine of bf16 compute,
    in bf16, and `Engine.evaluate` over the VOC tree's split "test" (K1, K2
    counted from 0); the teacher-forced step: the weights `<name>_trained.pth`,
    the sampling generator at seed 1, one packed step on b samples of
    seed + 1. Returns the losses, the detections (rank 0), the mAP, the
    launches, the digests of the replicated and the sharded tensors and of
    the gathered state, and whether the gathered state shards back to this
    rank's tensors; rank 0 writes the gathered state after the
    teacher-forced step to `<name>_tp<tp>x<dp>_forced.pth` in out_dir."""
    import torch
    import torch.distributed as dist
    from fasterrcnn_torch.data import voc
    from fasterrcnn_torch.data.synthetic import SyntheticDataset
    from fasterrcnn_torch.engine import Engine
    from fasterrcnn_torch.parallel import mesh as mesh_lib
    from fasterrcnn_torch.parallel import tp as tp_lib

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = kernel_counters()
    samples = list(SyntheticDataset(num_samples=b, seed=seed))
    barrier = lambda: dist.barrier(group=mesh.group)  # noqa: E731
    t0 = time.perf_counter()

    def stage(what):
        if mesh.is_main:
            print(f"  dp={mesh.dp} x tp={mesh.tp} rank 0, {time.perf_counter() - t0:.1f} s: {what}", flush=True)

    results = {}
    for name in names:
        out = results[name] = {}
        engine = Engine(tp_config(name), seed=0, mesh=mesh)
        predict_weights = os.path.join(out_dir, f"{name}_predict.pth")
        engine.load_weights(predict_weights)
        stage(f"{name} engine built")
        for fn in counters:
            fn.launches = 0
        out["step0_rows"] = train_rows(engine, samples, b, 1)
        out["train_launches"] = {fn.__name__: fn.launches for fn in counters}
        stage(f"{name} step 0")
        if timed:
            images_s, aux_s, dens = packed_arrays(samples, b, engine.model_cfg.max_gt_boxes, mesh.device)
            step = engine.dp_step_for((608, 800))
            rows = mesh.rows(b)
            run = lambda: step.packed(images_s[rows], aux_s[rows], dens)  # noqa: E731
            out["step_ms"] = timed_ms(run, 3, barrier)
            real = tp_lib._all_reduce
            tp_lib._all_reduce = lambda t, group: None
            try:
                out["no_tp_collectives_ms"] = timed_ms(run, 3, barrier)
            finally:
                tp_lib._all_reduce = real
            del step, images_s, aux_s, dens
        engine.load_weights(predict_weights)
        det = engine.predict(images, image_hw, score_threshold=TP_THRESHOLD)
        out["detections"] = tuple(t.cpu().numpy() for t in det) if mesh.is_main else None
        for fn in counters:
            fn.launches = 0
        with contextlib.redirect_stdout(io.StringIO()):
            out["map"] = engine.evaluate(voc.Dataset("test", dir=voc_root, augment=False, shuffle=False, cache=False),
                                         batch_size=4, score_threshold=TP_THRESHOLD, progress=False)
        torch.cuda.synchronize()
        out["eval_launches"] = {fn.__name__: fn.launches for fn in counters}
        stage(f"{name} timed, predicted and evaluated")
        engine.load_weights(os.path.join(out_dir, f"{name}_trained.pth"))
        engine.generator.manual_seed(1)
        for fn in counters:
            fn.launches = 0
        out["forced_rows"] = train_rows(engine, list(SyntheticDataset(num_samples=b, seed=seed + 1)), b, 1)
        out["forced_launches"] = {fn.__name__: fn.launches for fn in counters}
        held = engine.model.state_dict()
        full = engine.full_state_dict()
        out["digests"] = split_digests(held)
        out["full_digest"] = state_digest_of(full)
        out["shards_match"] = all(torch.equal(a, held[k]) for k, a in mesh_lib.shard_state_dict(mesh, full).items())
        if mesh.is_main:
            torch.save({n: t.detach().cpu() for n, t in full.items()},
                       os.path.join(out_dir, f"{name}_tp{mesh.tp}x{mesh.dp}_forced.pth"))
        del engine, held, full
        torch.cuda.empty_cache()
        stage(f"{name} teacher-forced step, gathered")
        if mesh.dp == 1:
            engine16 = Engine(tp_config(name, "bfloat16"), seed=0, mesh=mesh)
            engine16.load_weights(predict_weights)
            det16 = engine16.predict(images, image_hw, score_threshold=TP_THRESHOLD)
            out["detections_bf16"] = tuple(t.cpu().numpy() for t in det16) if mesh.is_main else None
            del engine16
            torch.cuda.empty_cache()
            stage(f"{name} bf16 predict")
    return results


def state_digest_of(state) -> str:
    import hashlib

    digest = hashlib.sha256()
    for name, t in state.items():
        digest.update(name.encode() + t.detach().cpu().contiguous().numpy().tobytes())
    return digest.hexdigest()


def detection_gap(got, want):
    """(valid slots that differ, largest score gap over the slots valid in
    both, largest distance of a valid box to the nearest valid box of its
    image and class in `want`, and the slots valid in both) of two (boxes,
    scores, valid) triples. The box gap is printed, not checked: at score
    threshold 0 a class holds hundreds of boxes whose near-tied scores
    trade slots (and so which box of a near-tied pair NMS keeps), so slot
    by slot it reads hundreds of pixels, and the nearest box is a weak
    test."""
    (boxes, scores, valid), (wboxes, wscores, wvalid) = got, want
    both = (valid > 0) & (wvalid > 0)
    box_gap = 0.0
    for i, c in zip(*np.nonzero((valid > 0).any(axis=-1))):
        g, w = boxes[i, c][valid[i, c] > 0], wboxes[i, c][wvalid[i, c] > 0]
        if len(w):
            box_gap = max(box_gap, float(np.abs(g[:, None] - w[None]).max(axis=-1).min(axis=1).max()))
    return (int(((valid > 0) != (wvalid > 0)).sum()), float(np.abs(scores - wscores)[both].max(initial=0.0)),
            box_gap, int(both.sum()))


def tp_references(voc_root, tmp, b=4, seed=7) -> dict:
    """Phase 6t's one-rank side, in this process: for each configuration of
    TP_CASES, the seed-0 weights of its configuration without train_all
    (`<name>_predict.pth`) and the weights after step 0 from them
    (`<name>_trained.pth`) in `tmp`; the mAP, the f32 and bf16 detections
    of phase 5's images, step 0's losses, the packed step's ms and the
    teacher-forced step's losses and parameters. Returns them with the
    ranks' inputs."""
    import torch
    from fasterrcnn_torch.data import voc
    from fasterrcnn_torch.data.synthetic import SyntheticDataset
    from fasterrcnn_torch.engine import Engine

    samples = list(SyntheticDataset(num_samples=b, seed=seed))
    forced_batch = list(SyntheticDataset(num_samples=b, seed=seed + 1))
    images, image_hw = main_path_images(np.random.default_rng(5), MAIN_EXTENTS, (608, 800))
    one = {}
    for name in TP_CASES:
        ref = one[name] = {}
        engine = Engine(tp_config(name), seed=0)
        ref["labels"] = dict(engine.labels)
        predict_weights = os.path.join(tmp, f"{name}_predict.pth")
        if engine.model_cfg.train_all:
            Engine(dataclasses.replace(tp_config(name), train_all=False), seed=0).save_weights(predict_weights)
            torch.cuda.empty_cache()
        else:
            engine.save_weights(predict_weights)
        engine.load_weights(predict_weights)
        with contextlib.redirect_stdout(io.StringIO()):
            ref["map"] = engine.evaluate(voc.Dataset("test", dir=voc_root, augment=False, shuffle=False,
                                                     cache=False), batch_size=4, score_threshold=TP_THRESHOLD,
                                         progress=False)
        ref["detections"] = tuple(t.cpu().numpy()
                                  for t in engine.predict(images, image_hw, score_threshold=TP_THRESHOLD))
        ref["step0_rows"] = train_rows(engine, samples, b, 1)
        trained = os.path.join(tmp, f"{name}_trained.pth")
        engine.save_weights(trained)
        images_s, aux_s, _ = packed_arrays(samples, b, engine.model_cfg.max_gt_boxes, "cuda")
        ref["step_ms"] = timed_ms(lambda: engine.packed_step_for((608, 800))(images_s, aux_s), 3)
        del images_s, aux_s
        engine.load_weights(trained)
        ref["before"] = {n: p.detach().cpu().clone() for n, p in engine.model.named_parameters()}
        engine.generator.manual_seed(1)
        ref["forced_rows"] = train_rows(engine, forced_batch, b, 1)
        ref["forced"] = {n: p.detach().cpu().clone() for n, p in engine.model.named_parameters()}
        del engine
        torch.cuda.empty_cache()
        engine16 = Engine(tp_config(name, "bfloat16"), seed=0)
        engine16.load_weights(predict_weights)
        ref["detections_bf16"] = tuple(t.cpu().numpy()
                                       for t in engine16.predict(images, image_hw, score_threshold=TP_THRESHOLD))
        del engine16
        torch.cuda.empty_cache()
    return dict(one=one, images=images, image_hw=image_hw, voc_root=voc_root, tmp=tmp, b=b, seed=seed)


def tp_rank_args(ref, names, timed):
    """The arguments of `tp_rank` after its mesh."""
    return (names, ref["b"], ref["seed"], ref["images"], ref["image_hw"], ref["voc_root"], ref["tmp"], timed)


def phase_tensor_parallel(card, refs, pair_ranks):
    """Phase 6t: tensor parallelism, ranks sharing cuda:0 over gloo (NCCL
    refuses two ranks on one card; the phase checks correctness, not
    scaling), against one rank in this process from the same seeds, f32
    with TF32 off, B=4 on the 608x800 canvas:
      * dp=1 x tp=2 (two ranks), ModelConfig() (VGG-16) and ResNet-101 in
        from-scratch mode (train_all): step 0's losses within 1e-4 of one
        rank's, relative; a teacher-forced step (the one-rank run's weights
        after its step 0, the sampling generator at seed 1, a packed step on
        another batch): losses within 1e-4, each trained tensor's update
        within 3e-3 in relative norm, as phase 6d, and the tp-sharded
        tensors' (VGG-16's fc pair, layer4's conv1/bn1/conv2) reported
        apart, each moved by the step; the replicated tensors
        identical bit for bit on both ranks, the gathered states equal, and
        each rank's tensors the shards of the gathered state;
        `Engine.predict` of phase 5's images (score threshold 0, so that
        either model's seeded weights give detections): the same valid
        slots as one rank's and scores within 1e-4, the largest score and
        box gaps printed (the box gap not checked: `detection_gap`);
        `Engine.evaluate` of the seed-0 weights over phase 6c's VOC tree:
        the mAP equal on both ranks and on one rank; a bf16 predict, its gap
        to one rank's bf16 predict printed; the packed step's warm ms with
        and without the tp collectives (every engine of the phase starts
        from its configuration's seed-0 weights without train_all:
        TP_CASES);
      * dp=2 x tp=2 (four ranks), VGG-16: the teacher-forced step and the
        mAP as above, the four ranks' replicated tensors alike;
      * every rank launched K1-K3 in its steps and K1 and K2 in its eval.
    `refs` is `tp_references`' one-rank side; the dp=1 x tp=2 ranks ran on
    phase 6d's two processes (`dp_then_tp_rank`), `pair_ranks` their
    results; the four ranks are spawned here.
    """
    import torch
    from fasterrcnn_torch.parallel import mesh as mesh_lib
    from fasterrcnn_torch.parallel.mesh import param_spec

    required = ("nms_keep_mask", "roi_pool_taps", "roi_pool_taps_bwd")
    one, tmp, b = refs["one"], refs["tmp"], refs["b"]
    launches, result = {}, {}
    mesh4 = mesh_lib.make_mesh(4, tp=2, devices=["cuda:0"] * 4)
    print(f"Device mesh : dp={mesh4.dp} x tp={mesh4.tp}, backend={mesh4.backend} ({mesh4.size} ranks on cuda:0)",
          flush=True)
    t0 = time.perf_counter()
    ranks4 = mesh_lib.spawn(tp_rank, mesh4, args=tp_rank_args(refs, ("vgg16",), False), timeout=900,
                            collective_timeout=300)
    print(f"dp=2 x tp=2: the ranks ran in {time.perf_counter() - t0:.1f} s", flush=True)
    runs = {(1, 2): (mesh_lib.make_mesh(2, tp=2, devices=["cuda:0"] * 2), tuple(TP_CASES), pair_ranks),
            (2, 2): (mesh4, ("vgg16",), ranks4)}
    for (dp, tp), (mesh, names, ranks) in runs.items():
        check(mesh.backend == "gloo", f"tp on one card: backend {mesh.backend}")
        for name in names:
            want, tag = one[name], f"dp{dp}xtp{tp}_{name}"
            outs = [r[name] for r in ranks]
            forced = torch.load(os.path.join(tmp, f"{name}_tp{tp}x{dp}_forced.pth"), weights_only=True)
            for r, out in enumerate(outs):
                launches[f"{tag}_rank{r}_train"] = check_launches(
                    {k: out["train_launches"][k] + out["forced_launches"][k] for k in out["train_launches"]},
                    required, f"{tag} rank {r} train steps")
                launches[f"{tag}_rank{r}_eval"] = check_launches(out["eval_launches"], required[:2],
                                                                 f"{tag} rank {r} eval")
            check(len({out["digests"][0] for out in outs}) == 1, f"{tag}: the replicated tensors differ")
            check(len({out["digests"][1] for out in outs[:tp]}) == tp, f"{tag}: the ranks' shards are alike")
            check(len({out["full_digest"] for out in outs}) == 1 and outs[0]["full_digest"] == state_digest_of(
                forced), f"{tag}: the gathered states differ")
            check(all(out["shards_match"] for out in outs), f"{tag}: a rank's tensors are not its shards")
            check(all(np.array_equal(out["forced_rows"], outs[0]["forced_rows"]) for out in outs),
                  f"{tag}: the ranks' losses differ")

            def rel(a, want):
                return float((np.abs(a - want) / np.abs(want)).max())

            forced_update, forced_tensor = update_gap(forced, want["forced"], want["before"], want["labels"])
            sharded = {n: label for n, label in want["labels"].items() if param_spec(n) is not None}
            sharded_update, sharded_tensor = update_gap(forced, want["forced"], want["before"], sharded)
            sharded_moved = all((want["forced"][n] - want["before"][n]).any() for n in sharded)
            res = result[tag] = {
                "ranks": mesh.size, "backend": mesh.backend, "batch": b,
                "forced_loss_gap_rel": rel(outs[0]["forced_rows"], want["forced_rows"]),
                "forced_update_gap_rel_norm": forced_update, "forced_update_gap_tensor": forced_tensor,
                "forced_sharded_update_gap_rel_norm": sharded_update, "forced_sharded_update_gap_tensor": sharded_tensor,
                "map_one_rank": want["map"], "map_ranks": [out["map"] for out in outs],
                "step0_loss_gap_rel": rel(outs[0]["step0_rows"], want["step0_rows"]),
            }
            if dp == 1:
                gap = detection_gap(outs[0]["detections"], want["detections"])
                gap16 = detection_gap(outs[0]["detections_bf16"], want["detections_bf16"])
                res.update({
                    "predict_f32_gap": dict(zip(("valid_slots_differ", "max_score_gap", "max_box_gap_px",
                                                 "slots_compared"), gap)),
                    "predict_bf16_gap": dict(zip(("valid_slots_differ", "max_score_gap", "max_box_gap_px",
                                                  "slots_compared"), gap16)),
                    "one_rank_step_ms": want["step_ms"], "step_ms": [out["step_ms"] for out in outs],
                    "step_ms_without_tp_collectives": [out["no_tp_collectives_ms"] for out in outs],
                    "tp_collectives_ms": [out["step_ms"] - out["no_tp_collectives_ms"] for out in outs],
                })
            print(f"{tag} against one rank (B={b}): {json.dumps(res)} [{card}]", flush=True)
            check(res["step0_loss_gap_rel"] <= 1e-4, f"{tag}: step 0 losses part by {res['step0_loss_gap_rel']}")
            check(res["forced_loss_gap_rel"] <= 1e-4,
                  f"{tag}: teacher-forced losses part by {res['forced_loss_gap_rel']}")
            check(forced_update <= 3e-3, f"{tag}: teacher-forced updates part by {forced_update} ({forced_tensor})")
            check(len(sharded) == (3 if name == "vgg16" else 12) and sharded_moved and sharded_update <= 3e-3,
                  f"{tag}: teacher-forced updates of the {len(sharded)} tp-sharded tensors part by {sharded_update} "
                  f"({sharded_tensor})")
            check(want["map"] > 0.0 and res["map_ranks"] == [want["map"]] * mesh.size,
                  f"{tag}: mAP {res['map_ranks']}, one rank {want['map']}")
            if dp == 1:
                check(gap[0] == 0 and gap[3] > 0 and gap[1] <= 1e-4,
                      f"{tag}: f32 predict parts from one rank's: {res['predict_f32_gap']}")
    print(json.dumps({"tensor_parallel": result, "card": card}), flush=True)
    return result, launches


def eval_throughput(engine, root, card, split_name, batch_size=4, reps=3):
    """Warm Engine.evaluate over a VOC split: fed by the reader (the JPEG
    decode and resize in the prefetch thread, inside the time) and fed a
    list of already-decoded samples. The difference is the host's decode
    cost. f32 with cuDNN TF32 off and on; one warm-up pass over the split
    for each (it meets every canvas the split holds)."""
    import torch
    from fasterrcnn_torch.config import select_canvas
    from fasterrcnn_torch.data import native_loader, voc

    native, libjpeg = native_loader.available(), libjpeg_present()
    print(f"the reader's JPEG decoder: {'native (data/native_loader, libjpeg)' if native else 'PIL'}; "
          f"libjpeg on this machine: {libjpeg}", flush=True)
    check(native or not libjpeg, "libjpeg is present but the native reader did not build")

    def split():
        return voc.Dataset(split_name, dir=root, augment=False, shuffle=False, cache=False)

    t0 = time.perf_counter()
    decoded = list(split())
    for sample in decoded:  # deferred samples (the native reader's batch decode) decode here
        sample.materialize()
    read_s = time.perf_counter() - t0
    n = len(decoded)
    out = {"images": n, "batch_size": batch_size, "decoder": "native" if native else "PIL", "canvases": dict(collections.Counter(
        "x".join(map(str, select_canvas(*s.image_hw))) for s in decoded)),
        "reader_alone_ms_per_image": 1e3 * read_s / n}
    print(f"the reader alone (parse, JPEG decode, resize; one thread, no device work): {n} images in "
          f"{read_s!r} s, {1e3 * read_s / n!r} ms an image; canvases {out['canvases']}", flush=True)
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        with contextlib.redirect_stdout(io.StringIO()):  # each call prints its mAP
            engine.evaluate(decoded, batch_size=batch_size, progress=False)
        for label, source in (("decode", split), ("decoded", lambda: decoded)):
            times = []
            with contextlib.redirect_stdout(io.StringIO()):
                for _ in range(reps):
                    src = source()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    engine.evaluate(src, batch_size=batch_size, progress=False)
                    times.append(time.perf_counter() - t0)
            med = statistics.median(times)
            key = f"{label}_{'tf32_on' if tf32 else 'tf32_off'}"
            out[key] = {"median_s": med, "min_s": min(times), "max_s": max(times), "img_per_s": n / med}
            print(f"Engine.evaluate f32 (cuDNN TF32 {'on' if tf32 else 'off'}), "
                  f"{'JPEG decode in the prefetch thread' if label == 'decode' else 'already-decoded samples'}: "
                  f"{n} images at batch {batch_size}, median {med!r} s over {reps} (min {min(times)!r}, "
                  f"max {max(times)!r}), {n / med!r} img/s [{card}]", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    for tf32 in ("tf32_off", "tf32_on"):
        a, b = out[f"decode_{tf32}"]["median_s"], out[f"decoded_{tf32}"]["median_s"]
        out[f"decode_cost_ms_per_image_{tf32}"] = 1e3 * (a - b) / n
    print(json.dumps({"eval_timing": out, "card": card}), flush=True)
    return out


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


def phase_profile(calls, card, reps=3):
    """Device time by layer over warm calls of each entry of `calls` (label
    -> function; torch.profiler, TF32 off), the device's idle share and the
    kernel launches per call (`utils/profiling.device_profile`)."""
    from fasterrcnn_torch.utils.profiling import device_profile

    out = {}
    for label, fn in calls.items():
        out[label] = device_profile(fn, reps)
        print(f"profile {label}: {json.dumps(out[label])} [{card}]", flush=True)
    return out


def main() -> None:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "fasterrcnn_torch")):
        fail(f"no fasterrcnn_torch package beside {__file__}")
    sys.path.insert(0, root)
    from fasterrcnn_torch.config import ModelConfig
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

    counters = kernel_counters()
    rng = np.random.default_rng(0)
    for fn in counters:
        fn.launches = 0
    parity = phase_kernel_parity(dev, rng)
    torch.cuda.synchronize()
    parity_launches = {fn.__name__: fn.launches for fn in counters}
    phase_reference(dev, rng)
    phase_reference_train(dev)
    # ResNet-50 at the tiny config, on generators of its own: the phases
    # after it draw what they drew before it.
    phase_reference(dev, np.random.default_rng(7), backbone="resnet50")
    phase_reference_train(dev, backbone="resnet50", train_all=True)
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

    # ResNet-101 at full width: predict (frozen mode), K2 and K3 on its own
    # C=1024 map, timing and profile; then the from-scratch train path.
    r_engine, r_engine16, r_images, r_hw, r_launches = phase_main_path(
        dev, np.random.default_rng(11), counters, cfg=ModelConfig(backbone="resnet101"), label="resnet101 predict path")
    r_parity = path_roi_parity(r_engine, r_engine16, r_images, r_hw)
    r_timing = phase_timing(r_engine, r_engine16, r_images, r_hw, card)
    print(json.dumps({"resnet101_predict_timing": r_timing, "card": card}), flush=True)
    phase_profile({
        "resnet101 predict f32": lambda: r_engine.predict(r_images, r_hw),
        "resnet101 predict bf16": lambda: r_engine16.predict(r_images, r_hw),
    }, card)
    del r_engine, r_engine16
    torch.cuda.empty_cache()
    rt_engine, rt_engine16, r_batch, r_train_launches = phase_main_path_train(
        counters, cfg=ModelConfig(backbone="resnet101", train_all=True), label="resnet101 train path")
    r_train_timing = phase_timing_train(rt_engine, rt_engine16, r_batch, card)
    print(json.dumps({"resnet101_train_timing": r_train_timing, "card": card}), flush=True)
    phase_profile({
        "resnet101 train f32": lambda: rt_engine.train_step(r_batch),
        "resnet101 train bf16": lambda: rt_engine16.train_step(r_batch),
    }, card)
    del rt_engine, rt_engine16
    torch.cuda.empty_cache()
    _, stage_launches = phase_stage_isolation(counters, card)
    other_launches = {f"{name}_predict": phase_predict_only(counters, name, r_images, r_hw)
                      for name in ("resnet50", "resnet152")}

    # Exact RoIPool at full width on phase 5's images and phase 6's batch,
    # beside this run's crop paths; then the overfit proxy.
    crop = {"vgg16": {"predict": timing, "train": train_timing},
            "resnet101": {"predict": r_timing, "train": r_train_timing}}
    _, exact_launches = phase_exact_pool(dev, counters, card, images, image_hw, crop)
    _, overfit_launches = phase_overfit(counters, card)

    # Phase 6e: the train loop as the JAX package runs it (captured programs),
    # its diagnostics through the CLI, and the bench entry.
    phase_graph_vs_eager(card)
    loop, loop_launches = phase_train_loop(counters, card)
    cli_diag_launches = phase_cli_diagnostics(counters, card)
    _, bench_launches = phase_bench(counters, card)

    _, conv_launches = phase_conv_ab(counters, card)
    # Phases 6c and 6d on one VOC tree in a temporary directory.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_voc_") as tmp:
        root = write_voc_tree(tmp)
        cli_train_launches, eval_launches, cli_resnet_launches, cli_exact_launches, _ = phase_eval_cli(
            counters, card, tmp, root)
        # Phase 6t's dp=1 x tp=2 runs on phase 6d's two ranks, after theirs.
        tp_ref = tp_references(root, tmp)
        _, dp_launches, pair_ranks = phase_data_parallel(counters, card, root,
                                                         tp_rank_args(tp_ref, tuple(TP_CASES), True))
        _, tp_launches = phase_tensor_parallel(card, tp_ref, pair_ranks)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    paths = {"predict": launches, "train": train_launches, "fused_roi_op": fused_launches,
             "conv_ab": conv_launches, "cli_train": cli_train_launches, "eval": eval_launches,
             "resnet101_predict": r_launches, "resnet101_train": r_train_launches, **other_launches,
             "cli_resnet101_eval": cli_resnet_launches, **exact_launches, **overfit_launches,
             "cli_exact_pool_eval": cli_exact_launches, **loop_launches, "cli_diagnostics": cli_diag_launches,
             "bench": bench_launches, **dp_launches, **tp_launches, "stage_isolation": stage_launches,
             "parity": parity_launches}

    def by_path(name):
        return {path: counts[name] for path, counts in paths.items()}

    def in_graphs(name):
        """Launches one replay of each train loop path's K-step graph holds,
        and its replays (the path's count above is their product, plus the
        warm-up's eager launches and the residues')."""
        return {tag: {"per_replay": r["capture_launches"][name], "replays": r["replays"]} for tag, r in loop.items()}

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
            "train_loop_graphs": in_graphs("nms_keep_mask"),
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
            "train_loop_graphs": in_graphs("roi_pool_taps"),
            "ldg128_instructions": vector_loads["roi_pool_taps"],
            "bf16": parity["roi_bf16"],
            **{k: v for k, v in parity.items() if k.endswith(("_roi_pool_taps_f32", "_roi_pool_taps_bf16"))},
            "resnet101_path": {tag: r_parity[f"roi_pool_taps_{tag}"] for tag in ("f32", "bf16")},
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
            "train_loop_graphs": in_graphs("roi_pool_taps_bwd"),
            "vector_reduction_instructions": vector_reductions,
            **{k: parity[k] for k in ("roi_bwd_bf16", "roi_bwd_f32_relu", "roi_bwd_bf16_relu")},
            **{k: v for k, v in parity.items() if k.endswith(("_roi_pool_taps_bwd_f32", "_roi_pool_taps_bwd_bf16"))},
            "resnet101_path": {tag: r_parity[f"roi_pool_taps_bwd_{tag}"] for tag in ("f32", "bf16")},
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
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
