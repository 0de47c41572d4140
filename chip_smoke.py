#!/usr/bin/env python3
"""Drive the PyTorch port (`fasterrcnn_torch`) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):
  1. card: require CUDA; print the card's name and power limit.
  2. build: compile every CUDA kernel of the predict and train paths from
     the sources in the checkout (one nvcc per source, in parallel).
  3. kernel parity: each kernel against its plain PyTorch version on the
     card, at the main paths' shapes: NMS keep-masks identical at the
     predict RPN shape (4 x 6000 -> 300), the per-class shape (80 x 300)
     and the train RPN shape (4 x 12000 -> 2000); RoI crop+pool on a
     (4, 38, 50, 512) map x 300 RoIs identical in f32 and in bf16 (both
     round each tap product and each two-tap sum once, and the bf16 rows
     before the x-taps, so no value may differ); the RoI backward on the
     same map x 128 RoIs (the train shape), normal and ReLU'd, f32 and
     bf16, within the tolerance of `backward_close`; a CUDA feature map
     that requires grad gets a grad_fn from roi_pool_taps and its backward
     launches the backward kernel. Beside them, the library convolution
     the unported conv kernels would replace is timed.
  4. reference: the tiny config (full-width VGG-16, 128x160 canvas) on the
     card against the same model on the CPU (plain versions), stage by stage
     on identical inputs, then the whole predict; then one train step's
     losses and gradients, with the same weights and the same draws.
  5. main path, predict: the default ModelConfig (VGG-16, 21 classes, caps
     6000 -> 300) at full width through Engine, on a 608x800 canvas, B=4,
     seeded random weights and images: predict at score thresholds 0.05 and
     0.0, one predict_image, and one bf16 predict; the kernels' launch
     counts must rise. TF32 is off for every parity phase.
  6. main path, train: the default ModelConfig at full width through
     Engine.train_step and Engine.train_epoch, B=4 synthetic 600x800
     samples on the 608x800 canvas: the f32 loss must fall over 10 steps on
     one batch, with all four losses positive at the first step; two steps
     of train_epoch; bf16 train steps; all three kernels must launch.
  7. timing: Engine.predict and Engine.train_step on the host's batch, ms
     per batch and img/s (f32 with TF32 off, f32 with cuDNN TF32 on, bf16),
     and the peak memory of the f32 call. Each kernel's time, with CUDA
     events beside its plain version's and its bound, is taken in phase 3.
  8. profile: torch.profiler over warm Engine.predict calls and warm
     Engine.train_step calls, f32 and bf16 with TF32 off: device time by
     layer, idle share, device ops per call.
Then, on the last lines: the card line, one JSON line of the kernels, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores


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


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm call."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sorted_boxes(rng, n, k, img_h, img_w):
    """(n, k, 4) boxes in descending-score order, spread over an image."""
    cy = rng.uniform(0, img_h, (n, k))
    cx = rng.uniform(0, img_w, (n, k))
    h = rng.uniform(16, 300, (n, k))
    w = rng.uniform(16, 300, (n, k))
    return np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1).astype(np.float32)


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


def roi_inside_samples(rois, norm, h: int, w: int) -> int:
    """Bilinear samples, of the 14x14 per RoI, that fall inside the map."""
    import torch

    steps = torch.tensor([s / 13 for s in range(14)], dtype=torch.float32, device=rois.device)
    r = rois * norm[:, (0, 1, 0, 1)][:, None, :]
    ys = r[..., 0:1] + (r[..., 2:3] - r[..., 0:1]) * steps
    xs = r[..., 1:2] + (r[..., 3:4] - r[..., 1:2]) * steps
    in_y = ((ys >= 0) & (ys <= h - 1)).sum(-1)
    in_x = ((xs >= 0) & (xs <= w - 1)).sum(-1)
    return int((in_y * in_x).sum().item())


def phase_kernel_parity(dev, rng):
    import torch
    from fasterrcnn_torch.ops import nms as nms_ops
    from fasterrcnn_torch.ops import roi as roi_ops

    results = {}
    for label, n, k, thr, max_keep in (
        ("rpn", 4, 6000, 0.7, 300), ("per_class", 80, 300, 0.3, 300), ("train", 4, 12000, 0.7, 2000)
    ):
        boxes = torch.from_numpy(sorted_boxes(rng, n, k, 600.0, 800.0)).to(dev)
        valid = torch.from_numpy(rng.uniform(size=(n, k)) > 0.1).to(dev)
        got = nms_ops.nms_keep_mask(boxes, valid, thr, max_keep)
        want = nms_ops.nms_keep_mask_plain(boxes, valid, thr, max_keep)
        torch.cuda.synchronize()
        mismatches = int((got != want).sum().item())
        print(f"nms_keep_mask {label} ({n}x{k}, thr {thr}, keep {max_keep}): "
              f"{int(got.sum())} accepts, {mismatches} mask mismatches", flush=True)
        check(mismatches == 0, f"nms_keep_mask {label}: {mismatches} keep-mask entries differ")
        ms = cuda_ms(lambda: nms_ops.nms_keep_mask(boxes, valid, thr, max_keep), 20)
        plain_ms = cuda_ms(lambda: nms_ops.nms_keep_mask_plain(boxes, valid, thr, max_keep), 2)
        bytes_moved = n * k * (16 + 1 + 1)
        tests = nms_iou_tests(boxes, valid, got, thr)
        ops = NMS_OPS_PER_TEST * tests + 3 * int(valid.sum().item())
        print(f"  {tests} IoU tests, {ops} f32 operations", flush=True)
        results[label] = dict(
            max_abs_err=float(mismatches), ms=ms, plain_ms=plain_ms,
            bound_ms=1e3 * max(bytes_moved / HBM_BYTES_PER_S, ops / F32_FLOPS),
            bound_by="bytes" if bytes_moved / HBM_BYTES_PER_S >= ops / F32_FLOPS else "operations",
            accepts=int(got.sum()), iou_tests=tests, shape=[n, k],
        )

    b, h, w, c, p = 4, 38, 50, 512, 300
    img_h, img_w = 600.0, 800.0  # real grid 37 x 50 of the 38 x 50 canvas map
    fm32 = torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(np.float32)).to(dev)
    y1 = rng.uniform(-20, img_h * 0.8, (b, p))
    x1 = rng.uniform(-20, img_w * 0.8, (b, p))
    rois_np = np.stack(
        [y1, x1, y1 + rng.uniform(16, img_h * 0.5, (b, p)), x1 + rng.uniform(16, img_w * 0.5, (b, p))], -1
    )
    rois = torch.from_numpy(rois_np.astype(np.float32)).to(dev)
    norm = torch.tensor([[(37 - 1) / img_h, (50 - 1) / img_w]] * b, device=dev)
    # Each sample inside the map: 2 rows of 2 y-taps and 2 x-taps, 3
    # operations a tap pair; then 3 maxes per output.
    ops = c * (9 * roi_inside_samples(rois, norm, h, w) + 3 * b * p * 49)
    for dtype in (torch.float32, torch.bfloat16):
        fm = fm32.to(dtype)
        got = roi_ops.roi_pool_taps(fm, rois, norm)
        want = roi_ops.roi_pool_features(fm, rois, norm)
        torch.cuda.synchronize()
        check(got.dtype == dtype and got.shape == (b, p, 7, 7, c), f"roi_pool_taps {dtype}: {got.dtype} {tuple(got.shape)}")
        err = float((got.float() - want.float()).abs().max().item())
        mismatches = int((got != want).sum().item())
        print(f"roi_pool_taps {dtype} ({b}x{h}x{w}x{c}, {p} RoIs): max_abs_err {err!r}, "
              f"{mismatches} of {got.numel()} values differ (tolerance: identical)", flush=True)
        check(mismatches == 0, f"roi_pool_taps {dtype}: {mismatches} values differ, max_abs_err {err}")
        ms = cuda_ms(lambda: roi_ops.roi_pool_taps(fm, rois, norm), 20)
        plain_ms = cuda_ms(lambda: roi_ops.roi_pool_features(fm, rois, norm), 3)
        item = fm.element_size()
        bytes_moved = b * h * w * c * item + b * p * 4 * 4 + b * 2 * 4 + b * p * 49 * c * item
        results[f"roi_{'f32' if dtype == torch.float32 else 'bf16'}"] = dict(
            max_abs_err=err, mismatches=mismatches, ms=ms, plain_ms=plain_ms,
            bound_ms=1e3 * max(bytes_moved / HBM_BYTES_PER_S, ops / F32_FLOPS),
            bound_by="bytes" if bytes_moved / HBM_BYTES_PER_S >= ops / F32_FLOPS else "operations",
            shape=[b, h, w, c, p],
        )
    results.update(roi_backward_parity(dev, rng, fm32, img_h, img_w))
    check_grad_fn(dev, rng)
    results["library_conv"] = library_conv_times(dev)
    return results


def backward_close(got, want):
    """K3's tolerance: the kernel makes the plain version's argmax and tie
    decisions (both recompute the forward's samples bit for bit) but adds
    into the map with atomics, in an order that changes from run to run,
    and multiplies each share by its x- and y-weight before adding, where
    the plain version sums the x-taps first. So each value may differ by
    1e-5 of the largest; in bf16, after the one cast at the end, also by one
    bf16 step (2^-7 of the value). Returns (ok, max abs err)."""
    import torch

    rtol = 2.0**-7 if want.dtype == torch.bfloat16 else 0.0
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool((err <= 1e-5 * want.abs().max() + rtol * want.abs()).all())
    return ok, float(err.max())


def roi_tie_counts(fm, rois, norm):
    """(inside samples, tied inside sample values, outputs) of the RoI
    backward on these inputs: the work its bound counts."""
    import torch
    from fasterrcnn_torch.ops import roi as roi_ops

    b, h, w, c = fm.shape
    p = rois.shape[1]
    ys, xs = roi_ops._sample_positions(rois, norm)
    in_y = (ys >= 0) & (ys <= h - 1)
    in_x = (xs >= 0) & (xs <= w - 1)
    inside = in_y[..., :, None] & in_x[..., None, :]  # (B, P, 14, 14)
    window = roi_ops.crop_and_resize(fm, rois, norm).reshape(b, p, 7, 2, 7, 2, c)
    tied = (window == window.amax(dim=(3, 5), keepdim=True)).reshape(b, p, 14, 14, c)
    return (
        int(inside.sum().item()) * c,
        int((tied & inside[..., None]).sum().item()),
        b * p * 49 * c,
    )


def roi_backward_parity(dev, rng, fm32, img_h, img_w):
    """K3 against its plain version at the train shape: 128 RoIs an image."""
    import torch
    from fasterrcnn_torch.ops import roi as roi_ops

    b, h, w, c = fm32.shape
    p = 128
    y1 = rng.uniform(-20, img_h * 0.8, (b, p))
    x1 = rng.uniform(-20, img_w * 0.8, (b, p))
    rois_np = np.stack(
        [y1, x1, y1 + rng.uniform(16, img_h * 0.5, (b, p)), x1 + rng.uniform(16, img_w * 0.5, (b, p))], -1
    )
    rois = torch.from_numpy(rois_np.astype(np.float32)).to(dev)
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
            ok, err = backward_close(got, want)
            label = f"roi_bwd_{'f32' if dtype == torch.float32 else 'bf16'}{'_relu' if relu else ''}"
            print(f"roi_pool_taps_bwd {label} ({b}x{h}x{w}x{c}, {p} RoIs): max_abs_err {err!r} "
                  f"(max |plain| {float(want.float().abs().max())!r}; tolerance 1e-5 of it"
                  f"{' + 2^-7 of each value' if dtype == torch.bfloat16 else ''})", flush=True)
            check(ok, f"roi_pool_taps_bwd {label}: outside tolerance, max_abs_err {err}")
            ms = cuda_ms(lambda: roi_ops.roi_pool_taps_bwd(fm, rois, norm, g), 20)
            plain_ms = cuda_ms(lambda: roi_ops.roi_pool_taps_bwd_plain(fm, rois, norm, g), 3)
            item = fm.element_size()
            inside, tied, outputs = roi_tie_counts(fm, rois, norm)
            # Recompute: 9 operations a sample inside the map and 3 maxes an
            # output; ties: 4 comparisons, 3 adds and a division an output;
            # each tied sample inside: 2 x-weight and 4 y-weight products and
            # 4 adds.
            ops = 9 * inside + 11 * outputs + 10 * tied
            # Inputs read once (map, cotangent, RoIs, norm), output written once.
            bytes_moved = 2 * b * h * w * c * item + outputs * item + b * p * 16 + b * 8
            # The kernel's own floor: it also zeroes and writes an f32 map,
            # and a bf16 result is cast from it.
            accumulator_bytes = 2 * b * h * w * c * 4 + (b * h * w * c * 4 if dtype == torch.bfloat16 else 0)
            results[label] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=1e3 * max(bytes_moved / HBM_BYTES_PER_S, ops / F32_FLOPS),
                bound_by="bytes" if bytes_moved / HBM_BYTES_PER_S >= ops / F32_FLOPS else "operations",
                bound_with_f32_accumulator_ms=1e3 * (bytes_moved + accumulator_bytes) / HBM_BYTES_PER_S,
                tied_inside_samples=tied, shape=[b, h, w, c, p],
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


def library_conv_times(dev):
    """Time of the library call the unported conv kernels (K5, K6) compute:
    3x3 SAME conv + bias (cuDNN) + ReLU, NHWC (channels_last), at the block-5
    shape (K5) and the block-2 shape (K6), f32 (TF32 off) and bf16."""
    import torch
    import torch.nn.functional as F

    out = {}
    for label, (b, h, w, c) in (("block5", (4, 38, 50, 512)), ("block2", (4, 304, 400, 128))):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(b, c, h, w, device=dev, dtype=dtype).to(memory_format=torch.channels_last)
            wt = (torch.randn(c, c, 3, 3, device=dev, dtype=dtype) * 0.02).to(memory_format=torch.channels_last)
            bias = torch.zeros(c, device=dev, dtype=dtype)
            ms = cuda_ms(lambda: F.relu(F.conv2d(x, wt, bias, padding=1)), 20)
            key = f"{label}_{'f32' if dtype == torch.float32 else 'bf16'}"
            out[key] = {"ms": ms, "shape": [b, h, w, c, c], "gflop": 2 * b * h * w * c * c * 9 / 1e9}
            print(f"library conv3x3+bias+relu {key} (B,H,W,Cin,Cout)={out[key]['shape']}: {ms!r} ms", flush=True)
    return out


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


def every_box_config():
    """The tiny config with every anchor a proposal (no NMS suppression, no
    size filter, caps above the 720 anchors of the 128x160 canvas) and every
    anchor and proposal sampled: the boxes a step trains on then do not
    depend on near-tied scores, which the card and the CPU may order
    differently in the last bits."""
    from fasterrcnn_torch.config import AnchorConfig, DetectorConfig, ModelConfig, RPNConfig

    return ModelConfig(
        anchors=AnchorConfig(areas=(24.0 * 24, 48.0 * 48, 96.0 * 96)),
        rpn=RPNConfig(pre_nms_train=720, post_nms_train=720, nms_iou_threshold=1.0, min_proposal_side=0.0,
                      minibatch_size=720, max_positive_fraction=1.0),
        detector=DetectorConfig(proposal_batch_size=256, positive_fraction=1.0),
        max_gt_boxes=8,
    )


def phase_reference_train(dev, rng):
    """One train step's losses and gradients, card vs CPU: same weights,
    same batch, same draws. Gradients are compared per tensor in relative
    norm |g_card - g_cpu| / |g_cpu| <= 3e-3: the backbones differ in the last
    bits (TF32 off), and on the ReLU'd feature map a tie between two samples
    may be exact on one side only, so a cotangent splits on one side alone."""
    import torch
    from fasterrcnn_torch.models import faster_rcnn as frcnn

    cfg = every_box_config()
    cpu = frcnn.FasterRCNN(cfg)
    frcnn.init_params(cpu, seed=1)
    card = frcnn.FasterRCNN(cfg)
    card.load_state_dict(cpu.state_dict())
    card = card.to(dev, memory_format=torch.channels_last)
    grid = frcnn.anchor_grid_for(cfg, 128, 160)
    images = np.zeros((2, 128, 160, 3), np.uint8)
    images[:, :64, :80] = rng.integers(0, 255, (2, 64, 80, 3), dtype=np.uint8)
    gt_boxes = np.zeros((2, 8, 4), np.float32)
    gt_boxes[0, :2] = [[5, 8, 40, 50], [20, 30, 60, 78]]
    gt_boxes[1, :1] = [[10, 10, 50, 60]]
    gt_mask = (gt_boxes[..., 2] > 0).astype(np.float32)
    host = frcnn.Batch(
        images=torch.from_numpy(images), image_hw=torch.tensor([[64.0, 80.0]] * 2),
        gt_boxes=torch.from_numpy(gt_boxes), gt_classes=torch.from_numpy((gt_mask * 7).astype(np.int32)),
        gt_mask=torch.from_numpy(gt_mask), sample_weight=torch.ones(2),
    )
    draws = frcnn.draw_train_uniforms(cfg, grid, 2, torch.Generator().manual_seed(0), "cpu")
    results = []
    for model, device in ((cpu, "cpu"), (card, dev)):
        model.train()
        batch = frcnn.Batch(*(t.to(device) for t in host))
        d = frcnn.TrainDraws(*(tuple(u.to(device) for u in pair) for pair in draws))
        total, losses = frcnn.compute_losses(model, batch, grid, draws=d)
        total.backward()
        results.append((
            [v.item() for v in losses], {n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None}
        ))
    (cpu_losses, cpu_grads), (card_losses, card_grads) = results
    print(f"reference train losses: card {card_losses!r}, CPU {cpu_losses!r}", flush=True)
    for name, a, c in zip(("rpn_class", "rpn_regression", "detector_class", "detector_regression"),
                          card_losses, cpu_losses):
        check(c > 0 and abs(a - c) <= 1e-4 * abs(c), f"reference train {name}: card {a} vs CPU {c}")
    check(card_grads.keys() == cpu_grads.keys() and len(cpu_grads) > 0, "reference train: gradient sets differ")
    worst = max(
        (float((card_grads[n] - g).norm() / g.norm().clamp_min(1e-30)), n) for n, g in cpu_grads.items()
    )
    print(f"reference train gradients: worst relative norm {worst[0]!r} ({worst[1]}; tolerance 3e-3) "
          f"over {len(cpu_grads)} tensors", flush=True)
    check(worst[0] <= 3e-3, f"reference train gradients: {worst[1]} at {worst[0]}")


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


def phase_main_path(dev, rng, counters, canvas=(608, 800), extents=MAIN_EXTENTS):
    """The predict path; `counters` are the kernels it must launch."""
    import torch
    from fasterrcnn_torch.config import ModelConfig
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
    per_image = engine.predict_image(images[0, :h0, :w0], score_threshold=0.0)
    det16 = engine16.predict(images, image_hw, score_threshold=0.0)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"main path launches: {launches}", flush=True)
    for name, n in launches.items():
        check(n > 0, f"main path: kernel {name} was never launched")

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
    """The default config's train path at full width through Engine."""
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
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"train path launches: {launches}", flush=True)
    for name, n in launches.items():
        check(n > 0, f"train path: kernel {name} was never launched")
    return engine, engine16, batch, launches


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
    ("nms_keep_mask", ("nms_keep_mask_kernel",)),
    ("roi_pool_taps_bwd", ("roi_pool_taps_bwd_kernel",)),
    ("roi_pool_taps", ("roi_pool_taps_kernel",)),
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
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    rng = np.random.default_rng(0)
    parity = phase_kernel_parity(dev, rng)
    print(json.dumps({"library_conv_ms": parity["library_conv"], "card": card}), flush=True)
    phase_reference(dev, rng)
    phase_reference_train(dev, rng)
    counters = (nms_ops.nms_keep_mask, roi_ops.roi_pool_taps, roi_ops.roi_pool_taps_bwd)
    # Each path runs, is timed and profiled with only its own engines on
    # the card, so each peak memory counts that path alone.
    engine, engine16, images, image_hw, launches = phase_main_path(dev, rng, counters[:2])
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

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")

    def by_path(name):
        return {"predict": launches.get(name, 0), "train": train_launches[name]}

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
            "per_class": parity["per_class"],
            "train": parity["train"],
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
            "bf16": parity["roi_bf16"],
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
            **{k: parity[k] for k in ("roi_bwd_bf16", "roi_bwd_f32_relu", "roi_bwd_bf16_relu")},
        },
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
