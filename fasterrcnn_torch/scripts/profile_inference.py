"""Stage-isolation profile of the predict program on the card: the JAX
package's `scripts/profile_inference.py`.

Times (slope method, `utils/timing.slope_ms`) larger and larger prefixes of
the predict program at production shapes, so that stage costs fall out by
subtraction. Each prefix calls the functions the predict program calls:

  1. backbone + RPN head      (`FasterRCNN.features_and_rpn`)
  2. + proposal generation    (`infer_proposals`: top-k, decode, RPN NMS: K1)
  3. + RoI pool + detector head (`FasterRCNN.detect_rois`: K2)
  4. + per-class decode + NMS (`make_predict_fn`, the whole predict: K1),
     score threshold 0.05; then images a second.

Each stage prints its slope in ms a batch and its difference from the
previous stage, then one JSON line of `utils/profiling.device_profile` over
3 warm calls: `device_busy_ms`, `device_idle_share`, `device_ops` (device
operations a call). A slope times a loop of eager calls: where the host
enqueues slower than the card runs (bf16, where the card idles much of an
eager call), it measures the enqueue, and a stage's difference can come out
negative. `device_busy_ms` is the card's own work a call. Read the slope
for what a caller waits, the busy time for what the card spends.

Also the train-shape proposals, 12000 -> 2000 at B=8 (the first 8 images)
on stage 1's outputs: leg `kernel` is `generate_proposals` as the train
step calls it (K1); leg `plain` is the NMS alone on the same score-sorted
candidates (`models/rpn.proposal_candidates`): `nms_keep_mask` (K1) beside
`nms_keep_mask_plain`, its plain PyTorch twin, at LO/HI 1/2 (the twin takes
about half a second a call there), with the twin's peak memory; the two
keep masks must be equal.

Defaults are the JAX script's: VGG-16, bf16, PROF_BATCH (32) images on the
608x800 canvas (real extent 600x800), LO/HI 4/16; weights from seed 0,
uint8 images from numpy's default_rng(0). f32 runs at PyTorch's defaults
(cuDNN TF32 on, matmul TF32 off). --tiny takes the CLI's tiny ModelConfig
(128x160 canvas, 120x150 images, caps 200 -> 64 and 400 -> 128).

Usage (on the card; no fallback):
    python -m fasterrcnn_torch.scripts.profile_inference [--backbone resnet101] [--dtype float32]
On the CPU, at the tiny config:
    python -m fasterrcnn_torch.scripts.profile_inference --device cpu --tiny --batch 2 --lo 1 --hi 2
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

CANVAS, IMAGE_HW = (608, 800), (600.0, 800.0)
TINY_CANVAS, TINY_IMAGE_HW = (128, 160), (120.0, 150.0)
TRAIN_PROPOSAL_BATCH = 8
PLAIN_LO_HI = (1, 2)


def build_parser(batch_env: str, batch: int, lo: int, hi: int, doc: str) -> argparse.ArgumentParser:
    """The flags of both stage-isolation scripts, with their JAX defaults."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true", help="The CLI's tiny ModelConfig at 128x160")
    ap.add_argument("--batch", type=int, default=int(os.environ.get(batch_env, batch)),
                    help=f"Images a batch (default ${batch_env} or {batch})")
    ap.add_argument("--lo", type=int, default=lo, help="Short loop of the slope")
    ap.add_argument("--hi", type=int, default=hi, help="Long loop of the slope")
    ap.add_argument("--backbone", default="vgg16", choices=["vgg16", "vgg16-torch", "resnet50", "resnet101",
                                                            "resnet152"])
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    return ap


def make_engine(options):
    """An Engine with the CLI's ModelConfig of the flags (`cli.model_config`)
    and seed-0 weights, on `options.device`."""
    from fasterrcnn_torch import cli
    from fasterrcnn_torch.engine import Engine

    flags = ["--backbone", options.backbone, "--compute-dtype", options.dtype] + (["--tiny"] if options.tiny else [])
    return Engine(cli.model_config(cli.build_parser().parse_args(flags)), seed=0, device=options.device)


def canvas_of(options) -> Tuple[Tuple[int, int], Tuple[float, float]]:
    return (TINY_CANVAS, TINY_IMAGE_HW) if options.tiny else (CANVAS, IMAGE_HW)


class Setup(NamedTuple):
    engine: object  # fasterrcnn_torch.engine.Engine
    canvas: Tuple[int, int]
    grid: object  # ops/anchors.AnchorGrid of the canvas
    centers: torch.Tensor  # the grid's anchor centers on the device
    images: torch.Tensor  # (B, H, W, 3) uint8
    image_hw: torch.Tensor  # (B, 2) f32 real extents


def setup(options) -> Setup:
    from fasterrcnn_torch.models.faster_rcnn import anchor_grid_for
    from fasterrcnn_torch.ops import constants

    engine = make_engine(options)
    canvas, hw = canvas_of(options)
    dev = engine.device
    rng = np.random.default_rng(0)
    images = torch.as_tensor(rng.integers(0, 255, (options.batch, *canvas, 3), dtype=np.uint8), device=dev)
    image_hw = torch.tensor([hw] * options.batch, dtype=torch.float32, device=dev)
    grid = anchor_grid_for(engine.model_cfg, *canvas)
    return Setup(engine, canvas, grid, constants.array(grid.centers, dev), images, image_hw)


# The four prefixes of the predict program.

@torch.inference_mode()
def stage_features(s: Setup):
    """1: (feature map, RPN logits, RPN deltas)."""
    return s.engine.model.features_and_rpn(s.images)


@torch.inference_mode()
def stage_proposals(s: Setup):
    """2: (feature map, Proposals) with the infer caps."""
    from fasterrcnn_torch.models.faster_rcnn import infer_proposals

    return infer_proposals(s.engine.model, s.grid, s.centers, s.images, s.image_hw)


@torch.inference_mode()
def stage_detect(s: Setup):
    """3: the detector's (class logits, box deltas) over stage 2's proposals."""
    fm, props = stage_proposals(s)
    return s.engine.model.detect_rois(fm, props.boxes, s.image_hw)


def stage_predict(s: Setup):
    """4: the whole predict program's Detections."""
    return s.engine.predict_fn_for(s.canvas)(s.images, s.image_hw, score_threshold=0.05)


@contextlib.contextmanager
def predict_internals(model):
    """Record what the predict program computes inside: while in the
    context, its `infer_proposals` proposals ("proposals") and its
    `detect_rois` class logits ("logits") land in the yielded dict."""
    from fasterrcnn_torch.models import faster_rcnn

    seen: Dict[str, object] = {}
    infer, detect = faster_rcnn.infer_proposals, model.detect_rois

    def recording_infer(*args, **kwargs):
        fm, props = infer(*args, **kwargs)
        seen["proposals"] = props
        return fm, props

    def recording_detect(*args, **kwargs):
        out = detect(*args, **kwargs)
        seen["logits"] = out[0]
        return out

    faster_rcnn.infer_proposals, model.detect_rois = recording_infer, recording_detect
    try:
        yield seen
    finally:
        faster_rcnn.infer_proposals = infer
        del model.detect_rois


# The train-shape proposals.

def train_rows(s: Setup, logits: torch.Tensor, deltas: torch.Tensor):
    """The first TRAIN_PROPOSAL_BATCH rows of stage 1's outputs and their
    (proposal mask, real extents)."""
    from fasterrcnn_torch.models.faster_rcnn import proposal_masks

    n = min(TRAIN_PROPOSAL_BATCH, logits.shape[0])
    hw = s.image_hw[:n]
    return logits[:n], deltas[:n], proposal_masks(s.engine.model_cfg, s.grid, hw)[0], hw


@torch.inference_mode()
def train_proposals(s: Setup, logits: torch.Tensor, deltas: torch.Tensor):
    """Leg `kernel`: `generate_proposals` with the train caps, as the train
    step calls it."""
    from fasterrcnn_torch.models.rpn import generate_proposals

    rpn = s.engine.model_cfg.rpn
    logits, deltas, mask, hw = train_rows(s, logits, deltas)
    return generate_proposals(logits, deltas, s.centers, mask, hw[:, 0], hw[:, 1], rpn.pre_nms_train,
                              rpn.post_nms_train, rpn.nms_iou_threshold, rpn.min_proposal_side)


@torch.inference_mode()
def train_candidates(s: Setup, logits: torch.Tensor, deltas: torch.Tensor):
    """Leg `plain`'s input: the score-sorted (boxes, scores, valid) the train
    proposals' NMS takes."""
    from fasterrcnn_torch.models.rpn import proposal_candidates

    rpn = s.engine.model_cfg.rpn
    logits, deltas, mask, hw = train_rows(s, logits, deltas)
    return proposal_candidates(logits, deltas, s.centers, mask, hw[:, 0], hw[:, 1], rpn.pre_nms_train,
                               rpn.min_proposal_side)


# Timing and printing.

def synchronizer(device: torch.device) -> Callable[[], None]:
    return torch.cuda.synchronize if device.type == "cuda" else (lambda: None)


def slope(fn: Callable[[], object], sync: Callable[[], None], lo: int, hi: int) -> float:
    """ms a call of `fn` by `slope_ms`, after one warming call."""
    from fasterrcnn_torch.utils.timing import slope_ms

    fn()
    sync()
    return slope_ms(fn, sync, lo, hi)


def report(label: str, ms: float, prev: Optional[float], diff_label: str, fn: Callable[[], object],
           context: Dict[str, object]) -> Dict[str, object]:
    """Print a stage's slope (and its difference from `prev`) and one JSON
    line with the card's busy time, idle share and operations over 3 warm
    calls of `fn`; return that line's dict."""
    from fasterrcnn_torch.utils.profiling import device_profile

    prof = device_profile(fn, reps=3)
    diff = None if prev is None else ms - prev
    busy = prof["device_busy_ms_per_call"]
    print(f"{label:26s}: {ms:8.2f} ms/batch" + ("" if diff is None else f" ({diff_label}: {diff:+.2f})")
          + f"  device busy {busy if isinstance(busy, str) else f'{busy:.2f} ms'}", flush=True)
    row = {"stage": label, "slope_ms": ms, "diff_ms": diff, "device_busy_ms": busy,
           "device_idle_share": prof["device_idle_share"], "device_ops": prof["device_ops_per_call"],
           "wall_ms_profiler_on": prof["wall_ms_per_call_profiler_on"], "by_layer_ms": prof["by_layer_ms"],
           **context}
    print(json.dumps(row), flush=True)
    return row


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, object]]:
    options = build_parser("PROF_BATCH", 32, 4, 16, __doc__).parse_args(argv)
    return profile(setup(options), options)


def profile(s: Setup, options) -> List[Dict[str, object]]:
    """Time and profile every stage of `s` as the flags `options` say; print
    them and return the stages' JSON rows."""
    from fasterrcnn_torch.ops import nms as nms_ops
    from fasterrcnn_torch.scripts.prodshape_proxy import device_line

    card = device_line()
    print(f"card: {card}", flush=True)
    sync = synchronizer(s.engine.device)
    b, lo, hi = options.batch, options.lo, options.hi
    context = {"backbone": options.backbone, "dtype": options.dtype, "batch": b,
               "canvas": list(s.canvas), "card": card}
    rows = []

    def stage(label, fn, prev, diff_label="stage", loops=(lo, hi)):
        ms = slope(fn, sync, *loops)
        rows.append(report(label, ms, prev, diff_label, fn, context))
        return ms

    t1 = stage("backbone+rpn_head", lambda: stage_features(s), None)
    t2 = stage("+ proposal gen (RPN NMS)", lambda: stage_proposals(s), t1)
    t3 = stage("+ roi pool + det head", lambda: stage_detect(s), t2)
    t4 = stage("full predict", lambda: stage_predict(s), t3, "per-class NMS")
    print(f"-> {b / (t4 / 1e3):.1f} images/sec", flush=True)

    _, logits, deltas = stage_features(s)
    n = min(TRAIN_PROPOSAL_BATCH, b)
    rpn = s.engine.model_cfg.rpn
    tag = f"train NMS {rpn.pre_nms_train}->{rpn.post_nms_train} B={n}"
    context = {**context, "batch": n}
    stage(f"{tag} [kernel]", lambda: train_proposals(s, logits, deltas), None)
    boxes, _, valid = train_candidates(s, logits, deltas)
    post = rpn.post_nms_train

    def keep_kernel():
        return nms_ops.nms_keep_mask(boxes, valid, rpn.nms_iou_threshold, post)

    def keep_plain():
        return nms_ops.nms_keep_mask_plain(boxes, valid, rpn.nms_iou_threshold, post)

    stage(f"{tag} [nms_keep_mask]", keep_kernel, None)
    cuda = s.engine.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    same = torch.equal(keep_kernel(), keep_plain())
    peak = f"{torch.cuda.max_memory_allocated()} bytes" if cuda else "not measured"
    print(f"{tag}: nms_keep_mask_plain's peak device memory {peak}; keep masks equal: {same}", flush=True)
    if not same:
        raise SystemExit(f"{tag}: nms_keep_mask and nms_keep_mask_plain disagree")
    stage(f"{tag} [nms_keep_mask_plain]", keep_plain, None, loops=PLAIN_LO_HI)
    return rows


if __name__ == "__main__":
    main()
