"""Stage-isolation profile of the train step on the card: the JAX package's
`scripts/profile_train.py`.

Times (slope method, `utils/timing.slope_ms`) larger and larger pieces of
the train step, each calling the functions the step calls:

  1. backbone + RPN head forward (`features_and_rpn`, under no_grad)
  2. the whole `compute_losses` forward, under no_grad (adds proposal
     generation 12000 -> 2000 with K1, RPN target assignment, both
     samplers, RoI pool with K2, detector head, losses); JAX's jitted
     forward builds no backward either
  3. `compute_losses` and `total.backward()` (adds the backward, K3), the
     gradients zeroed first, no update
  4. the whole `make_train_step` (adds `engine.make_optimizer`'s SGD
     update); then images a second

and one more row: the captured packed step (`make_train_step_packed`, one
CUDA graph replay a step), the program `Engine.train_epoch` runs. In bf16
the eager step is host-bound: the card idles while Python enqueues, so the
eager rows' slopes time the enqueue and the captured row shows what the
card itself costs. Each row also prints one JSON line of
`utils/profiling.device_profile` over 3 warm calls (`device_busy_ms`,
`device_idle_share`, `device_ops`); see `profile_inference.py` for which of
slope and busy time to read.

The batch is JAX's: one gt box [100, 100, 400, 500] of class 5 an image,
the rest padded, sample_weight 1, uint8 images from numpy's
default_rng(0). Stages 1-4 sample with one set of draws
(`draw_train_uniforms` from a seeded torch.Generator), so every stage
samples the same RoIs; the captured step draws from the engine's
generator, as the epoch does. Every row starts from the same parameters,
optimizer and generator state (`snapshot_train_state`).

Defaults are the JAX script's: VGG-16, bf16, PROF_TRAIN_BATCH (8) images on
the 608x800 canvas, LO/HI 4/12; weights from seed 0. Flags as
`profile_inference.py`'s.

Usage (on the card; no fallback):
    python -m fasterrcnn_torch.scripts.profile_train [--backbone resnet101] [--dtype float32]
On the CPU, at the tiny config:
    python -m fasterrcnn_torch.scripts.profile_train --device cpu --tiny --batch 2 --lo 1 --hi 2
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from fasterrcnn_torch.scripts import profile_inference as prof_inf

GT_BOX, GT_CLASS = (100.0, 100.0, 400.0, 500.0), 5


class TrainSetup(NamedTuple):
    engine: object  # fasterrcnn_torch.engine.Engine
    canvas: tuple
    grid: object  # ops/anchors.AnchorGrid of the canvas
    batch: object  # models/faster_rcnn.Batch on the device
    draws: object  # models/faster_rcnn.TrainDraws of every eager stage
    aux: torch.Tensor  # the packed step's (B, aux_width) f32 beside batch.images
    restore: Callable[[], None]  # puts back the parameters, optimizer and generators


def host_batch(b: int, canvas, image_hw, max_gt: int):
    """JAX's profiling batch, as numpy arrays in a Batch."""
    from fasterrcnn_torch.models.faster_rcnn import Batch

    rng = np.random.default_rng(0)
    gt_boxes = np.zeros((b, max_gt, 4), np.float32)
    gt_boxes[:, 0] = GT_BOX
    gt_classes = np.zeros((b, max_gt), np.int32)
    gt_classes[:, 0] = GT_CLASS
    gt_mask = np.zeros((b, max_gt), np.float32)
    gt_mask[:, 0] = 1.0
    return Batch(
        images=rng.integers(0, 255, (b, *canvas, 3), dtype=np.uint8),
        image_hw=np.tile(np.float32([image_hw]), (b, 1)),
        gt_boxes=gt_boxes, gt_classes=gt_classes, gt_mask=gt_mask,
        sample_weight=np.ones((b,), np.float32),
    )


def setup(options) -> TrainSetup:
    from fasterrcnn_torch.models.faster_rcnn import anchor_grid_for, draw_train_uniforms, pack_aux, snapshot_train_state

    engine = prof_inf.make_engine(options)
    canvas, hw = prof_inf.canvas_of(options)
    cfg, dev = engine.model_cfg, engine.device
    host = host_batch(options.batch, canvas, hw, cfg.max_gt_boxes)
    grid = anchor_grid_for(cfg, *canvas)
    draws = draw_train_uniforms(cfg, grid, options.batch, torch.Generator(device=dev).manual_seed(0), dev)
    batch = engine.to_device(host)
    aux = torch.as_tensor(pack_aux(host, 0), device=dev)
    restore = snapshot_train_state(engine.model, engine.optimizer, (engine.generator,))
    return TrainSetup(engine, canvas, grid, batch, draws, aux, restore)


# The pieces of the train step.

@torch.no_grad()
def stage_features(s: TrainSetup) -> torch.Tensor:
    """1: the RPN logits."""
    s.engine.model.train()
    return s.engine.model.features_and_rpn(s.batch.images)[1]


@torch.no_grad()
def stage_losses(s: TrainSetup) -> torch.Tensor:
    """2: `compute_losses`' total."""
    from fasterrcnn_torch.models.faster_rcnn import compute_losses

    s.engine.model.train()
    return compute_losses(s.engine.model, s.batch, s.grid, draws=s.draws)[0]


def stage_backward(s: TrainSetup) -> torch.Tensor:
    """3: `compute_losses`' total after its backward into zeroed gradients."""
    from fasterrcnn_torch.models.faster_rcnn import compute_losses

    s.engine.model.train()
    s.engine.optimizer.zero_grad()
    total = compute_losses(s.engine.model, s.batch, s.grid, draws=s.draws)[0]
    total.backward()
    return total.detach()


def stage_step(s: TrainSetup):
    """4: one `make_train_step` step (the optimizer updates the parameters);
    its Losses."""
    return s.engine.train_step_for(s.canvas)(s.batch, draws=s.draws)


def stage_captured(s: TrainSetup):
    """The packed step `Engine.train_epoch` runs (a CUDA graph on the card,
    captured at its first call); its (Losses, loss vector)."""
    return s.engine.packed_step_for(s.canvas)(s.batch.images, s.aux)


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, object]]:
    options = prof_inf.build_parser("PROF_TRAIN_BATCH", 8, 4, 12, __doc__).parse_args(argv)
    return profile(setup(options), options)


def profile(s: TrainSetup, options) -> List[Dict[str, object]]:
    """Time and profile every row of `s` as the flags `options` say; print
    them and return the rows' JSON dicts. Leaves the state as it found it."""
    from fasterrcnn_torch.scripts.prodshape_proxy import device_line

    card = device_line()
    print(f"card: {card}", flush=True)
    sync = prof_inf.synchronizer(s.engine.device)
    b = options.batch
    context = {"backbone": options.backbone, "dtype": options.dtype, "batch": b,
               "canvas": list(s.canvas), "card": card}
    rows = []

    def stage(label, fn, prev, diff_label):
        s.restore()
        ms = prof_inf.slope(fn, sync, options.lo, options.hi)
        rows.append(prof_inf.report(label, ms, prev, diff_label, fn, context))
        return ms

    t1 = stage("fwd backbone+rpn_head", lambda: stage_features(s), None, "")
    t2 = stage("fwd full losses", lambda: stage_losses(s), t1, "proposals+sampling+roi+det")
    t3 = stage("+ backward", lambda: stage_backward(s), t2, "bwd")
    t4 = stage("full train step", lambda: stage_step(s), t3, "optimizer")
    print(f"-> {b / (t4 / 1e3):.1f} images/sec", flush=True)
    t5 = stage("captured packed step", lambda: stage_captured(s), t4, "vs the eager step")
    print(f"-> {b / (t5 / 1e3):.1f} images/sec", flush=True)
    s.restore()
    return rows


if __name__ == "__main__":
    main()
