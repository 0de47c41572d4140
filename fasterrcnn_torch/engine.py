"""Engine: holds the model, its optimizer and per-canvas programs.

`Engine(model_cfg, train_cfg, seed, device)` (the JAX package's argument
order) builds the model with seeded random weights on `device` ("cuda"
unless the caller asks for "cpu"); `set_params` installs a state_dict (see
`utils/weights.py` for one made from the JAX package's parameters) and
restarts the optimizer; `load_weights` does so from any weight file
`utils/checkpoint.load` reads and `save_weights` writes the port's own
`.pth`; `predict` runs a padded canvas batch; `predict_image` stages one
`data/voc.Sample` into its canvas bucket and returns the reference's
per-class dict; `train_step` takes one optimizer step on a padded batch and
`train_epoch` runs one over a dataset; `evaluate` runs predict over a
dataset and returns the VOC mAP in percent.
"""

from __future__ import annotations

import itertools
import math
import sys
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from fasterrcnn_torch.config import ModelConfig, TrainConfig, select_canvas
from fasterrcnn_torch.data.pipeline import Prefetcher, batched, make_host_batch
from fasterrcnn_torch.data.voc import Sample
from fasterrcnn_torch.models.faster_rcnn import (
    Batch,
    Detections,
    FasterRCNN,
    Losses,
    frozen_parameter_names,
    init_params,
    make_predict_fn,
    make_train_step,
)
from fasterrcnn_torch.utils import checkpoint as ckpt_lib
from fasterrcnn_torch.utils import postprocess
from fasterrcnn_torch.utils.stats import PrecisionRecallCurveCalculator, TrainingStatistics

def resolve_device(device) -> torch.device:
    """The requested device; raises rather than falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def parameter_labels(model: FasterRCNN) -> Dict[str, str]:
    """Optimizer group of each parameter: "frozen" (the backbone's frozen
    patterns, unless train_all), "decayed" (conv and dense weights, and
    frozen-BN scales, as the JAX package decays names ending in kernel or
    scale) or "plain" (biases)."""
    frozen = set(frozen_parameter_names(model))
    return {
        name: "frozen" if name in frozen else "decayed" if name.endswith(("weight", "scale")) else "plain"
        for name, _ in model.named_parameters()
    }


def warmup_cosine_factor(count: int, warmup_steps: int, total_steps: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, 1, warmup_steps, total_steps) at
    update `count`: linear warmup, then cosine decay to 0 at total_steps
    (the warmup counted inside total_steps)."""
    if count < warmup_steps:
        return count / warmup_steps
    decay = total_steps - warmup_steps
    return 0.5 * (1.0 + math.cos(math.pi * min(count - warmup_steps, decay) / decay))


class TrainOptimizer:
    """The JAX package's optax optimizer on torch parameters.

    Groups as `parameter_labels` gives them: "decayed" with weight decay,
    "plain" without, "frozen" held out (those parameters do not require
    grad). When clipnorm > 0, each group's gradients are clipped by that
    group's own global norm, as optax.clip_by_global_norm inside each
    multi_transform group does (g * clipnorm / norm when norm >= clipnorm);
    then torch.optim adds weight_decay * p to the gradient, as
    optax.add_decayed_weights does before sgd or adam, and updates the
    parameters in place; then the learning-rate schedule advances.
    """

    def __init__(self, optimizer: torch.optim.Optimizer, scheduler, clipnorm: float):
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.clipnorm = clipnorm

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        if self.clipnorm > 0:
            for group in self.optimizer.param_groups:
                grads = [p.grad for p in group["params"] if p.grad is not None]
                if not grads:
                    continue
                norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
                factor = torch.where(norm < self.clipnorm, 1.0, self.clipnorm / norm)
                for g in grads:
                    g.mul_(factor)
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()


def make_optimizer(
    model_cfg: ModelConfig, train_cfg: TrainConfig, model: FasterRCNN
) -> Tuple[TrainOptimizer, Dict[str, str]]:
    """The optimizer of `train_cfg` over `model`'s parameters, and each
    parameter's group label. SGD with momentum or Adam; a constant learning
    rate or optax's warmup-cosine schedule."""
    labels = parameter_labels(model)
    params = dict(model.named_parameters())
    groups = [
        {"params": [params[n] for n, g in labels.items() if g == "decayed"], "weight_decay": train_cfg.weight_decay},
        {"params": [params[n] for n, g in labels.items() if g == "plain"], "weight_decay": 0.0},
    ]
    lr = train_cfg.learning_rate
    if train_cfg.optimizer == "adam":
        opt = torch.optim.Adam(groups, lr=lr, betas=(train_cfg.beta1, train_cfg.beta2), eps=1e-8)
    elif train_cfg.optimizer == "sgd":
        opt = torch.optim.SGD(groups, lr=lr, momentum=train_cfg.momentum)
    else:
        raise ValueError(f"unknown optimizer {train_cfg.optimizer!r}")
    scheduler = None
    if train_cfg.lr_schedule == "cosine":
        warmup = max(train_cfg.warmup_steps, 1)
        if train_cfg.total_steps <= warmup:
            raise ValueError(
                "lr_schedule='cosine' needs total_steps > max(warmup_steps, 1) "
                f"(got total_steps={train_cfg.total_steps})"
            )
        total = train_cfg.total_steps
        scheduler = torch.optim.lr_scheduler.LambdaLR(opt, lambda n: warmup_cosine_factor(n, warmup, total))
    elif train_cfg.lr_schedule != "constant":
        raise ValueError(f"unknown lr_schedule {train_cfg.lr_schedule!r}")
    return TrainOptimizer(opt, scheduler, train_cfg.clipnorm), labels


class Engine:
    """Holds the model on one device, its optimizer, the sampling generator
    and the per-canvas predict and train functions."""

    def __init__(
        self,
        model_cfg: ModelConfig = ModelConfig(),
        train_cfg: TrainConfig = TrainConfig(),
        seed: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        model = FasterRCNN(model_cfg)
        init_params(model, seed)
        self.model = model.to(device=self.device, memory_format=torch.channels_last).eval()
        # Uniforms of the minibatch and proposal sampling, on the device.
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._predict_fns: Dict[Tuple[int, int], callable] = {}
        self._restart_optimizer()

    def _restart_optimizer(self) -> None:
        self.optimizer, self.labels = make_optimizer(self.model_cfg, self.train_cfg, self.model)
        self._train_steps: Dict[Tuple[int, int], callable] = {}

    def set_params(self, state_dict) -> None:
        """Install a full state_dict (no missing or unexpected keys) and
        restart the optimizer, as the JAX package's Engine does."""
        self.model.load_state_dict(state_dict)
        self._restart_optimizer()

    def load_weights(self, filepath: str) -> None:
        """Load any weight file `utils/checkpoint.load` reads; restarts the
        optimizer."""
        self.set_params(ckpt_lib.load(self.model, filepath))

    def save_weights(self, filepath: str) -> None:
        ckpt_lib.save_weights(filepath, self.model)

    def predict_fn_for(self, canvas_hw: Tuple[int, int]):
        canvas_hw = tuple(canvas_hw)
        if canvas_hw not in self._predict_fns:
            self._predict_fns[canvas_hw] = make_predict_fn(self.model, *canvas_hw)
        return self._predict_fns[canvas_hw]

    def train_step_for(self, canvas_hw: Tuple[int, int]):
        canvas_hw = tuple(canvas_hw)
        if canvas_hw not in self._train_steps:
            self._train_steps[canvas_hw] = make_train_step(self.model, self.optimizer, *canvas_hw)
        return self._train_steps[canvas_hw]

    def to_device(self, batch) -> Batch:
        """A padded batch on this engine's device: `batch` is a
        data/pipeline.HostBatch (numpy) or a Batch."""
        return Batch(*(torch.as_tensor(getattr(batch, f), device=self.device) for f in Batch._fields))

    def train_step(self, batch) -> Losses:
        """One optimizer step on a padded batch (HostBatch or Batch; a host
        batch is copied to the device here). Returns the detached losses,
        still on the device."""
        b = self.to_device(batch)
        step = self.train_step_for(tuple(b.images.shape[1:3]))
        return step(b, generator=self.generator)

    def train_epoch(
        self,
        dataset: Iterable,
        batch_size: int,
        stats: Optional[TrainingStatistics] = None,
        progress: bool = False,
        max_steps: Optional[int] = None,
    ) -> TrainingStatistics:
        """One pass over `dataset` (samples, see data/voc.Sample) in padded
        canvas batches, assembled in a background thread; at most max_steps
        steps. The losses are fetched to the host in blocks of steps, not
        after every step."""
        stats = stats or TrainingStatistics()
        batches = Prefetcher(batched(iter(dataset), batch_size, self.model_cfg.max_gt_boxes))
        pending = []
        steps = 0

        def flush():
            if not pending:
                return
            rows = torch.stack([torch.stack(list(losses)) for losses in pending]).cpu().numpy()
            pending.clear()
            for row in rows:
                stats.on_training_step_values(row)
            if progress:
                print(f"step {steps}: {stats.get_progbar_postfix()}", file=sys.stderr, flush=True)

        try:
            for hb in batches:
                if max_steps is not None and steps >= max_steps:
                    break
                pending.append(self.train_step(hb))
                steps += 1
                if len(pending) >= 32:
                    flush()
            flush()
        finally:
            batches.close()
        return stats

    def predict(self, images_u8, image_hw, score_threshold: float = 0.05) -> Detections:
        """Padded canvas batch (B, H, W, 3) uint8 + real extents (B, 2)."""
        images = torch.as_tensor(images_u8, device=self.device)
        hw = torch.as_tensor(image_hw, dtype=torch.float32, device=self.device)
        predict = self.predict_fn_for(tuple(images.shape[1:3]))
        return predict(images, hw, score_threshold=score_threshold)

    def predict_image(self, sample: Sample, score_threshold: float = 0.7) -> Dict[int, np.ndarray]:
        """Single-sample predict -> reference-style per-class dict."""
        hb = make_host_batch([sample], select_canvas(*sample.image_hw), self.model_cfg.max_gt_boxes)
        det = self.predict(hb.images, hb.image_hw, score_threshold=score_threshold)
        return postprocess.detections_to_dicts(det)[0]

    def evaluate(
        self,
        dataset: Iterable,
        batch_size: int = 8,
        num_samples: Optional[int] = None,
        score_threshold: float = 0.05,
        print_average_precisions: bool = False,
        plot: bool = False,
        progress: bool = True,
    ) -> float:
        """Predict over `dataset` (at most num_samples samples) in padded
        canvas batches assembled in a background thread, and return the VOC
        mAP in percent. Each batch's detections are read, in one copy to the
        host, just after the next batch is dispatched; only real samples
        reach the calculator."""
        calc = PrecisionRecallCurveCalculator()
        source = iter(dataset)
        if num_samples is not None:
            # Bounds the decode work: the prefetch thread stops after them.
            source = itertools.islice(source, num_samples)
        batches = Prefetcher(batched(source, batch_size, self.model_cfg.max_gt_boxes))
        seen = 0
        finished = 0

        def finish(packed, samples):
            nonlocal seen, finished
            packed = packed.cpu().numpy()
            det = Detections(boxes=packed[..., :4], scores=packed[..., 4], valid=packed[..., 5])
            # hb.samples holds only the real samples: the zero-weight
            # padding rows of a residue batch are dropped here.
            for sample, scored in zip(samples, postprocess.detections_to_dicts(det)):
                calc.add_image_results(scored, sample.gt_boxes)
                seen += 1
            finished += 1
            if progress and finished % 8 == 0:
                print(f"eval: {seen} images", file=sys.stderr, flush=True)

        # Reading one batch behind lets the calculator's work on a batch
        # overlap the device's on the next. A deeper queue would add
        # nothing: predict's upload of the next batch from pageable memory
        # is a copy PyTorch ends with a stream synchronize, so it already
        # waits for the device to finish every batch before it.
        previous = None
        try:
            for hb in batches:
                det = self.predict(hb.images, hb.image_hw, score_threshold=score_threshold)
                packed = torch.cat([det.boxes, det.scores[..., None], det.valid[..., None].float()], dim=-1)
                if previous is not None:
                    finish(*previous)
                previous = (packed, hb.samples)
            if previous is not None:
                finish(*previous)
        finally:
            batches.close()
        if progress:
            print(f"eval: {seen} images", file=sys.stderr, flush=True)
        class_names = getattr(dataset, "class_index_to_name", {})
        if print_average_precisions:
            calc.print_average_precisions(class_names)
        mean_ap = 100.0 * calc.compute_mean_average_precision()
        print("Mean Average Precision = %1.2f%%" % mean_ap)
        if plot:
            calc.plot_average_precisions(class_names)
        return mean_ap
