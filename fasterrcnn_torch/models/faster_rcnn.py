"""Faster R-CNN: backbone + RPN head + RoI head + detector heads, the
fixed-shape predict program and the train step.

The same model as the JAX package's `models/faster_rcnn.py`. Predict: a
padded batch of uint8 canvases (real image in the top-left corner, real
extent given per image) goes through the backbone, proposal generation with
greedy NMS, RoI crop + pool, the heads, per-class decode and per-class NMS,
and comes out as fixed-shape per-class detections. Train: `compute_losses`
adds RPN target assignment, minibatch and proposal sampling and the four
losses, as a `sample_weight`-weighted mean over the batch's images, and
`make_train_step` takes one optimizer step on it. The parameters are f32;
convs and dense layers compute in `ModelConfig.torch_dtype`
(`models/layers.py`); geometry, scores, NMS and losses stay in f32.
"""

from __future__ import annotations

import re
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from fasterrcnn_torch.config import ModelConfig
from fasterrcnn_torch.models.backbone import get_backbone, normalize_images
from fasterrcnn_torch.models import losses as loss_fns
from fasterrcnn_torch.models.detector import DetectorHeads
from fasterrcnn_torch.models.rpn import RPNHead, generate_proposals
from fasterrcnn_torch.ops import anchors as anchor_ops
from fasterrcnn_torch.ops import boxes as box_ops
from fasterrcnn_torch.ops import nms as nms_ops
from fasterrcnn_torch.ops import roi as roi_ops
from fasterrcnn_torch.ops import sampling as sampling_ops


class Batch(NamedTuple):
    """One padded training batch on the device (canvas-static shapes).

    Residue batches are padded to the full batch size with blank images of
    sample_weight 0; the loss is a weighted mean over images, so padding
    never dilutes gradients.
    """

    images: torch.Tensor  # (B, Hc, Wc, 3) uint8
    image_hw: torch.Tensor  # (B, 2) f32 real (height, width) per image
    gt_boxes: torch.Tensor  # (B, G, 4) f32 corners
    gt_classes: torch.Tensor  # (B, G) int
    gt_mask: torch.Tensor  # (B, G) f32
    sample_weight: torch.Tensor  # (B,) f32: 1 = real image, 0 = padding


class Detections(NamedTuple):
    """Fixed-shape per-class inference output (B, C-1, D, ...)."""

    boxes: torch.Tensor  # (B, C-1, D, 4)
    scores: torch.Tensor  # (B, C-1, D)
    valid: torch.Tensor  # (B, C-1, D)


class Losses(NamedTuple):
    rpn_class: torch.Tensor
    rpn_regression: torch.Tensor
    detector_class: torch.Tensor
    detector_regression: torch.Tensor

    @property
    def total(self):
        return self.rpn_class + self.rpn_regression + self.detector_class + self.detector_regression


class TrainDraws(NamedTuple):
    """The uniforms one train step's sampling consumes, per image."""

    rpn: sampling_ops.Draws  # two (B, A): positive and negative anchor ranks
    detector: sampling_ops.Draws  # two (B, post_nms_train + G): proposal ranks


class FasterRCNN(nn.Module):
    """Backbone + RPN head + RoI head + detector heads."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.roi_mode != "crop":
            raise NotImplementedError(f"roi_mode={cfg.roi_mode!r} is not ported yet")
        self.cfg = cfg
        self.spec = get_backbone(cfg.backbone)
        freeze = not cfg.train_all
        self.feature_extractor = self.spec.make_feature_extractor(freeze)
        self.rpn_head = RPNHead(self.spec.feature_map_channels, cfg.anchors.num_anchors)
        self.roi_head = self.spec.make_head(cfg.detector.dropout)
        self.detector_heads = DetectorHeads(cfg.num_classes, self.spec.feature_vector_size)
        for name in frozen_parameter_names(self):
            self.get_parameter(name).requires_grad_(False)

    def features_and_rpn(self, images_u8: torch.Tensor):
        """(B,H,W,3) uint8 -> feature map (B,h,w,C) + flat RPN outputs
        (B, h*w*9) logits and (B, h*w*9, 4) deltas."""
        x = normalize_images(images_u8, self.spec.preprocessing, self.cfg.torch_dtype)
        fm = self.feature_extractor(x)
        logits, deltas = self.rpn_head(fm)
        b = logits.shape[0]
        return fm, logits.reshape(b, -1), deltas.reshape(b, -1, 4)

    def roi_norm(self, image_hw: torch.Tensor) -> torch.Tensor:
        """(B, 2) pixel -> feature-grid factors of the RoI ops: (real feature
        map side - 1) / real image side, per axis."""
        hw = image_hw.float()
        fh, fw = anchor_ops.real_feature_map_size(
            hw[:, 0].to(torch.int32),
            hw[:, 1].to(torch.int32),
            self.spec.feature_pixels,
            self.spec.fm_ceil_mode,
        )
        return torch.stack([(fh.float() - 1.0) / hw[:, 0], (fw.float() - 1.0) / hw[:, 1]], dim=1)

    def detect_rois(self, fm: torch.Tensor, roi_boxes: torch.Tensor, image_hw: torch.Tensor):
        """RoI pooling + heads over a padded (B, S, 4) box set.

        All images' RoIs run through the heads as one (B*S, ...) stack.
        Returns (B, S, C) class logits and (B, S, 4*(C-1)) box deltas.
        """
        pooled = roi_ops.roi_pool_taps(fm, roi_boxes, self.roi_norm(image_hw))
        bsz, s = pooled.shape[0], pooled.shape[1]
        vec = self.roi_head(pooled.reshape(bsz * s, *pooled.shape[2:]))
        class_logits, box_deltas = self.detector_heads(vec)
        return class_logits.reshape(bsz, s, -1), box_deltas.reshape(bsz, s, -1)


def frozen_parameter_names(model: FasterRCNN) -> Tuple[str, ...]:
    """Parameters training leaves unchanged: the backbone's
    `frozen_param_patterns`, none in from-scratch mode (`train_all`)."""
    if model.cfg.train_all:
        return ()
    patterns = [re.compile(p) for p in model.spec.frozen_param_patterns]
    return tuple(n for n, _ in model.named_parameters() if any(p.match(n) for p in patterns))


def anchor_grid_for(cfg: ModelConfig, canvas_h: int, canvas_w: int) -> anchor_ops.AnchorGrid:
    spec = get_backbone(cfg.backbone)
    fm_h, fm_w = spec.compute_feature_map_shape(canvas_h, canvas_w)
    return anchor_ops.generate_anchor_grid(fm_h, fm_w, cfg.anchors)


def proposal_masks(cfg: ModelConfig, grid, image_hw: torch.Tensor):
    """(proposal_mask, train_valid_mask), each (B, A) f32, for real extents
    image_hw (B, 2).

    * train_valid: anchor exists (inside the real feature grid) and lies
      fully inside the real image.
    * proposal: anchors eligible to emit proposals: exists, plus validity
      only when edge proposals are excluded.
    """
    spec = get_backbone(cfg.backbone)
    dev = image_hw.device
    hw = image_hw.float()
    fh, fw = anchor_ops.real_feature_map_size(
        hw[:, 0].to(torch.int32), hw[:, 1].to(torch.int32), spec.feature_pixels, spec.fm_ceil_mode
    )
    exists = anchor_ops.anchor_exists(grid, fh, fw, device=dev)
    corners = torch.as_tensor(grid.corners, device=dev)
    valid = anchor_ops.anchor_validity(corners, hw[:, 0], hw[:, 1])
    train_valid = exists & valid
    proposal = exists if cfg.allow_edge_proposals else train_valid
    return proposal.float(), train_valid.float()


def infer_proposals(model: FasterRCNN, grid, centers: torch.Tensor, images: torch.Tensor, hw: torch.Tensor):
    """The predict path's first stage: the feature map and the RPN proposals,
    with the infer caps, of (B,H,W,3) uint8 images with real extents hw (B,2)
    f32. `centers` are the grid's anchor centers on the images' device."""
    cfg = model.cfg
    fm, logits, deltas = model.features_and_rpn(images)
    props = generate_proposals(
        logits,
        deltas,
        centers,
        proposal_masks(cfg, grid, hw)[0],
        hw[:, 0],
        hw[:, 1],
        cfg.rpn.pre_nms_infer,
        cfg.rpn.post_nms_infer,
        cfg.rpn.nms_iou_threshold,
        cfg.rpn.min_proposal_side,
    )
    return fm, props


def make_predict_fn(model: FasterRCNN, canvas_h: int, canvas_w: int):
    """The fixed-shape inference function for one canvas.

    predict(images (B,H,W,3) uint8, image_hw (B,2) f32, score_threshold)
    -> Detections: forward with the infer proposal caps, per-class delta
    decode with stds (.1,.1,.2,.2), clip to [0, dim-1], score threshold,
    per-class NMS, all on the model's device and batched. Both NMS stages
    (RPN: B problems; per-class: B*(C-1) problems) go through one launch of
    the NMS kernel each on a CUDA device.
    """
    cfg = model.cfg
    grid = anchor_grid_for(cfg, canvas_h, canvas_w)
    num_fg = cfg.num_classes - 1
    # 0 = uncapped: every per-class survivor fits (survivors <= proposals).
    max_det = cfg.detector.max_detections_per_class or cfg.rpn.post_nms_infer
    centers_by_device: Dict[torch.device, torch.Tensor] = {}

    @torch.inference_mode()
    def predict(images: torch.Tensor, image_hw: torch.Tensor, score_threshold: float = 0.05):
        if tuple(images.shape[1:3]) != (canvas_h, canvas_w):
            raise ValueError(f"images {tuple(images.shape)} on a {canvas_h}x{canvas_w} canvas")
        model.eval()
        dev = images.device
        if dev not in centers_by_device:
            centers_by_device[dev] = torch.as_tensor(grid.centers, device=dev)
        centers = centers_by_device[dev]
        hw = image_hw.float()

        fm, props = infer_proposals(model, grid, centers, images, hw)
        class_logits, box_deltas = model.detect_rois(fm, props.boxes, hw)
        class_probs = torch.softmax(class_logits, dim=-1)  # (B, S, C)

        b, s = props.boxes.shape[:2]
        anchors_ctr = box_ops.corners_to_centers(props.boxes)  # (B, S, 4)
        decoded = box_ops.decode_deltas(
            box_deltas.reshape(b, s, num_fg, 4),
            anchors_ctr[:, :, None, :],
            cfg.detector.delta_means,
            cfg.detector.delta_stds,
        )
        # Predict-time clip is to [0, dim-1].
        decoded = box_ops.clip_to_image(
            decoded, (hw[:, 0] - 1.0)[:, None, None], (hw[:, 1] - 1.0)[:, None, None]
        )
        cls_boxes = decoded.permute(0, 2, 1, 3)  # (B, C-1, S, 4)
        cls_scores = class_probs[..., 1:].permute(0, 2, 1)  # (B, C-1, S)
        keep = (cls_scores > score_threshold) & (props.valid[:, None, :] > 0)
        res = nms_ops.nms(
            cls_boxes.reshape(b * num_fg, s, 4),
            cls_scores.reshape(b * num_fg, s),
            keep.reshape(b * num_fg, s),
            iou_threshold=cfg.detector.test_nms_iou_threshold,
            max_outputs=max_det,
        )
        return Detections(
            boxes=res.boxes.reshape(b, num_fg, max_det, 4),
            scores=res.scores.reshape(b, num_fg, max_det),
            valid=res.valid.reshape(b, num_fg, max_det),
        )

    return predict


def draw_train_uniforms(cfg: ModelConfig, grid, batch_size: int, generator: torch.Generator, device) -> TrainDraws:
    """The uniforms of one train step, drawn from `generator` on `device`."""
    shapes = ((batch_size, grid.total), (batch_size, cfg.rpn.post_nms_train + cfg.max_gt_boxes))
    rpn, det = (
        tuple(torch.rand(shape, generator=generator, device=device) for _ in range(2)) for shape in shapes
    )
    return TrainDraws(rpn=rpn, detector=det)


def compute_losses(
    model: FasterRCNN,
    batch: Batch,
    grid: anchor_ops.AnchorGrid,
    draws: Optional[TrainDraws] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Losses]:
    """Loss of one padded batch, differentiable with respect to the model's
    parameters: (total, Losses), each a weighted mean over the images.

    The sampling consumes `draws`, or draws them from `generator` on the
    batch's device. Proposals come from detached RPN outputs, with the train
    caps, and the sampled boxes are constants of the RoI stage, as in the
    JAX package (the reference detaches them).
    """
    cfg = model.cfg
    dev = batch.images.device
    hw = batch.image_hw.float()
    b = hw.shape[0]
    centers = torch.as_tensor(grid.centers, device=dev)
    corners = torch.as_tensor(grid.corners, device=dev)
    if draws is None:
        draws = draw_train_uniforms(cfg, grid, b, generator, dev)

    fm, logits, deltas = model.features_and_rpn(batch.images)
    prop_mask, train_valid = proposal_masks(cfg, grid, hw)
    proposals = generate_proposals(
        logits.detach(),
        deltas.detach(),
        centers,
        prop_mask,
        hw[:, 0],
        hw[:, 1],
        cfg.rpn.pre_nms_train,
        cfg.rpn.post_nms_train,
        cfg.rpn.nms_iou_threshold,
        cfg.rpn.min_proposal_side,
    )
    gt_boxes = batch.gt_boxes.float()
    targets = anchor_ops.generate_rpn_targets(
        centers,
        corners,
        train_valid > 0,
        gt_boxes,
        batch.gt_mask,
        cfg.rpn.object_iou_threshold,
        cfg.rpn.background_iou_threshold,
    )
    minibatch = sampling_ops.sample_rpn_minibatch(
        targets.trainable,
        targets.objectness,
        cfg.rpn.minibatch_size,
        cfg.rpn.max_positive_fraction,
        draws=draws.rpn,
    )
    samples = sampling_ops.label_and_sample_proposals(
        proposals.boxes,
        proposals.valid,
        gt_boxes,
        batch.gt_classes,
        batch.gt_mask,
        cfg.detector.proposal_batch_size,
        cfg.detector.positive_fraction,
        cfg.detector.min_object_iou,
        cfg.detector.min_background_iou,
        cfg.detector.delta_means,
        cfg.detector.delta_stds,
        draws=draws.detector,
    )
    class_logits, box_deltas = model.detect_rois(fm, samples.boxes.detach(), hw)

    per_image = Losses(
        rpn_class=loss_fns.rpn_class_loss(logits, targets.objectness, minibatch),
        rpn_regression=loss_fns.rpn_regression_loss(
            deltas, targets.deltas, targets.objectness, minibatch, cfg.rpn.regression_sigma
        ),
        detector_class=loss_fns.detector_class_loss(class_logits, samples.classes, samples.weights, samples.count),
        detector_regression=loss_fns.detector_regression_loss(
            box_deltas,
            samples.classes,
            samples.deltas,
            samples.weights,
            samples.count,
            cfg.detector.regression_sigma,
        ),
    )
    # Weighted mean over images: padding images (sample_weight 0) cost
    # compute but add nothing to the loss or the gradients.
    w = batch.sample_weight.float()
    denom = w.sum() + 1e-7
    mean = Losses(*((v * w).sum() / denom for v in per_image))
    return mean.total, mean


def make_train_step(model: FasterRCNN, optimizer, canvas_h: int, canvas_w: int):
    """The train step for one canvas bucket.

    train_step(batch, draws=None, generator=None) -> Losses (detached): puts
    the model in training mode, computes the losses, back-propagates and
    calls `optimizer.step()` (see `engine.make_optimizer`), which clips,
    updates the parameters in place and advances the schedule.
    """
    grid = anchor_grid_for(model.cfg, canvas_h, canvas_w)

    def train_step(batch: Batch, draws: Optional[TrainDraws] = None, generator: Optional[torch.Generator] = None):
        if tuple(batch.images.shape[1:3]) != (canvas_h, canvas_w):
            raise ValueError(f"images {tuple(batch.images.shape)} on a {canvas_h}x{canvas_w} canvas")
        model.train()
        optimizer.zero_grad()
        total, losses = compute_losses(model, batch, grid, draws=draws, generator=generator)
        total.backward()
        optimizer.step()
        return Losses(*(v.detach() for v in losses))

    return train_step


def _truncated_normal(shape, std: float, gen: torch.Generator) -> torch.Tensor:
    """N(0, std) truncated to two standard deviations, by resampling."""
    w = torch.randn(shape, generator=gen)
    bad = w.abs() > 2.0
    while bad.any():
        w[bad] = torch.randn(int(bad.sum()), generator=gen)
        bad = w.abs() > 2.0
    return w * std


# Normal-init standard deviations by module path; every other conv/linear
# weight gets flax's lecun_normal (truncated normal, variance 1/fan_in).
_NORMAL_INIT_STD = {
    "rpn_head.conv": 0.01,
    "rpn_head.objectness": 0.01,
    "rpn_head.deltas": 0.01,
    "detector_heads.classifier": 0.01,
    "detector_heads.regressor": 0.001,
}
# Standard deviation of a unit normal truncated to [-2, 2].
_TRUNC_NORMAL_STDDEV = 0.87962566103423978


@torch.no_grad()
def init_params(model: FasterRCNN, seed: int = 0) -> None:
    """Initialize every parameter in place from a seeded torch.Generator.

    The values are drawn on the CPU, so a seed gives the same weights on
    every device. Biases are zero.
    """
    gen = torch.Generator().manual_seed(seed)
    for name, module in model.named_modules():
        if not isinstance(module, (nn.Conv2d, nn.Linear)):
            continue
        shape = tuple(module.weight.shape)
        std = _NORMAL_INIT_STD.get(name)
        if std is None:
            fan_in = int(np.prod(shape[1:]))
            w = _truncated_normal(shape, (1.0 / fan_in) ** 0.5 / _TRUNC_NORMAL_STDDEV, gen)
        else:
            w = torch.randn(shape, generator=gen) * std
        module.weight.copy_(w)
        module.bias.zero_()
