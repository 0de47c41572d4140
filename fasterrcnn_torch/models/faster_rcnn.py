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
import torch.distributed as dist
from torch import nn

from fasterrcnn_torch.config import ModelConfig
from fasterrcnn_torch.models.backbone import get_backbone, normalize_images
from fasterrcnn_torch.models import losses as loss_fns
from fasterrcnn_torch.models.detector import DetectorHeads
from fasterrcnn_torch.models.resnet import FrozenBatchNorm
from fasterrcnn_torch.models.rpn import RPNHead, generate_proposals
from fasterrcnn_torch.ops import anchors as anchor_ops
from fasterrcnn_torch.ops import boxes as box_ops
from fasterrcnn_torch.ops import constants
from fasterrcnn_torch.ops import nms as nms_ops
from fasterrcnn_torch.ops import roi as roi_ops
from fasterrcnn_torch.ops import sampling as sampling_ops
from fasterrcnn_torch.parallel import tp


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
        if cfg.roi_mode not in ("crop", "exact_pool"):
            raise ValueError(f"roi_mode={cfg.roi_mode!r}: expected 'crop' or 'exact_pool'")
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
        Returns (B, S, C) class logits and (B, S, 4*(C-1)) box deltas. The
        pooling is the crop (`roi_pool_taps`, K2 and K3 on a card) or, for
        roi_mode "exact_pool", torchvision's RoIPool (`roi_pool_exact`, on
        the whole canvas map at 1 / feature_pixels; no norm).
        """
        if self.cfg.roi_mode == "exact_pool":
            pooled = roi_ops.roi_pool_exact(fm, roi_boxes, 1.0 / self.spec.feature_pixels, roi_ops.OUTPUT_SIZE)
        else:
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
    corners = constants.array(grid.corners, dev)
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

    @torch.inference_mode()
    def predict(images: torch.Tensor, image_hw: torch.Tensor, score_threshold: float = 0.05):
        if tuple(images.shape[1:3]) != (canvas_h, canvas_w):
            raise ValueError(f"images {tuple(images.shape)} on a {canvas_h}x{canvas_w} canvas")
        model.eval()
        centers = constants.array(grid.centers, images.device)
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


def draw_train_uniforms(cfg: ModelConfig, grid, batch_size: int, generator: torch.Generator, device,
                        shard: Tuple[int, int] = (0, 1)) -> TrainDraws:
    """The uniforms of one train step, drawn from `generator` on `device`.

    shard = (dp index, dp): the step's batch is dp * batch_size images, of
    which this rank's dp row holds rows dp_index * batch_size onwards.
    Every rank draws the whole batch's uniforms from its generator (seeded
    alike on every rank) and keeps its rows, so an image draws what it
    draws on one device, as JAX's per-image keys split from the step's
    key."""
    index, dp = shard
    rows = slice(index * batch_size, (index + 1) * batch_size)
    shapes = ((dp * batch_size, grid.total), (dp * batch_size, cfg.rpn.post_nms_train + cfg.max_gt_boxes))
    rpn, det = (
        tuple(torch.rand(shape, generator=generator, device=device)[rows] for _ in range(2)) for shape in shapes
    )
    return TrainDraws(rpn=rpn, detector=det)


def compute_losses(
    model: FasterRCNN,
    batch: Batch,
    grid: anchor_ops.AnchorGrid,
    draws: Optional[TrainDraws] = None,
    generator: Optional[torch.Generator] = None,
    denominator: Optional[torch.Tensor] = None,
    shard: Tuple[int, int] = (0, 1),
) -> Tuple[torch.Tensor, Losses]:
    """Loss of one padded batch, differentiable with respect to the model's
    parameters: (total, Losses), each a weighted mean over the images.

    The sampling consumes `draws`, or draws them from `generator` on the
    batch's device. Proposals come from detached RPN outputs, with the train
    caps, and the sampled boxes are constants of the RoI stage, as in the
    JAX package (the reference detaches them).

    Under data parallelism `batch` is one dp row's rows of the step's batch
    and shard = (dp index, dp) (see `draw_train_uniforms`); `denominator` is
    then the whole batch's sum of sample weights plus 1e-7 (a 0-d tensor the
    host computes), so that the ranks' losses, and their gradients, sum to
    those of the whole batch. By default it is this batch's own.
    """
    cfg = model.cfg
    dev = batch.images.device
    hw = batch.image_hw.float()
    b = hw.shape[0]
    centers = constants.array(grid.centers, dev)
    corners = constants.array(grid.corners, dev)
    if draws is None:
        draws = draw_train_uniforms(cfg, grid, b, generator, dev, shard)

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
    denom = w.sum() + 1e-7 if denominator is None else denominator
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
        return _optimizer_step(model, optimizer, batch, grid, draws, generator)

    return train_step


def _optimizer_step(model: FasterRCNN, optimizer, batch: Batch, grid, draws=None, generator=None) -> Losses:
    """Training mode, the losses, their backward and one optimizer step;
    the detached losses. Every train step of the module runs this."""
    model.train()
    optimizer.zero_grad()
    total, losses = compute_losses(model, batch, grid, draws=draws, generator=generator)
    total.backward()
    optimizer.step()
    return Losses(*(v.detach() for v in losses))


# ---------------------------------------------------------------------------
# Packed train steps (the production Engine path)
# ---------------------------------------------------------------------------
#
# The JAX package folds everything of a batch but its uint8 images into one
# (B, aux_width) f32 array, step index included, so that one step is two
# uploads and one program. The port keeps that layout column for column. A
# step is one program here too: on a CUDA device each make_train_step_* captures
# its body in a CUDA graph at the first call and replays it after.


def aux_width(max_gt: int) -> int:
    """Columns of the packed aux array: hw(2) + boxes(4G) + classes(G) +
    mask(G) + sample_weight(1) + step_idx(1)."""
    return 2 + 6 * max_gt + 2


def pack_aux(hb, step_idx: int) -> np.ndarray:
    """Host-side packing of everything in Batch except images.

    gt classes (< 21) and the step index (< 2^24) are exact in f32.
    """
    b = hb.images.shape[0]
    g = hb.gt_boxes.shape[1]
    return np.concatenate(
        [
            np.asarray(hb.image_hw, np.float32),
            np.asarray(hb.gt_boxes, np.float32).reshape(b, g * 4),
            np.asarray(hb.gt_classes, np.float32),
            np.asarray(hb.gt_mask, np.float32),
            np.asarray(hb.sample_weight, np.float32).reshape(b, 1),
            np.full((b, 1), float(step_idx), np.float32),
        ],
        axis=1,
    )


def unpack_aux(images: torch.Tensor, aux: torch.Tensor, max_gt: int) -> Tuple[Batch, torch.Tensor]:
    """(images (B,H,W,3) uint8, aux (B, aux_width) f32) -> (Batch, step
    index as a 0-d int32 tensor), views of `aux` where the types allow."""
    g = max_gt
    b = aux.shape[0]
    if aux.shape[1] != aux_width(g):
        raise ValueError(f"packed aux width {aux.shape[1]} != aux_width({g})={aux_width(g)}")
    batch = Batch(
        images=images,
        image_hw=aux[:, 0:2],
        gt_boxes=aux[:, 2 : 2 + 4 * g].reshape(b, g, 4),
        gt_classes=aux[:, 2 + 4 * g : 2 + 5 * g].to(torch.int32),
        gt_mask=aux[:, 2 + 5 * g : 2 + 6 * g],
        sample_weight=aux[:, 2 + 6 * g],
    )
    return batch, aux[0, 2 + 6 * g + 1].to(torch.int32)


# The kernel wrappers of the train path. Each counts its launches in Python,
# so a graph replay would add nothing: CapturedStep adds what its capture
# counted once a replay.
LAUNCH_COUNTERS = (nms_ops.nms_keep_mask, roi_ops.roi_pool_taps, roi_ops.roi_pool_taps_bwd)


def train_tensors(model: nn.Module, optimizer) -> list:
    """Every tensor a train step writes: parameters, buffers, optimizer state."""
    return [*model.parameters(), *model.buffers(), *optimizer.state_tensors()]


def snapshot_train_state(model: nn.Module, optimizer, generators=(), extra=()):
    """Copy everything a train step writes (`train_tensors`, the tensors of
    `extra`, the generators' states and the model's device's default
    generator) and return a function that puts it back."""
    tensors = train_tensors(model, optimizer) + list(extra)
    saved = [t.detach().clone() for t in tensors]
    dev = tensors[0].device
    gens = [(g, g.get_state()) for g in generators]
    default = torch.cuda.get_rng_state(dev) if dev.type == "cuda" else torch.get_rng_state()

    @torch.no_grad()
    def restore():
        for t, v in zip(tensors, saved):
            t.copy_(v)
        for g, state in gens:
            g.set_state(state)
        if dev.type == "cuda":
            torch.cuda.set_rng_state(default, dev)
        else:
            torch.set_rng_state(default)

    return restore


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: Tuple[torch.Tensor, ...]  # static input buffers
    output: torch.Tensor  # static output


class CapturedStep:
    """A train-step body, `body(*inputs) -> tensor`, run as one program.

    On a CPU model the body runs eagerly on the inputs. On a CUDA model the
    first call at each set of input shapes copies the inputs into static
    buffers, runs the body once eagerly on a side stream (the warm-up
    PyTorch's capture recipe asks for: cuDNN and cuBLAS pick and allocate
    there) and puts back every parameter, optimizer state and generator
    state it moved, so the warm-up adds no step; then it captures the body
    in a `torch.cuda.CUDAGraph` with `generator` registered (its draws
    advance at each replay as they would eagerly, and so do the default
    generator's) and memory from `pool`. Each call, the first included,
    copies its inputs into the static buffers of its shapes' graph, replays
    it and returns a copy of the output. A capture that fails raises;
    nothing falls back to running eagerly.

    Runs eagerly on a CUDA device only where it must, and says so in
    `captured` (False): under autograd anomaly mode (`utils/profiling.
    nan_guard`: its checks read values on the host), for roi_mode
    "exact_pool" (`ops/roi.roi_pool_exact` sizes its gathers from the data)
    and for a body that holds collectives (`collectives=True`: a CUDA
    graph holds no gloo collective; `DataParallelStep`'s gradient part on a
    tp mesh).

    `graphs` maps input shapes to their graph; `launches` maps each kernel
    of `LAUNCH_COUNTERS` to the launches one replay holds (added to the
    wrapper's count at each replay); `replays` counts the replays. `state`
    names tensors besides `train_tensors` that the body writes: the warm-up
    puts them back too.
    """

    def __init__(self, body, model: FasterRCNN, optimizer, generator: Optional[torch.Generator] = None,
                 pool=None, state: Tuple[torch.Tensor, ...] = (), collectives: bool = False):
        self.body = body
        self.collectives = collectives
        self.model = model
        self.optimizer = optimizer
        self.generator = generator
        self.pool = pool
        self.state = state
        self.device = next(model.parameters()).device
        self.graphs: Dict[Tuple[Tuple[int, ...], ...], _Graph] = {}
        self.launches: Dict[str, int] = {}
        self.replays = 0

    @property
    def captured(self) -> bool:
        return self.model.cfg.roi_mode != "exact_pool" and not self.collectives and not torch.is_anomaly_enabled()

    def __call__(self, *inputs: torch.Tensor) -> torch.Tensor:
        if self.device.type != "cuda" or not self.captured:
            return self.body(*inputs)
        key = tuple(tuple(x.shape) for x in inputs)
        if key not in self.graphs:
            self.graphs[key] = self._capture(inputs)
        graph = self.graphs[key]
        for static, x in zip(graph.inputs, inputs):
            static.copy_(x)
        graph.graph.replay()
        for fn in LAUNCH_COUNTERS:
            fn.launches += self.launches[fn.__name__]
        self.replays += 1
        return graph.output.clone()

    def _capture(self, inputs) -> _Graph:
        static = tuple(x.clone() for x in inputs)
        gens = () if self.generator is None else (self.generator,)
        restore = snapshot_train_state(self.model, self.optimizer, gens, self.state)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.body(*static)
        torch.cuda.current_stream().wait_stream(side)
        restore()
        before = {fn.__name__: fn.launches for fn in LAUNCH_COUNTERS}
        graph = torch.cuda.CUDAGraph()
        for g in gens:
            graph.register_generator_state(g)
        try:
            # thread_local: the prefetch thread's uploads (pinned buffers,
            # event queries) go on during the capture, off its stream.
            with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
                output = self.body(*static)
        except RuntimeError as err:
            raise RuntimeError(f"capturing the train step in a CUDA graph failed: {err}") from err
        finally:
            # The capture recorded launches; it ran none.
            self.launches = {fn.__name__: fn.launches - before[fn.__name__] for fn in LAUNCH_COUNTERS}
            for fn in LAUNCH_COUNTERS:
                fn.launches = before[fn.__name__]
        return _Graph(graph, static, output)


def _packed_body(model: FasterRCNN, optimizer, grid, generator):
    """One optimizer step on a packed batch -> its (4,) loss vector."""
    cfg = model.cfg

    def step(images: torch.Tensor, aux: torch.Tensor) -> torch.Tensor:
        batch, _ = unpack_aux(images, aux, cfg.max_gt_boxes)
        return torch.stack(list(_optimizer_step(model, optimizer, batch, grid, generator=generator)))

    return step


def make_train_step_packed(model: FasterRCNN, optimizer, canvas_h: int, canvas_w: int,
                           generator: Optional[torch.Generator] = None, pool=None):
    """Packed-aux twin of make_train_step (the same loss graph by
    construction: both call compute_losses; the sampling draws from
    `generator`). Returns step(images (B,H,W,3) uint8, aux (B, aux_width)
    f32) -> (Losses, loss_vec (4,)), one `CapturedStep` on a CUDA device."""
    body = _packed_body(model, optimizer, anchor_grid_for(model.cfg, canvas_h, canvas_w), generator)
    captured = CapturedStep(body, model, optimizer, generator, pool)

    def step(images: torch.Tensor, aux: torch.Tensor):
        if tuple(images.shape[1:3]) != (canvas_h, canvas_w):
            raise ValueError(f"images {tuple(images.shape)} on a {canvas_h}x{canvas_w} canvas")
        loss_vec = captured(images, aux)
        return Losses(*loss_vec), loss_vec

    step.captured_step = captured
    return step


def make_train_step_scan(model: FasterRCNN, optimizer, canvas_h: int, canvas_w: int, k: int,
                         generator: Optional[torch.Generator] = None, pool=None):
    """K optimizer steps per call: the packed step K times in one program.

    Semantics are those of K sequential make_train_step_packed calls by
    construction: the body is the packed step's body on each of the K
    batches in turn. On a CUDA device the K steps are one CUDA graph (one
    replay, K steps' kernels). Returns step(images_k (K,B,H,W,3) uint8,
    aux_k (K,B,aux_width) f32) -> loss_block (K, 4).
    """
    one = _packed_body(model, optimizer, anchor_grid_for(model.cfg, canvas_h, canvas_w), generator)

    def body(images_k: torch.Tensor, aux_k: torch.Tensor) -> torch.Tensor:
        return torch.stack([one(images_k[i], aux_k[i]) for i in range(k)])

    captured = CapturedStep(body, model, optimizer, generator, pool)

    def step(images_k: torch.Tensor, aux_k: torch.Tensor) -> torch.Tensor:
        if images_k.shape[0] != k or tuple(images_k.shape[2:4]) != (canvas_h, canvas_w):
            raise ValueError(f"images {tuple(images_k.shape)}: expected {k} batches on a {canvas_h}x{canvas_w} canvas")
        return captured(images_k, aux_k)

    step.captured_step = captured
    return step


class DataParallelStep:
    """One optimizer step of a rank of a (dp, tp) mesh, on its dp row's rows
    of the step's batch, for one canvas bucket.

    The JAX package's mesh step is one program in which XLA places the
    collectives. Here a step has these parts, because a CUDA graph cannot
    hold a collective over gloo:

      1. `grad`: training mode, this rank's losses over the whole batch's
         denominator (`compute_losses(denominator=, shard=(dp index,
         dp))`) and their backward, the tp collectives inside it
         (`parallel/tp.py`) on a tp mesh; the gradient of every trainable
         parameter this rank holds (its shard of a tp-sharded one; zeros
         for one the backward leaves without) and the four partial losses
         are written into `flat`, one buffer;
      2. the SUM all-reduce of `flat` over the dp group (the ranks of this
         rank's tp column; none when dp is 1): the gradients of the whole
         batch's loss, and its four losses. On a tp mesh `flat` holds the
         replicated parameters' gradients first: they are summed over
         every rank and divided by tp instead (`tp.average_replicated`),
         as the ranks of a dp row compute them alike only up to the card's
         nondeterministic reductions (K3's atomics, cuDNN's backward), so
         that every rank applies one gradient to them;
      3. on a tp mesh with clipping, `TrainOptimizer.reduce_tp_squares`:
         the sharded gradients' sums of squares, summed over the tp group,
         into a buffer the update reads;
      4. `update`: the reduced gradients become the parameters' `.grad`
         (a parameter the backward left without one keeps none, as on one
         device), then `optimizer.step()` (clipping by the group's global
         norm, decay, the update) and a copy of the reduced losses.

    Every rank of a tp column applies the same update to its shards, and
    every rank the same update to the replicated parameters, so those stay
    identical bit for bit on every rank. On a
    CUDA model `update` is a CapturedStep (a CUDA graph) and so is `grad`
    on a mesh of tp=1; on a tp mesh `grad` runs eagerly, a rule the mesh
    sets, as exact RoIPool's: its tp collectives run over gloo, or over
    nccl uncaptured. On the CPU every part runs eagerly. One instance serves
    the packed step and the K-step block: a block is K steps, each with its
    all-reduce.

    `packed(images (b,H,W,3) uint8, aux (b, aux_width) f32, denominator
    (0-d f32)) -> (Losses, (4,) losses)`; `block` runs K of them on (K, ...)
    stacks -> (K, 4); `eager(batch, denominator)` runs one step on a
    Batch, uncaptured.
    """

    def __init__(self, model: FasterRCNN, optimizer, canvas_h: int, canvas_w: int, mesh,
                 generator: Optional[torch.Generator] = None, pool=None):
        cfg = model.cfg
        grid = anchor_grid_for(cfg, canvas_h, canvas_w)
        trained = [p for p in model.parameters() if p.requires_grad]
        # The replicated parameters first, then (on a tp mesh) the shards.
        replicated = [p for p in trained if not getattr(p, "tp_sharded", False)]
        params = replicated + [p for p in trained if getattr(p, "tp_sharded", False)]
        sizes = [p.numel() for p in params]
        self.mesh = mesh
        self.optimizer = optimizer
        self.replicated = sum(p.numel() for p in replicated)
        self.flat = torch.zeros(sum(sizes) + 4, device=params[0].device)
        views = [v.view(p.shape) for v, p in zip(torch.split(self.flat[:-4], sizes), params)]
        reduced_losses = self.flat[-4:]
        live: list = []

        def grad(batch: Batch, denominator: torch.Tensor) -> torch.Tensor:
            model.train()
            optimizer.zero_grad()
            total, losses = compute_losses(model, batch, grid, generator=generator, denominator=denominator,
                                           shard=(mesh.dp_index, mesh.dp))
            total.backward()
            live[:] = [p.grad is not None for p in params]
            for p, v in zip(params, views):
                if p.grad is None:
                    v.zero_()
                else:
                    v.copy_(p.grad)
            reduced_losses.copy_(torch.stack([v.detach() for v in losses]))
            return reduced_losses

        def attach() -> None:
            for p, v, has_grad in zip(params, views, live):
                p.grad = v if has_grad else None

        def update() -> torch.Tensor:
            attach()
            optimizer.step()
            return reduced_losses.clone()

        def grad_packed(images, aux, denominator):
            return grad(unpack_aux(images, aux, cfg.max_gt_boxes)[0], denominator)

        self._grad, self._update, self._attach = grad, update, attach
        self.grad = CapturedStep(grad_packed, model, optimizer, generator, pool, state=(self.flat,),
                                 collectives=mesh.tp > 1)
        self.update = CapturedStep(update, model, optimizer, None, pool, state=(self.flat,))

    def reduce(self) -> None:
        """The dp all-reduce of `flat` (on a tp mesh, of its shards and
        losses, and the replicated gradients' average); then, on a tp mesh,
        the sums of squares the clipping norm needs from the tp group."""
        mesh = self.mesh
        if mesh.tp == 1:
            if mesh.dp > 1:
                dist.all_reduce(self.flat, group=mesh.dp_group)
            return
        tp.average_replicated(self.flat[:self.replicated], mesh)
        if mesh.dp > 1:
            dist.all_reduce(self.flat[self.replicated:], group=mesh.dp_group)
        if self.optimizer.clipnorm > 0:
            self._attach()
            self.optimizer.reduce_tp_squares(self.mesh.tp_group)

    def packed(self, images: torch.Tensor, aux: torch.Tensor, denominator: torch.Tensor):
        self.grad(images, aux, denominator)
        self.reduce()
        loss_vec = self.update()
        return Losses(*loss_vec), loss_vec

    def block(self, images_k: torch.Tensor, aux_k: torch.Tensor, denominators: torch.Tensor) -> torch.Tensor:
        return torch.stack([self.packed(images_k[i], aux_k[i], denominators[i])[1] for i in range(images_k.shape[0])])

    def eager(self, batch: Batch, denominator: torch.Tensor) -> Losses:
        self._grad(batch, denominator)
        self.reduce()
        return Losses(*self._update())


def _truncated_normal(shape, std: float, gen: torch.Generator) -> torch.Tensor:
    """N(0, std) truncated to two standard deviations, by resampling: each
    round draws one value for every position still out of range, in index
    order. Only those positions are checked again (the others stay)."""
    w = torch.randn(shape, generator=gen)
    flat = w.view(-1)
    bad = (flat.abs() > 2.0).nonzero().squeeze(1)
    while bad.numel():
        flat[bad] = torch.randn(bad.numel(), generator=gen)
        bad = bad[flat[bad].abs() > 2.0]
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
    every device. Biases are zero. Frozen BatchNorms are the identity, except
    each ResNet bottleneck's bn3 under `train_all`, whose scale is 0: every
    residual branch starts closed, the JAX package's from-scratch init.
    """
    gen = torch.Generator().manual_seed(seed)
    for name, module in model.named_modules():
        if isinstance(module, FrozenBatchNorm):
            closed = model.cfg.train_all and name.endswith(".bn3")
            module.scale.fill_(0.0 if closed else 1.0)
            module.bias.zero_()
            continue
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
        if module.bias is not None:
            module.bias.zero_()
