"""Static configuration for the Faster R-CNN model and training loop.

The same frozen, hashable dataclasses and defaults as the JAX package's
`fasterrcnn_tpu/config.py`, so one `ModelConfig` describes the same model in
both packages. The one difference: the compute type is a `torch.dtype`
(`ModelConfig.torch_dtype`).

Hyperparameter provenance (the reference's pytorch/FasterRCNN tree):
  * anchor areas/aspects:      models/anchors.py:33-34
  * RPN IoU thresholds:        models/anchors.py:137
  * pre/post-NMS proposal caps models/faster_rcnn.py:124-125,302-303
  * RPN NMS IoU 0.7:           models/rpn.py:147-151
  * min proposal side 16px:    models/rpn.py:139-144
  * per-class test NMS 0.3:    models/faster_rcnn.py:213-226
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    """Anchor pyramid: 3 areas x 3 aspect ratios = 9 anchors per cell."""

    areas: Tuple[float, ...] = (128.0 * 128.0, 256.0 * 256.0, 512.0 * 512.0)
    aspect_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    feature_pixels: int = 16  # stride of the backbone feature map

    @property
    def num_anchors(self) -> int:
        return len(self.areas) * len(self.aspect_ratios)


@dataclasses.dataclass(frozen=True)
class RPNConfig:
    object_iou_threshold: float = 0.7
    background_iou_threshold: float = 0.3
    nms_iou_threshold: float = 0.7
    pre_nms_train: int = 12000
    post_nms_train: int = 2000
    pre_nms_infer: int = 6000
    post_nms_infer: int = 300
    minibatch_size: int = 256
    max_positive_fraction: float = 0.5  # at most half of the minibatch positive
    min_proposal_side: float = 16.0
    regression_sigma: float = 3.0


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    proposal_batch_size: int = 128
    positive_fraction: float = 0.25
    min_background_iou: float = 0.0
    min_object_iou: float = 0.5
    delta_means: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    delta_stds: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    test_nms_iou_threshold: float = 0.3
    # Per-class detection rows in the fixed-shape predict output; 0 means one
    # row per proposal (rpn.post_nms_infer), which keeps every survivor.
    max_detections_per_class: int = 0
    regression_sigma: float = 1.0
    dropout: float = 0.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    num_classes: int = 21  # VOC: background + 20 object classes
    backbone: str = "vgg16"
    anchors: AnchorConfig = AnchorConfig()
    rpn: RPNConfig = RPNConfig()
    detector: DetectorConfig = DetectorConfig()
    # Keep proposals from image-boundary-crossing anchors (reference default).
    allow_edge_proposals: bool = True
    max_gt_boxes: int = 56
    # Compute type of the conv/matmul layers: "float32" or "bfloat16".
    compute_dtype: str = "float32"
    # "crop" = 14x14 bilinear crop + 2x2 max pool; "exact_pool" = torchvision
    # RoIPool quantization (--custom-roi-pool), for RoIPool-trained checkpoints.
    roi_mode: str = "crop"
    train_all: bool = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 5e-4
    epochs: int = 1
    augment: bool = True
    batch_size: int = 1
    clipnorm: float = 0.0
    optimizer: str = "sgd"  # "sgd" or "adam"
    beta1: float = 0.9
    beta2: float = 0.999
    lr_schedule: str = "constant"  # "constant" or "cosine"
    warmup_steps: int = 0
    total_steps: int = 0


# Canvas buckets: every preprocessed image (shorter side scaled to 600) is
# padded into the smallest fitting (height, width) canvas, so the model sees
# a small fixed set of shapes. Sides are multiples of 32.
CANVAS_BUCKETS: Tuple[Tuple[int, int], ...] = (
    (128, 160),  # tiny smoke-test bucket (never hit by min-side-600 VOC data)
    (160, 128),
    (608, 608),
    (608, 800),
    (800, 608),
    (608, 928),
    (928, 608),
    (608, 1120),
    (1120, 608),
    (608, 1600),
    (1600, 608),
)


def select_canvas(height: int, width: int) -> Tuple[int, int]:
    """Smallest canvas bucket that fits an (height, width) image."""
    best = None
    for ch, cw in CANVAS_BUCKETS:
        if ch >= height and cw >= width:
            area = ch * cw
            if best is None or area < best[0]:
                best = (area, (ch, cw))
    if best is None:
        raise ValueError(f"No canvas bucket fits image of size {height}x{width}")
    return best[1]
