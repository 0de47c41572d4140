"""Anchor grid generation, per-image anchor masks and RPN target assignment.

The anchor grid is built once per canvas bucket in NumPy; the real image
occupies the top-left corner of the canvas, and anchors over padding are
masked at run time from the real image size. RPN ground truth is assigned on
the device, over a batch of padded gt boxes (`generate_rpn_targets`).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from fasterrcnn_torch.config import AnchorConfig
from fasterrcnn_torch.ops import boxes as box_ops


def anchor_sizes(cfg: AnchorConfig = AnchorConfig()) -> np.ndarray:
    """(num_anchors, 2) array of (height, width) anchor sizes in pixels.

    For area a and x-aspect r: width = sqrt(a / r), height = r * width.
    """
    sizes = []
    for area in cfg.areas:
        for r in cfg.aspect_ratios:
            w = math.sqrt(area / r)
            sizes.append((r * w, w))
    return np.array(sizes, dtype=np.float64)


class AnchorGrid(NamedTuple):
    """Static per-canvas anchor constants (A = fm_height * fm_width * 9)."""

    centers: np.ndarray  # (A, 4) float32, (cy, cx, h, w) in image pixels
    corners: np.ndarray  # (A, 4) float32, (y1, x1, y2, x2)
    fm_height: int
    fm_width: int
    num_anchors_per_cell: int

    @property
    def total(self) -> int:
        return self.fm_height * self.fm_width * self.num_anchors_per_cell


@functools.lru_cache(maxsize=64)
def generate_anchor_grid(
    fm_height: int, fm_width: int, cfg: AnchorConfig = AnchorConfig()
) -> AnchorGrid:
    """Build the full anchor set for a feature map of the given static shape.

    Anchors are centered at ((i + 0.5) * stride, (j + 0.5) * stride).
    Centers are rounded to f32 before the f64 size template is added, then
    the result is rounded to f32: anchor labelling is sensitive to this.
    """
    sizes = anchor_sizes(cfg)  # (k, 2) float64
    k = sizes.shape[0]
    stride = float(cfg.feature_pixels)

    ys = (np.arange(fm_height, dtype=np.float64) + 0.5) * stride
    xs = (np.arange(fm_width, dtype=np.float64) + 0.5) * stride
    cy, cx = np.meshgrid(ys, xs, indexing="ij")  # (H, W)
    centers_yx = np.stack([cy, cx], axis=-1).astype(np.float32)  # f32 rounding first
    centers_yx = centers_yx[:, :, None, :].astype(np.float64)  # (H, W, 1, 2)

    half = 0.5 * sizes  # (k, 2) f64
    y1x1 = centers_yx - half[None, None, :, :]
    y2x2 = centers_yx + half[None, None, :, :]
    corners64 = np.concatenate([y1x1, y2x2], axis=-1).reshape(-1, 4)  # f64

    centers64 = np.empty_like(corners64)
    centers64[:, 0:2] = 0.5 * (corners64[:, 0:2] + corners64[:, 2:4])
    centers64[:, 2:4] = corners64[:, 2:4] - corners64[:, 0:2]

    return AnchorGrid(
        centers=centers64.astype(np.float32),
        corners=corners64.astype(np.float32),
        fm_height=fm_height,
        fm_width=fm_width,
        num_anchors_per_cell=k,
    )


def anchor_validity(corners: torch.Tensor, image_height, image_width) -> torch.Tensor:
    """(..., A) bool: anchor lies fully inside the real image.

    corners is (A, 4); image_height / image_width are numbers or tensors of
    shape (...,), one per image.
    """
    h = torch.as_tensor(image_height, dtype=torch.float32, device=corners.device)[..., None]
    w = torch.as_tensor(image_width, dtype=torch.float32, device=corners.device)[..., None]
    return (
        (corners[:, 0] >= 0.0)
        & (corners[:, 1] >= 0.0)
        & (corners[:, 2] <= h)
        & (corners[:, 3] <= w)
    )


def anchor_exists(grid: AnchorGrid, real_fm_height, real_fm_width, device="cpu") -> torch.Tensor:
    """(..., A) bool: anchor's cell lies inside the *real* feature grid.

    real_fm_height / real_fm_width are numbers or int tensors of shape (...,);
    cells over canvas padding are excluded from proposals.
    """
    idx = torch.arange(grid.total, dtype=torch.int64, device=device)
    cell_y = idx // (grid.fm_width * grid.num_anchors_per_cell)
    cell_x = (idx // grid.num_anchors_per_cell) % grid.fm_width
    fh = torch.as_tensor(real_fm_height, device=device)[..., None]
    fw = torch.as_tensor(real_fm_width, device=device)[..., None]
    return (cell_y < fh) & (cell_x < fw)


class RPNTargets(NamedTuple):
    trainable: torch.Tensor  # (B, A) f32: 1 if anchor is a definite pos/neg sample
    objectness: torch.Tensor  # (B, A) f32: 1 = object, 0 = background/ignored
    deltas: torch.Tensor  # (B, A, 4) f32: (ty, tx, th, tw) vs assigned gt box


def generate_rpn_targets(
    anchor_centers: torch.Tensor,
    anchor_corners: torch.Tensor,
    anchor_valid: torch.Tensor,
    gt_corners: torch.Tensor,
    gt_mask: torch.Tensor,
    object_iou_threshold: float = 0.7,
    background_iou_threshold: float = 0.3,
) -> RPNTargets:
    """RPN ground-truth assignment for a batch, over padded gt boxes.

    anchor_centers / anchor_corners: (A, 4); anchor_valid: (B, A);
    gt_corners: (B, G, 4) padded; gt_mask: (B, G), 1 for real boxes.

    * anchors crossing the image (invalid) get IoU -1, padded gt columns -2,
      so a padded box never wins an argmax nor joins the tie test below;
    * IoU < background threshold => background; >= object threshold => object;
    * for every real gt box, all valid anchors equal to its best IoU are
      forced positive (an equality test, kept even for a gt box that
      overlaps nothing);
    * each anchor regresses to its best-IoU gt box (first on ties); non-finite
      deltas (degenerate assignments, masked out in the loss) become 0.
    """
    anchor_valid = anchor_valid.bool()
    gt_real = gt_mask.bool()
    ious = box_ops.iou_matrix(anchor_corners[None], gt_corners)  # (B, A, G)
    ious = torch.where(anchor_valid[:, :, None], ious, -1.0)
    ious = torch.where(gt_real[:, None, :], ious, -2.0)

    max_iou_per_anchor = ious.amax(dim=2)  # (B, A)
    best_gt_per_anchor = ious.argmax(dim=2)  # the first max, as jnp.argmax
    max_iou_per_gt = ious.amax(dim=1)  # (B, G)
    forced = ((ious == max_iou_per_gt[:, None, :]) & gt_real[:, None, :]).any(dim=2)
    forced = forced & anchor_valid

    label = torch.full_like(best_gt_per_anchor, -1)
    label = torch.where(max_iou_per_anchor < background_iou_threshold, 0, label)
    label = torch.where(max_iou_per_anchor >= object_iou_threshold, 1, label)
    label = torch.where(forced, 1, label)

    trainable = (anchor_valid & (label >= 0)).float()
    objectness = (label == 1).float()
    assigned = torch.gather(gt_corners, 1, best_gt_per_anchor[:, :, None].expand(-1, -1, 4))
    deltas = box_ops.encode_deltas(box_ops.corners_to_centers(assigned), anchor_centers[None])
    deltas = torch.where(torch.isfinite(deltas), deltas, 0.0)
    return RPNTargets(trainable=trainable, objectness=objectness, deltas=deltas)


def real_feature_map_size(
    image_height, image_width, feature_pixels: int, ceil_mode: bool
) -> Tuple:
    """Feature-grid extent of the real image: floor division for VGG-16,
    ceil for ResNet. Works on ints and integer tensors."""
    if ceil_mode:
        fh = -(-image_height // feature_pixels)
        fw = -(-image_width // feature_pixels)
    else:
        fh = image_height // feature_pixels
        fw = image_width // feature_pixels
    return fh, fw
