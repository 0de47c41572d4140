"""Box geometry: format conversion, IoU, delta encode/decode.

Boxes are (..., 4) with corner layout (y1, x1, y2, x2); "center" format is
(cy, cx, h, w). Delta parameterization is (ty, tx, th, tw). Every function
computes in float32, one rounded operation at a time, as the JAX package's
`ops/boxes.py` does: the NMS and anchor-labelling decisions that read these
values are strict comparisons against thresholds.
"""

from __future__ import annotations

import torch

from fasterrcnn_torch.ops import constants

EPSILON = 1e-7


def corners_to_centers(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) corners (y1,x1,y2,x2) -> centers (cy,cx,h,w)."""
    center = 0.5 * (boxes[..., 0:2] + boxes[..., 2:4])
    size = boxes[..., 2:4] - boxes[..., 0:2]
    return torch.cat([center, size], dim=-1)


def centers_to_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) centers (cy,cx,h,w) -> corners (y1,x1,y2,x2)."""
    half = 0.5 * boxes[..., 2:4]
    return torch.cat([boxes[..., 0:2] - half, boxes[..., 0:2] + half], dim=-1)


def iou_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of corner boxes: (..., N, 4) x (..., M, 4) -> (..., N, M).

    Strict well-ordering test (zero-area intersections count as no overlap)
    and an epsilon-padded union.
    """
    boxes1 = boxes1.float()
    boxes2 = boxes2.float()
    top_left = torch.maximum(boxes1[..., :, None, 0:2], boxes2[..., None, :, 0:2])
    bottom_right = torch.minimum(boxes1[..., :, None, 2:4], boxes2[..., None, :, 2:4])
    well_ordered = (top_left < bottom_right).all(dim=-1)
    intersection = well_ordered * (bottom_right - top_left).prod(dim=-1)
    areas1 = (boxes1[..., 2:4] - boxes1[..., 0:2]).prod(dim=-1)
    areas2 = (boxes2[..., 2:4] - boxes2[..., 0:2]).prod(dim=-1)
    union = areas1[..., :, None] + areas2[..., None, :] - intersection
    return intersection / (union + EPSILON)


def pairwise_iou_corners(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of two equally-shaped (..., 4) corner box tensors."""
    boxes1 = boxes1.float()
    boxes2 = boxes2.float()
    top_left = torch.maximum(boxes1[..., 0:2], boxes2[..., 0:2])
    bottom_right = torch.minimum(boxes1[..., 2:4], boxes2[..., 2:4])
    well_ordered = (top_left < bottom_right).all(dim=-1)
    intersection = well_ordered * (bottom_right - top_left).prod(dim=-1)
    areas1 = (boxes1[..., 2:4] - boxes1[..., 0:2]).prod(dim=-1)
    areas2 = (boxes2[..., 2:4] - boxes2[..., 0:2]).prod(dim=-1)
    union = areas1 + areas2 - intersection
    return intersection / (union + EPSILON)


def encode_deltas(gt_centers: torch.Tensor, anchor_centers: torch.Tensor) -> torch.Tensor:
    """Regression targets (ty,tx,th,tw) of gt boxes relative to anchors.

    Both inputs are (..., 4) in center format. No mean/std normalization.
    """
    t_center = (gt_centers[..., 0:2] - anchor_centers[..., 0:2]) / anchor_centers[..., 2:4]
    t_size = torch.log(gt_centers[..., 2:4] / anchor_centers[..., 2:4])
    return torch.cat([t_center, t_size], dim=-1)


def decode_deltas(
    deltas: torch.Tensor,
    anchor_centers: torch.Tensor,
    means=(0.0, 0.0, 0.0, 0.0),
    stds=(1.0, 1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Invert encode_deltas: (..., 4) deltas + anchors (center fmt) -> corners.

    Deltas are first de-normalized (delta * std + mean).
    """
    dev = deltas.device
    deltas = deltas.float() * constants.values(stds, dev)
    deltas = deltas + constants.values(means, dev)
    center = anchor_centers[..., 2:4] * deltas[..., 0:2] + anchor_centers[..., 0:2]
    size = anchor_centers[..., 2:4] * torch.exp(deltas[..., 2:4])
    return torch.cat([center - 0.5 * size, center + 0.5 * size], dim=-1)


def clip_to_image(boxes: torch.Tensor, image_height, image_width) -> torch.Tensor:
    """Clamp corner boxes into [0, H] x [0, W].

    image_height / image_width are numbers or tensors that broadcast against
    boxes[..., 0].
    """
    def clip(v, hi):
        hi = torch.as_tensor(hi, dtype=v.dtype, device=v.device)
        return torch.minimum(torch.clamp(v, min=0.0), hi)

    return torch.stack(
        [
            clip(boxes[..., 0], image_height),
            clip(boxes[..., 1], image_width),
            clip(boxes[..., 2], image_height),
            clip(boxes[..., 3], image_width),
        ],
        dim=-1,
    )
