"""Region Proposal Network: head module + fixed-shape proposal generation.

The head is a 3x3 conv + two 1x1 siblings (one sigmoid objectness logit and
four deltas per anchor). Proposal generation is a fixed-K program over a
batch: top K_pre by score (a stable sort, so ties go to the lower index as
`jax.lax.top_k` breaks them), decode, clip, a masked size filter, and greedy
NMS to K_post, all on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fasterrcnn_torch.models.layers import Conv2d
from fasterrcnn_torch.ops import boxes as box_ops
from fasterrcnn_torch.ops import nms as nms_ops


class RPNHead(nn.Module):
    """(B, H, W, C) feature map -> objectness logits (B, H, W, 9) and box
    deltas (B, H, W, 9*4), both f32 and NHWC."""

    def __init__(self, channels: int = 512, num_anchors: int = 9):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)
        self.objectness = Conv2d(channels, num_anchors, 1)
        self.deltas = Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feature_map: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = F.relu(self.conv(feature_map.permute(0, 3, 1, 2)))
        # Back to NHWC before any flatten: the flat order is (y, x, anchor).
        logits = self.objectness(x).permute(0, 2, 3, 1).float()
        deltas = self.deltas(x).permute(0, 2, 3, 1).float()
        return logits, deltas


class Proposals(NamedTuple):
    boxes: torch.Tensor  # (B, K_post, 4) corner boxes, score-ordered
    scores: torch.Tensor  # (B, K_post)
    valid: torch.Tensor  # (B, K_post) 1.0 = real proposal


def proposal_candidates(
    objectness_logits: torch.Tensor,
    box_deltas: torch.Tensor,
    anchor_centers: torch.Tensor,
    proposal_mask: torch.Tensor,
    image_height: torch.Tensor,
    image_width: torch.Tensor,
    pre_nms_top_k: int,
    min_side: float = 16.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The RPN NMS's input: the top `pre_nms_top_k` anchors by score,
    decoded and clipped, in descending score order -> boxes (B, K_pre, 4),
    scores (B, K_pre) and valid (B, K_pre) (eligible and at least `min_side`
    on both sides). Arguments as `generate_proposals`."""
    b, a = objectness_logits.shape
    k_pre = min(pre_nms_top_k, a)

    scores = torch.where(proposal_mask > 0, objectness_logits.float(), nms_ops.NEG_INF)
    top_scores, top_idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :k_pre], top_idx[:, :k_pre]

    deltas = torch.gather(box_deltas, 1, top_idx[:, :, None].expand(b, k_pre, 4))
    anchors = anchor_centers[top_idx]  # (B, K_pre, 4)
    boxes = box_ops.decode_deltas(deltas, anchors)
    boxes = box_ops.clip_to_image(boxes, image_height[:, None], image_width[:, None])

    # Size filter as a mask.
    heights = boxes[..., 2] - boxes[..., 0]
    widths = boxes[..., 3] - boxes[..., 1]
    size_ok = (heights >= min_side) & (widths >= min_side)
    valid = (top_scores > nms_ops.NEG_INF) & size_ok
    return boxes, top_scores, valid


def generate_proposals(
    objectness_logits: torch.Tensor,
    box_deltas: torch.Tensor,
    anchor_centers: torch.Tensor,
    proposal_mask: torch.Tensor,
    image_height: torch.Tensor,
    image_width: torch.Tensor,
    pre_nms_top_k: int,
    post_nms_top_k: int,
    nms_iou_threshold: float = 0.7,
    min_side: float = 16.0,
) -> Proposals:
    """Fixed-shape proposal generation for a batch of images.

    Args:
      objectness_logits: (B, A) raw logits, flattened (y, x, anchor) order.
      box_deltas: (B, A, 4) predicted (ty, tx, th, tw).
      anchor_centers: (A, 4) anchors in center format.
      proposal_mask: (B, A) anchors eligible to produce proposals.
      image_height / image_width: (B,) real image extents (clip targets).
      pre_nms_top_k / post_nms_top_k: static caps.

    Returns score-ordered padded proposals: `proposal_candidates`, then
    greedy NMS.
    """
    boxes, top_scores, valid = proposal_candidates(
        objectness_logits, box_deltas, anchor_centers, proposal_mask, image_height, image_width,
        pre_nms_top_k, min_side,
    )
    result = nms_ops.nms(
        boxes,
        top_scores,
        valid,
        iou_threshold=nms_iou_threshold,
        max_outputs=post_nms_top_k,
        presorted=True,  # the sort above already ordered them
    )
    return Proposals(
        boxes=result.boxes,
        scores=torch.sigmoid(result.scores) * result.valid,
        valid=result.valid,
    )
