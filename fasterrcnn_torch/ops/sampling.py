"""On-device minibatch sampling for RPN anchors and detector proposals.

The JAX package's `ops/sampling.py`, batched over images: "sample k of a
masked set uniformly without replacement" is "draw one uniform per element,
rank within the masked set, keep rank < k", with fixed shapes throughout.

The uniform draws are an argument. `jax.random` bits cannot be reproduced in
PyTorch, so each sampling function takes either the draws (the tests feed it
those JAX made from its keys) or a `torch.Generator` on the device to draw
them. Ties follow JAX: `jnp.argsort` is stable (stable sort here),
`jax.lax.top_k` puts equal values in index order (a stable descending sort
here), `jnp.argmax` returns the first max (as `torch.argmax`), and
`jnp.round` rounds half to even (as `torch.round`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from fasterrcnn_torch.ops import boxes as box_ops
from fasterrcnn_torch.ops import constants

Draws = Tuple[torch.Tensor, torch.Tensor]  # uniforms for the positive and negative draws


def _uniforms(
    draws: Optional[Draws], shape, device, generator: Optional[torch.Generator]
) -> Draws:
    if draws is not None:
        for u in draws:
            if tuple(u.shape) != tuple(shape):
                raise ValueError(f"draws of shape {tuple(u.shape)}, expected {tuple(shape)}")
        return draws
    return tuple(torch.rand(shape, generator=generator, device=device) for _ in range(2))


def _masked_rank(uniform: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Uniform-random rank of each element within the masked subset, per row.

    uniform and mask are (B, N). Elements outside the mask get rank >= the
    row's mask count, so rank < k selects a uniform random k-subset.
    """
    priority = torch.where(mask, uniform, 2.0)  # unmasked elements sort last
    order = torch.argsort(priority, dim=-1, stable=True)
    positions = torch.arange(mask.shape[-1], device=mask.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, positions)


def sample_rpn_minibatch(
    trainable: torch.Tensor,
    objectness: torch.Tensor,
    minibatch_size: int = 256,
    max_positive_fraction: float = 0.5,
    draws: Optional[Draws] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """The RPN training minibatch of each image, a (B, A) f32 mask.

    Up to `max_positive_fraction` of the minibatch is positive anchors
    (fewer if the image lacks them); the rest is negative. draws: two (B, A)
    uniforms, for the positive and the negative ranks.
    """
    pos_mask = (trainable > 0) & (objectness > 0)
    neg_mask = (trainable > 0) & (objectness == 0)
    u_pos, u_neg = _uniforms(draws, trainable.shape, trainable.device, generator)
    max_pos = int(minibatch_size * max_positive_fraction)
    num_pos = torch.clamp(pos_mask.sum(dim=-1, keepdim=True), max=max_pos)
    num_neg = torch.minimum(minibatch_size - num_pos, neg_mask.sum(dim=-1, keepdim=True))
    sel_pos = pos_mask & (_masked_rank(u_pos, pos_mask) < num_pos)
    sel_neg = neg_mask & (_masked_rank(u_neg, neg_mask) < num_neg)
    return (sel_pos | sel_neg).float()


class ProposalSamples(NamedTuple):
    """Fixed-size detector training batch (S = proposal_batch_size slots)."""

    boxes: torch.Tensor  # (B, S, 4) proposal corners
    classes: torch.Tensor  # (B, S) int64 gt class (0 = background)
    deltas: torch.Tensor  # (B, S, 4) normalized regression targets (ty,tx,th,tw)
    weights: torch.Tensor  # (B, S) 1.0 for live samples, 0.0 for padding
    count: torch.Tensor  # (B,) number of live samples (loss normalizer)


def label_and_sample_proposals(
    proposals: torch.Tensor,
    proposal_valid: torch.Tensor,
    gt_corners: torch.Tensor,
    gt_classes: torch.Tensor,
    gt_mask: torch.Tensor,
    batch_size: int = 128,
    positive_fraction: float = 0.25,
    min_object_iou: float = 0.5,
    min_background_iou: float = 0.0,
    delta_means=(0.0, 0.0, 0.0, 0.0),
    delta_stds=(0.1, 0.1, 0.2, 0.2),
    draws: Optional[Draws] = None,
    generator: Optional[torch.Generator] = None,
) -> ProposalSamples:
    """Label each image's proposals against its gt boxes and sample the
    detector batch.

    proposals (B, P, 4), proposal_valid (B, P), gt_corners (B, G, 4),
    gt_classes (B, G), gt_mask (B, G); draws: two (B, P + G) uniforms.

    * gt boxes join the proposals (guaranteed positives);
    * the best-IoU gt box gives the class; IoU < min_object_iou is background;
    * proposals below min_background_iou are dropped;
    * the batch is min(batch_size, N) samples with round(positive_fraction *
      that) positives at most, drawn without replacement;
    * if either side is empty, the batch is empty (weights all 0).
    """
    b = proposals.shape[0]
    dev = proposals.device
    gt_real = gt_mask > 0
    all_boxes = torch.cat([proposals, gt_corners], dim=1)  # (B, P+G, 4)
    all_valid = torch.cat([proposal_valid.bool(), gt_real], dim=1)

    ious = box_ops.iou_matrix(all_boxes, gt_corners)  # (B, P+G, G)
    ious = torch.where(gt_real[:, None, :], ious, -1.0)
    best_iou = ious.amax(dim=2)
    best_gt = ious.argmax(dim=2)

    all_valid = all_valid & (best_iou >= min_background_iou)
    label = torch.where(best_iou >= min_object_iou, torch.gather(gt_classes.long(), 1, best_gt), 0)
    label = torch.where(all_valid, label, 0)

    pos_mask = all_valid & (label > 0)
    neg_mask = all_valid & (label == 0)
    n_pos = pos_mask.sum(dim=-1, keepdim=True)
    n_neg = neg_mask.sum(dim=-1, keepdim=True)
    num_samples = torch.clamp(all_valid.sum(dim=-1, keepdim=True), max=batch_size)
    num_pos = torch.minimum(torch.round(num_samples.float() * positive_fraction).long(), n_pos)
    num_neg = torch.minimum(num_samples - num_pos, n_neg)
    empty = (num_pos <= 0) | (num_neg <= 0)

    u_pos, u_neg = _uniforms(draws, all_valid.shape, dev, generator)
    sel = (pos_mask & (_masked_rank(u_pos, pos_mask) < num_pos)) | (
        neg_mask & (_masked_rank(u_neg, neg_mask) < num_neg)
    )
    sel = sel & ~empty

    # Pack the selected proposals into batch_size slots, selected first, each
    # group in index order (what top_k of the 0/1 priority gives).
    k = min(batch_size, sel.shape[1])
    slots = torch.sort(sel.float(), dim=1, descending=True, stable=True).indices[:, :k]
    slot_live = torch.gather(sel, 1, slots)
    if k < batch_size:
        slots = torch.cat([slots, slots.new_zeros((b, batch_size - k))], dim=1)
        slot_live = torch.cat([slot_live, slot_live.new_zeros((b, batch_size - k))], dim=1)

    boxes = torch.gather(all_boxes, 1, slots[:, :, None].expand(-1, -1, 4))
    classes = torch.where(slot_live, torch.gather(label, 1, slots), 0)
    slot_gt = torch.gather(best_gt, 1, slots)
    assigned_gt = torch.gather(gt_corners, 1, slot_gt[:, :, None].expand(-1, -1, 4))
    targets = box_ops.encode_deltas(box_ops.corners_to_centers(assigned_gt), box_ops.corners_to_centers(boxes))
    targets = (targets - constants.values(delta_means, dev)) / constants.values(delta_stds, dev)
    targets = torch.where(torch.isfinite(targets), targets, 0.0)

    count = ((num_pos + num_neg) * (~empty).long()).squeeze(1)
    return ProposalSamples(
        boxes=torch.where(slot_live[:, :, None], boxes, 0.0),
        classes=classes,
        deltas=targets,
        weights=slot_live.float(),
        count=count,
    )
