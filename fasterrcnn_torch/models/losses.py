"""The four Faster R-CNN losses, fixed-shape and masked.

The JAX package's `models/losses.py`. Each function reduces its last axes
and keeps leading ones, so it takes one image or a batch of images:

  * RPN class loss: masked binary cross-entropy from logits (stable form)
    over the sampled anchor minibatch, / N_cls.
  * RPN regression loss: smooth-L1 (sigma 3) over positive minibatch
    anchors, / N_cls.
  * Detector class loss: softmax cross-entropy over the sampled proposals,
    / the live-sample count.
  * Detector regression loss: smooth-L1 (sigma 1) on the target class's 4
    deltas only, gathered from the per-class predictions, / the count.
"""

from __future__ import annotations

import torch

EPSILON = 1e-7


def smooth_l1(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Robust L1 (Fast R-CNN eq. 3), elementwise."""
    sigma_sq = sigma * sigma
    x_abs = x.abs()
    return torch.where(x_abs < 1.0 / sigma_sq, 0.5 * x * x * sigma_sq, x_abs - 0.5 / sigma_sq)


def rpn_class_loss(
    objectness_logits: torch.Tensor, gt_objectness: torch.Tensor, minibatch_mask: torch.Tensor
) -> torch.Tensor:
    """(..., A) logits, 0/1 labels, 0/1 selection mask -> (...) loss."""
    n_cls = minibatch_mask.sum(dim=-1) + EPSILON
    z = objectness_logits
    # BCE from logits: max(z,0) - z*y + log(1+exp(-|z|)).
    per_anchor = torch.clamp(z, min=0.0) - z * gt_objectness + torch.log1p(torch.exp(-z.abs()))
    return (per_anchor * minibatch_mask).sum(dim=-1) / n_cls


def rpn_regression_loss(
    predicted_deltas: torch.Tensor,
    gt_deltas: torch.Tensor,
    gt_objectness: torch.Tensor,
    minibatch_mask: torch.Tensor,
    sigma: float = 3.0,
) -> torch.Tensor:
    """(..., A, 4) deltas, (..., A) labels and mask -> (...) loss."""
    n_cls = minibatch_mask.sum(dim=-1) + EPSILON
    weights = (minibatch_mask * gt_objectness)[..., None]
    losses = smooth_l1(gt_deltas - predicted_deltas, sigma)
    return (losses * weights).sum(dim=(-2, -1)) / n_cls


def detector_class_loss(
    class_logits: torch.Tensor,
    gt_classes: torch.Tensor,
    sample_weights: torch.Tensor,
    sample_count: torch.Tensor,
) -> torch.Tensor:
    """(..., S, C) logits, (..., S) int classes and 0/1 weights, (...) count."""
    log_probs = torch.log_softmax(class_logits, dim=-1)
    picked = torch.gather(log_probs, -1, gt_classes.long()[..., None])[..., 0]
    return -(picked * sample_weights).sum(dim=-1) / (sample_count + EPSILON)


def detector_regression_loss(
    box_deltas: torch.Tensor,
    gt_classes: torch.Tensor,
    gt_deltas: torch.Tensor,
    sample_weights: torch.Tensor,
    sample_count: torch.Tensor,
    sigma: float = 1.0,
) -> torch.Tensor:
    """(..., S, 4*(C-1)) predictions, (..., S) classes (0 = background),
    (..., S, 4) targets, (..., S) weights, (...) count -> (...) loss."""
    per_class = box_deltas.reshape(*box_deltas.shape[:-1], -1, 4)  # (..., S, C-1, 4)
    # Class c > 0 regresses slot c-1; background rows gather slot 0 and are
    # masked out by the positive weight.
    slot = torch.clamp(gt_classes.long() - 1, min=0)
    index = slot[..., None, None].expand(*slot.shape, 1, 4)
    picked = torch.gather(per_class, -2, index)[..., 0, :]
    positive = (gt_classes > 0).float() * sample_weights
    losses = smooth_l1(gt_deltas - picked, sigma)
    return (losses * positive[..., None]).sum(dim=(-2, -1)) / (sample_count + EPSILON)
