"""Detector stage: RoI feature vectors -> class scores + per-class box deltas."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from fasterrcnn_torch.models.layers import Linear


class DetectorHeads(nn.Module):
    """Feature vectors (P, F) -> class logits (P, C) and box deltas
    (P, 4*(C-1)), both f32. Background class 0 has no box regressor."""

    def __init__(self, num_classes: int, in_features: int = 4096):
        super().__init__()
        self.classifier = Linear(in_features, num_classes)
        self.regressor = Linear(in_features, 4 * (num_classes - 1))

    def forward(self, features: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.classifier(features).float(), self.regressor(features).float()
