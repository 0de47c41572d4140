"""VGG-16 backbone: 13 3x3 convs with a stride-16 feature map, and the
two-layer 4096-d fully connected RoI head.

Module names (block{i}_conv{j}, fc1/fc2) are the JAX package's parameter
names, so `utils/weights.py` maps one state onto the other by name. The
convs run NCHW in the `channels_last` memory format; the extractor takes and
returns NHWC tensors, the layout of the JAX package's public functions.
Max pools floor (VALID padding), so the map extent is `size // 16`.
Blocks 1-2 are frozen in training unless `ModelConfig.train_all`: their
parameters are listed in `frozen_param_patterns`, and the extractor cuts the
gradient after block 2 so no backward pass runs through them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from fasterrcnn_torch.data.image import CAFFE_BGR, TORCHVISION_RGB
from fasterrcnn_torch.models.backbone import BackboneSpec, register_backbone
from fasterrcnn_torch.models.layers import Conv2d, Linear

_BLOCKS = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


class VGG16FeatureExtractor(nn.Module):
    """conv1_1..conv5_3; pools after blocks 1-4 only (stride-16 output)."""

    def __init__(self, freeze: bool = True):
        super().__init__()
        self.freeze = freeze
        in_ch = 3
        for block_idx, (num_convs, channels) in enumerate(_BLOCKS):
            for conv_idx in range(num_convs):
                name = f"block{block_idx + 1}_conv{conv_idx + 1}"
                self.add_module(name, Conv2d(in_ch, channels, 3, padding=1))
                in_ch = channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, H/16, W/16, 512), both NHWC."""
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
        for block_idx, (num_convs, _) in enumerate(_BLOCKS):
            for conv_idx in range(num_convs):
                conv = getattr(self, f"block{block_idx + 1}_conv{conv_idx + 1}")
                x = F.relu(conv(x))
            if block_idx < 4:  # no pool after block 5
                x = F.max_pool2d(x, 2, 2)
            if block_idx == 1 and self.freeze:
                x = x.detach()  # blocks 1-2 are frozen: no backward through them
        return x.permute(0, 2, 3, 1)


class VGG16Head(nn.Module):
    """Pooled RoIs (P, 7, 7, 512) -> feature vectors (P, 4096), flattened in
    HWC order as the JAX package flattens them. Dropout after fc1 and fc2
    when `dropout` > 0, active in training mode only."""

    def __init__(self, dropout: float = 0.0):
        super().__init__()
        self.fc1 = Linear(7 * 7 * 512, 4096)
        self.fc2 = Linear(4096, 4096)
        self.dropout = nn.Dropout(dropout) if dropout > 0.0 else nn.Identity()

    def forward(self, rois: torch.Tensor) -> torch.Tensor:
        x = rois.reshape(rois.shape[0], -1)
        x = self.dropout(F.relu(self.fc1(x)))
        return self.dropout(F.relu(self.fc2(x)))


def _make_spec() -> BackboneSpec:
    return BackboneSpec(
        name="vgg16",
        feature_map_channels=512,
        feature_pixels=16,
        feature_vector_size=4096,
        preprocessing=CAFFE_BGR,
        fm_ceil_mode=False,
        make_feature_extractor=VGG16FeatureExtractor,
        make_head=VGG16Head,
        frozen_param_patterns=(r".*block1_conv.*", r".*block2_conv.*"),
    )


def _make_torch_spec() -> BackboneSpec:
    """The reference's second VGG-16 flavor: same topology, torchvision
    weight source and RGB/255 preprocessing."""
    return dataclasses.replace(_make_spec(), name="vgg16-torch", preprocessing=TORCHVISION_RGB)


register_backbone("vgg16", _make_spec)
register_backbone("vgg16-torch", _make_torch_spec)
