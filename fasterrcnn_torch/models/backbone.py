"""Backbone protocol: static properties + module factories.

A backbone is a frozen spec: feature extractor and pooled-RoI head
factories, channel/stride/vector-size constants, preprocessing parameters,
the feature-map-shape rule and the parameters that training leaves frozen.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch
from torch import nn

from fasterrcnn_torch.data.image import ChannelOrder, PreprocessingParams
from fasterrcnn_torch.ops import constants


@dataclasses.dataclass(frozen=True)
class BackboneSpec:
    name: str
    feature_map_channels: int
    feature_pixels: int
    feature_vector_size: int
    preprocessing: PreprocessingParams
    # floor (VGG) vs ceil (ResNet) feature-map extent for an image extent.
    fm_ceil_mode: bool
    # Factories take (freeze) / (dropout); freeze is False in from-scratch
    # mode (ModelConfig.train_all), which lifts the backward cut.
    make_feature_extractor: Callable[[bool], nn.Module]
    make_head: Callable[[float], nn.Module]
    # Regex patterns (re.match) of parameter names frozen during training
    # unless ModelConfig.train_all.
    frozen_param_patterns: Tuple[str, ...]

    def compute_feature_map_shape(self, image_height: int, image_width: int):
        s = self.feature_pixels
        if self.fm_ceil_mode:
            return (-(-image_height // s), -(-image_width // s))
        return (image_height // s, image_width // s)


def normalize_images(
    images_u8: torch.Tensor, pre: PreprocessingParams, dtype: torch.dtype
) -> torch.Tensor:
    """uint8 RGB (B, H, W, 3) -> normalized (B, H, W, 3) in `dtype`, on device:
    reorder channels, scale, subtract means, divide stds (in f32)."""
    x = images_u8.float()
    if pre.channel_order == ChannelOrder.BGR:
        x = x.flip(-1)
    x = x * pre.scaling
    x = (x - constants.values(pre.means, x.device)) / constants.values(pre.stds, x.device)
    return x.to(dtype)


_REGISTRY = {}


def register_backbone(name: str, factory: Callable[[], BackboneSpec]):
    _REGISTRY[name] = factory


def get_backbone(name: str) -> BackboneSpec:
    # Registration happens when the backbone modules load.
    from fasterrcnn_torch.models import resnet, vgg16  # noqa: F401

    if name not in _REGISTRY:
        raise ValueError(f"Unknown backbone '{name}'. Available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()
