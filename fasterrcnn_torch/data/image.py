"""Image loading and resize (host side) and normalization parameters.

The host keeps images as uint8 HWC and ships them to the device raw; channel
reordering, scaling and standardization run on the device
(`models/backbone.normalize_images`).
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Optional, Tuple

import numpy as np
from PIL import Image


class ChannelOrder(Enum):
    RGB = "RGB"
    BGR = "BGR"


@dataclasses.dataclass(frozen=True)
class PreprocessingParams:
    """Normalization contract per backbone.

    Applied in order: channel reorder, * scaling, - means, / stds, with means
    and stds given in the target channel order.
    """

    channel_order: ChannelOrder
    scaling: float
    means: Tuple[float, float, float]
    stds: Tuple[float, float, float]


# Caffe-VGG16 convention.
CAFFE_BGR = PreprocessingParams(
    channel_order=ChannelOrder.BGR,
    scaling=1.0,
    means=(103.939, 116.779, 123.680),
    stds=(1.0, 1.0, 1.0),
)
# Torchvision convention.
TORCHVISION_RGB = PreprocessingParams(
    channel_order=ChannelOrder.RGB,
    scaling=1.0 / 255.0,
    means=(0.485, 0.456, 0.406),
    stds=(0.229, 0.224, 0.225),
)


def compute_scale_factor(
    original_width: int,
    original_height: int,
    min_dimension_pixels: Optional[int],
    max_dimension_pixels: Optional[int] = None,
) -> float:
    """Scale so the shorter side equals min_dimension_pixels.

    max_dimension_pixels caps the LONGER side, so an extreme-aspect image
    still fits the largest canvas bucket.
    """
    if not min_dimension_pixels:
        return 1.0
    short = min(original_width, original_height)
    long_ = max(original_width, original_height)
    scale = min_dimension_pixels / short
    if max_dimension_pixels and long_ * scale > max_dimension_pixels:
        scale = max_dimension_pixels / long_
    return scale


def load_image(
    path,
    min_dimension_pixels: Optional[int] = 600,
    horizontal_flip: bool = False,
    max_dimension_pixels: Optional[int] = None,
):
    """Load an image with PIL and resize it; no normalization. `path` is a
    file path, a file object or an http(s) URL (fetched with urllib).

    Returns:
      (image_u8, pil_image, scale_factor, original_shape) where image_u8 is
      (H, W, 3) uint8 RGB, pil_image is the resized PIL image for drawing,
      and original_shape is (3, orig_h, orig_w).
    """
    if isinstance(path, str) and path.startswith(("http://", "https://")):
        import io
        import urllib.request

        with urllib.request.urlopen(path) as resp:
            path = io.BytesIO(resp.read())
    image = Image.open(path).convert("RGB")
    original_width, original_height = image.width, image.height
    if horizontal_flip:
        image = image.transpose(method=Image.FLIP_LEFT_RIGHT)
    if min_dimension_pixels is not None:
        scale_factor = compute_scale_factor(
            original_width=image.width,
            original_height=image.height,
            min_dimension_pixels=min_dimension_pixels,
            max_dimension_pixels=max_dimension_pixels,
        )
        width = int(image.width * scale_factor)
        height = int(image.height * scale_factor)
        image = image.resize((width, height), resample=Image.BILINEAR)
    else:
        scale_factor = 1.0
    image_u8 = np.asarray(image, dtype=np.uint8)
    return image_u8, image, scale_factor, (3, original_height, original_width)
