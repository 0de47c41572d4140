"""Image loading and resize (host side) and normalization parameters.

The host keeps images as uint8 HWC and ships them to the device raw; channel
reordering, scaling and standardization run on the device
(`models/backbone.normalize_images`).
"""

from __future__ import annotations

import dataclasses
import os
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
    use_native: bool = True,
):
    """Load an image and resize it; no normalization. `path` is a file path,
    a file object or an http(s) URL (fetched with urllib).

    A local JPEG file is decoded by the native reader (`data/native_loader`:
    libjpeg and its own bilinear resize) when it is available and
    use_native is set, as the JAX package's reader does; everything else,
    and a JPEG the native reader refuses, by PIL.

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
    if (
        use_native
        and min_dimension_pixels
        and isinstance(path, str)
        and os.path.isfile(path)
        and path.lower().endswith((".jpg", ".jpeg"))
    ):
        result = _load_image_native(path, min_dimension_pixels, horizontal_flip, max_dimension_pixels)
        if result is not None:
            return result
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


# Largest aspect ratio the native scratch canvas covers at min-side 600.
_NATIVE_SCRATCH_SIDE = 1664


def _load_image_native(path: str, min_dim: int, flip: bool, max_dim=None):
    """JPEG decode+resize via the native reader; None -> caller uses PIL."""
    from fasterrcnn_torch.data import native_loader

    if not native_loader.available():
        return None
    try:
        with open(path, "rb") as f:
            jpeg = f.read()
        scratch = np.empty((_NATIVE_SCRATCH_SIDE, _NATIVE_SCRATCH_SIDE, 3), np.uint8)
        rh, rw, oh, ow = native_loader.decode_resize_into(jpeg, scratch, min_dim, flip, max_side=max_dim or 0)
    except (OSError, ValueError):
        return None
    image_u8 = np.ascontiguousarray(scratch[:rh, :rw])
    scale_factor = compute_scale_factor(ow, oh, min_dim, max_dim)
    pil_image = Image.fromarray(image_u8)
    return image_u8, pil_image, scale_factor, (3, oh, ow)
