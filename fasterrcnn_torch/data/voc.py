"""PASCAL VOC class list and the sample records the data pipeline carries.

A JAX-free copy of the parts of `fasterrcnn_tpu/data/voc.py` the train path
needs: the fixed 21-class contract, `Box` and `Sample`. The VOC reader
itself (XML parsing, JPEG decode and resize, flips) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

VOC_CLASSES = (
    "background",
    "aeroplane",
    "bicycle",
    "bird",
    "boat",
    "bottle",
    "bus",
    "car",
    "cat",
    "chair",
    "cow",
    "diningtable",
    "dog",
    "horse",
    "motorbike",
    "person",
    "pottedplant",
    "sheep",
    "sofa",
    "train",
    "tvmonitor",
)
CLASS_INDEX_TO_NAME = dict(enumerate(VOC_CLASSES))


@dataclasses.dataclass
class Box:
    """One ground-truth box."""

    class_index: int
    class_name: str
    corners: np.ndarray  # (4,) f32 (y1, x1, y2, x2)


@dataclasses.dataclass
class Sample:
    """One training/eval sample; labels are assigned on the device."""

    image_u8: Optional[np.ndarray]  # (H, W, 3) uint8, already resized
    image_hw: Tuple[int, int]  # real (height, width)
    gt_boxes: List[Box]  # in the resized image's pixels
    filepath: str
    flip: bool = False
