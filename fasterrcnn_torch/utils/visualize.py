"""Detection / anchor visualization (host side, PIL).

A copy of `fasterrcnn_tpu/utils/visualize.py`: show_anchors renders
ground-truth boxes and positive anchors over the image; show_detections
renders class-coloured final boxes with score labels.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw

_COLORS = [
    (60, 180, 75),
    (230, 25, 75),
    (67, 99, 216),
    (255, 225, 25),
    (245, 130, 49),
    (145, 30, 180),
    (70, 240, 240),
    (240, 50, 230),
    (188, 246, 12),
    (250, 190, 190),
    (0, 128, 128),
    (230, 190, 255),
    (154, 99, 36),
    (255, 250, 200),
    (128, 0, 0),
    (170, 255, 195),
    (128, 128, 0),
    (255, 216, 177),
    (0, 0, 117),
    (128, 128, 128),
]


def _class_color(class_index: int):
    return _COLORS[(class_index - 1) % len(_COLORS)]


def _draw_box(draw: ImageDraw.ImageDraw, corners, color, label: Optional[str] = None):
    y1, x1, y2, x2 = [float(v) for v in corners[:4]]
    draw.rectangle([x1, y1, x2, y2], outline=color, width=2)
    if label:
        draw.text((x1 + 2, y1 + 2), label, fill=color)


def show_detections(
    image: Image.Image,
    scored_boxes_by_class_index: Dict[int, np.ndarray],
    class_index_to_name: Dict[int, str],
    output_path: Optional[str] = None,
    show_image: bool = False,
):
    """Render final detections."""
    canvas = image.convert("RGB").copy()
    draw = ImageDraw.Draw(canvas)
    for class_index, scored_boxes in scored_boxes_by_class_index.items():
        for row in np.asarray(scored_boxes).reshape(-1, 5):
            label = "%s %1.2f" % (class_index_to_name[class_index], row[4])
            _draw_box(draw, row, _class_color(class_index), label)
    if output_path:
        canvas.save(output_path)
        print(f"Wrote detection results to '{output_path}'")
    if show_image:
        canvas.show()
    return canvas


def show_anchors(
    image: Image.Image,
    anchor_centers: np.ndarray,
    positive_mask: np.ndarray,
    gt_boxes: Sequence,
    output_path: Optional[str] = None,
):
    """Render gt boxes (green) and positive anchors (yellow)."""
    canvas = image.convert("RGB").copy()
    draw = ImageDraw.Draw(canvas)
    centers = np.asarray(anchor_centers).reshape(-1, 4)
    positive = np.asarray(positive_mask).reshape(-1) > 0
    for ctr in centers[positive]:
        cy, cx, h, w = [float(v) for v in ctr]
        draw.rectangle(
            [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
            outline=(255, 255, 0),
            width=1,
        )
    for box in gt_boxes:
        _draw_box(draw, box.corners, (0, 255, 0), box.class_name)
    if output_path:
        canvas.save(output_path)
    return canvas
