"""Write a synthetic dataset in PASCAL VOC's on-disk format.

A copy of `fasterrcnn_tpu/data/synthetic_voc.py`: the same seed writes the
same files. It produces a directory tree that `data.voc.Dataset` loads
unmodified: JPEGImages/*.jpg, Annotations/*.xml (1-based inclusive corners,
like VOC), ImageSets/Main/{split}.txt plus the per-class {cls}_{split}.txt
files the class-discovery step expects.

It stands in for VOC2007 where no VOC data is on disk: it exercises the
whole reader (XML parse, JPEG decode, scaling, flipping, bucketing, deferred
decode) and, because every object is a solid class-coloured rectangle, a
correct training pipeline can learn it at full production shapes.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple

import numpy as np

from fasterrcnn_torch.data.voc import VOC_CLASSES

# Deterministic, well-separated RGB color per class index (1..20).
def class_color(cls: int) -> np.ndarray:
    return np.array(
        [60 + cls * 9 % 190, 255 - cls * 11 % 200, 30 + cls * 23 % 220],
        dtype=np.uint8,
    )


def _write_xml(path: str, h: int, w: int, objects) -> None:
    lines = [
        "<annotation>",
        "  <size>",
        f"    <width>{w}</width>",
        f"    <height>{h}</height>",
        "    <depth>3</depth>",
        "  </size>",
    ]
    for name, (y1, x1, y2, x2), difficult in objects:
        lines += [
            "  <object>",
            f"    <name>{name}</name>",
            f"    <difficult>{int(difficult)}</difficult>",
            "    <bndbox>",
            # VOC corners are 1-based inclusive.
            f"      <xmin>{x1 + 1}</xmin>",
            f"      <ymin>{y1 + 1}</ymin>",
            f"      <xmax>{x2 + 1}</xmax>",
            f"      <ymax>{y2 + 1}</ymax>",
            "    </bndbox>",
            "  </object>",
        ]
    lines.append("</annotation>")
    with open(path, "w") as f:
        f.write("\n".join(lines))


def generate_voc_dataset(
    root: str,
    splits: Dict[str, int],
    image_sizes: Sequence[Tuple[int, int]] = ((375, 500), (500, 375), (333, 500)),
    max_boxes: int = 4,
    min_box_frac: float = 0.15,
    max_box_frac: float = 0.45,
    seed: int = 0,
    jpeg_quality: int = 95,
    difficult_fraction: float = 0.0,
) -> str:
    """Create a VOC-format dataset under `root`; returns `root`.

    splits: {"trainval": 128, "test": 32}-style split sizes. Image (h, w)
    sizes are drawn from `image_sizes` (original, pre-resize pixels). Boxes
    are solid class-colored rectangles over a smooth background; box sides
    are uniform in [min_box_frac, max_box_frac] of the image's short side.
    """
    from PIL import Image

    rng = np.random.default_rng(seed)
    jpeg_dir = os.path.join(root, "JPEGImages")
    ann_dir = os.path.join(root, "Annotations")
    sets_dir = os.path.join(root, "ImageSets", "Main")
    os.makedirs(jpeg_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    os.makedirs(sets_dir, exist_ok=True)

    for split, count in splits.items():
        basenames = []
        for idx in range(count):
            basename = f"{split}{idx:05d}"
            basenames.append(basename)
            h, w = image_sizes[int(rng.integers(0, len(image_sizes)))]
            short = min(h, w)
            # Smooth gradient background (JPEG-friendly; rectangles survive
            # compression crisply).
            yy = np.linspace(20, 70, h, dtype=np.float32)[:, None]
            xx = np.linspace(10, 60, w, dtype=np.float32)[None, :]
            image = np.repeat(
                ((yy + xx) / 2).astype(np.uint8)[:, :, None], 3, axis=2
            )
            n = int(rng.integers(1, max_boxes + 1))
            objects = []
            for _ in range(n):
                bh = int(rng.uniform(min_box_frac, max_box_frac) * short)
                bw = int(rng.uniform(min_box_frac, max_box_frac) * short)
                y1 = int(rng.integers(0, h - bh))
                x1 = int(rng.integers(0, w - bw))
                y2, x2 = y1 + bh - 1, x1 + bw - 1  # 0-based inclusive
                cls = int(rng.integers(1, len(VOC_CLASSES)))
                image[y1 : y2 + 1, x1 : x2 + 1] = class_color(cls)
                difficult = rng.uniform() < difficult_fraction
                objects.append((VOC_CLASSES[cls], (y1, x1, y2, x2), difficult))
            # Guarantee at least one non-difficult object (the loader
            # asserts every annotation has a usable box).
            if all(d for _, _, d in objects):
                objects[0] = (objects[0][0], objects[0][1], False)
            Image.fromarray(image).save(
                os.path.join(jpeg_dir, basename + ".jpg"),
                quality=jpeg_quality,
            )
            _write_xml(
                os.path.join(ann_dir, basename + ".xml"), h, w, objects
            )
        with open(os.path.join(sets_dir, split + ".txt"), "w") as f:
            f.write("\n".join(basenames) + "\n")
        # Class discovery globs *_{split}.txt and expects all 20 classes
        # (+background) — mirror VOC2007's per-class set files.
        for cls_name in VOC_CLASSES[1:]:
            with open(
                os.path.join(sets_dir, f"{cls_name}_{split}.txt"), "w"
            ) as f:
                f.write("\n".join(f"{b}  1" for b in basenames) + "\n")
    return root
