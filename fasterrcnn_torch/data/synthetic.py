"""Synthetic dataset: VOC-shaped random samples for tests, the card smoke run
and smoke training when no VOC data is on disk.

A copy of `fasterrcnn_tpu/data/synthetic.py`, so one seed gives the same
samples in both packages. Images are solid-colour rectangles on noise; the
boxes are the rectangles themselves, so a working detector can overfit them.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from fasterrcnn_torch.data.voc import CLASS_INDEX_TO_NAME, Box, Sample


def synthetic_samples(
    num_samples: int,
    height: int = 600,
    width: int = 800,
    max_boxes: int = 4,
    seed: int = 0,
) -> Iterator[Sample]:
    rng = np.random.default_rng(seed)
    for idx in range(num_samples):
        image = rng.integers(0, 60, (height, width, 3), dtype=np.uint8)
        n = int(rng.integers(1, max_boxes + 1))
        boxes = []
        for _ in range(n):
            h = float(rng.uniform(60, height * 0.5))
            w = float(rng.uniform(60, width * 0.5))
            y1 = float(rng.uniform(0, height - h))
            x1 = float(rng.uniform(0, width - w))
            cls = int(rng.integers(1, 21))
            color = np.array(
                [60 + cls * 9 % 190, 255 - cls * 11 % 200, 30 + cls * 23 % 220],
                dtype=np.uint8,
            )
            image[int(y1) : int(y1 + h), int(x1) : int(x1 + w)] = color
            boxes.append(
                Box(
                    class_index=cls,
                    class_name=CLASS_INDEX_TO_NAME[cls],
                    corners=np.array([y1, x1, y1 + h, x1 + w], np.float32),
                )
            )
        yield Sample(
            image_u8=image,
            image_hw=(height, width),
            gt_boxes=boxes,
            filepath=f"synthetic://{idx}",
        )


class SyntheticDataset:
    """Dataset-shaped wrapper (iterable, num_samples, class mapping)."""

    num_classes = 21
    class_index_to_name = CLASS_INDEX_TO_NAME

    def __init__(self, num_samples=64, height=600, width=800, seed=0):
        self.num_samples = num_samples
        self.split = "synthetic"
        self._args = (num_samples, height, width)
        self._seed = seed

    def __iter__(self):
        n, h, w = self._args
        return synthetic_samples(n, h, w, seed=self._seed)
