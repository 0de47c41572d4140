"""The one generator of every traffic mix: `traffic/<name>.json` holds
its parameters.

Scenes are synthetic VOC scenes made in memory from the seed: a smooth
grey gradient (20 to 70) over the image, and 1 to N solid class-coloured
rectangles whose sides are a uniform share of the short side, classes
uniform over the 20 VOC object classes. Ground truth is the rectangles'
0-based inclusive corners (y1, x1, y2, x2). Nothing is written to disk or
JPEG-coded.

A mix's "kind" says which entry it drives:
  * "predict": a pool of `pool_batches` distinct padded canvas batches of
    `batch` scenes (uint8 (B, H, W, 3) on the host, the scene in the
    top-left corner, and the real extents (B, 2)), sent round robin by one
    closed-loop client;
  * "train": epochs of `epoch_samples` samples drawn from a pool of
    `pool_scenes` scenes: each epoch walks shuffled passes over the pool,
    and each sample is flipped left to right with probability `flip`, as
    the reader's augmentation does.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, NamedTuple

import numpy as np

HERE = Path(__file__).resolve().parent


def load(name: str, directory: Path = HERE / "traffic") -> dict:
    """The parameters of the mix `name` (`<directory>/<name>.json`)."""
    path = directory / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    return json.loads(path.read_text())


def class_color(cls: int) -> np.ndarray:
    """A distinct RGB colour of each class index (1..20)."""
    return np.array([60 + cls * 9 % 190, 255 - cls * 11 % 200, 30 + cls * 23 % 220], np.uint8)


class Scene(NamedTuple):
    image: np.ndarray  # (H, W, 3) uint8
    boxes: np.ndarray  # (n, 4) float32 corners (y1, x1, y2, x2)
    classes: np.ndarray  # (n,) int32, 1..20


def make_scene(rng: np.random.Generator, spec: dict) -> Scene:
    h, w = spec["height"], spec["width"]
    lo, hi = spec["box_frac"]
    short = min(h, w)
    yy = np.linspace(20, 70, h, dtype=np.float32)[:, None]
    xx = np.linspace(10, 60, w, dtype=np.float32)[None, :]
    image = np.repeat(((yy + xx) / 2).astype(np.uint8)[:, :, None], 3, axis=2)
    n = int(rng.integers(spec["objects"][0], spec["objects"][1] + 1))
    boxes, classes = [], []
    for _ in range(n):
        bh, bw = int(rng.uniform(lo, hi) * short), int(rng.uniform(lo, hi) * short)
        y1, x1 = int(rng.integers(0, h - bh)), int(rng.integers(0, w - bw))
        cls = int(rng.integers(1, 21))
        image[y1:y1 + bh, x1:x1 + bw] = class_color(cls)
        boxes.append((y1, x1, y1 + bh - 1, x1 + bw - 1))
        classes.append(cls)
    return Scene(image, np.asarray(boxes, np.float32), np.asarray(classes, np.int32))


def flip_scene(s: Scene) -> Scene:
    """Left-right flip: x -> width - 1 - x."""
    w = s.image.shape[1]
    b = s.boxes.copy()
    b[:, 1], b[:, 3] = w - 1 - s.boxes[:, 3], w - 1 - s.boxes[:, 1]
    return Scene(s.image[:, ::-1], b, s.classes)


class CanvasBatch(NamedTuple):
    """A padded batch, as the program's `Batch` holds it (numpy)."""

    images: np.ndarray  # (B, H, W, 3) uint8
    image_hw: np.ndarray  # (B, 2) float32
    gt_boxes: np.ndarray  # (B, G, 4) float32
    gt_classes: np.ndarray  # (B, G) int32
    gt_mask: np.ndarray  # (B, G) float32
    sample_weight: np.ndarray  # (B,) float32


def canvas_batch(scenes: List[Scene], canvas, max_gt: int) -> CanvasBatch:
    b = len(scenes)
    ch, cw = canvas
    images = np.zeros((b, ch, cw, 3), np.uint8)
    hw = np.zeros((b, 2), np.float32)
    boxes = np.zeros((b, max_gt, 4), np.float32)
    classes = np.zeros((b, max_gt), np.int32)
    mask = np.zeros((b, max_gt), np.float32)
    for i, s in enumerate(scenes):
        h, w = s.image.shape[:2]
        images[i, :h, :w] = s.image
        hw[i] = (h, w)
        n = len(s.classes)
        boxes[i, :n], classes[i, :n], mask[i, :n] = s.boxes, s.classes, 1.0
    return CanvasBatch(images, hw, boxes, classes, mask, np.ones((b,), np.float32))


def predict_pool(mix: dict, seed: int, max_gt: int) -> List[CanvasBatch]:
    """The predict client's `pool_batches` distinct batches."""
    rng = np.random.default_rng(seed)
    return [canvas_batch([make_scene(rng, mix["scene"]) for _ in range(mix["batch"])], mix["canvas"], max_gt)
            for _ in range(mix["pool_batches"])]


class TrainStream:
    """The train mix's sample order: `epoch(e)` yields (scene index, flip)
    pairs of epoch e, `epoch_samples` of them; every epoch of a seed draws
    the same number of samples from the same pool."""

    def __init__(self, mix: dict, seed: int):
        rng = np.random.default_rng(seed)
        self.mix = mix
        self.scenes = [make_scene(rng, mix["scene"]) for _ in range(mix["pool_scenes"])]
        self._seed = seed

    def epoch(self, e: int):
        rng = np.random.default_rng([self._seed, e])
        n, pool = self.mix["epoch_samples"], len(self.scenes)
        passes = -(-n // pool)
        order = np.concatenate([rng.permutation(pool) for _ in range(passes)])[:n]
        flips = rng.uniform(size=n) < self.mix["flip"]
        return list(zip(order.tolist(), flips.tolist()))

    def scene(self, index: int, flip: bool) -> Scene:
        s = self.scenes[index]
        return flip_scene(s) if flip else s
