"""Padded, bucketed batching and background prefetch on the host.

A JAX-free copy of `fasterrcnn_tpu/data/pipeline.py` without its deferred
JPEG decode (which waits for the VOC reader): samples are padded into the
static canvas buckets (`config.CANVAS_BUCKETS`), batches form within a
bucket, residue batches are padded with zero-weight blanks, and a background
thread keeps batches ready.
"""

from __future__ import annotations

import queue
import threading
import warnings
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

from fasterrcnn_torch.config import CANVAS_BUCKETS, select_canvas
from fasterrcnn_torch.data.voc import Sample


class HostBatch:
    """Numpy staging of models.faster_rcnn.Batch plus per-sample metadata."""

    def __init__(self, canvas_hw, images, image_hw, gt_boxes, gt_classes, gt_mask, sample_weight, samples):
        self.canvas_hw: Tuple[int, int] = canvas_hw
        self.images: np.ndarray = images  # (B, Hc, Wc, 3) u8
        self.image_hw: np.ndarray = image_hw  # (B, 2) f32
        self.gt_boxes: np.ndarray = gt_boxes  # (B, G, 4) f32
        self.gt_classes: np.ndarray = gt_classes  # (B, G) i32
        self.gt_mask: np.ndarray = gt_mask  # (B, G) f32
        self.sample_weight: np.ndarray = sample_weight  # (B,) f32
        self.samples: List[Sample] = samples  # real samples only (<= B)


def make_host_batch(
    samples: List[Sample],
    canvas_hw: Tuple[int, int],
    max_gt: int,
    pad_to: Optional[int] = None,
) -> HostBatch:
    """Stage samples into one padded canvas batch.

    pad_to: if set and > len(samples), the batch is padded with blank images
    (zero pixels, full-canvas extent, no gt) of sample_weight 0.
    """
    b = max(len(samples), pad_to or 0)
    ch, cw = canvas_hw
    images = np.zeros((b, ch, cw, 3), np.uint8)
    # Padding rows use the canvas extent: a zero-size extent would divide by
    # zero in RoI normalization and poison gradients with NaN * 0.
    image_hw = np.tile(np.asarray([[float(ch), float(cw)]], np.float32), (b, 1))
    gt_boxes = np.zeros((b, max_gt, 4), np.float32)
    gt_classes = np.zeros((b, max_gt), np.int32)
    gt_mask = np.zeros((b, max_gt), np.float32)
    sample_weight = np.zeros((b,), np.float32)
    for i, s in enumerate(samples):
        if s.image_u8 is None:
            raise ValueError(f"{s.filepath}: sample has no pixels")
        if len(s.gt_boxes) > max_gt:
            raise ValueError(f"{s.filepath}: {len(s.gt_boxes)} gt boxes exceeds max_gt={max_gt}")
        h, w = s.image_hw
        images[i, :h, :w] = s.image_u8
        image_hw[i] = s.image_hw
        sample_weight[i] = 1.0
        for j, box in enumerate(s.gt_boxes):
            gt_boxes[i, j] = box.corners
            gt_classes[i, j] = box.class_index
            gt_mask[i, j] = 1.0
    return HostBatch(canvas_hw, images, image_hw, gt_boxes, gt_classes, gt_mask, sample_weight, samples)


def batched(
    dataset: Iterable[Sample],
    batch_size: int,
    max_gt: int,
    drop_remainder: bool = False,
) -> Iterator[HostBatch]:
    """Group samples by canvas bucket and emit padded batches.

    At the end, each bucket's residue is padded up to batch_size with
    zero-weight blanks, or dropped (drop_remainder=True).
    """
    pending = {hw: [] for hw in CANVAS_BUCKETS}
    for sample in dataset:
        hw = select_canvas(*sample.image_hw)
        pending[hw].append(sample)
        if len(pending[hw]) == batch_size:
            yield make_host_batch(pending[hw], hw, max_gt)
            pending[hw] = []
    if not drop_remainder:
        for hw, group in pending.items():
            if group:
                yield make_host_batch(group, hw, max_gt, pad_to=batch_size)


class Prefetcher:
    """Run an iterator in a background thread with a bounded queue.

    `close()` stops the worker promptly (it checks a stop flag around every
    blocking put), so an early-exiting consumer does not keep the source
    running. An error in the worker is raised on the consumer's side.
    """

    _DONE = object()

    def __init__(self, iterator: Iterator, depth: int = 2):
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._closed = False

        def worker():
            try:
                for item in iterator:
                    while not self._stop.is_set():
                        try:
                            self._queue.put(item, timeout=0.05)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
            except BaseException as e:  # re-raised on the consumer side
                self._error = e
            finally:
                # The end marker waits behind the queued items; only after
                # close() may it take the place of one.
                while True:
                    try:
                        self._queue.put(self._DONE, timeout=0.05)
                        break
                    except queue.Full:
                        if not self._stop.is_set():
                            continue
                        try:
                            self._queue.get_nowait()
                        except queue.Empty:
                            pass

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def close(self, timeout: float = 5.0):
        """Stop the worker and drop queued items (iteration ends after)."""
        self._closed = True
        self._stop.set()
        while True:  # unblock a put stuck on a full queue
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            warnings.warn(
                f"Prefetcher worker did not stop within {timeout}s of close(); it is blocked "
                "inside the wrapped iterator",
                RuntimeWarning,
                stacklevel=2,
            )

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        item = self._queue.get()
        if item is self._DONE:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item
