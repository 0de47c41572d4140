"""Padded, bucketed batching and background prefetch on the host.

A JAX-free copy of `fasterrcnn_tpu/data/pipeline.py`: samples are padded
into the static canvas buckets (`config.CANVAS_BUCKETS`), batches form
within a bucket, residue batches are padded with zero-weight blanks, and a
background thread keeps batches ready. Deferred samples (`data/voc.
DeferredJpeg`) are decoded straight into the padded batch: by the native
reader (`data/native_loader`, threaded libjpeg) where it builds, else with
PIL, as the JAX package does. `stage`, `upload` and `arrived` carry batches
from the prefetch thread to the card (`Engine.train_epoch`).
"""

from __future__ import annotations

import queue
import threading
import warnings
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fasterrcnn_torch.config import CANVAS_BUCKETS, select_canvas
from fasterrcnn_torch.data import image as image_lib
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


def _decode_deferred_into(images: np.ndarray, samples: List[Sample], idx):
    """Decode deferred samples straight into the padded batch canvas.

    One threaded native-reader call per batch (`data/native_loader`, the GIL
    released for its whole duration) when the reader is available, else
    PIL one sample at a time. Samples with a cache_sink are decoded
    unflipped (the dataset caches one variant per file) and flipped as they
    are written. A decoded size other than the annotation's raises.
    """
    from fasterrcnn_torch.data import native_loader

    spec = samples[idx[0]].deferred
    if native_loader.available():
        jpegs, flips = [], []
        for i in idx:
            with open(samples[i].filepath, "rb") as f:
                jpegs.append(f.read())
            flips.append(samples[i].flip and samples[i].deferred.cache_sink is None)
        real_hw, _ = native_loader.decode_batch_into(
            jpegs, images, dest_indices=idx, min_side=spec.min_side, max_side=spec.max_side, flips=flips,
        )
        decoded_hw = [(int(real_hw[k, 0]), int(real_hw[k, 1])) for k in range(len(idx))]
        arrays = [None] * len(idx)  # already in the batch
    else:
        decoded_hw, arrays = [], []
        for i in idx:
            s = samples[i]
            arr, _, _, _ = image_lib.load_image(
                s.filepath,
                min_dimension_pixels=spec.min_side,
                max_dimension_pixels=spec.max_side,
                horizontal_flip=s.flip and s.deferred.cache_sink is None,
                use_native=False,
            )
            decoded_hw.append(arr.shape[:2])
            arrays.append(arr)
    for k, i in enumerate(idx):
        s = samples[i]
        rh, rw = decoded_hw[k]
        if (rh, rw) != tuple(s.image_hw):
            raise ValueError(
                f"{s.filepath}: decoded to {(rh, rw)} but the annotation's "
                f"<size> element predicted {tuple(s.image_hw)}"
            )
        if arrays[k] is not None:
            images[i, :rh, :rw] = arrays[k]
        sink = s.deferred.cache_sink
        if sink is not None:
            unflipped = images[i, :rh, :rw].copy()
            sink(unflipped)
            if s.flip:
                images[i, :rh, :rw] = unflipped[:, ::-1]
        s.image_u8 = images[i, :rh, :rw]
        s.deferred = None


def make_host_batch(
    samples: List[Sample],
    canvas_hw: Tuple[int, int],
    max_gt: int,
    pad_to: Optional[int] = None,
) -> HostBatch:
    """Stage samples into one padded canvas batch.

    pad_to: if set and > len(samples), the batch is padded with blank images
    (zero pixels, full-canvas extent, no gt) of sample_weight 0. Deferred
    samples are decoded into the batch here and get their pixels (a view of
    the batch) as they would from an eager decode.
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
    deferred_idx = [i for i, s in enumerate(samples) if s.image_u8 is None]
    for i, s in enumerate(samples):
        if len(s.gt_boxes) > max_gt:
            raise ValueError(f"{s.filepath}: {len(s.gt_boxes)} gt boxes exceeds max_gt={max_gt}")
        if s.image_u8 is not None:
            h, w = s.image_hw
            images[i, :h, :w] = s.image_u8
        image_hw[i] = s.image_hw
        sample_weight[i] = 1.0
        for j, box in enumerate(s.gt_boxes):
            gt_boxes[i, j] = box.corners
            gt_classes[i, j] = box.class_index
            gt_mask[i, j] = 1.0
    if deferred_idx:
        _decode_deferred_into(images, samples, deferred_idx)
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


def stage(arrays: Sequence[np.ndarray], pin: bool) -> torch.Tensor:
    """`np.stack(arrays)` assembled straight into a host tensor, in
    page-locked memory if `pin` (so that a copy to the card can run
    asynchronously)."""
    first = np.asarray(arrays[0])
    dtype = torch.from_numpy(np.empty(0, first.dtype)).dtype
    out = torch.empty((len(arrays), *first.shape), dtype=dtype, pin_memory=pin)
    np.stack(arrays, out=out.numpy())
    return out


def upload(host: Sequence[torch.Tensor], device: torch.device, stream) -> Tuple[Tuple[torch.Tensor, ...], object]:
    """Copy host tensors to `device` and return them with the event that
    marks their arrival (None on the CPU, where nothing is copied).

    On a CUDA device the copies are enqueued on `stream` with
    `non_blocking=True` and an event is recorded after them. The consumer
    must make its stream wait on the event and `record_stream` each tensor
    on it (`arrived`). PyTorch's pinned-memory allocator holds each pinned
    source until its copy has run, so the host tensors may be dropped at once.
    """
    if device.type != "cuda":
        return tuple(t.to(device) for t in host), None
    with torch.cuda.device(device), torch.cuda.stream(stream):
        out = tuple(t.to(device, non_blocking=True) for t in host)
        ready = torch.cuda.Event()
        ready.record(stream)
    return out, ready


def arrived(tensors: Sequence[torch.Tensor], ready) -> None:
    """Make the current stream wait for an `upload` and tie its tensors'
    memory to that stream, so that the allocator gives it to no later
    upload before the reads queued here have run."""
    if ready is None:
        return
    current = torch.cuda.current_stream(tensors[0].device)
    current.wait_event(ready)
    for t in tensors:
        t.record_stream(current)
