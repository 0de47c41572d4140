"""PASCAL VOC dataset reader (host side) and the sample records the data
pipeline carries.

A JAX-free copy of `fasterrcnn_tpu/data/voc.py`: the reader parses the XML,
decodes and resizes the JPEGs (`data/image.load_image`: the native reader
where it builds, else PIL), flips, and scales the ground truth. Anchor maps and RPN targets are computed on the
device inside the train step. The same seed gives the same order and the
same flips as the JAX package's reader.

Semantics kept:
  * the fixed 21-class VOC contract, with the class discovery check;
  * 1-based -> 0-based corner conversion;
  * difficult objects filtered out unless allow_difficult;
  * 50% horizontal flips, flipped x computed as width-1-x against the
    *original* size, then scaled;
  * optional in-memory caching of one unflipped array per file;
  * per-epoch shuffling.

`batch_decode=True` hands undecoded samples (`DeferredJpeg`) to
`data/pipeline.make_host_batch`, which decodes them straight into the
padded batch (one threaded native call a batch, or PIL). `batch_decode=None`
(the default) means "when the native reader is available", as in JAX.
"""

from __future__ import annotations

import dataclasses
import os
import random
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from fasterrcnn_torch.data import image as image_lib

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
CLASS_NAME_TO_INDEX = {n: i for i, n in CLASS_INDEX_TO_NAME.items()}
NUM_CLASSES = len(VOC_CLASSES)


@dataclasses.dataclass
class Box:
    """One ground-truth box."""

    class_index: int
    class_name: str
    corners: np.ndarray  # (4,) f32 (y1, x1, y2, x2)

    def __repr__(self):
        return "Box(class=%s (%d), corners=%s)" % (
            self.class_name,
            self.class_index,
            self.corners,
        )


@dataclasses.dataclass
class DeferredJpeg:
    """Decode instructions for a sample whose pixels are produced at batch
    time (data/pipeline.make_host_batch), straight into the padded batch."""

    min_side: int
    max_side: int
    # Called with the decoded UNFLIPPED (H, W, 3) array so the dataset can
    # cache one variant per file (flips are applied as views on read).
    cache_sink: Optional[object] = None


@dataclasses.dataclass
class Sample:
    """One training/eval sample; labels are assigned on the device."""

    image_u8: Optional[np.ndarray]  # (H, W, 3) uint8 resized; None = deferred
    image_hw: Tuple[int, int]  # real (height, width) after resize
    gt_boxes: List[Box]  # in the resized image's pixels
    filepath: str
    flip: bool = False
    deferred: Optional[DeferredJpeg] = None  # set iff image_u8 is None

    @property
    def image(self):
        """The resized image as a PIL image, for drawing; None while the
        pixels are deferred."""
        if self.image_u8 is None:
            return None
        from PIL import Image

        return Image.fromarray(np.ascontiguousarray(self.image_u8))

    def materialize(self) -> "Sample":
        """Decode a deferred sample's pixels in place (for consumers outside
        the batched pipeline, such as --dump-anchors). No-op when the pixels
        already exist."""
        if self.image_u8 is not None or self.deferred is None:
            return self
        arr, _, _, _ = image_lib.load_image(
            self.filepath,
            min_dimension_pixels=self.deferred.min_side,
            max_dimension_pixels=self.deferred.max_side,
        )
        # The batch path's check (pipeline._decode_deferred_into): the gt
        # boxes were scaled from the annotation's <size>.
        if arr.shape[:2] != tuple(self.image_hw):
            raise ValueError(
                f"{self.filepath}: decoded to {arr.shape[:2]} but the "
                f"annotation's <size> element predicted {tuple(self.image_hw)}"
            )
        if self.deferred.cache_sink is not None:
            self.deferred.cache_sink(arr)
        self.image_u8 = arr[:, ::-1] if self.flip else arr
        self.deferred = None  # invariant: deferred is set iff image_u8 is None
        return self


class Dataset:
    """A VOC split iterator."""

    num_classes = NUM_CLASSES
    class_index_to_name = CLASS_INDEX_TO_NAME

    def __init__(
        self,
        split: str,
        dir: str = "VOCdevkit/VOC2007",
        augment: bool = True,
        shuffle: bool = True,
        allow_difficult: bool = False,
        cache: bool = True,
        min_dimension_pixels: int = 600,
        max_dimension_pixels: int = 1600,
        seed: Optional[int] = None,
        batch_decode: Optional[bool] = None,
    ):
        if not os.path.exists(dir):
            raise FileNotFoundError(f"Dataset directory does not exist: {dir}")
        self.split = split
        self._dir = dir
        self._rng = random.Random(seed)
        self.class_index_to_name = self._discover_classes()
        self.class_name_to_index = {
            name: idx for idx, name in self.class_index_to_name.items()
        }
        self.num_classes = len(self.class_index_to_name)
        if self.num_classes != NUM_CLASSES:
            raise ValueError(
                "Dataset does not have the expected number of classes "
                f"(found {self.num_classes}, expected {NUM_CLASSES})"
            )
        if self.class_index_to_name != CLASS_INDEX_TO_NAME:
            raise ValueError("Dataset does not have the expected class mapping")
        self._filepaths = self._list_filepaths()
        self.num_samples = len(self._filepaths)
        self._gt_boxes_by_filepath, self._orig_hw_by_filepath = (
            self._parse_all_annotations(self._filepaths, allow_difficult)
        )
        self._augment = augment
        self._shuffle = shuffle
        self._cache_enabled = cache
        self._min_dim = min_dimension_pixels
        self._max_dim = max_dimension_pixels
        # One UNFLIPPED resized array per file; flips are views on read.
        self._cache: Dict[str, np.ndarray] = {}
        # Deferred batch decode: the resized extent is known before decoding
        # from the annotation's <size> element.
        if batch_decode is None:
            from fasterrcnn_torch.data import native_loader

            batch_decode = native_loader.available()
        self._batch_decode = batch_decode
        self._order = list(self._filepaths)
        self._i = 0

    # -- iteration --------------------------------------------------------

    def __iter__(self):
        self._i = 0
        if self._shuffle:
            self._rng.shuffle(self._order)
        return self

    def __next__(self) -> Sample:
        if self._i >= len(self._order):
            raise StopIteration
        filepath = self._order[self._i]
        self._i += 1
        flip = self._rng.randint(0, 1) != 0 if self._augment else False
        arr = self._cache.get(filepath)
        if arr is None and not self._batch_decode:
            arr = self._decode_unflipped(filepath)
            if self._cache_enabled:
                self._cache[filepath] = arr
        if arr is not None:
            # A horizontal flip commutes with the center-aligned bilinear
            # resize, so a flipped view of the resized cache equals
            # flip-before-scale.
            img = arr[:, ::-1] if flip else arr
            return Sample(
                image_u8=img,
                image_hw=(arr.shape[0], arr.shape[1]),
                gt_boxes=self._gt_for(filepath, flip),
                filepath=filepath,
                flip=flip,
            )
        sink = self._cache_store(filepath) if self._cache_enabled else None
        return Sample(
            image_u8=None,
            image_hw=self._expected_resized_hw(filepath),
            gt_boxes=self._gt_for(filepath, flip),
            filepath=filepath,
            flip=flip,
            deferred=DeferredJpeg(
                min_side=self._min_dim,
                max_side=self._max_dim,
                cache_sink=sink,
            ),
        )

    def cache_nbytes(self) -> int:
        """In-memory image-cache footprint in bytes."""
        return sum(a.nbytes for a in self._cache.values())

    def _cache_store(self, filepath: str):
        def sink(arr: np.ndarray) -> None:
            self._cache[filepath] = arr

        return sink

    def _scale_for(self, filepath: str) -> float:
        oh, ow = self._orig_hw_by_filepath[filepath]
        return image_lib.compute_scale_factor(ow, oh, self._min_dim, self._max_dim)

    def _expected_resized_hw(self, filepath: str) -> Tuple[int, int]:
        oh, ow = self._orig_hw_by_filepath[filepath]
        scale = self._scale_for(filepath)
        # Truncation, as load_image does (int(image.height * scale_factor)).
        return int(oh * scale), int(ow * scale)

    def _gt_for(self, filepath: str, flip: bool) -> List[Box]:
        """Scaled (and flip-adjusted) ground truth for one sample read.

        Flipped x-coords are computed against the *original* width, then
        scaled (flip before scale)."""
        _, original_width = self._orig_hw_by_filepath[filepath]
        scale = self._scale_for(filepath)
        gt_boxes = []
        for box in self._gt_boxes_by_filepath[filepath]:
            corners = box.corners
            if flip:
                corners = np.array(
                    [
                        corners[0],
                        original_width - 1 - corners[3],
                        corners[2],
                        original_width - 1 - corners[1],
                    ],
                    dtype=np.float32,
                )
            gt_boxes.append(
                Box(
                    class_index=box.class_index,
                    class_name=box.class_name,
                    corners=corners * scale,
                )
            )
        return gt_boxes

    def _decode_unflipped(self, filepath: str) -> np.ndarray:
        image_u8, _, _, (_, oh, ow) = image_lib.load_image(
            filepath,
            min_dimension_pixels=self._min_dim,
            max_dimension_pixels=self._max_dim,
        )
        expected = self._orig_hw_by_filepath[filepath]
        if (oh, ow) != expected:
            raise ValueError(
                f"{filepath}: decoded size {(oh, ow)} does not match the "
                f"annotation's <size> element {expected}"
            )
        return image_u8

    # -- filesystem parsing ------------------------------------------------

    def _discover_classes(self) -> Dict[int, str]:
        imageset_dir = os.path.join(self._dir, "ImageSets", "Main")
        classes = {
            os.path.basename(path).split("_")[0]
            for path in Path(imageset_dir).glob(f"*_{self.split}.txt")
        }
        if not classes:
            raise ValueError(f"No classes found in ImageSets/Main for '{self.split}'")
        mapping = {i + 1: name for i, name in enumerate(sorted(classes))}
        mapping[0] = "background"
        return dict(sorted(mapping.items()))

    def _list_filepaths(self) -> List[str]:
        list_file = os.path.join(self._dir, "ImageSets", "Main", self.split + ".txt")
        with open(list_file) as fp:
            basenames = [line.strip() for line in fp if line.strip()]
        return [os.path.join(self._dir, "JPEGImages", name) + ".jpg" for name in basenames]

    def _parse_all_annotations(self, filepaths, allow_difficult):
        boxes_out = {}
        sizes_out = {}
        for filepath in filepaths:
            basename = os.path.splitext(os.path.basename(filepath))[0]
            annotation_file = os.path.join(self._dir, "Annotations", basename) + ".xml"
            boxes_out[filepath], sizes_out[filepath] = parse_voc_annotation(
                annotation_file, self.class_name_to_index, allow_difficult
            )
        return boxes_out, sizes_out


def parse_voc_annotation(
    annotation_file: str,
    class_name_to_index: Dict[str, int],
    allow_difficult: bool,
) -> Tuple[List[Box], Tuple[int, int]]:
    """Parse one VOC XML file into (Box objects, original (h, w)); the
    <size> element gives the resized extent before any decode."""
    tree = ET.parse(annotation_file)
    root = tree.getroot()
    size = root.find("size")
    if size is None or int(size.find("depth").text) != 3:
        raise ValueError(f"{annotation_file}: no <size> element of depth 3")
    orig_hw = (int(size.find("height").text), int(size.find("width").text))
    boxes = []
    for obj in root.findall("object"):
        if int(obj.find("difficult").text) != 0 and not allow_difficult:
            continue
        class_name = obj.find("name").text
        bndbox = obj.find("bndbox")
        # VOC is 1-based inclusive; convert to 0-based.
        x_min = int(bndbox.find("xmin").text) - 1
        y_min = int(bndbox.find("ymin").text) - 1
        x_max = int(bndbox.find("xmax").text) - 1
        y_max = int(bndbox.find("ymax").text) - 1
        boxes.append(
            Box(
                class_index=class_name_to_index[class_name],
                class_name=class_name,
                corners=np.array([y_min, x_min, y_max, x_max], np.float32),
            )
        )
    if not boxes:
        raise ValueError(f"No usable ground-truth boxes in {annotation_file}")
    return boxes, orig_hw
