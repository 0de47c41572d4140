"""The port's mAP calculator and `Engine.evaluate` against the JAX package's.

* The calculator (`utils/stats.PrecisionRecallCurveCalculator`) on 200
  seeded images of random detections and ground truth, with duplicate
  detections, detections at IoU exactly 0.5 of a gt box and classes without
  objects: AP per class and mAP equal JAX's to 1e-12.
* `Engine.evaluate` on a predict stub that returns the ground truth: 100.0;
  with num_samples=3 and batch_size=2 it sees exactly those 3 images and no
  zero-weight padding row reaches the calculator.
* The port's `Engine(device="cpu").evaluate` and JAX's `Engine.evaluate`
  on the same weights (carried by `utils/weights.from_jax_params`) over the
  same VOC test split: tiny config, 6 images, batch_size=4 (two canvas
  buckets, so residue batches). The JAX reader is held to its PIL path (see
  `tests/test_torch_voc.py`). Tolerance 0 on the mAP: the two packages'
  detections agree to ~1e-5 (tests/test_torch_predict.py), and only a score
  tie inside that gap or a box within ~1e-4 of IoU 0.5 to a gt box could
  move a match or a rank; this split has neither, at either threshold.
"""

import numpy as np
import pytest
import torch

from fasterrcnn_tpu import config as jax_config
from fasterrcnn_tpu import engine as jax_engine
from fasterrcnn_tpu.data import native_loader as jax_native_loader
from fasterrcnn_tpu.data import voc as jax_voc
from fasterrcnn_tpu.utils import stats as jax_stats
from fasterrcnn_torch import config as torch_config
from fasterrcnn_torch import engine as torch_engine
from fasterrcnn_torch.data import native_loader, synthetic_voc, voc
from fasterrcnn_torch.data.voc import Box, Sample
from fasterrcnn_torch.models.faster_rcnn import Detections
from fasterrcnn_torch.utils import stats
from fasterrcnn_torch.utils.weights import from_jax_params
from tests.test_torch_predict import tiny_config

SIZES = dict(min_dimension_pixels=120, max_dimension_pixels=160)


def random_image_results(rng, num_classes=21):
    """One image's gt boxes and per-class scored detections. Class 20 never
    has an object; some detections duplicate a gt box, some overlap one at
    IoU exactly 0.5 (of the boxes' areas), the rest are random."""
    gts = []
    for _ in range(int(rng.integers(0, 5))):
        y1, x1 = rng.integers(0, 80, 2).astype(np.float64)
        h, w = rng.integers(4, 40, 2) * 2.0
        gts.append(Box(int(rng.integers(1, num_classes - 1)), "x", np.array([y1, x1, y1 + h, x1 + w], np.float32)))
    scored = {}
    for c in range(1, num_classes):
        rows = []
        for g in gts:
            if g.class_index != c:
                continue
            y1, x1, y2, x2 = (float(v) for v in g.corners)
            for _ in range(int(rng.integers(0, 3))):  # duplicates
                rows.append([y1, x1, y2, x2, rng.uniform()])
            if rng.uniform() < 0.5:  # half the box: IoU exactly 0.5
                rows.append([y1, x1, y2, x1 + (x2 - x1) / 2, rng.uniform()])
        for _ in range(int(rng.integers(0, 4))):
            y1, x1 = rng.uniform(0, 90, 2)
            rows.append([y1, x1, y1 + rng.uniform(2, 40), x1 + rng.uniform(2, 40), rng.uniform()])
        if rng.uniform() < 0.2:  # a score tie
            rows.append(list(rows[0]) if rows else [0, 0, 5, 5, 0.5])
        rows = np.asarray(rows, np.float32).reshape(-1, 5)
        scored[c] = rows[np.argsort(-rows[:, 4], kind="stable")]
    return scored, gts


def test_calculator_matches_jax():
    rng = np.random.default_rng(0)
    mine, theirs = stats.PrecisionRecallCurveCalculator(), jax_stats.PrecisionRecallCurveCalculator()
    for _ in range(200):
        scored, gts = random_image_results(rng)
        mine.add_image_results(scored, gts)
        theirs.add_image_results(scored, gts)
    got, want = mine.compute_average_precisions(), theirs.compute_average_precisions()
    assert got.keys() == want.keys()
    assert 20 not in got  # a class without objects has no AP
    for c in want:
        assert abs(got[c] - want[c]) <= 1e-12, c
    assert 0.0 < want[1] < 1.0
    assert abs(mine.compute_mean_average_precision() - theirs.compute_mean_average_precision()) <= 1e-12


def test_calculator_matches_at_iou_exactly_half():
    gt = [Box(3, "x", np.array([0.0, 0.0, 10.0, 10.0], np.float32))]
    half = {3: np.array([[0.0, 0.0, 10.0, 5.0, 0.9]], np.float32)}
    for calc in (stats.PrecisionRecallCurveCalculator(), jax_stats.PrecisionRecallCurveCalculator()):
        calc.add_image_results(half, gt)
        assert calc.compute_average_precisions() == {3: 0.0}  # IoU 0.5 is not > 0.5


def gt_stub_samples(n=5):
    """Samples whose first pixel holds their index + 1; the canvas padding
    rows of a residue batch are 0 there."""
    samples = []
    for i in range(n):
        image = np.full((120, 150, 3), i + 1, np.uint8)
        boxes = [Box(1 + i % 20, "x", np.array([10.0 + i, 20.0, 60.0 + i, 90.0], np.float32)),
                 Box(1 + (i + 7) % 20, "x", np.array([50.0, 60.0 - i, 110.0, 140.0 - i], np.float32))]
        samples.append(Sample(image_u8=image, image_hw=(120, 150), gt_boxes=boxes, filepath=f"stub://{i}"))
    return samples


@pytest.fixture(scope="module")
def cpu_engine():
    return torch_engine.Engine(tiny_config(torch_config), seed=0, device="cpu")


@pytest.fixture
def gt_predict(cpu_engine, monkeypatch):
    """Engine.predict returning each sample's gt boxes at score 0.9, and a
    confident wrong box for a padding row."""
    samples = gt_stub_samples()
    num_fg, d = 20, 4

    def predict(images, image_hw, score_threshold=0.05):
        b = images.shape[0]
        boxes = torch.zeros((b, num_fg, d, 4))
        scores = torch.zeros((b, num_fg, d))
        valid = torch.zeros((b, num_fg, d))
        for row in range(b):
            idx = int(images[row, 0, 0, 0]) - 1
            gts = samples[idx].gt_boxes if idx >= 0 else [Box(1, "x", np.array([0.0, 0.0, 5.0, 5.0], np.float32))]
            for j, g in enumerate(gts):
                boxes[row, g.class_index - 1, j] = torch.from_numpy(g.corners)
                scores[row, g.class_index - 1, j] = 0.9
                valid[row, g.class_index - 1, j] = 1.0
        return Detections(boxes=boxes, scores=scores, valid=valid)

    monkeypatch.setattr(cpu_engine, "predict", predict)
    return samples


def test_evaluate_of_ground_truth_is_100(cpu_engine, gt_predict):
    assert cpu_engine.evaluate(gt_predict, batch_size=2, progress=False) == 100.0


def test_evaluate_sees_num_samples_and_no_padding(cpu_engine, gt_predict, monkeypatch):
    seen = []

    class Recording(stats.PrecisionRecallCurveCalculator):
        def add_image_results(self, scored, gt_boxes):
            seen.append(gt_boxes)
            super().add_image_results(scored, gt_boxes)

    monkeypatch.setattr(torch_engine, "PrecisionRecallCurveCalculator", Recording)
    # 3 images at batch 2: one full batch and a residue padded with a blank
    # row whose stub detection would be a false positive of class 1.
    assert cpu_engine.evaluate(gt_predict, batch_size=2, num_samples=3, progress=True) == 100.0
    assert seen == [s.gt_boxes for s in gt_predict[:3]]


@pytest.fixture(scope="module")
def voc_test_split(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc_eval") / "VOC2007"
    return synthetic_voc.generate_voc_dataset(str(root), {"test": 6}, seed=2)


def test_evaluate_matches_jax_on_a_voc_split(voc_test_split, monkeypatch, capsys):
    monkeypatch.setattr(jax_native_loader, "available", lambda: False)
    monkeypatch.setattr(native_loader, "available", lambda: False)
    jax_eng = jax_engine.Engine(tiny_config(jax_config), seed=0, init_canvas=(128, 160))
    port = torch_engine.Engine(tiny_config(torch_config), seed=1, device="cpu")
    port.set_params(from_jax_params(jax_eng.params))

    def split(module):
        return module.Dataset("test", dir=voc_test_split, augment=False, shuffle=False, cache=False,
                              batch_decode=False, **SIZES)

    # Random weights score every class near 1/21, so both thresholds matter.
    for threshold in (0.0, 0.05):
        want = jax_eng.evaluate(split(jax_voc), batch_size=4, score_threshold=threshold, progress=False)
        got = port.evaluate(split(voc), batch_size=4, score_threshold=threshold, progress=False,
                            print_average_precisions=True)
        out = capsys.readouterr().out
        assert "Average Precisions" in out and "Mean Average Precision = %1.2f%%" % got in out
        assert 0.0 < want < 100.0
        assert got == want, (threshold, got, want)
