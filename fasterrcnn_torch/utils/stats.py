"""Training statistics and the VOC mAP calculator.

A copy of the JAX package's `utils/stats.py`. The mAP protocol is the
reference's, exactly:
  * greedy true-positive matching at IoU > 0.5, each gt box claimable once,
    predictions ranked by confidence across the whole split;
  * all-point interpolated precision (running max from each recall point);
  * AP by rectangular integration, mAP = unweighted mean over the classes
    that have ground-truth objects.
Host-side NumPy; the IoU of an image's predictions and gt boxes is one
vectorized matrix.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Sequence

import numpy as np


def _iou_matrix(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    top_left = np.maximum(boxes1[:, None, 0:2], boxes2[None, :, 0:2])
    bottom_right = np.minimum(boxes1[:, None, 2:4], boxes2[None, :, 2:4])
    well_ordered = np.all(top_left < bottom_right, axis=2)
    inter = well_ordered * np.prod(bottom_right - top_left, axis=2)
    a1 = np.prod(boxes1[:, 2:4] - boxes1[:, 0:2], axis=1)
    a2 = np.prod(boxes2[:, 2:4] - boxes2[:, 0:2], axis=1)
    return inter / (a1[:, None] + a2[None, :] - inter + 1e-7)


class TrainingStatistics:
    """Running means of the four losses over the steps of an epoch."""

    LOSS_NAMES = (
        "rpn_class",
        "rpn_regression",
        "detector_class",
        "detector_regression",
    )

    def __init__(self):
        self._sums = defaultdict(float)
        self._count = 0

    def on_training_step(self, losses) -> None:
        """`losses` is models.faster_rcnn.Losses (or any object with the four
        loss attributes as scalars). float() of a device scalar waits for the
        device; the train loop records batches of steps with
        on_training_step_values instead."""
        for name in self.LOSS_NAMES:
            self._sums[name] += float(getattr(losses, name))
        self._count += 1

    def on_training_step_values(self, values) -> None:
        """Record one step from a length-4 host array in LOSS_NAMES order."""
        for name, v in zip(self.LOSS_NAMES, values):
            self._sums[name] += float(v)
        self._count += 1

    def means(self) -> Dict[str, float]:
        c = max(self._count, 1)
        return {k: v / c for k, v in self._sums.items()}

    def get_progbar_postfix(self) -> Dict[str, str]:
        m = self.means()
        return {
            "rpn_class_loss": "%1.4f" % m.get("rpn_class", float("inf")),
            "rpn_regr_loss": "%1.4f" % m.get("rpn_regression", float("inf")),
            "detector_class_loss": "%1.4f" % m.get("detector_class", float("inf")),
            "detector_regr_loss": "%1.4f" % m.get("detector_regression", float("inf")),
            "total_loss": "%1.2f" % sum(m.values()),
        }


class PrecisionRecallCurveCalculator:
    """Accumulates per-image detections and computes AP/mAP."""

    def __init__(self):
        # class_index -> list of (score, is_true_positive)
        self._predictions = defaultdict(list)
        self._object_count = defaultdict(int)

    def add_image_results(
        self,
        scored_boxes_by_class_index: Dict[int, np.ndarray],
        gt_boxes: Sequence,
    ) -> None:
        """scored_boxes: class_index -> (N, 5) rows (y1, x1, y2, x2, score);
        gt_boxes: sequence of objects with .class_index and .corners."""
        for gt in gt_boxes:
            self._object_count[gt.class_index] += 1

        for class_index, scored in scored_boxes_by_class_index.items():
            scored = np.asarray(scored, dtype=np.float64).reshape(-1, 5)
            gt_this = np.array(
                [g.corners for g in gt_boxes if g.class_index == class_index],
                dtype=np.float64,
            ).reshape(-1, 4)
            n = scored.shape[0]
            is_tp = np.zeros(n, dtype=bool)
            if n and len(gt_this):
                ious = _iou_matrix(scored[:, :4], gt_this)  # (N, M)
                # Matching order replicates the reference exactly: its sort is
                # a no-op (it keys on a constant), so pairs are visited
                # gt-major in construction order and each gt claims the
                # first unclaimed prediction with IoU > 0.5. Predictions
                # arrive score-descending from NMS, so "first" means
                # "highest-scoring".
                gt_taken = np.zeros(len(gt_this), dtype=bool)
                for g in range(len(gt_this)):
                    for b in range(n):
                        if ious[b, g] <= 0.5:
                            continue
                        if is_tp[b] or gt_taken[g]:
                            continue
                        is_tp[b] = True
                        gt_taken[g] = True
            self._predictions[class_index].extend(
                (float(scored[i, 4]), bool(is_tp[i])) for i in range(n)
            )

    def _average_precision(self, class_index: int):
        preds = sorted(self._predictions[class_index], key=lambda p: -p[0])
        num_gt = self._object_count[class_index]
        recall, precision = [0.0], [0.0]
        tp = fp = 0
        for _, correct in preds:
            tp += 1 if correct else 0
            fp += 0 if correct else 1
            recall.append(tp / num_gt if num_gt else 0.0)
            precision.append(tp / (tp + fp))
        recall.append(1.0)
        precision.append(0.0)
        precision = np.maximum.accumulate(np.asarray(precision)[::-1])[::-1]
        recall = np.asarray(recall)
        return float(np.sum(np.diff(recall) * precision[1:])), recall, precision

    def compute_average_precisions(self) -> Dict[int, float]:
        return {
            ci: self._average_precision(ci)[0] for ci in self._object_count
        }

    def compute_mean_average_precision(self) -> float:
        aps = self.compute_average_precisions()
        return float(np.mean(list(aps.values()))) if aps else 0.0

    # -- reporting ----------------------------------------------------------

    def print_average_precisions(self, class_index_to_name: Dict[int, str]):
        aps = self.compute_average_precisions()
        rows = sorted(
            ((class_index_to_name[ci], ap) for ci, ap in aps.items()),
            key=lambda r: -r[1],
        )
        width = max((len(name) for name, _ in rows), default=10)
        print("Average Precisions")
        print("------------------")
        for name, ap in rows:
            print("%s: %1.1f%%" % (name.ljust(width), ap * 100.0))
        print("------------------")

    def plot_average_precisions(self, class_index_to_name: Dict[int, str]):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        aps = self.compute_average_precisions()
        rows = sorted(
            ((class_index_to_name[ci], ap * 100) for ci, ap in aps.items()),
            reverse=True,
        )
        labels, values = zip(*rows)
        plt.clf()
        plt.xlim([0, 100])
        plt.barh(labels, values)
        plt.title("Model Performance")
        plt.xlabel("Average Precision (%)")
        for i, v in enumerate(values):
            plt.text(v, i, "%1.1f" % v)
        plt.savefig("average_precisions.png", bbox_inches="tight")
        print("Saved AP plot to average_precisions.png")

    def plot_precision_vs_recall(self, class_index, class_name=None):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        ap, recall, precision = self._average_precision(class_index)
        label = "{0} AP={1:1.2f}".format(class_name or f"Class {class_index}", ap)
        plt.plot(recall, precision, label=label)
        plt.title("Precision vs. Recall")
        plt.xlabel("Recall")
        plt.ylabel("Precision")
        plt.legend()
        plt.savefig(f"pr_curve_{class_index}.png", bbox_inches="tight")
