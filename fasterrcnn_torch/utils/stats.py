"""Running per-epoch loss means (the JAX package's `TrainingStatistics`)."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict


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
