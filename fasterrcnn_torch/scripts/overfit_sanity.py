"""End-to-end learning check: overfit 4 synthetic images to ~100% mAP.

The strongest correctness evidence that needs no VOC data: a working
implementation of proposal labeling, minibatch sampling, all four losses,
gradients and the eval protocol drives the train-set mAP to ~100% on the
solid-rectangle synthetic set. A sign or assignment fault anywhere in the
pipeline keeps the mAP near zero even while the losses fall.

The JAX package's `scripts/overfit_sanity.py` with the same recipe: the
tiny config (anchors 24^2/48^2/96^2, caps 400 -> 128 train and 200 -> 64
infer, RPN minibatch 64, proposal batch 32, 8 ground-truth boxes), SGD at
learning rate 2e-3 without weight decay, batch 4, seed 0, four 120x150
images of `SyntheticDataset(seed=3)`, OVERFIT_EPOCHS epochs (default 150),
then `Engine.evaluate` at score threshold 0.05 on the same images; below
90% it exits with the mAP. Run on the card:

  python -m fasterrcnn_torch.scripts.overfit_sanity
  OVERFIT_BACKBONE=resnet50 python -m fasterrcnn_torch.scripts.overfit_sanity

`main(device=..., roi_mode=...)` runs it from Python (`device="cpu"` asks
for the CPU; `roi_mode="exact_pool"` trains exact RoIPool instead of the
crop); the backbone and the epochs come from the environment as above.
"""

from __future__ import annotations

import os
import time

from fasterrcnn_torch.config import AnchorConfig, DetectorConfig, ModelConfig, RPNConfig, TrainConfig
from fasterrcnn_torch.data.synthetic import SyntheticDataset
from fasterrcnn_torch.engine import Engine

THRESHOLD = 90.0


def tiny_config(backbone: str = "vgg16", roi_mode: str = "crop") -> ModelConfig:
    """Small canvas and scaled anchors (`tests/test_model.py`'s tiny config)."""
    return ModelConfig(
        num_classes=21,
        backbone=backbone,
        anchors=AnchorConfig(areas=(24.0 * 24, 48.0 * 48, 96.0 * 96)),
        rpn=RPNConfig(pre_nms_train=400, post_nms_train=128, pre_nms_infer=200, post_nms_infer=64, minibatch_size=64),
        detector=DetectorConfig(proposal_batch_size=32),
        max_gt_boxes=8,
        roi_mode=roi_mode,
    )


def main(device: str = "cuda", roi_mode: str = "crop") -> float:
    """Train, evaluate and return the train-set mAP in percent; SystemExit
    below THRESHOLD."""
    epochs = int(os.environ.get("OVERFIT_EPOCHS", "150"))
    backbone = os.environ.get("OVERFIT_BACKBONE", "vgg16")
    engine = Engine(
        tiny_config(backbone, roi_mode),
        TrainConfig(learning_rate=2e-3, batch_size=4, weight_decay=0.0),
        seed=0,
        device=device,
    )
    data = SyntheticDataset(num_samples=4, height=120, width=150, seed=3)
    t0 = time.perf_counter()
    for epoch in range(1, epochs + 1):
        stats = engine.train_epoch(data, batch_size=4, progress=False)
        if epoch % 10 == 0:
            means = stats.means()
            print(f"epoch {epoch:3d}: " + " ".join(f"{k}={v:.3f}" for k, v in means.items()), flush=True)
    mAP = engine.evaluate(data, batch_size=4, progress=False, score_threshold=0.05)
    print(f"overfit mAP on train images ({backbone}, roi_mode={roi_mode}, {epochs} epochs, "
          f"{time.perf_counter() - t0:.1f} s): {mAP:.1f}%", flush=True)
    if mAP < THRESHOLD:
        raise SystemExit(f"FAIL: expected ~100% overfit mAP, got {mAP:.1f}%")
    print("PASS", flush=True)
    return mAP


if __name__ == "__main__":
    main()
