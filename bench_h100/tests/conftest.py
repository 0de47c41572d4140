"""Fixtures of the benchmark's own tests.

    python -m pytest -q -p no:cacheprovider bench_h100/tests

They run on the CPU at a tiny size (ResNet-50, 128x160 canvases, small
proposal caps); the tests marked `cuda` run the benchmark's cells on the
card and skip where torch.cuda.is_available() is false (decided in the
`cuda` fixture, never at import).
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
REPO = BENCH.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

SCENE = {"height": 128, "width": 160, "objects": [1, 3], "box_frac": [0.3, 0.6]}
PREDICT = {"kind": "predict", "batch": 2, "pool_batches": 2, "score_threshold": 0.05, "canvas": [128, 160],
           "scene": SCENE}
TRAIN = {"kind": "train", "batch": 2, "scan_steps": 2, "epoch_samples": 9, "pool_scenes": 8, "flip": 0.5,
         "canvas": [128, 160], "scene": SCENE}


# The cells' numbers, with limits for this size. The tests run the tiny
# configuration in float32, where the program equals the reference; on the
# CPU at this size the float8 control read worst_batch_q50 >= 0.33 and
# trace_gap >= 0.043 (3 seeds each); the RPN has no anchor inside a 128x160
# image.
TINY_LIMITS = {"worst_class_q50": 0.05, "worst_batch_count_gap": 0.05, "rpn_loss_gap": 0.009,
               "rpn_loss_gap_mean": 0.009, "trace_gap": 0.02, "update_gap": 0.02}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips where torch.cuda.is_available() is false")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port on the H100 and never on the CPU")


def tiny_config(source: str, dtype: str = "float32") -> dict:
    cfg = json.loads((BENCH / "configs" / f"{source}.json").read_text())
    cfg["name"] = "tiny"
    cfg["model"].update(backbone="resnet50", compute_dtype=dtype)
    cfg["model"]["rpn"].update(pre_nms_train=600, post_nms_train=100, pre_nms_infer=300, post_nms_infer=50)
    cfg["model"]["detector"]["proposal_batch_size"] = 32
    return cfg


def make_tiny(root: Path, dtype: str = "float32") -> dict:
    """A benchmark directory under `root`: a copy of bench_h100 (its
    metrics, limits and code) with a tiny configuration and two tiny mixes,
    and the BENCHMARK dict of its two cells, `tiny.p` (the numbers
    `vgg16-bf16.predict-b32` compares) and `tiny.t` (those of
    `resnet101-bf16.train-b8`), with TINY_LIMITS."""
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"), dirs_exist_ok=True)
    (root / "configs" / "tiny.json").write_text(json.dumps(tiny_config("resnet101-bf16", dtype)))
    (root / "traffic" / "p.json").write_text(json.dumps(PREDICT))
    (root / "traffic" / "t.json").write_text(json.dumps(TRAIN))
    for cell, source in (("tiny.p", "vgg16-bf16.predict-b32"), ("tiny.t", "resnet101-bf16.train-b8")):
        limits = json.loads((root / "limits" / f"{source}.json").read_text())
        for name, spec in limits["limits"].items():
            spec["limit"] = TINY_LIMITS[name]
        (root / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    rename = {"vgg16-bf16.predict-b32": "tiny.p", "resnet101-bf16.train-b8": "tiny.t"}

    def cells(entry):
        if "workloads" not in entry:
            return entry
        return dict(entry, workloads=[rename[w] for w in entry["workloads"] if w in rename])

    bench["configs"] = [{"name": "tiny", "source": "test", "file": "configs/tiny.json", "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": "tiny.p", "config": "tiny", "traffic": "p", "chips": 1, "why": "test"},
                          {"name": "tiny.t", "config": "tiny", "traffic": "t", "chips": 1, "why": "test"}]
    bench["end_to_end"] = [cells(m) for m in bench["end_to_end"]]
    bench["per_layer"] = [cells(m) for m in bench["per_layer"]]
    return bench


@pytest.fixture
def tiny(tmp_path):
    torch.set_num_threads(4)
    root = tmp_path / "bench"
    return root, make_tiny(root)
