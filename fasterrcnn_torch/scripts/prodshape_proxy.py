#!/usr/bin/env python
"""Production-shape learning proxy: the stand-in for the VOC2007 mAP gate
when no VOC data and no pretrained weights are on disk.

The JAX package's `scripts/prodshape_proxy.py`, with the same flags,
defaults, seeds and phases, driven through `python -m fasterrcnn_torch`
(its `main`, in this process):

  * a synthetic VOC-format dataset at production shapes (seed 7): 375x500
    originals that resize to 600x800, the standard 608x800 canvas;
  * the standard model config: the 128/256/512-px anchor pyramid,
    12000 -> 2000 train and 6000 -> 300 infer proposal caps, batch 8, bf16
    (`--compute-dtype float32` runs the same recipe in f32, named so in the
    record's "canvas");
  * `--train` in two phases (the reference's long phase at the learning
    rate, then a short one at a tenth of it from phase 1's best weights,
    each phase with its own `--save-best-to`), then `--eval` of the best
    weights on the held-out test split, whose "Mean Average Precision =
    X%" line is the result;
  * the record (the JAX record's fields, the card's name and power limit as
    nvidia-smi gives them, and "package": "fasterrcnn_torch") is appended
    to the backbone's list in PRODSHAPE_PROXY_TORCH.json at the repository
    root (`--no-record`: none); below `--threshold` it exits with the mAP.

Run on the card, for example:

  python -m fasterrcnn_torch.scripts.prodshape_proxy --run-seed 0
  python -m fasterrcnn_torch.scripts.prodshape_proxy --backbone resnet101 \\
      --train-all --optimizer adam --lr-schedule cosine --warmup-steps 64 \\
      --epochs 84 --epochs2 0 --run-seed 0
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RECORD = os.path.join(REPO, "PRODSHAPE_PROXY_TORCH.json")


class _Tee(io.TextIOBase):
    """Capture the CLI's standard output while still streaming it to the
    stream that was standard output before."""

    def __init__(self):
        self.buf = io.StringIO()
        self.out = sys.stdout

    def write(self, s):
        self.buf.write(s)
        self.out.write(s)
        return len(s)

    def flush(self):
        self.out.flush()


def run_cli(args):
    """`python -m fasterrcnn_torch` with `args`; returns what it printed."""
    from fasterrcnn_torch.cli import main as cli_main

    tee = _Tee()
    with contextlib.redirect_stdout(tee):
        cli_main(args)
    return tee.buf.getvalue()


def device_line() -> str:
    """The card's name and power limit (nvidia-smi), or "cpu" without a card."""
    import torch

    if not torch.cuda.is_available():
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0].strip()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--epochs", type=int, default=20, help="Phase-1 epochs at --learning-rate")
    p.add_argument("--epochs2", type=int, default=8,
                   help="Phase-2 epochs at learning-rate/10 (the reference's two-phase schedule; 0 disables)")
    p.add_argument("--train-images", type=int, default=128)
    p.add_argument("--eval-images", type=int, default=32)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--backbone", default="vgg16")
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--optimizer", default="sgd", choices=["sgd", "adam"],
                   help="Optimizer of the train phases; from-scratch ResNet proxies use adam")
    p.add_argument("--threshold", type=float, default=80.0, help="Required held-out mAP (%%)")
    p.add_argument("--run-seed", type=int, default=0,
                   help="Training seed offset: the phases' seeds are run_seed*2 and run_seed*2+1")
    p.add_argument("--lr-schedule", default="constant", choices=["constant", "cosine"],
                   help="CLI --lr-schedule of the train phases; pair cosine with --epochs2 0")
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--train-all", action="store_true",
                   help="Pass --train-all (from-scratch mode) to the train phases; needed for ResNet proxies, "
                        "whose frozen stem would keep its random weights")
    p.add_argument("--compute-dtype", default="bfloat16", choices=["bfloat16", "float32"],
                   help="CLI --compute-dtype of every phase; the recipe's is bfloat16, float32 tells the "
                        "type's share of a result apart")
    p.add_argument("--no-record", action="store_true", help="Skip writing PRODSHAPE_PROXY_TORCH.json")
    return p


def schedule_name(args) -> str:
    if args.epochs2:
        return "two-phase (lr, lr/10), fresh optimizer at reload"
    return f"single-phase {args.lr_schedule}" + (" (warmup + decay to 0)" if args.lr_schedule == "cosine" else "")


def append_record(path: str, record: dict) -> None:
    """Add `record` to its backbone's list of runs in the JSON file at `path`."""
    runs = {}
    if os.path.exists(path):
        with open(path) as f:
            runs = json.load(f)
    runs.setdefault(record["backbone"], []).append(record)
    with open(path, "w") as f:
        json.dump(runs, f, indent=2)
        f.write("\n")


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from fasterrcnn_torch.data.synthetic_voc import generate_voc_dataset

    root = tempfile.mkdtemp(prefix="prodshape_voc_")
    try:
        voc = os.path.join(root, "VOC2007")
        generate_voc_dataset(
            voc,
            splits={"trainval": args.train_images, "test": args.eval_images},
            image_sizes=((375, 500),),  # min-side-600 resize -> (608, 800)
            seed=7,
        )
        weights = os.path.join(root, "proxy_weights.pth")

        def train_phase(epochs, lr, load, save, seed, best):
            cli = [
                "--train",
                "--dataset-dir", voc,
                "--epochs", str(epochs),
                "--batch-size", str(args.batch_size),
                "--eval-batch-size", str(args.batch_size),
                "--compute-dtype", args.compute_dtype,
                "--cache-images",
                "--backbone", args.backbone,
                "--learning-rate", str(lr),
                "--periodic-eval-samples", str(args.eval_images),
                "--save-to", save,
                "--seed", str(seed),
                "--optimizer", args.optimizer,
                "--lr-schedule", args.lr_schedule,
                "--warmup-steps", str(args.warmup_steps),
                # The shipped weights are the best-mAP epoch's (the
                # reference's BestWeightsTracker).
                "--save-best-to", best,
            ]
            if args.train_all:
                cli += ["--train-all"]
            if load:
                cli += ["--load-from", load]
            run_cli(cli)

        best1 = os.path.join(root, "proxy_best_p1.pth")
        best2 = os.path.join(root, "proxy_best_p2.pth")
        t0 = time.time()
        train_phase(args.epochs, args.learning_rate, None, weights, seed=args.run_seed * 2, best=best1)
        p1 = best1 if os.path.exists(best1) else weights
        if args.epochs2:
            # Phase 2 resumes from phase 1's best weights, with a fresh
            # optimizer, and keeps its own best-weights file.
            train_phase(args.epochs2, args.learning_rate / 10, p1, weights, seed=args.run_seed * 2 + 1, best=best2)
        final = best2 if os.path.exists(best2) else p1
        train_seconds = time.time() - t0

        out = run_cli([
            "--eval",
            "--dataset-dir", voc,
            "--load-from", final,
            "--eval-batch-size", str(args.batch_size),
            "--compute-dtype", args.compute_dtype,
            "--backbone", args.backbone,
        ])
        map_final = float(re.findall(r"Mean Average Precision = ([0-9.]+)%", out)[-1])
        record = {
            "map_heldout_pct": map_final,
            "threshold_pct": args.threshold,
            "passed": map_final >= args.threshold,
            "train_images": args.train_images,
            "eval_images": args.eval_images,
            "epochs": args.epochs,
            "epochs_phase2": args.epochs2,
            "schedule": schedule_name(args),
            "optimizer": args.optimizer,
            "learning_rate": args.learning_rate,
            "lr_schedule": args.lr_schedule,
            "warmup_steps": args.warmup_steps,
            "weights": "best-mAP epoch (BestWeightsTracker parity)",
            "batch_size": args.batch_size,
            "backbone": args.backbone,
            "run_seed": args.run_seed,
            "train_all": args.train_all,
            "canvas": "608x800 (standard bucket; full anchor pyramid, 12000->2000 train caps, "
                      + ("bf16)" if args.compute_dtype == "bfloat16" else "f32)"),
            "train_wall_seconds": round(train_seconds, 1),
            "device": device_line(),
            "package": "fasterrcnn_torch",
        }
        print(json.dumps(record), flush=True)
        if not args.no_record:
            append_record(RECORD, record)
        if not record["passed"]:
            raise SystemExit(f"held-out mAP {map_final:.2f}% < required {args.threshold}%")
        return record
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
