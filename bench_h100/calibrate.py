"""Readings that the limits of `limits/<workload>.json` are set from.

    python3 bench_h100/calibrate.py --workload <name> --seeds 11,12,... [--control 3] [--faults half]

For each seed, the program's answers to the cell's timed call (each
predict pool batch once through `Engine.predict`; or the checked train
steps through `Engine.train_epoch`), at the cell's own sizes, held
against the float32 reference: the lower readings. On the first
`--control` seeds also the control, the reference computed in float8
(the precision below the configuration's bfloat16) put in the program's
place, and each of `--faults`, the reference with that fault planted put
in the program's place: the upper readings. Faults of a train cell:
"half" (half of each batch left out, the mean taken over the rest). Of a
predict cell: "nms_off" (per-class NMS suppresses nothing), "boxes_half"
(every other class's box regressor returns no offset), "roi_quarter"
(every fourth RoI's pooled features are zero). Predict cells also read
the program and the control against the reference in bfloat16 (sides
"program@bf16", "control@bf16"). Prints one JSON line a reading and a
summary (each number's largest program reading and smallest control and
fault readings); `--detail` keeps the raw readings (per-image costs;
per-step losses and per-leaf norms). The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


@contextlib.contextmanager
def planted(cell, fault: str):
    """A copy of the predict cell whose reference has `fault` planted."""
    from bench_h100 import harness
    from bench_h100.reference import model as ref

    broken = copy.copy(cell)
    broken.config = copy.deepcopy(cell.config)
    real_pool, real_weights = ref.roi_pool, harness.make_weights
    if fault == "nms_off":
        broken.config["model"]["detector"]["test_nms_iou_threshold"] = 1.0  # an IoU never exceeds 1
    elif fault == "roi_quarter":
        def roi_pool(*args):
            out = real_pool(*args).clone()
            out[:, ::4] = 0.0
            return out

        ref.roi_pool = roi_pool
    elif fault == "boxes_half":
        def make_weights(*args):
            p = real_weights(*args)
            for name in ("detector_heads.regressor.weight", "detector_heads.regressor.bias"):
                rows = p[name].view(-1, 4, *p[name].shape[1:])
                rows[::2] = 0.0
            return p

        harness.make_weights = make_weights
    else:
        raise ValueError(f"no predict fault {fault!r}")
    try:
        yield broken
    finally:
        ref.roi_pool, harness.make_weights = real_pool, real_weights


def readings(cell, seed: int, device, controls: bool, faults) -> list:
    import torch

    from bench_h100 import harness, traffic
    from bench_h100.reference import compare

    seeds = harness.derive_seeds(seed)
    out = []
    t = time.perf_counter()
    if cell.kind == "predict":
        pool = traffic.predict_pool(cell.mix, seeds.data, cell.config["model"]["max_gt_boxes"])
        engine = harness.build_engine(cell, seeds, device)
        answers = [harness.predict_call(engine, b, cell.mix["score_threshold"]) for b in pool]
        del engine
        harness.free()
        prog = tuple(torch.cat(t) for t in zip(*(harness.unpack(a, device) for a in answers)))
        group = cell.mix["batch"]
        answers = lambda c, precision="float32": tuple(
            torch.cat(t) for t in zip(*harness.reference_predict(c, seeds, pool, device, precision)))
        ref32, ref16 = answers(cell), answers(cell, "bfloat16")
        out.append(("program", compare.detection_gaps(prog, ref32, group, detail=True)))
        out.append(("program@bf16", compare.detection_gaps(prog, ref16, group, detail=True)))
        if controls:
            ref8 = answers(cell, "float8")
            out.append(("control", compare.detection_gaps(ref8, ref32, group, detail=True)))
            out.append(("control@bf16", compare.detection_gaps(ref8, ref16, group, detail=True)))
            for fault in faults:
                with planted(cell, fault) as broken:
                    out.append((f"fault:{fault}", compare.detection_gaps(answers(broken), ref32, group, detail=True)))
    else:
        os.environ["FRCNN_SCAN_STEPS"] = str(cell.mix["scan_steps"])
        stream = traffic.TrainStream(cell.mix, seeds.data)
        engine = harness.build_engine(cell, seeds, device)
        prog = harness.program_train_check(engine, cell, stream)
        del engine
        harness.free()
        ref32 = harness.reference_train(cell, seeds, stream, device)
        raw = {"reference": ref32, "program": prog}
        out.append(("program", compare.train_gaps(prog, ref32)))
        if controls:
            raw["control"] = ref8 = harness.reference_train(cell, seeds, stream, device, "float8")
            out.append(("control", compare.train_gaps(ref8, ref32)))
        for fault in faults if controls else ():
            raw[f"fault:{fault}"] = bad = harness.reference_train(cell, seeds, stream, device, fault=fault)
            out.append((f"fault:{fault}", compare.train_gaps(bad, ref32)))
        out = [(side, dict(numbers, raw=raw if side == "program" else None)) for side, numbers in out]
    return [{"workload": cell.name, "seed": seed, "side": side, "numbers": numbers,
             "seconds": time.perf_counter() - t} for side, numbers in out]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--control", type=int, default=3, help="seeds (the first ones) that also read the control")
    parser.add_argument("--faults", default="", help="comma-separated: half")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--detail", default="", help="append each reading with its raw data to this JSONL file")
    args = parser.parse_args(argv)

    import torch

    from bench_h100 import harness

    if args.device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell(harness.load_benchmark(), args.workload)
    faults = [f for f in args.faults.split(",") if f]
    rows = []
    detail = Path(args.detail) if args.detail else None
    if detail:
        detail.parent.mkdir(parents=True, exist_ok=True)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        for row in readings(cell, seed, args.device, i < args.control, faults):
            rows.append(row)
            if detail:
                with detail.open("a") as f:
                    f.write(json.dumps(row) + "\n")
            row["numbers"] = {k: v for k, v in row["numbers"].items() if isinstance(v, (int, float))}
            print(json.dumps(row), flush=True)
    summary = {}
    for row in rows:
        for name, v in row["numbers"].items():
            s = summary.setdefault(name, {})
            side = row["side"]
            key = "lower" if side == "program" else side + ("_max" if side.startswith("program") else "_min")
            pick = min if key.endswith("_min") else max
            s[key] = v if key not in s else pick(s[key], v)
    print(json.dumps({"workload": cell.name, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
