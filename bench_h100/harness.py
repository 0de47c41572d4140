"""One run of one cell: set-up, the measured window, the traced stretch,
and the check of what the window produced against the plain reference.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by name: `configs/<name>.json` (through BENCHMARK.json's
`file`), `traffic/<name>.json`, `metrics/<name>.py` and
`limits/<workload>.json`. The program under test is `fasterrcnn_torch`;
it is imported only inside the functions that drive it, and nothing here
imports JAX or the JAX package.

Seeds: the run's `--seed` gives, through numpy's SeedSequence, the seed of
the weights, of the traffic, of the engine (its sampling generator) and of
the choice of which answers are compared.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from bench_h100 import traffic
from bench_h100.reference import compare
from bench_h100.reference import model as ref
from bench_h100.tracing import Profiler, Trace
from bench_h100.weights import make_weights

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


class Seeds(NamedTuple):
    weights: int
    data: int
    engine: int
    sample: int


def derive_seeds(seed: int) -> Seeds:
    return Seeds(*(int(v) for v in np.random.SeedSequence(seed).generate_state(4)))


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic, metrics
    and limits, found by name under `root` (the benchmark's directory);
    configuration files are relative to `base` (BENCHMARK.json's)."""

    def __init__(self, bench: dict, workload: str, base: Path = REPO, root: Path = HERE):
        found = [w for w in bench["workloads"] if w["name"] == workload]
        if not found:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.name, self.workload = workload, found[0]
        entry = next(c for c in bench["configs"] if c["name"] == self.workload["config"])
        self.config = json.loads((base / entry["file"]).read_text())
        self.mix = traffic.load(self.workload["traffic"], root / "traffic")
        self.kind = self.mix["kind"]
        applies = lambda m: "workloads" not in m or workload in m["workloads"]
        self.end_to_end = [m for m in bench["end_to_end"] if applies(m)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m)]
        self.root = root
        self.limits = compare.load_limits(root / "limits", workload)

    def metric_reader(self, name: str):
        """The reader of a per-layer metric: `metrics/<name>.py`, or that of
        the name without its last dot-separated part."""
        path = self.root / "metrics" / f"{name}.py"
        if not path.is_file() and "." in name:
            path = self.root / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
        spec = importlib.util.spec_from_file_location(f"bench_h100_metric_{len(name)}_{abs(hash(name))}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module


def load_benchmark(path: Path = REPO / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The program under test
# ---------------------------------------------------------------------------


def build_engine(cell: Cell, seeds: Seeds, device):
    """The program's Engine for the configuration, with the seed's weights."""
    from fasterrcnn_torch.config import AnchorConfig, DetectorConfig, ModelConfig, RPNConfig, TrainConfig
    from fasterrcnn_torch.engine import Engine

    m = cell.config["model"]
    tuples = lambda d: {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
    model_cfg = ModelConfig(
        **{k: v for k, v in m.items() if k not in ("anchors", "rpn", "detector")},
        anchors=AnchorConfig(**tuples(m["anchors"])), rpn=RPNConfig(**m["rpn"]),
        detector=DetectorConfig(**tuples(m["detector"])))
    engine = Engine(model_cfg, TrainConfig(**cell.config["train"]), seed=seeds.engine, device=device)
    engine.set_params(make_weights(cell.config, seeds.weights, device))
    return engine


def free() -> None:
    """Give the device memory of the program's dropped state back (the
    caller drops its references first)."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def predict_call(engine, batch: traffic.CanvasBatch, threshold: float) -> torch.Tensor:
    """One request: the host batch to `Engine.predict`, its detections
    copied to the host as one (B, K-1, D, 6) tensor (box, score, valid)."""
    det = engine.predict(batch.images, batch.image_hw, threshold)
    return torch.cat([det.boxes, det.scores[..., None], det.valid[..., None].float()], -1).cpu()


def to_sample(scene: traffic.Scene):
    from fasterrcnn_torch.data.voc import VOC_CLASSES, Box, Sample

    boxes = [Box(int(c), VOC_CLASSES[int(c)], b.astype(np.float32)) for b, c in zip(scene.boxes, scene.classes)]
    return Sample(image_u8=scene.image, image_hw=tuple(scene.image.shape[:2]), gt_boxes=boxes, filepath="scene")


class LossRows:
    """The `stats` object `Engine.train_epoch` reports each step's four
    losses to (on its main thread), kept as rows; `hook(rows_before)` runs
    before each row is recorded."""

    def __init__(self, hook=None):
        self.rows: List[List[float]] = []
        self.hook = hook
        self._count = 0

    def on_training_step_values(self, values) -> None:
        if self.hook is not None:
            self.hook(len(self.rows))
        self.rows.append([float(v) for v in values])
        self._count += 1

    def get_progbar_postfix(self) -> str:
        return ""


class Feed:
    """One epoch's samples for `Engine.train_epoch`, cut off at a deadline;
    `count` is the samples handed over."""

    def __init__(self, stream: traffic.TrainStream, pairs, deadline: float = float("inf")):
        self.stream, self.pairs, self.deadline, self.count = stream, pairs, deadline, 0

    def __iter__(self):
        for index, flip in self.pairs:
            if time.perf_counter() >= self.deadline:
                return
            self.count += 1
            yield to_sample(self.stream.scene(index, flip))


def check_pairs(mix: dict, stream: traffic.TrainStream):
    """The samples of the checked steps: the seed's first `scan_steps` + 1
    batches of epoch 0, all different scenes (the epoch's first pass over
    the pool is a permutation)."""
    return stream.epoch(0)[: mix["batch"] * (mix["scan_steps"] + 1)]


def program_train_check(engine, cell: Cell, stream: traffic.TrainStream) -> dict:
    """The checked steps through `Engine.train_epoch`, one call, which runs
    the two programs the window runs: its first K batches as one block of
    the captured K-step program, the last as a residue step of the captured
    single-step program. The program's readings of them: each step's
    losses, and each trainable leaf's norm of the optimizer's momentum
    trace after the steps and of its change over them."""
    if engine.optimizer.kind != "sgd":
        raise NotImplementedError("the train check reads SGD's momentum trace")
    names = {id(p): name for name, p in engine.model.named_parameters()}
    p0 = {name: p.detach().double().cpu() for name, p in engine.model.named_parameters() if p.requires_grad}
    rows = LossRows()
    engine.train_epoch(Feed(stream, check_pairs(cell.mix, stream)), cell.mix["batch"], stats=rows)
    ordered = [p for params, _ in engine.optimizer.groups for p in params]
    traces = engine.optimizer.state_tensors()[2:]
    trace_norms = {names[id(p)]: float(tr.detach().double().norm()) for p, tr in zip(ordered, traces)}
    update_norms = {name: float((p.detach().double().cpu() - p0[name]).norm())
                    for name, p in engine.model.named_parameters() if p.requires_grad}
    return {"losses": rows.rows, "trace_norms": trace_norms, "update_norms": update_norms}


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------


def _device_batch(batch: traffic.CanvasBatch, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch._asdict().items()}


def reference_predict(cell: Cell, seeds: Seeds, pool, device, precision: str = "float32"):
    """The reference's detections of each pool batch, on `device`."""
    model = cell.config["model"]
    p = make_weights(cell.config, seeds.weights, device)
    out = []
    with ref.strict_float32():
        for batch in pool:
            d = _device_batch(batch, device)
            out.append(ref.predict(model, p, d["images"], d["image_hw"], cell.mix["score_threshold"], precision))
    return out


def reference_train(cell: Cell, seeds: Seeds, stream: traffic.TrainStream, device, precision: str = "float32",
                    fault: Optional[str] = None) -> dict:
    """The reference's readings of the checked steps: the same weights, the
    same batches, the sampling's uniforms drawn again from a generator
    seeded as the engine's, in the order a step draws them; also each
    leaf's first gradient norm, whose size decides which leaves count.
    `fault` "half" zeroes the sample weight of half of each batch (the
    mean then taken over the rest)."""
    model, train, mix = cell.config["model"], cell.config["train"], cell.mix
    b = mix["batch"]
    pairs = check_pairs(mix, stream)
    n = len(pairs) // b
    p = make_weights(cell.config, seeds.weights, device)
    trainable = [name for name in p if not ref.frozen(model, name)]
    p0 = {name: p[name].double() for name in trainable}
    fm_h, fm_w = ref.feature_size(model, *mix["canvas"])
    anchors = fm_h * fm_w * ref.num_anchors(model)
    gen = torch.Generator(device=device).manual_seed(seeds.engine)
    rows, grad_norms, trace = [], {}, {}
    with ref.strict_float32():
        for k in range(n):
            scenes = [stream.scene(i, f) for i, f in pairs[k * b:(k + 1) * b]]
            batch = _device_batch(traffic.canvas_batch(scenes, mix["canvas"], model["max_gt_boxes"]), device)
            if fault == "half":
                batch["sample_weight"][b // 2:] = 0.0
            draws = ref.draw_uniforms(model, b, anchors, gen, device)
            leaves = {name: p[name].detach().requires_grad_(True) for name in trainable}
            losses = ref.losses(model, {**p, **leaves}, batch, draws, precision)
            grads = torch.autograd.grad(losses.sum(), [leaves[name] for name in trainable])
            rows.append([float(v) for v in losses.detach()])
            g = {name: gr.detach() for name, gr in zip(trainable, grads)}
            if k == 0:
                grad_norms = {name: float(v.double().norm()) for name, v in g.items()}
            ref.sgd_step(model, train, p, g, trace)
    update_norms = {name: float((p[name].double() - p0[name]).norm()) for name in trainable}
    trace_norms = {name: float(trace[name].double().norm()) for name in trainable}
    return {"losses": rows, "grad_norms": grad_norms, "trace_norms": trace_norms, "update_norms": update_norms}


def unpack(packed: torch.Tensor, device):
    t = packed.to(device)
    return t[..., :4], t[..., 4], t[..., 5] > 0.5


# ---------------------------------------------------------------------------
# Runs
# ---------------------------------------------------------------------------


class Outcome(NamedTuple):
    end_to_end: Dict[str, float]
    trace: Optional[Trace]
    attempted: int
    numbers: Dict[str, float]


def run_predict(cell: Cell, seeds: Seeds, seconds: float, traced: bool, device, t0: float) -> Outcome:
    max_gt = cell.config["model"]["max_gt_boxes"]
    threshold = cell.mix["score_threshold"]
    engine = build_engine(cell, seeds, device)
    pool = traffic.predict_pool(cell.mix, seeds.data, max_gt)
    for batch in pool:  # the cell's one shape: kernel builds, cuDNN's choices
        predict_call(engine, batch, threshold)
    if traced:
        Profiler.warm_up()
    synchronize(device)
    setup_s = time.perf_counter() - t0

    rng = np.random.default_rng(seeds.sample)
    kept: List[Optional[torch.Tensor]] = [None] * len(pool)
    seen = [0] * len(pool)
    latencies: List[float] = []
    prof = Profiler() if traced else None
    traced_batches = 0
    start = time.perf_counter()
    deadline, end = start + seconds, start
    i = 0
    while True:
        t = time.perf_counter()
        if t >= deadline:
            break
        if prof is not None:
            # The stretch: a third of the window, from a third of it on.
            if not prof.started and t - start >= seconds / 3:
                prof.start()
            elif prof.started and not prof.stopped and t - prof.started_at >= seconds / 3:
                prof.stop()
        j = i % len(pool)
        out = predict_call(engine, pool[j], threshold)
        end = time.perf_counter()
        latencies.append(end - t)
        if prof is not None and prof.started and not prof.stopped:
            traced_batches += 1
        seen[j] += 1
        if rng.integers(seen[j]) == 0:  # a uniform choice of each batch's answers
            kept[j] = out
        i += 1
    if prof is not None:
        prof.stop()
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    e2e = {"predict_images_per_s": cell.mix["batch"] * i / (end - start),
           "predict_p95_ms": 1e3 * float(np.percentile(latencies, 95)),
           "setup_s": setup_s, "memory_peak_bytes": peak}
    trace = None
    if prof is not None and prof.stopped:
        b = cell.mix["batch"]
        trace = Trace(prof.events(), cell.config, cell.mix, images=b * traced_batches, batches=traced_batches)
    del engine
    free()

    compared = [j for j in range(len(pool)) if kept[j] is not None]
    refs = reference_predict(cell, seeds, [pool[j] for j in compared], device)
    prog = [unpack(kept[j], device) for j in compared]
    numbers = compare.detection_gaps(tuple(torch.cat(t) for t in zip(*prog)),
                                     tuple(torch.cat(t) for t in zip(*refs)), cell.mix["batch"])
    numbers["images_compared"] = cell.mix["batch"] * len(compared)
    return Outcome(e2e, trace, i, numbers)


def run_train(cell: Cell, seeds: Seeds, seconds: float, traced: bool, device, t0: float) -> Outcome:
    mix = cell.mix
    b = mix["batch"]
    os.environ["FRCNN_SCAN_STEPS"] = str(mix["scan_steps"])
    engine = build_engine(cell, seeds, device)
    stream = traffic.TrainStream(mix, seeds.data)
    # The checked steps capture both programs the window replays.
    readings = program_train_check(engine, cell, stream)
    if traced:
        Profiler.warm_up()
    synchronize(device)
    setup_s = time.perf_counter() - t0

    prof = Profiler() if traced else None
    marks: Dict[str, int] = {}
    start = time.perf_counter()

    def hook(rows_before: int) -> None:
        # On the main thread, as each step's losses come back; the loop
        # reads them a flush block at a time, so the stretch runs from the
        # start of one block to the start of another.
        if prof is None or prof.stopped:
            return
        now = time.perf_counter()
        if not prof.started and now - start >= seconds / 3:
            prof.start()
            marks["first"] = rows_before
        elif prof.started and (rows_before - marks["first"] >= 96 or now - prof.started_at >= seconds / 3):
            prof.stop()
            marks["last"] = rows_before

    rows = LossRows(hook)
    deadline = start + seconds
    images, epochs, e = 0, [], 1
    while time.perf_counter() < deadline:
        feed = Feed(stream, stream.epoch(e), deadline)
        engine.train_epoch(feed, b, stats=rows)
        images += feed.count
        epochs.append(dict(engine.last_epoch_trace))
        e += 1
    end = time.perf_counter()
    if prof is not None and prof.started and not prof.stopped:
        prof.stop()
        marks["last"] = len(rows.rows)
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    e2e = {"train_images_per_s": images / (end - start), "setup_s": setup_s, "memory_peak_bytes": peak}
    trace = None
    if prof is not None and prof.stopped:
        steps = marks["last"] - marks["first"]
        trace = Trace(prof.events(), cell.config, cell.mix, images=b * steps, steps=steps, epochs=epochs)
    del engine
    free()

    reference = reference_train(cell, seeds, stream, device)
    numbers = compare.train_gaps(readings, reference)
    return Outcome(e2e, trace, images, numbers)


RUNS = {"predict": run_predict, "train": run_train}


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device="cuda", t0: Optional[float] = None) -> dict:
    """The result line's object of one run of the cell."""
    t0 = time.perf_counter() if t0 is None else t0
    seeds = derive_seeds(seed)
    out = RUNS[cell.kind](cell, seeds, seconds, traced, device, t0)
    correct, checks = compare.judge(out.numbers, cell.limits)
    metrics = {}
    if traced:
        for m in cell.per_layer:
            value = None if out.trace is None else cell.metric_reader(m["name"]).read(out.trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
    dev = torch.device(device)
    result = {
        "correct": correct,
        "attempted": out.attempted,
        "failed": 0,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": out.end_to_end["memory_peak_bytes"],
        },
    }
    if traced:
        result["device"]["busy_s"] = out.trace.busy_s if out.trace else 0.0
        result["device"]["window_s"] = out.trace.window_s if out.trace else 0.0
        if out.trace is not None:
            result["breakdown"] = out.trace.breakdown()
    result["readings"] = out.numbers
    result["checks"] = checks
    return result


def check_lines(result: dict) -> List[str]:
    """The compared numbers beside their limits, one a line."""
    lines = [f"check {name} {c['value']!r} limit {c['limit']!r}" for name, c in result["checks"].items()]
    if not result["checks"]:
        lines.append("check none: no limits file for this workload, so the run is not correct")
    return lines
