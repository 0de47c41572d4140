"""The reference against the port, the control and the faults the
comparison must catch, the result line, and the import guard. On the CPU
at the tiny size of `conftest.make_tiny`, with the cells' own limits."""

from __future__ import annotations

import copy
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench_h100 import calibrate, harness, traffic
from bench_h100.reference import compare

from conftest import REPO, make_tiny

SEED = 2**31 + 12345


def run_tiny(bench, root, workload: str, seconds: float = 1.0, traced: bool = False) -> dict:
    cell = harness.Cell(bench, workload, base=root, root=root)
    return harness.run_cell(cell, SEED, seconds, traced, "cpu")


@pytest.fixture(scope="module")
def tiny_module(tmp_path_factory):
    torch.set_num_threads(4)
    root = tmp_path_factory.mktemp("tiny") / "bench"
    return root, make_tiny(root)


@pytest.fixture(scope="module")
def sound(tiny_module):
    root, bench = tiny_module
    return {w: run_tiny(bench, root, w) for w in ("tiny.p", "tiny.t")}


def test_reference_equals_the_port_in_float32(sound):
    """In float32 the plain reference and the port compute the same model:
    the same detections, losses, first gradients and updates (to float32
    rounding), with the sampling's uniforms drawn again from the seed."""
    p, t = sound["tiny.p"]["readings"], sound["tiny.t"]["readings"]
    assert p["worst_image_median"] == 0.0 and p["unmatched_share"] == 0.0 and p["program_detections"] > 0
    assert p["program_detections"] == p["reference_detections"]
    assert t["loss_gap"] < 1e-6 and t["trace_gap"] < 1e-4 and t["update_gap"] < 1e-4
    assert sound["tiny.p"]["correct"] and sound["tiny.t"]["correct"]


def test_result_line_schema(sound, tiny_module):
    root, bench = tiny_module
    for workload, r in sound.items():
        assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
        assert list(r)[-1] == "checks" and r["checks"]
        assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        cell = harness.Cell(bench, workload, base=root, root=root)
        assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())
        lines = harness.check_lines(r)
        assert len(lines) == len(r["checks"]) and all(" limit " in line for line in lines)
        json.dumps(r)


def test_traced_run_reports_per_layer_metrics(tiny_module):
    root, bench = tiny_module
    r = run_tiny(bench, root, "tiny.t", seconds=3.0, traced=True)
    cell = harness.Cell(bench, "tiny.t", base=root, root=root)
    assert set(r["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert "train_loop.wait_share" in r["metrics"]  # the program's own span: read on any device
    assert {"busy_s", "window_s"} <= set(r["device"]) and "breakdown" in r


@pytest.mark.parametrize("workload", ["tiny.p", "tiny.t"])
def test_control_is_not_correct(tiny_module, workload):
    """The reference in float8, put in the program's place, fails the
    cell's limits."""
    root, bench = tiny_module
    cell = harness.Cell(bench, workload, base=root, root=root)
    rows = calibrate.readings(cell, SEED, "cpu", True, [])
    control = next(r["numbers"] for r in rows if r["side"] == "control")
    assert not compare.judge(control, cell.limits)[0], control


def _half_detections(monkeypatch):
    from fasterrcnn_torch import engine as engine_mod

    real = engine_mod.Engine.predict

    def predict(self, images, image_hw, score_threshold=0.05):
        det = real(self, images, image_hw, score_threshold)
        valid = det.valid.clone()
        valid[valid.shape[0] // 2:] = 0.0
        return det._replace(valid=valid)

    monkeypatch.setattr(engine_mod.Engine, "predict", predict)


def _altered_answer(monkeypatch):
    from fasterrcnn_torch import engine as engine_mod

    real = engine_mod.Engine.predict

    def predict(self, images, image_hw, score_threshold=0.05):
        det = real(self, images, image_hw, score_threshold)
        return det._replace(boxes=det.boxes + 20.0)  # the answers moved where they are produced

    monkeypatch.setattr(engine_mod.Engine, "predict", predict)


def _nms_off(monkeypatch):
    """The program's per-class NMS suppresses nothing (an IoU never exceeds 1)."""
    real = harness.build_engine

    def build_engine(cell, seeds, device):
        broken = copy.copy(cell)
        broken.config = copy.deepcopy(cell.config)
        broken.config["model"]["detector"]["test_nms_iou_threshold"] = 1.0
        return real(broken, seeds, device)

    monkeypatch.setattr(harness, "build_engine", build_engine)


def _frozen_step(monkeypatch):
    from fasterrcnn_torch import engine as engine_mod

    monkeypatch.setattr(engine_mod.TrainOptimizer, "step", lambda self: None)


def _half_batch(monkeypatch):
    from fasterrcnn_torch.models import faster_rcnn

    real = faster_rcnn.compute_losses

    def compute_losses(model, batch, grid, *args, **kwargs):
        w = batch.sample_weight.clone()
        w[w.shape[0] // 2:] = 0.0
        return real(model, batch._replace(sample_weight=w), grid, *args, **kwargs)

    monkeypatch.setattr(faster_rcnn, "compute_losses", compute_losses)


def _altered_loss(monkeypatch):
    from fasterrcnn_torch.models import faster_rcnn

    real = faster_rcnn.compute_losses

    def compute_losses(model, batch, grid, *args, **kwargs):
        total, losses = real(model, batch, grid, *args, **kwargs)
        losses = losses._replace(detector_class=1.5 * losses.detector_class)  # altered where it is produced
        return losses.total, losses

    monkeypatch.setattr(faster_rcnn, "compute_losses", compute_losses)


@pytest.mark.parametrize("workload,fault", [
    ("tiny.p", _half_detections), ("tiny.p", _altered_answer), ("tiny.p", _nms_off),
    ("tiny.t", _frozen_step), ("tiny.t", _half_batch), ("tiny.t", _altered_loss)])
def test_broken_timed_path_is_not_correct(tiny_module, monkeypatch, workload, fault):
    root, bench = tiny_module
    fault(monkeypatch)
    r = run_tiny(bench, root, workload)
    assert r["correct"] is False, r["checks"]


def test_train_check_runs_the_programs_the_window_runs(tiny_module, monkeypatch):
    """The checked steps go through `Engine.train_epoch` as the window's do:
    a block of the K-step program, then a residue step of the single-step
    program, and each step's losses are read."""
    root, bench = tiny_module
    cell = harness.Cell(bench, "tiny.t", base=root, root=root)
    k, canvas = cell.mix["scan_steps"], tuple(cell.mix["canvas"])
    monkeypatch.setenv("FRCNN_SCAN_STEPS", str(k))
    seeds = harness.derive_seeds(SEED)
    engine = harness.build_engine(cell, seeds, "cpu")
    readings = harness.program_train_check(engine, cell, traffic.TrainStream(cell.mix, seeds.data))
    assert len(readings["losses"]) == k + 1 and k > 1
    assert list(engine._scan_steps) == [(canvas, k)] and list(engine._packed_steps) == [canvas]
    assert set(readings["trace_norms"]) == set(readings["update_norms"])


def test_import_guard_names_whole_modules(monkeypatch):
    sys.path.insert(0, str(REPO / "bench_h100"))
    import run

    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "fasterrcnn_tpu_extra", object())
    assert "jax" in run.forbidden_modules()
    assert "fasterrcnn_torch" not in run.forbidden_modules() and "fasterrcnn_tpu_extra" not in run.forbidden_modules()


SCRIPT = """
import sys
sys.path.insert(0, {repo!r})
{body}
bad = sorted({{m.split('.')[0] for m in sys.modules}} & {{{names}}})
print(bad)
"""


def _loaded(body: str, names: str) -> str:
    code = SCRIPT.format(repo=str(REPO), body=body, names=names)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    root = tmp_path / "bench"
    bench = make_tiny(root)
    (tmp_path / "bench.json").write_text(json.dumps(bench))
    body = (f"import json, pathlib\nfrom bench_h100 import harness\n"
            f"bench = json.loads(pathlib.Path({str(tmp_path / 'bench.json')!r}).read_text())\n"
            f"root = pathlib.Path({str(root)!r})\n"
            "harness.run_cell(harness.Cell(bench, 'tiny.p', base=root, root=root), 7, 0.5, False, 'cpu')")
    assert _loaded(body, "'jax', 'jaxlib', 'flax', 'fasterrcnn_tpu'") == "[]"


def test_the_reference_imports_nothing_of_the_program():
    body = ("from bench_h100.reference import model, compare\nfrom bench_h100 import weights, traffic\n"
            "from bench_h100.yardstick import flops, bounds, kernels, peaks")
    assert _loaded(body, "'jax', 'jaxlib', 'flax', 'fasterrcnn_tpu', 'fasterrcnn_torch'") == "[]"


def test_run_needs_a_card():
    """Without a card the run prints no result and exits non-zero."""
    out = subprocess.run([sys.executable, "bench_h100/run.py", "--workload", "vgg16-bf16.predict-b32", "--seed",
                          str(SEED), "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=REPO, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_on_the_card(cuda):
    """One short run of the first cell on the card: its result line, and
    `correct` true."""
    out = subprocess.run([sys.executable, "bench_h100/run.py", "--workload", "vgg16-bf16.predict-b32", "--seed",
                          str(SEED), "--seconds", "3", "--trace", "0"], capture_output=True, text=True, timeout=600,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu" and r["metrics"]["predict_images_per_s"]["value"] > 0
    assert np.isfinite(r["metrics"]["setup_s"]["value"])
