"""BENCHMARK.json against the contract, and the lookup of configurations,
mixes, metrics and limits by name."""

from __future__ import annotations

import json
import re

import numpy as np
import pytest

from bench_h100 import harness, traffic
from bench_h100.reference import model as ref

from conftest import REPO, make_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_benchmark_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["bench_h100"]
    assert 1 <= bench["run_seconds"] <= 51
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench_h100/") and (REPO / c["file"]).is_file()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    metrics = bench["end_to_end"] + bench["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [x["name"] for x in bench["configs"] + bench["workloads"] + metrics]
    assert len(names) == len(set(names))
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_cell_reports_what_its_layers_move(bench):
    """Each cell has setup_s, another end-to-end metric and a per-layer
    metric, and every per-layer metric's `moves` is reported in its cells."""
    for w in bench["workloads"]:
        cell = harness.Cell(bench, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


@pytest.mark.parametrize("kind", ["configs", "traffic", "metrics", "limits"])
def test_found_by_name(bench, kind):
    for w in bench["workloads"]:
        cell = harness.Cell(bench, w["name"])
        if kind == "configs":
            assert cell.config["name"] == w["config"]
            assert len(ref.param_shapes(cell.config["model"])) > 0
        elif kind == "traffic":
            assert cell.mix == traffic.load(w["traffic"])
        elif kind == "limits":
            assert cell.limits and cell.limits["limits"], w["name"]
        else:
            for m in cell.per_layer:
                assert callable(cell.metric_reader(m["name"]).read), m["name"]


def test_metrics_of_one_layer_name_it_alike(bench):
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_a_new_configuration_and_metric_need_no_edit(tmp_path):
    """A configuration file, a mix and a metric reader added as files, with
    their BENCHMARK entries, are found and read by the harness as it is."""
    root = tmp_path / "bench"
    bench = make_tiny(root)
    (root / "metrics" / "images_seen.py").write_text(
        "def read(trace):\n    return float(trace.images)\n")
    bench["per_layer"].append({"name": "images_seen", "unit": "images", "better": "higher", "source": "program_counter",
                               "layer": "whole step", "moves": "predict_images_per_s", "workloads": ["tiny.p"]})
    cell = harness.Cell(bench, "tiny.p", base=root, root=root)
    assert cell.config["model"]["backbone"] == "resnet50" and cell.mix["batch"] == 2
    reader = cell.metric_reader("images_seen")

    class Stub:
        images = 64

    assert reader.read(Stub()) == 64.0
    assert "images_seen" in [m["name"] for m in cell.per_layer]


def test_unknown_workload_is_refused(bench):
    with pytest.raises(KeyError):
        harness.Cell(bench, "no-such-cell")


def test_traffic_is_the_same_work_for_every_seed():
    """Every seed gets the same sizes: the same batch shapes, the same number
    of samples an epoch from the same pool."""
    mix = traffic.load("train-b8")
    a, b = traffic.TrainStream(dict(mix, pool_scenes=16), 1), traffic.TrainStream(dict(mix, pool_scenes=16), 2**33 + 5)
    assert len(a.epoch(1)) == len(b.epoch(1)) == mix["epoch_samples"]
    assert sorted(i for i, _ in a.epoch(0)[:16]) == list(range(16))
    pm = dict(traffic.load("predict-b32"), pool_batches=1, batch=2)
    p1, p2 = traffic.predict_pool(pm, 7, 56)[0], traffic.predict_pool(pm, 7, 56)[0]
    assert p1.images.shape == (2, 608, 800, 3) and (p1.images == p2.images).all()
    s = traffic.make_scene(np.random.default_rng(0), pm["scene"])
    f = traffic.flip_scene(s)
    assert (f.boxes[:, 1] == 799 - s.boxes[:, 3]).all() and (f.image[:, 0] == s.image[:, 799]).all()
