"""`python -m fasterrcnn_torch` on the CPU: the flows of tests/test_cli.py on
`--device cpu --tiny --synthetic 8`, through the port's `__main__.main`.

Each test runs in its own temporary working directory, because the CLI
writes predictions.png there, as the JAX package's CLI does.
"""

import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from fasterrcnn_torch import __main__ as cli
from fasterrcnn_torch.data import synthetic_voc, voc

TINY = ["--device", "cpu", "--tiny"]
TRAIN = [*TINY, "--train", "--synthetic", "8", "--batch-size", "4", "--eval-batch-size", "4",
         "--periodic-eval-samples", "2"]


@pytest.fixture(autouse=True)
def in_tmp_path(tmp_path, monkeypatch):
    """Run in tmp_path; delete its files (full-width weights, ~0.5 GB each)
    when the test ends, not when pytest prunes old temporary directories."""
    monkeypatch.chdir(tmp_path)
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_cli_train_resume_eval(tmp_path, capsys):
    cli.main([*TRAIN, "--epochs", "1", "--save-to", "final.pth", "--save-best-to", "best.pth",
              "--log-csv", "log.csv", "--checkpoint-dir", "ck"])
    assert (tmp_path / "final.pth").exists()
    lines = (tmp_path / "log.csv").read_text().strip().splitlines()
    assert lines[0].startswith("epoch,") and len(lines) == 2 and lines[1].startswith("1,")
    assert os.listdir(tmp_path / "ck") == ["1"]
    # The final weights and the epoch-1 checkpoint are the same weights.
    final = torch.load(tmp_path / "final.pth", weights_only=True)
    epoch1 = torch.load(tmp_path / "ck" / "1" / "params.pth", weights_only=True)
    assert final.keys() == epoch1.keys() and all(torch.equal(final[k], epoch1[k]) for k in final)
    out = capsys.readouterr().out
    assert "Saved checkpoint for epoch 1" in out and out.count("Mean Average Precision = ") == 2

    # Resume: continue to epoch 2 from the stored epoch-1 checkpoint.
    cli.main([*TRAIN, "--epochs", "2", "--checkpoint-dir", "ck", "--resume", "--log-csv", "log.csv"])
    assert sorted(os.listdir(tmp_path / "ck")) == ["1", "2"]
    lines = (tmp_path / "log.csv").read_text().strip().splitlines()
    assert len(lines) == 3 and lines[-1].startswith("2,")  # only epoch 2 trained
    assert "Resumed from checkpoint epoch 1" in capsys.readouterr().out

    # Reload the saved weights through the multi-format loader and eval.
    cli.main([*TINY, "--eval", "--synthetic", "4", "--eval-batch-size", "4", "--load-from", "final.pth"])
    out = capsys.readouterr().out
    assert "Average Precisions" in out and "Mean Average Precision = " in out


@pytest.mark.parametrize("source", ["path", "url"])
def test_cli_predict_to_file(tmp_path, source):
    """--predict-to-file of a local JPEG, or of one fetched by URL (from a
    server on this machine)."""
    import functools
    import http.server
    import threading

    from PIL import Image

    rng = np.random.default_rng(0)
    img_path = tmp_path / "test.jpg"
    Image.fromarray(rng.integers(0, 255, (120, 150, 3), dtype=np.uint8)).save(img_path)
    if source == "path":
        cli.main([*TINY, "--predict-to-file", str(img_path)])
    else:
        handler = functools.partial(http.server.SimpleHTTPRequestHandler, directory=str(tmp_path))
        server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            cli.main([*TINY, "--predict-to-file", f"http://127.0.0.1:{server.server_port}/test.jpg"])
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)
        assert not thread.is_alive()
    assert Image.open(tmp_path / "predictions.png").size == (750, 600)  # resized to min side 600


def test_load_weights_after_a_predict_uses_the_new_weights(tmp_path):
    """The engine's cached predict functions close over the model, and
    load_weights copies into its parameters, so a predict after a load uses
    the loaded weights."""
    from fasterrcnn_torch import config
    from fasterrcnn_torch.data.synthetic import synthetic_samples
    from fasterrcnn_torch.engine import Engine
    from tests.test_torch_predict import tiny_config

    sample = next(synthetic_samples(1, 120, 150, seed=0))
    cfg = tiny_config(config)
    other = Engine(cfg, seed=1, device="cpu")
    other.save_weights(str(tmp_path / "other.pth"))
    engine = Engine(cfg, seed=0, device="cpu")
    before = engine.predict_image(sample, score_threshold=0.0)
    engine.load_weights(str(tmp_path / "other.pth"))
    after = engine.predict_image(sample, score_threshold=0.0)
    want = other.predict_image(sample, score_threshold=0.0)
    assert any(not np.array_equal(before[c], after[c]) for c in before)
    for c in want:
        np.testing.assert_array_equal(after[c], want[c])


def test_cli_dump_anchors_renders_deferred_voc(tmp_path, monkeypatch):
    """--dump-anchors renders one PNG per image from a VOC tree whose
    samples are deferred (no pixels until batch time): the CLI materializes
    them."""
    root = synthetic_voc.generate_voc_dataset(str(tmp_path / "VOC2007"), {"trainval": 2, "test": 1}, seed=5)
    materialized = []

    class DeferredDataset(voc.Dataset):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, batch_decode=True, **kwargs)

        def __next__(self):
            sample = super().__next__()
            assert sample.image_u8 is None and sample.deferred is not None
            materialized.append(sample)
            return sample

    monkeypatch.setattr(voc, "Dataset", DeferredDataset)
    cli.main([*TINY, "--dump-anchors", "anchors", "--dataset-dir", root, "--no-augment"])
    pngs = sorted(f for f in os.listdir(tmp_path / "anchors") if f.endswith(".png"))
    assert pngs == ["anchors_trainval00000.jpg.png", "anchors_trainval00001.jpg.png"]
    assert len(materialized) == 2 and all(s.image_u8 is not None for s in materialized)


@pytest.mark.parametrize("flags, item", [
    (["--num-devices", "2", "--tp", "2"], "A16"),
    (["--tp", "2"], "A16"),
])
def test_cli_waiting_flags_raise_naming_their_item(flags, item, monkeypatch):
    """The flags that waited for ROADMAP `item` (tensor parallelism) now run:
    on CPU ranks, --tp 2 with --num-devices 2, or alone (T CPU ranks), plans
    a dp=1 x tp=2 mesh of two CPU ranks and spawns the run on it (the run
    itself: `tests/test_torch_mesh_eval.py`)."""
    from fasterrcnn_torch.parallel import mesh as mesh_lib

    spawned = []
    monkeypatch.setattr(mesh_lib, "spawn", lambda fn, mesh, args=(): spawned.append((fn, mesh, args)))
    cli.main([*TRAIN, "--epochs", "1", *flags])
    ((fn, mesh, (options,)),) = spawned
    assert fn is cli.run_rank and options.tp == 2, item
    assert mesh.shape == {"dp": 1, "tp": 2} and mesh.devices == ("cpu", "cpu") and mesh.backend == "gloo"


def test_cli_memory_stats_and_debug_nans_print_the_jax_lines(tmp_path, capsys):
    """--memory-stats prints the JAX CLI's train-step line for each canvas
    the epoch trained on, with temp "not measured" on the CPU (its
    allocator keeps no peak) and no device line (the JAX CLI prints none on
    a CPU either); --debug-nans trains under anomaly mode, restored after."""
    cli.main([*TRAIN, "--synthetic", "4", "--epochs", "1", "--memory-stats", "--debug-nans"])
    out = capsys.readouterr().out
    lines = [line for line in out.splitlines() if line.startswith("Train step memory : ")]
    assert lines == [lines[0]] and re.fullmatch(
        r"Train step memory : canvas=\(128, 160\) temp=not measured args=[0-9.]+ MiB out=0\.0 MiB code=0\.0 MiB",
        lines[0]), lines
    assert "Device memory     :" not in out
    assert "Mean Average Precision" in out and not torch.is_anomaly_enabled()


def test_cli_profile_dir_writes_a_trace_of_the_first_epoch(tmp_path, capsys):
    cli.main([*TRAIN, "--synthetic", "4", "--epochs", "2", "--profile-dir", "prof"])
    out = capsys.readouterr().out
    assert out.count("Wrote profiler trace to prof") == 1
    assert out.index("Epoch 1/2") < out.index("Wrote profiler trace to prof") < out.index("Epoch 2/2")
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    # The first epoch's steps: the RPN's NMS and the loss backward ran inside.
    assert any("nms" in n or "sort" in n for n in names) and any("backward" in n.lower() for n in names)


def test_cli_debug_nans_raises_at_a_nan_step(tmp_path, monkeypatch):
    """A step whose losses hold a NaN stops --debug-nans training."""
    from fasterrcnn_torch.models import losses

    monkeypatch.setattr(losses, "rpn_class_loss", lambda logits, *a: torch.full_like(logits[..., 0], float("nan")))
    with pytest.raises(FloatingPointError, match="non-finite loss at step 0"):
        cli.main([*TRAIN, "--synthetic", "4", "--epochs", "1", "--debug-nans"])
    assert not torch.is_anomaly_enabled()


@pytest.mark.parametrize("backbone", ["resnet50", "resnet101", "resnet152"])
def test_cli_runs_the_resnet_backbones(tmp_path, monkeypatch, backbone):
    """--backbone resnet50 trains one epoch on the CPU with finite losses;
    resnet101 and resnet152 build their engine (nothing else to do), whose
    stages hold the architecture's bottlenecks, and --train-all starts each
    bottleneck's bn3 closed (scale 0)."""
    from fasterrcnn_torch import engine as engine_mod
    from fasterrcnn_torch.models.resnet import ARCHITECTURES

    built = []

    class RecordingEngine(engine_mod.Engine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    monkeypatch.setattr(engine_mod, "Engine", RecordingEngine)
    if backbone == "resnet50":
        cli.main([*TINY, "--train", "--synthetic", "2", "--epochs", "1", "--backbone", backbone, "--log-csv", "log.csv"])
        header, row = (tmp_path / "log.csv").read_text().strip().splitlines()
        losses = {k: float(v) for k, v in zip(header.split(","), row.split(",")) if k.endswith("loss")}
        assert len(losses) == 5 and all(np.isfinite(v) and v > 0 for v in losses.values()), losses
    else:
        cli.main([*TINY, "--backbone", backbone, "--train-all"])
    (engine,) = built
    model = engine.model
    assert model.spec.name == backbone and model.cfg.train_all == (backbone != "resnet50")
    stages = (model.feature_extractor.layer1, model.feature_extractor.layer2, model.feature_extractor.layer3,
              model.roi_head.layer4)
    assert tuple(len(s) for s in stages) == ARCHITECTURES[backbone]
    closed = all(bool((b.bn3.scale == 0).all()) for s in stages for b in s)
    assert closed == model.cfg.train_all


def test_cli_device_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli.main(["--tiny", "--eval", "--synthetic", "4"])


def test_cli_parser_has_every_flag_of_the_jax_cli():
    from fasterrcnn_tpu.__main__ import build_parser as jax_parser

    def flags(parser):
        return {a.dest: (a.option_strings, a.default, a.choices, a.type) for a in parser._actions}

    mine, theirs = flags(cli.build_parser()), flags(jax_parser())
    assert set(mine) - set(theirs) == {"device"}
    for dest, spec in theirs.items():
        assert mine[dest] == spec, dest
    assert mine["device"][1] == "cuda"


def test_best_weights_file_holds_the_best_epoch(tmp_path, monkeypatch):
    """--save-best-to writes the weights of the epoch with the highest mAP,
    not the last epoch's (random weights score 0.0, so the eval is pinned)."""
    from fasterrcnn_torch.engine import Engine

    maps = iter([10.0, 5.0, 10.0, 7.0])  # periodic evals of epochs 1 and 2, then the final eval
    monkeypatch.setattr(Engine, "evaluate", lambda self, *a, **k: next(maps))
    cli.main([*TRAIN, "--epochs", "2", "--save-best-to", "best.pth", "--checkpoint-dir", "ck"])
    best = torch.load(tmp_path / "best.pth", weights_only=True)
    epoch1 = torch.load(tmp_path / "ck" / "1" / "params.pth", weights_only=True)
    epoch2 = torch.load(tmp_path / "ck" / "2" / "params.pth", weights_only=True)
    assert best.keys() == epoch1.keys()
    assert all(torch.equal(best[k], epoch1[k]) for k in best)
    assert not all(torch.equal(best[k], epoch2[k]) for k in best)
