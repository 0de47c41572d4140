"""The port's learning proxies (`fasterrcnn_torch/scripts/overfit_sanity.py`
and `prodshape_proxy.py`) on the CPU, at one or two tiny epochs.

They learn on the card; here the point is that each recipe is the JAX
script's, that every flag a script passes to `python -m fasterrcnn_torch`
is valid, that the overfit bar bites (two epochs from seeded random weights
are far from 90%), and that the prodshape record has every field of the
JAX record.
"""

import dataclasses
import importlib.util
import json
import os
import shutil

import pytest

from fasterrcnn_torch.data import voc
from fasterrcnn_torch.scripts import overfit_sanity, prodshape_proxy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("backbone", ["vgg16", "resnet50"])
def test_overfit_config_is_the_jax_scripts(backbone, monkeypatch):
    monkeypatch.setenv("OVERFIT_BACKBONE", backbone)
    want = dataclasses.asdict(jax_script("overfit_sanity").tiny_config())
    assert dataclasses.asdict(overfit_sanity.tiny_config(backbone)) == want
    assert overfit_sanity.tiny_config(roi_mode="exact_pool").roi_mode == "exact_pool"


@pytest.mark.parametrize("roi_mode", ["crop", "exact_pool"])
def test_overfit_sanity_runs_and_its_bar_bites(roi_mode, capsys, monkeypatch):
    monkeypatch.setenv("OVERFIT_EPOCHS", "2")
    monkeypatch.delenv("OVERFIT_BACKBONE", raising=False)
    with pytest.raises(SystemExit, match=r"FAIL: expected ~100% overfit mAP, got \d+\.\d%"):
        overfit_sanity.main(device="cpu", roi_mode=roi_mode)
    assert f"(vgg16, roi_mode={roi_mode}, 2 epochs" in capsys.readouterr().out


def test_prodshape_proxy_flags_are_valid_and_the_record_has_every_field(tmp_path, monkeypatch):
    """Both phases, the best-weights files and the final --eval, on the CPU
    with the tiny config and images resized to min side 120 (the 128x160
    canvas); --no-record writes no file; the record holds the fields of the
    JAX record plus "package", and `append_record` adds it to its backbone's
    list."""
    seen = []

    def tiny_cli(args):
        seen.append(args)
        return real_run_cli(["--device", "cpu", "--tiny", *args])

    class SmallDataset(voc.Dataset):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, min_dimension_pixels=120, **kwargs)

    real_run_cli = prodshape_proxy.run_cli
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(prodshape_proxy, "run_cli", tiny_cli)
    monkeypatch.setattr(voc, "Dataset", SmallDataset)
    path = tmp_path / "record.json"
    monkeypatch.setattr(prodshape_proxy, "RECORD", str(path))
    record = prodshape_proxy.main(["--train-images", "2", "--eval-images", "1", "--batch-size", "1", "--epochs", "1",
                                   "--epochs2", "1", "--no-record", "--threshold", "0"])
    assert not path.exists()
    assert [a[0] for a in seen] == ["--train", "--train", "--eval"]
    assert "--load-from" in seen[1] and "--save-best-to" in seen[0] and "--save-best-to" in seen[1]

    with open(os.path.join(REPO, "PRODSHAPE_PROXY.json")) as f:
        jax_fields = set(json.load(f)["resnet101"][-1])
    assert set(record) == jax_fields | {"package"}
    assert record["package"] == "fasterrcnn_torch" and record["device"] == "cpu"
    assert record["passed"] and 0.0 <= record["map_heldout_pct"] <= 100.0
    assert record["schedule"] == "two-phase (lr, lr/10), fresh optimizer at reload"
    assert record["canvas"].endswith("bf16)") and seen[0][seen[0].index("--compute-dtype") + 1] == "bfloat16"
    prodshape_proxy.append_record(str(path), record)
    assert json.loads(path.read_text()) == {"vgg16": [record]}
    prodshape_proxy.append_record(str(path), dict(record, run_seed=1))
    assert [r["run_seed"] for r in json.loads(path.read_text())["vgg16"]] == [0, 1]
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_prodshape_proxy_parser_defaults_are_the_jax_recipe():
    args = prodshape_proxy.build_parser().parse_args([])
    assert (args.epochs, args.epochs2, args.train_images, args.eval_images, args.batch_size) == (20, 8, 128, 32, 8)
    assert (args.backbone, args.learning_rate, args.optimizer, args.threshold) == ("vgg16", 1e-3, "sgd", 80.0)
    assert (args.run_seed, args.lr_schedule, args.warmup_steps, args.train_all) == (0, "constant", 0, False)
    assert args.compute_dtype == "bfloat16"
    assert prodshape_proxy.RECORD == os.path.join(REPO, "PRODSHAPE_PROXY_TORCH.json")
