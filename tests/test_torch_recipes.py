"""The paper-schedule recipes of the port (`fasterrcnn_torch/scripts/
train_vgg16.sh`, `train_resnet50.sh`) against the JAX package's
(`scripts/train_*.sh`): the same two commands flag for flag, over
`python -m fasterrcnn_torch`, with `.pth` weight files where JAX writes
`.msgpack`; and the VGG-16 recipe run by `sh` on the CPU at the tiny config.

Random weights score an mAP of 0.0, at which `--save-best-to` writes
nothing (in both packages), so the first phase would leave the second no
weights to load. The run therefore pins the eval's mAP, as
`tests/test_torch_cli.py::test_best_weights_file_holds_the_best_epoch`
does: the recipe's `python` is a wrapper that sets `Engine.evaluate` to
return 10.0 before it runs `python -m fasterrcnn_torch`.
"""

import os
import shlex
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_checkpoint import vgg16_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINNED_EVAL = """\
import runpy
import sys

from fasterrcnn_torch.engine import Engine

Engine.evaluate = lambda self, *args, **kwargs: 10.0
if sys.argv[1] != "-m":
    raise SystemExit(f"expected python -m <module>, got {sys.argv[1:]}")
sys.argv = sys.argv[2:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
"""


def commands(path):
    """The `python -m <module> flags...` commands of a recipe, as
    (module, flags)."""
    with open(path) as f:
        text = f.read().replace("\\\n", " ")
    found = []
    for line in text.splitlines():
        words = shlex.split(line, comments=True)
        if words[:2] == ["python", "-m"]:
            found.append((words[2], words[3:]))
    return found


@pytest.mark.parametrize("name", ["train_vgg16.sh", "train_resnet50.sh"])
def test_recipe_carries_the_jax_schedule_flag_for_flag(name):
    jax_cmds = commands(os.path.join(REPO, "scripts", name))
    port_cmds = commands(os.path.join(REPO, "fasterrcnn_torch", "scripts", name))
    assert [m for m, _ in jax_cmds] == ["fasterrcnn_tpu"] * 2
    assert [m for m, _ in port_cmds] == ["fasterrcnn_torch"] * 2
    for (_, jax_flags), (_, port_flags) in zip(jax_cmds, port_cmds):
        assert port_flags == [f.replace(".msgpack", ".pth") for f in jax_flags]
        assert port_flags[-1] == "$@"
    # The second phase loads the first's best weights.
    first, second = (dict(f.split("=", 1) for f in flags if "=" in f) for _, flags in port_cmds)
    assert second["--load-from"] == first["--save-best-to"]
    assert (first["--epochs"], first["--learning-rate"], second["--epochs"], second["--learning-rate"]) == (
        "10", "1e-3", "4", "1e-4")


def test_train_vgg16_recipe_trains_both_phases_on_the_cpu(tmp_path):
    """Both phases train one epoch from the appended flags (argparse keeps
    the last of a repeated flag), the second from the first's best weights,
    which hold the model's weights alone; the second writes its own."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    (bin_dir / "pinned_eval.py").write_text(PINNED_EVAL)
    wrapper = bin_dir / "python"
    wrapper.write_text(f'#!/bin/sh\nexec {shlex.quote(sys.executable)} {shlex.quote(str(bin_dir / "pinned_eval.py"))} "$@"\n')
    wrapper.chmod(0o755)
    torch.save(vgg16_state(np.random.default_rng(0)), tmp_path / "vgg16_caffe.pth")
    # One CPU thread a phase: the suite's six workers already fill the cores.
    env = dict(os.environ, PATH=os.pathsep.join((str(bin_dir), os.environ["PATH"])), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, (REPO, os.environ.get("PYTHONPATH")))))
    try:
        done = subprocess.run(
            ["sh", os.path.join(REPO, "fasterrcnn_torch", "scripts", "train_vgg16.sh"), "--device", "cpu", "--tiny",
             "--synthetic", "2", "--batch-size", "1", "--epochs", "1", "--eval-batch-size", "1"],
            cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
        assert done.returncode == 0, done.stderr[-4000:]
        out = done.stdout
        assert out.count("Epoch 1/1") == 2 and out.count("Batch size        : 1") == 2
        assert "Initial weights   : vgg16_caffe.pth" in out and "Initial weights   : vgg16_tmp.pth" in out
        assert "Learning rate     : 0.001000" in out and "Learning rate     : 0.000100" in out
        assert out.count("Compute dtype     : bfloat16") == 2
        first = torch.load(tmp_path / "vgg16_tmp.pth", weights_only=True)
        second = torch.load(tmp_path / "vgg16_fasterrcnn.pth", weights_only=True)
        assert first.keys() == second.keys() and all(torch.is_tensor(v) for v in first.values())
        assert "roi_head.fc1.weight" in first and not any("momentum" in k or "optimizer" in k for k in first)
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)  # full-width weights, ~0.5 GB a file
