"""The port's CUDA sources and the native reader's C++ source ship in its
wheel, and the kernels build where they can be written.

No card and no nvcc are needed: the wheel is built offline from a copy of
the project files (`pip wheel --no-deps --no-build-isolation`), and the
build-directory choice is checked on directories made here.
"""

import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

from fasterrcnn_torch.ops.kernels import _build

REPO = Path(__file__).resolve().parent.parent


def test_wheel_carries_every_kernel_source(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(REPO / name, src / name)
    shutil.copytree(REPO / "fasterrcnn_torch", src / "fasterrcnn_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    out = tmp_path / "wheel"
    subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation", "-q", "-w", str(out), str(src)],
        check=True, capture_output=True, timeout=300,
    )
    (wheel,) = out.glob("*.whl")
    names = set(zipfile.ZipFile(wheel).namelist())
    sources = sorted(p.name for p in _build.CSRC.iterdir() if p.suffix in (".cu", ".cuh"))
    assert {k.source for k in _build.KERNELS.values()} <= set(sources)
    for name in sources:
        assert f"fasterrcnn_torch/ops/kernels/csrc/{name}" in names, name
    # The native JPEG reader's source, built with g++ at first use.
    assert "fasterrcnn_torch/data/csrc/loader.cc" in names
    assert not any("/build/" in n for n in names)


def test_kernels_build_beside_the_package_when_it_is_writable(tmp_path):
    target = tmp_path / "pkg" / "build"
    assert _build.build_dir(target) == target
    assert target.is_dir()


def test_kernels_build_in_the_user_cache_when_the_package_is_not_writable(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    blocker = tmp_path / "site-packages"
    blocker.write_text("a file where the package directory would be")  # not a directory: nothing can be made in it
    chosen = _build.build_dir(blocker / "build")
    assert chosen == tmp_path / "home" / ".cache" / "fasterrcnn_torch" / "kernels"
    assert chosen.is_dir()
