"""Build the hand-written CUDA kernels with nvcc and bind them with ctypes.

Each source under `csrc/` is compiled on its own into a shared library with a
plain C interface, for Hopper (`sm_90a`), at first use. The library's file
name carries a hash of its source, the shared headers (`csrc/*.cuh`) and the
flags, so an edited source or header is rebuilt and a stale library is never
loaded. Builds go to `build/` beside this file (which `.gitignore` lists),
or, where the package directory is not writable (an installed package in a
read-only site-packages), to `~/.cache/fasterrcnn_torch/kernels`.

Nothing here runs at import: the CPU-only test machines import every module
of the package and have neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Dict, List, NamedTuple, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
PACKAGE_BUILD_DIR = Path(__file__).resolve().parent / "build"

_COMMON_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


class Kernel(NamedTuple):
    source: str  # file under csrc/
    flags: Tuple[str, ...]  # nvcc flags beyond the common ones
    symbol: str  # C entry point
    argtypes: list  # its ctypes signature


_P = ctypes.c_void_p
_I = ctypes.c_int
# Every pointer and the stream are c_void_p, so ctypes never truncates them
# to 32 bits. The NMS and RoI kernels decide by strict comparisons (IoU >
# threshold, sample position in range, argmax ties), so none of them may
# contract a*b+c into an FMA: the plain PyTorch versions round each
# operation, and the RoI backward must recompute the forward's samples bit
# for bit. The conv kernels decide nothing and may.
KERNELS: Dict[str, Kernel] = {
    "nms_keep_mask": Kernel(
        "nms_keep_mask.cu", ("-fmad=false",), "nms_keep_mask_launch",
        [_P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _P],
    ),
    "roi_pool_taps": Kernel(
        "roi_pool_taps.cu", ("-fmad=false",), "roi_pool_taps_launch",
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    ),
    "roi_pool_taps_bwd": Kernel(
        "roi_pool_taps_bwd.cu", ("-fmad=false",), "roi_pool_taps_bwd_launch",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    ),
    "roi_pool_fused": Kernel(
        "roi_pool_fused.cu", ("-fmad=false",), "roi_pool_fused_launch",
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    ),
    "conv3x3": Kernel(
        "conv3x3.cu", (), "conv3x3_launch",
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    ),
    "conv3x3_im2col": Kernel(
        "conv3x3_im2col.cu", (), "conv3x3_im2col_launch",
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    ),
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _writable(directory: Path) -> bool:
    try:
        directory.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryFile(dir=directory):
            return True
    except OSError:
        return False


def build_dir(package_dir: Path = PACKAGE_BUILD_DIR) -> Path:
    """Where the libraries are built: `package_dir` if it can be written,
    else a directory under the user's cache."""
    if _writable(package_dir):
        return package_dir
    cache = Path.home() / ".cache" / "fasterrcnn_torch" / "kernels"
    cache.mkdir(parents=True, exist_ok=True)
    return cache


@functools.lru_cache(maxsize=None)
def _build_dir() -> Path:
    return build_dir()  # chosen once a process


def _command(name: str) -> Tuple[List[str], Path]:
    kernel = KERNELS[name]
    src = CSRC / kernel.source
    flags = list(_COMMON_FLAGS) + list(kernel.flags)
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(flags).encode()).hexdigest()[:12]
    out = _build_dir() / f"lib{name}_{digest}.so"
    return [_nvcc(), *flags, "-o", str(out), str(src)], out


def build(names=None) -> Dict[str, Dict[str, object]]:
    """Compile the named kernels (default: all) in parallel, one nvcc each.

    Returns {name: {"seconds": wall time, "log": nvcc's output}}; a library
    that is already built is not rebuilt (seconds 0.0). Raises if any build
    fails.
    """
    names = list(KERNELS) if names is None else list(names)
    procs = {}
    result: Dict[str, Dict[str, object]] = {}
    for name in names:
        cmd, out = _command(name)
        if out.exists():
            result[name] = {"seconds": 0.0, "log": ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd[cmd.index(str(out))] = str(tmp)
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        result[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return result


def sass_opcodes(name: str) -> Counter:
    """How many instructions of each opcode (with its modifiers, e.g.
    `LDG.E.128.CONSTANT`) the built library of one kernel holds, from
    `cuobjdump -sass`."""
    build([name])
    _, out = _command(name)
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(out)], capture_output=True, text=True, check=True).stdout
    counts: Counter = Counter()
    for line in sass.splitlines():
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Za-z0-9_.]*)", line)
        if m:
            counts[m.group(1)] += 1
    return counts


def sass_count(name: str, opcode: str) -> int:
    """How many instructions of the built library of one kernel are `opcode`
    with any modifiers (e.g. HGMMA, the tensor cores' warpgroup MMA)."""
    return sum(n for op, n in sass_opcodes(name).items() if op == opcode or op.startswith(opcode + "."))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            _, out = _command(name)
            lib = ctypes.CDLL(str(out))
            fn = getattr(lib, KERNELS[name].symbol)
            fn.argtypes = KERNELS[name].argtypes
            fn.restype = ctypes.c_int
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def launch(name: str, *args) -> None:
    """Call a kernel's C entry point; raise if the launch was refused."""
    lib = library(name)
    err = getattr(lib, KERNELS[name].symbol)(*args)
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
