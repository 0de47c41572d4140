"""Build the hand-written CUDA kernels with nvcc and bind them with ctypes.

Each source under `csrc/` is compiled on its own into a shared library with a
plain C interface, for Hopper (`sm_90a`), at first use. The library's file
name carries a hash of its source, the shared headers (`csrc/*.cuh`) and the
flags, so an edited source or header is rebuilt and a stale library is never
loaded. Builds go to `build/` beside this file,
which `.gitignore` lists.

Nothing here runs at import: the CPU-only test machines import every module
of the package and have neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

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
# to 32 bits. The kernels decide by strict comparisons (IoU > threshold,
# sample position in range, argmax ties), so none may contract a*b+c into an
# FMA: the plain PyTorch versions round each operation, and the RoI backward
# must recompute the forward's samples bit for bit.
KERNELS: Dict[str, Kernel] = {
    "nms_keep_mask": Kernel(
        "nms_keep_mask.cu", ("-fmad=false",), "nms_keep_mask_launch",
        [_P, _P, _P, _I, _I, ctypes.c_float, _I, _P],
    ),
    "roi_pool_taps": Kernel(
        "roi_pool_taps.cu", ("-fmad=false",), "roi_pool_taps_launch",
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    ),
    "roi_pool_taps_bwd": Kernel(
        "roi_pool_taps_bwd.cu", ("-fmad=false",), "roi_pool_taps_bwd_launch",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
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


def _command(name: str) -> Tuple[List[str], Path]:
    kernel = KERNELS[name]
    src = CSRC / kernel.source
    flags = list(_COMMON_FLAGS) + list(kernel.flags)
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(flags).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    return [_nvcc(), *flags, "-o", str(out), str(src)], out


def build(names=None) -> Dict[str, Dict[str, object]]:
    """Compile the named kernels (default: all) in parallel, one nvcc each.

    Returns {name: {"seconds": wall time, "log": nvcc's output}}; a library
    that is already built is not rebuilt (seconds 0.0). Raises if any build
    fails.
    """
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
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
