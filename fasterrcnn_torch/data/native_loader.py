"""ctypes binding of the native JPEG reader, `csrc/loader.cc`.

The JAX package's `data/native_loader.py` for the port: the same C++ source
(a byte-identical copy of the repository's `native/loader.cc`, shipped with
this package), the same functions and the same fallback:

  * decode_resize_into: one JPEG -> resized uint8 written into a canvas
  * decode_batch_into / decode_batch: threaded batch decode straight into a
    padded batch array

The library is built with g++ and libjpeg at first use, into `build/`
beside this file (which `.gitignore` lists) or, where the package directory
cannot be written, into a directory under the user's cache; its file name
carries a hash of the source and the flags, so an edited source is rebuilt.
`available()` is False when the compiler or libjpeg is missing, and the
callers (`data/image.py`, `data/pipeline.py`, `data/voc.py`) then decode
with PIL. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "loader.cc"
PACKAGE_BUILD_DIR = Path(__file__).resolve().parent / "build"
FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build_dir() -> Path:
    for directory in (PACKAGE_BUILD_DIR, Path.home() / ".cache" / "fasterrcnn_torch" / "loader"):
        try:
            directory.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryFile(dir=directory):
                return directory
        except OSError:
            continue
    raise OSError("no writable directory for the native loader")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return _build_dir() / f"libfrcnn_loader-{digest}.so"


def _build(path: Path) -> bool:
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", *FLAGS, "-o", str(tmp), str(SOURCE), "-ljpeg", "-pthread"],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        try:
            path = library_path()
            if not path.exists() and not _build(path):
                _build_failed = True
                return None
            lib = ctypes.CDLL(str(path))
        except OSError:
            _build_failed = True
            return None
        lib.frcnn_decode_resize_into.restype = ctypes.c_int
        lib.frcnn_decode_resize_into.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.frcnn_decode_batch.restype = None
        lib.frcnn_decode_batch.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int64),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,  # dest_idx (int32* or NULL)
            np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int32), ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader unavailable (g++ or libjpeg missing)")
    return lib


def decode_resize_into(
    jpeg_bytes: bytes,
    canvas: np.ndarray,
    min_side: int = 600,
    flip: bool = False,
    max_side: int = 0,
) -> Tuple[int, int, int, int]:
    """Decode+resize one JPEG into canvas (H, W, 3) uint8 (top-left).

    Returns (real_h, real_w, orig_h, orig_w)."""
    lib = _require()
    if canvas.dtype != np.uint8 or canvas.ndim != 3 or canvas.shape[2] != 3 or not canvas.flags["C_CONTIGUOUS"]:
        raise ValueError(f"canvas must be a C-contiguous (H, W, 3) uint8 array, got {canvas.dtype} {canvas.shape}")
    rh, rw, oh, ow = (ctypes.c_int() for _ in range(4))
    rc = lib.frcnn_decode_resize_into(
        jpeg_bytes, len(jpeg_bytes), min_side, max_side, int(flip),
        canvas.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        canvas.shape[0], canvas.shape[1],
        ctypes.byref(rh), ctypes.byref(rw), ctypes.byref(oh), ctypes.byref(ow),
    )
    if rc != 0:
        raise ValueError(f"native decode failed with code {rc}")
    return rh.value, rw.value, oh.value, ow.value


def decode_batch_into(
    jpeg_buffers: Sequence[bytes],
    batch: np.ndarray,
    dest_indices: Optional[Sequence[int]] = None,
    min_side: int = 600,
    max_side: int = 0,
    flips: Optional[Sequence[bool]] = None,
    num_threads: int = 0,
):
    """Threaded batch decode DIRECTLY into an existing (B, H, W, 3) uint8
    padded batch array.

    dest_indices: batch row for each JPEG (default 0..n-1), so that a
    partly cached batch decodes only its missing rows. The GIL is released
    for the whole batch, so the prefetch thread's decode overlaps the main
    thread's work.

    Returns (real_hw (N,2) int32, orig_hw (N,2) int32)."""
    lib = _require()
    if batch.dtype != np.uint8 or batch.ndim != 4 or batch.shape[3] != 3 or not batch.flags["C_CONTIGUOUS"]:
        raise ValueError(f"batch must be a C-contiguous (B, H, W, 3) uint8 array, got {batch.dtype} {batch.shape}")
    n = len(jpeg_buffers)
    blob = b"".join(jpeg_buffers)
    lengths = np.asarray([len(b) for b in jpeg_buffers], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    flips_arr = np.asarray([int(bool(f)) for f in (flips or [False] * n)], np.int32)
    dest_arr = None
    dest_ptr = None
    if dest_indices is not None:
        dest_arr = np.ascontiguousarray(dest_indices, np.int32)
        if dest_arr.shape != (n,) or dest_arr.min(initial=0) < 0 or dest_arr.max(initial=0) >= batch.shape[0]:
            raise ValueError(f"dest_indices {dest_indices} for {n} JPEGs and a batch of {batch.shape[0]}")
        dest_ptr = dest_arr.ctypes.data_as(ctypes.c_void_p)
    ch, cw = batch.shape[1], batch.shape[2]
    real_hw = np.zeros((n, 2), np.int32)
    orig_hw = np.zeros((n, 2), np.int32)
    results = np.zeros((n,), np.int32)
    if num_threads <= 0:
        num_threads = min(os.cpu_count() or 1, n)
    lib.frcnn_decode_batch(
        blob, offsets, lengths, n, min_side, max_side, flips_arr, batch,
        ch, cw, dest_ptr, real_hw, orig_hw, results, num_threads,
    )
    if results.any():
        bad = int(np.flatnonzero(results)[0])
        raise ValueError(f"native decode failed for image {bad} (code {results[bad]})")
    return real_hw, orig_hw


def decode_batch(
    jpeg_buffers: Sequence[bytes],
    canvas_hw: Tuple[int, int],
    min_side: int = 600,
    flips: Optional[Sequence[bool]] = None,
    num_threads: int = 0,
    max_side: int = 0,
):
    """Threaded batch decode into a fresh (N, H, W, 3) uint8 canvas batch.

    Returns (batch, real_hw (N,2) int32, orig_hw (N,2) int32)."""
    n = len(jpeg_buffers)
    ch, cw = canvas_hw
    batch = np.zeros((n, ch, cw, 3), np.uint8)
    real_hw, orig_hw = decode_batch_into(jpeg_buffers, batch, None, min_side, max_side, flips, num_threads)
    return batch, real_hw, orig_hw
