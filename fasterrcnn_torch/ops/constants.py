"""Device copies of host constants, made once and reused.

A train step captured in a CUDA graph may not copy from host memory, so
every constant it reads (its canvas's anchor grid, the pixel and delta
normalizers) must already be on the device. `values` and `array` make each
one at its first use, which is the eager warm-up before a capture, and
return the same tensor ever after. The values are what `torch.tensor` and
`torch.as_tensor` give; callers never write to them.
"""

from __future__ import annotations

import threading
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

_LOCK = threading.Lock()
_VALUES: Dict[Tuple[Tuple[float, ...], torch.device], torch.Tensor] = {}
# Keyed by the array's id; each entry holds the array, so the id stays its own.
_ARRAYS: Dict[Tuple[int, torch.device], Tuple[np.ndarray, torch.Tensor]] = {}


def values(vals: Sequence[float], device) -> torch.Tensor:
    """`torch.tensor(vals, dtype=torch.float32, device=device)`, made once."""
    key = (tuple(float(v) for v in vals), torch.device(device))
    with _LOCK:
        if key not in _VALUES:
            _VALUES[key] = torch.tensor(key[0], dtype=torch.float32, device=key[1])
        return _VALUES[key]


def array(arr: np.ndarray, device) -> torch.Tensor:
    """`torch.as_tensor(arr, device=device)`, made once for this array object
    (the anchor grids are cached per canvas, `ops/anchors.generate_anchor_grid`)."""
    key = (id(arr), torch.device(device))
    with _LOCK:
        hit = _ARRAYS.get(key)
        if hit is None:
            hit = _ARRAYS[key] = (arr, torch.as_tensor(arr, device=key[1]))
        return hit[1]
