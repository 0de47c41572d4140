"""Least times of the RoI kernels from the shapes of one launch: the bytes
each must move at the card's HBM bandwidth (from the port's
`scripts/profile_roi.py`, its bytes terms; the operations term there
depends on the RoIs, which the benchmark cannot see on the timed path).

  K2 forward: the (B, H, W, C) map, the (B, P, 4) f32 RoIs and the (B, 2)
  f32 norm read once, the (B, P, 7, 7, C) output written once.
  K3 backward: the map and the (B, P, 7, 7, C) cotangent read, the RoIs
  and norm read, and the map's cotangent written once.
"""

from __future__ import annotations

from bench_h100.yardstick.peaks import HBM_BYTES_PER_S


def forward_bytes(b: int, h: int, w: int, c: int, p: int, item: int) -> int:
    return b * h * w * c * item + b * p * 16 + b * 8 + b * p * 49 * c * item


def backward_bytes(b: int, h: int, w: int, c: int, p: int, item: int) -> int:
    return 2 * b * h * w * c * item + b * p * 49 * c * item + b * p * 16 + b * 8


def seconds(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S
