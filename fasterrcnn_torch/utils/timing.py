"""Device timing by the slope of a dispatch loop.

PyTorch returns from a CUDA call before the card has run it, so a host
clock around calls measures their enqueue. The recipe: run a loop of
dispatches ended by one wait for the card (`torch.cuda.synchronize()`, or a
host read of the last result), at two loop lengths, and take the SLOPE.
The fixed costs of a call (the first launch, the closing synchronize and
its return to the host) are paid once per loop and cancel in the slope,
so what remains is the time per iteration of the work itself, or of its
enqueue where the host is slower than the card.

Used by `fasterrcnn_torch/scripts/bench.py`.
"""

from __future__ import annotations

import time
from typing import Callable


def slope_ms(
    dispatch: Callable[[], None],
    fetch: Callable[[], None],
    iters_lo: int,
    iters_hi: int,
) -> float:
    """Milliseconds per iteration of `dispatch`, overhead-cancelled.

    Args:
      dispatch: enqueue one iteration of device work (must NOT wait for it).
      fetch: wait for the card: `torch.cuda.synchronize()` or a host read
        of the latest result.
      iters_lo / iters_hi: the two loop lengths; slope is taken between them.

    The caller must have warmed the computation already (a cold call would
    bill its kernel builds and cuDNN's algorithm search to the hi-count leg).
    """

    def run(n: int) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            dispatch()
        fetch()
        return time.perf_counter() - t0

    run(1)  # settle caches / queue state
    t_lo = run(iters_lo)
    t_hi = run(iters_hi)
    return (t_hi - t_lo) / (iters_hi - iters_lo) * 1e3
