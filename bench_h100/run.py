"""Run one cell of the benchmark once and print its result line.

    python3 bench_h100/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (`python -m bench_h100.run` works too). The
run needs a CUDA card and never falls back to the CPU. Its last line on
standard output is one JSON object (`correct`, `attempted`, `failed`,
`metrics`, `device`; with --trace 1 also `breakdown`; then the reference's
`readings` and, last, the compared numbers beside their limits under
`checks`); its last lines on standard error are those checks.

Kernel builds and caches stay inside the checkout or the run's own HOME,
XDG_CACHE_HOME and TMPDIR: the program builds its kernels into its package
directory. Exit codes: 0 done; 1 an error (the program not found, say);
2 no card or a bad argument; 3 JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# Top-level module names a run may not load (compared whole, so the port,
# whose name starts with the JAX package's, is not one of them).
FORBIDDEN = ("jax", "jaxlib", "flax", "fasterrcnn_tpu")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from bench_h100 import harness

    bench_path = REPO / "BENCHMARK.json"
    if not bench_path.is_file():
        print(f"no BENCHMARK.json at {bench_path}", file=sys.stderr)
        return 2
    bench = harness.load_benchmark(bench_path)
    workload = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if workload is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        print(f"{args.workload} needs {workload['chips']} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = harness.run_cell(harness.Cell(bench, args.workload), args.seed, args.seconds, bool(args.trace),
                              "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}; the benchmark may not load JAX or the JAX package",
              file=sys.stderr)
        return 3
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
