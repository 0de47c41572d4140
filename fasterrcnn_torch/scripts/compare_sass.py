"""Compare the machine code of kernels between two checkouts.

Builds each named kernel's library in each checkout (with that checkout's
own `ops/kernels/_build.py`), disassembles both with `cuobjdump -sass` and
compares them kernel by kernel, instruction by instruction. Kernel names are
matched with the anonymous-namespace hash that nvcc derives from the source
file taken out, so an edit elsewhere in a source or in a shared header that
leaves a kernel's code as it was reads as identical. Prints one line per
library and exits 1 if any differs.

Usage (on a machine with nvcc; no card is needed):
    python -m fasterrcnn_torch.scripts.compare_sass <checkout> <other checkout> roi_pool_taps roi_pool_taps_bwd
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from typing import Dict, List


def library_path(checkout: str, name: str) -> str:
    """Builds kernel `name` in `checkout` and returns its library's path."""
    code = ("from fasterrcnn_torch.ops.kernels import _build; _build.build([%r]); "
            "print(_build._command(%r)[1])" % (name, name))
    out = subprocess.run([sys.executable, "-c", code], cwd=checkout, capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


def sass(cuobjdump: str, path: str) -> Dict[str, List[str]]:
    """{kernel name without its namespace hash: its instructions in order}."""
    text = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True, check=True).stdout
    kernels: Dict[str, List[str]] = {}
    current = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = re.sub(r"_GLOBAL__N__[0-9a-f]+", "_GLOBAL__N__", m.group(1))
            kernels[current] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and current is not None:
            kernels[current].append(m.group(1))
    return kernels


def main(argv: List[str]) -> int:
    if len(argv) < 3:
        raise SystemExit(__doc__)
    from fasterrcnn_torch.ops.kernels import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    first, second, names = argv[0], argv[1], argv[2:]
    same_all = True
    for name in names:
        a = sass(cuobjdump, library_path(first, name))
        b = sass(cuobjdump, library_path(second, name))
        same = a == b
        same_all &= same
        print(f"{name}: {len(a)} / {len(b)} kernels, {sum(map(len, a.values()))} / "
              f"{sum(map(len, b.values()))} instructions, identical: {same}", flush=True)
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
