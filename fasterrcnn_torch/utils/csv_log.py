"""Append-only CSV training log: the header is written once, on the first
append to an empty file. A copy of `fasterrcnn_tpu/utils/csv_log.py`."""

from __future__ import annotations

import os
from typing import Dict


class CSVLog:
    def __init__(self, filepath: str):
        self._filepath = filepath
        self._header_written = os.path.exists(filepath) and os.path.getsize(filepath) > 0

    def log(self, items: Dict) -> None:
        keys = list(items.keys())
        with open(self._filepath, "a") as f:
            if not self._header_written:
                f.write(",".join(str(k) for k in keys) + "\n")
                self._header_written = True
            f.write(",".join(str(items[k]) for k in keys) + "\n")
