"""Structured metrics (a copy of deepvcp_tpu/train/metrics.py: importing that
package's `train` would import jax). Metrics go to JSONL and are read back
for plotting."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    """Append-only JSONL metrics writer."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        else:
            self._fh = None

    def log(self, record: Dict[str, Any]) -> None:
        record = {"ts": time.time(), **record}
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
        if self.echo:
            parts = [
                f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in record.items()
                if k != "ts"
            ]
            print("[metrics] " + " ".join(parts), flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()


def load_metrics(path: str):
    """Read a JSONL metrics file back."""
    records = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records
