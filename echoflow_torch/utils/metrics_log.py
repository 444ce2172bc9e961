"""Structured metrics logging (a copy of `echoflow.utils.metrics_log`).

The reference's observability is `print()` statements in the train loop and
notebooks (SURVEY.md §5). Here: a JSONL/CSV metrics writer with step
timestamps, usable from the train loop's `log_fn` or standalone.
"""

from __future__ import annotations

import csv
import json
import time
from pathlib import Path


class MetricsLogger:
    """Append-only metrics sink. `fmt` is "jsonl" or "csv" (CSV locks the
    column set on first write)."""

    def __init__(self, path: str, fmt: str = "jsonl"):
        assert fmt in ("jsonl", "csv")
        self.path = Path(path)
        self.fmt = fmt
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._csv_fields = None
        self._t0 = time.time()

    def log(self, step: int, metrics: dict):
        record = {"step": int(step), "wall_time_s": round(time.time() - self._t0, 3)}
        record.update({k: (float(v) if hasattr(v, "__float__") else v)
                       for k, v in metrics.items()})
        if self.fmt == "jsonl":
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")
        else:
            new = not self.path.exists() or self.path.stat().st_size == 0
            if self._csv_fields is None:
                self._csv_fields = list(record)
            with open(self.path, "a", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=self._csv_fields,
                                        extrasaction="ignore")
                if new:
                    writer.writeheader()
                writer.writerow(record)

    def read(self) -> list[dict]:
        if not self.path.exists():
            return []
        if self.fmt == "jsonl":
            with open(self.path) as f:
                return [json.loads(line) for line in f if line.strip()]
        with open(self.path) as f:
            return list(csv.DictReader(f))
