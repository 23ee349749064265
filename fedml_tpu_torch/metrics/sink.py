"""Metrics sink: a step log and a latest-value summary, as JSONL + dict.

``close()`` writes the summary as ``summary.json`` next to the JSONL.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


def _json_default(v):
    """Serialize best-effort: floats where possible, ``repr`` otherwise,
    so one exotic value cannot end the metrics stream."""
    try:
        return float(v)
    except (TypeError, ValueError):
        return repr(v)


class MetricsSink:
    def __init__(self, path: str | None = None):
        self.history: list[dict[str, Any]] = []
        self.summary: dict[str, Any] = {}
        self.path = path
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")

    def log(self, record: dict[str, Any]) -> None:
        record = dict(record, _ts=time.time())
        self.history.append(record)
        self.summary.update(
            {k: v for k, v in record.items() if not k.startswith("_")}
        )
        if self._fh:
            self._fh.write(json.dumps(record, default=_json_default) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self.path:
            spath = os.path.join(
                os.path.dirname(self.path) or ".", "summary.json"
            )
            with open(spath, "w") as f:
                json.dump(self.summary, f, indent=2, default=_json_default)
        if self._fh:
            self._fh.close()
            self._fh = None
