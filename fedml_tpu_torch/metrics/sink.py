"""Metrics sink: a step log and a latest-value summary, as JSONL + dict.

``close()`` writes the summary as ``summary.json`` next to the JSONL;
while the telemetry registry is on, the summary carries its histograms
(count, sum, min, max and the p50/p95/p99 estimates) under
``telemetry_histograms``, as in the JAX package.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

from fedml_tpu_torch.core import telemetry


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
            summary = dict(self.summary)
            if telemetry.METRICS.enabled:
                hists = telemetry.METRICS.snapshot()["histograms"]
                if hists:
                    keep = ("count", "sum", "min", "max", "p50", "p95",
                            "p99")
                    summary["telemetry_histograms"] = {
                        name: {k: h[k] for k in keep if k in h}
                        for name, h in hists.items()}
            spath = os.path.join(
                os.path.dirname(self.path) or ".", "summary.json"
            )
            with open(spath, "w") as f:
                json.dump(summary, f, indent=2, default=_json_default)
        if self._fh:
            self._fh.close()
            self._fh = None
