"""The live observability plane: OpenMetrics export and ``/statusz``
(``fedml_tpu.core.export``, its listener and rendering; stdlib only).

:class:`MetricsExporter` is a stdlib ``http.server`` daemon thread
(``--metrics_port``, ``telemetry.configure(metrics_port=)``; port 0 binds
a free port; off by default, so no socket is opened and no work is added)
serving, on one listener:

- ``/metrics``: Prometheus/OpenMetrics text rendered from
  ``MetricsRegistry.snapshot()``, with the histograms' real bucket series
  (cumulative ``_bucket{le="..."}`` and ``_sum``/``_count``) beside the
  interpolated p50/p95/p99, names sanitized and ``# TYPE``-annotated;
- ``/statusz``: a JSON snapshot of the registered status sources, the
  run state the round loops set (:func:`set_run_state`) and the SLO
  verdicts;
- ``/healthz``: liveness, 503 once a status source reports a failure;
- ``/tracez``: the anatomy plane's ring, 404 while that plane is off.

The JAX module's fleet federation (clients' metric summaries on the
deploy heartbeat, folded into ``fleet.*``) is ROADMAP Queue A item
14b.
"""

from __future__ import annotations

import http.server
import json
import re
import threading
import time
import weakref
from typing import Any

from fedml_tpu_torch.core import telemetry

# ---------------------------------------------------------------------------
# OpenMetrics rendering
# ---------------------------------------------------------------------------

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
_SANITIZED: dict[str, str] = {}


def sanitize_metric_name(name: str) -> str:
    """Registry names are dotted; Prometheus names match
    ``[a-zA-Z_:][a-zA-Z0-9_:]*``. Dots (and anything else illegal)
    become underscores; a leading digit gets a ``_`` prefix. Cached —
    the scrape path renders the same names every time."""
    s = _SANITIZED.get(name)
    if s is None:
        s = _NAME_OK.sub("_", name)
        if not s or s[0].isdigit():
            s = "_" + s
        _SANITIZED[name] = s
    return s


def _escape_label(value: str) -> str:
    return (
        value.replace("\\", r"\\").replace('"', r"\"")
        .replace("\n", r"\n")
    )


def _fmt(v: float) -> str:
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return repr(float(v))


def render_openmetrics(snapshot: dict[str, Any]) -> str:
    """Render one registry snapshot as Prometheus text exposition
    format. Histograms export their REAL power-of-two buckets as the
    cumulative ``_bucket{le=...}`` series (monotone by construction,
    terminated by ``+Inf`` == ``_count``) plus ``_sum``/``_count``;
    the interpolated p50/p95/p99 ride along as gauges under
    ``<name>_p50`` etc. so dashboards keep the simple form too."""
    lines: list[str] = []
    for name in sorted(snapshot.get("counters", {})):
        v = snapshot["counters"][name]
        s = sanitize_metric_name(name)
        lines.append(f"# TYPE {s} counter")
        lines.append(f"{s} {_fmt(v)}")
    for name in sorted(snapshot.get("gauges", {})):
        v = snapshot["gauges"][name]
        s = sanitize_metric_name(name)
        lines.append(f"# TYPE {s} gauge")
        lines.append(f"{s} {_fmt(v)}")
    for name in sorted(snapshot.get("histograms", {})):
        h = snapshot["histograms"][name]
        s = sanitize_metric_name(name)
        lines.append(f"# TYPE {s} histogram")
        # registry buckets are "le_2^k" exponent tags; the wire wants
        # cumulative counts by ascending upper bound
        items = sorted(
            (int(k.split("^", 1)[1]), c)
            for k, c in h.get("buckets", {}).items()
        )
        cum = 0
        for k, c in items:
            cum += c
            le = _escape_label(_fmt(2.0 ** k))
            lines.append(f'{s}_bucket{{le="{le}"}} {cum}')
        lines.append(f'{s}_bucket{{le="+Inf"}} {h.get("count", 0)}')
        lines.append(f"{s}_sum {_fmt(h.get('sum', 0.0))}")
        lines.append(f"{s}_count {h.get('count', 0)}")
        for p in ("p50", "p95", "p99"):
            if p in h:
                lines.append(f"# TYPE {s}_{p} gauge")
                lines.append(f"{s}_{p} {_fmt(h[p])}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# status sources (/statusz, /healthz)
# ---------------------------------------------------------------------------

# name -> weakref to an object with .status() -> dict. Weak on purpose:
# a module-global strong ref would keep every actor a test ever built
# alive forever. Dead refs are skipped and pruned at snapshot time.
_STATUS_SOURCES: dict[str, "weakref.ref"] = {}
_RUN_STATE: dict[str, Any] = {}
_STATUS_LOCK = threading.Lock()


def register_status_source(name: str, obj: Any) -> None:
    """Register a live object exposing ``status() -> dict`` under
    ``name`` in the ``/statusz`` snapshot (last registration per name
    wins — a restarted actor supersedes its predecessor)."""
    with _STATUS_LOCK:
        _STATUS_SOURCES[name] = weakref.ref(obj)


def set_run_state(**fields: Any) -> None:
    """Cheap run-level fields (current round, run name, ...) for round
    loops without an actor object: the simulations' and the harness's."""
    with _STATUS_LOCK:
        _RUN_STATE.update(fields)


def set_round(round_idx: int, cfg) -> None:
    """The round loops' ``/statusz`` run block (the round, the run's
    rounds and name), while the metrics plane is on."""
    if telemetry.METRICS.enabled:
        set_run_state(round=round_idx, num_rounds=cfg.fed.num_rounds,
                      run_name=cfg.run_name)


def status_snapshot() -> dict[str, Any]:
    """The ``/statusz`` document. Each source's ``status()`` builds its
    dict under the source's OWN existing locks (briefly) and returns
    plain data; serialization happens out here with no lock held."""
    with _STATUS_LOCK:
        sources = dict(_STATUS_SOURCES)
        run_state = dict(_RUN_STATE)
    out: dict[str, Any] = {
        "ts": time.time(),
        "rank": telemetry.RECORDER.rank,
    }
    if run_state:
        out["run"] = run_state
    dead = []
    for name, ref in sources.items():
        obj = ref()
        if obj is None:
            dead.append(name)
            continue
        try:
            out[name] = obj.status()
        except Exception as err:  # a statusz probe must never crash
            out[name] = {"error": repr(err)}
    if dead:
        with _STATUS_LOCK:
            for name in dead:
                if _STATUS_SOURCES.get(name) is not None and \
                        _STATUS_SOURCES[name]() is None:
                    del _STATUS_SOURCES[name]
    slo = telemetry.slo_engine()
    if slo is not None:
        out["slo"] = slo.verdicts()
    return out


def health_snapshot() -> tuple[int, dict[str, Any]]:
    """``/healthz``: 200 while every status source is failure-free, 503
    once any reports a ``failure`` (a quorum-lost abort, a wedged async
    world). A server mid-recovery — resumed from a checkpoint, barrier
    still assembling — is HEALTHY: recovery is the designed path, not a
    failure (docs/FAULT_TOLERANCE.md)."""
    status = status_snapshot()
    failures = {
        name: src["failure"]
        for name, src in status.items()
        if isinstance(src, dict) and src.get("failure")
    }
    if failures:
        return 503, {"status": "degraded", "failures": failures}
    return 200, {"status": "ok", "rank": status.get("rank", 0)}


def reset_status_sources() -> None:
    with _STATUS_LOCK:
        _STATUS_SOURCES.clear()
        _RUN_STATE.clear()


#: what ``telemetry.shutdown()`` calls
reset = reset_status_sources


# ---------------------------------------------------------------------------
# the HTTP listener
# ---------------------------------------------------------------------------


class _Handler(http.server.BaseHTTPRequestHandler):
    # the exporter must never log scrapes to stderr
    def log_message(self, fmt, *args):  # noqa: A003
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                body = render_openmetrics(
                    telemetry.METRICS.snapshot()
                ).encode()
                self._send(
                    200, body,
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            elif path == "/statusz":
                body = json.dumps(
                    status_snapshot(), indent=2, default=repr
                ).encode()
                self._send(200, body, "application/json")
            elif path == "/healthz":
                code, doc = health_snapshot()
                self._send(
                    code, json.dumps(doc, default=repr).encode(),
                    "application/json",
                )
            elif path == "/tracez":
                # the round-anatomy ring (core/anatomy.py,
                # docs/OBSERVABILITY.md "Round anatomy") — lazily, so
                # a listener without the anatomy plane never imports
                # it; 404 while the plane is off (the
                # zero-cost-when-off rule: no section, not an empty
                # one)
                import sys as _sys

                _an = _sys.modules.get("fedml_tpu_torch.core.anatomy")
                if _an is None or not _an.ANATOMY.enabled:
                    self._send(404, b"anatomy plane off\n",
                               "text/plain")
                else:
                    body = json.dumps(
                        _an.ANATOMY.tracez(
                            rank=telemetry.RECORDER.rank
                        ),
                        indent=2, default=repr,
                    ).encode()
                    self._send(200, body, "application/json")
            else:
                self._send(404, b"not found\n", "text/plain")
        except Exception as err:  # scrape must not kill the server
            try:
                self._send(500, repr(err).encode(), "text/plain")
            except Exception:
                pass


class MetricsExporter:
    """One daemon-thread HTTP listener per rank. ``port=0`` binds an
    ephemeral port (read it back from :attr:`port`). The listener only
    READS the registry at scrape time — it adds zero work to any
    metric write path.

    The endpoints are UNauthenticated (exporter convention) and
    ``/statusz`` exposes run introspection — membership, quarantine
    bans, failure diagnostics. The default bind serves any network
    peer so a remote Prometheus can scrape; on a shared or untrusted
    network restrict it with ``--metrics_host 127.0.0.1`` (or front it
    with your scrape proxy)."""

    def __init__(self, port: int, host: str = "0.0.0.0"):
        self._server = http.server.ThreadingHTTPServer(
            (host, port), _Handler
        )
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"metrics-exporter:{self.port}",
        )
        self._thread.start()

    def stop(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:
            pass
        self._thread.join(timeout=2.0)
