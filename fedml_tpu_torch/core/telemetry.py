"""Runtime telemetry: the metrics registry, the flight recorder and the
process tracer (``fedml_tpu.core.telemetry``).

- :class:`MetricsRegistry`: thread-safe counters, gauges and histograms
  with a ``snapshot()``; one process-global instance (:data:`METRICS`)
  that the round loops, the perf, memory, anatomy and SLO planes and the
  bulk, elastic and state-bank accounting write under the JAX package's
  metric names.
- :class:`FlightRecorder`: a bounded ring of recent events, dumped to the
  telemetry directory on an unhandled crash (the sys and threading
  excepthooks) and on demand (:func:`flight_dump`).
- :data:`TRACER`: the process :class:`~fedml_tpu_torch.core.tracing.
  Tracer`, read through :func:`maybe_span`.

Off is the default and costs one attribute check: :data:`METRICS` starts
``enabled=False`` (every ``inc``/``gauge``/``observe`` returns at once),
:data:`TRACER` is ``None`` and the recorder accepts nothing.
:func:`configure` (the CLI calls it under ``--telemetry_dir``, ``--trace``
and the other observability flags) switches the plane on for this
process; :func:`shutdown` switches it off again.

The trace ids that ride ``core/message.py``'s ``Message`` envelopes live
here too: :func:`new_trace_id`, :func:`new_span_id` and the thread's
current trace (:func:`set_current_trace`, bound by the manager while a
handler runs, so the messages it sends inherit the inbound trace).
"""

from __future__ import annotations

import atexit
import collections
import glob
import json
import os
import sys
import threading
import time
import uuid
from typing import Any

from fedml_tpu_torch.core.tracing import Tracer


def percentiles_from_histogram(
    h: dict[str, Any], qs: tuple[float, ...] = (0.5, 0.95, 0.99)
) -> dict[str, float]:
    """Estimate quantiles from a histogram's power-of-two buckets.

    The target rank is found in the cumulative bucket counts and linearly
    interpolated inside its bucket ``(2^(k-1), 2^k]``, the range clamped
    to the observed ``[min, max]``. The estimate is exact when the chosen
    bucket's range collapses (one observation, or all observations equal);
    otherwise it is within the bucket's width, a factor of 2."""
    count = h.get("count", 0)
    buckets = h.get("buckets", {})
    if not count or not buckets:
        return {}
    items = sorted((int(k.split("^", 1)[1]), c) for k, c in buckets.items())
    hmin = h.get("min", float("-inf"))
    hmax = h.get("max", float("inf"))
    out: dict[str, float] = {}
    for q in qs:
        target = q * count
        cum = 0
        for k, c in items:
            prev, cum = cum, cum + c
            if cum >= target:
                lo = 0.0 if k <= -20 else 2.0 ** (k - 1)
                hi = 2.0 ** k
                lo = min(max(lo, hmin), hmax)
                hi = max(min(hi, hmax), hmin)
                frac = (target - prev) / c if c else 0.0
                out[f"p{round(q * 100):d}"] = lo + (hi - lo) * frac
                break
    return out


def _new_hist() -> dict[str, Any]:
    return {"count": 0, "sum": 0.0, "min": float("inf"),
            "max": float("-inf"), "buckets": {}}


class MetricsRegistry:
    """Thread-safe counters, gauges and histograms.

    Names are flat dotted strings (the JAX package's vocabulary,
    ``docs/OBSERVABILITY.md``). A histogram keeps count, sum, min, max
    and power-of-two bucket counts; ``snapshot()`` adds each one's
    ``p50``/``p95``/``p99`` estimates (:func:`percentiles_from_histogram`).
    Every write returns at once while ``enabled`` is False."""

    #: per-family label cap of :meth:`gauge_labeled`
    LABEL_CAP = 64

    def __init__(self, enabled: bool = True, label_cap: int = LABEL_CAP):
        self.enabled = enabled
        self.label_cap = label_cap
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, dict[str, Any]] = {}
        # family -> labels already minted (gauge_labeled's cap ledger)
        self._label_families: dict[str, set[str]] = {}

    def inc(self, name: str, value: float = 1) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def gauge(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._gauges[name] = float(value)

    def gauge_labeled(self, family: str, label: str, value: float,
                      sep: str = ".") -> None:
        """A gauge family by label with a cardinality cap: the first
        ``label_cap`` labels of a family mint ``<family><sep><label>``;
        every label past the cap writes the one ``<family>.other`` gauge
        and counts ``telemetry.label_overflow``."""
        if not self.enabled:
            return
        with self._lock:
            labels = self._label_families.setdefault(family, set())
            if label in labels or len(labels) < self.label_cap:
                labels.add(label)
                self._gauges[f"{family}{sep}{label}"] = float(value)
            else:
                self._gauges[f"{family}.other"] = float(value)
                self._counters["telemetry.label_overflow"] = (
                    self._counters.get("telemetry.label_overflow", 0) + 1)

    def labeled_name(self, family: str, label: str,
                     sep: str = ".") -> str:
        """Resolve (and register) a labeled gauge's final name once, for
        per-message paths that cache the string and then write with
        :meth:`gauge`; the family keeps :meth:`gauge_labeled`'s cap (an
        over-cap label resolves to ``<family>.other``, counted once)."""
        with self._lock:
            labels = self._label_families.setdefault(family, set())
            if label in labels or len(labels) < self.label_cap:
                labels.add(label)
                return f"{family}{sep}{label}"
            self._counters["telemetry.label_overflow"] = (
                self._counters.get("telemetry.label_overflow", 0) + 1)
            return f"{family}.other"

    def observe(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _new_hist()
            h["count"] += 1
            h["sum"] += value
            h["min"] = min(h["min"], value)
            h["max"] = max(h["max"], value)
            # bucket le_2^k for the smallest k in [-20, 20] with
            # value <= 2^k (clamped at both ends)
            k = -20
            while k < 20 and value > 2.0 ** k:
                k += 1
            key = f"le_2^{k}"
            h["buckets"][key] = h["buckets"].get(key, 0) + 1

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0)

    def snapshot(self) -> dict[str, Any]:
        """A copy safe to change or serialize; each histogram carries its
        ``p50``/``p95``/``p99`` estimates beside the raw buckets."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {
                    k: {**v, "buckets": dict(v["buckets"]),
                        **percentiles_from_histogram(v)}
                    for k, v in self._hists.items()
                },
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._label_families.clear()


class FlightRecorder:
    """A bounded ring of recent telemetry events and the crash artifact's
    writer. ``record`` is a deque append under a lock, a no-op while
    disabled; ``dump`` writes the ring, the metrics snapshot and the
    reason to ``<dir>/flight_<tag>_<n>_<reason>.json``, ``n`` counting up
    so two dumps never overwrite each other."""

    def __init__(self, capacity: int = 1024, enabled: bool = False):
        self.enabled = enabled
        self.dir: str | None = None
        self.rank = 0
        # the artifacts' stem: "rank<r>" and a restarted process's suffix
        self.tag = "rank0"
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._dumps = 0

    def record(self, kind: str, **fields) -> None:
        if not self.enabled:
            return
        ev = {"kind": kind, "ts": time.time(), **fields}
        with self._lock:
            self._ring.append(ev)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def dump(self, reason: str, **fields) -> str | None:
        """Write the flight artifact; returns its path (None without a
        telemetry directory)."""
        self.record(reason, **fields)
        if self.dir is None:
            return None
        with self._lock:
            self._dumps += 1
            n = self._dumps
            events = list(self._ring)
        path = os.path.join(self.dir, f"flight_{self.tag}_{n}_{reason}.json")
        data = {"reason": reason, "rank": self.rank, "ts": time.time(),
                **fields, "events": events, "metrics": METRICS.snapshot()}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=2, default=repr)
        os.replace(tmp, path)
        return path


#: Process-global registry, disabled until :func:`configure`.
METRICS = MetricsRegistry(enabled=False)
#: Process-global flight recorder, disabled until :func:`configure`.
RECORDER = FlightRecorder()
#: Process-global tracer, ``None`` until ``configure(trace=True)``.
TRACER: Tracer | None = None

_DIR: str | None = None
_RANK = 0
# the periodic metrics time series: a daemon thread appending snapshot
# rows to metrics_rank<r>.jsonl
_TS_STOP: threading.Event | None = None
_TS_THREAD: threading.Thread | None = None
# whether that thread appends rows (--metrics_interval) or only ticks the
# SLO engine (a cadence derived from --slo windows writes no time series)
_TS_ROWS = True
# one row at a time: the periodic rows and the final one never interleave
_TS_LOCK = threading.Lock()
# the live plane: the OpenMetrics listener (core/export.py) and the SLO
# engine (core/slo.py), None until configure(metrics_port=...)/(slos=...)
_EXPORTER = None
_SLO = None
# a restarted process's suffix ("" for the first; "_i<n>" after), so it
# never overwrites the artifacts of the one before it
_SUFFIX = ""
_hooks_installed = False


def set_gauge(counters: dict, name: str, value: float) -> None:
    """``counters[name] = value`` (a simulation's own record, read by its
    callers whatever the plane) and the registry's gauge ``name``."""
    counters[name] = float(value)
    METRICS.gauge(name, value)


def add_count(counters: dict, name: str, value: float = 1) -> None:
    """``counters[name] += value`` and the registry's counter ``name``."""
    counters[name] = counters.get(name, 0) + value
    METRICS.inc(name, value)


_tls = threading.local()


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def set_current_trace(trace_id: str | None) -> None:
    """Bind the thread's current trace id (set while a message handler
    runs, so the handler's sends inherit the inbound trace)."""
    _tls.trace = trace_id


def current_trace() -> str | None:
    return getattr(_tls, "trace", None)


def maybe_span(name: str, **attrs):
    """A tracer span when tracing is on, a null context otherwise."""
    import contextlib

    tr = TRACER
    if tr is None:
        return contextlib.nullcontext()
    return tr.span(name, **attrs)


def flight_dump(reason: str, **fields) -> str | None:
    """Record and dump a flight artifact (nothing is written without a
    telemetry directory)."""
    return RECORDER.dump(reason, **fields)


# -- lifecycle ---------------------------------------------------------------


def default_dir(out_dir: str, run_name: str) -> str:
    """Where the artifacts land when telemetry is asked for without a
    ``--telemetry_dir``."""
    return os.path.join(out_dir, run_name, "telemetry")


def artifact_dir() -> str | None:
    """The configured telemetry directory (None while off): the perf
    plane's capture windows and breakdowns and the anatomy plane's breach
    profiles land there."""
    return _DIR


def rank_tag() -> str:
    """This process's artifact stem (``rank<r>`` and the restart
    suffix)."""
    return f"rank{_RANK}{_SUFFIX}"


def slo_engine():
    """The process SLO engine (None unless ``configure(slos=...)``)."""
    return _SLO


def configure(telemetry_dir: str | None = None, rank: int = 0,
              trace: bool = True, torch_profiler: bool = False,
              metrics_interval: float | None = None,
              metrics_port: int | None = None,
              metrics_host: str = "0.0.0.0", slos=(),
              slo_scope: str = "") -> None:
    """Switch telemetry on for this process (idempotent).

    - metrics counting switches on;
    - ``trace=True`` makes the process tracer, its spans also
      ``torch.profiler.record_function`` ranges with ``torch_profiler``;
    - a ``telemetry_dir`` arms the flight recorder, the crash hooks and
      the exit flush that writes ``trace_rank<r>.json`` and
      ``metrics_rank<r>.json``;
    - ``metrics_interval`` (seconds, with a directory) starts the
      periodic ``metrics_rank<r>.jsonl`` rows;
    - ``metrics_port`` starts the OpenMetrics listener (``/metrics``,
      ``/statusz``, ``/healthz``; 0 binds a free port, read back from
      the ``telemetry.metrics_port`` gauge and ``export_rank<r>.json``);
      None opens no socket;
    - ``slos`` (``--slo`` strings) arms the SLO engine, which ticks on the
      time series' cadence (derived from the tightest window when there
      is no ``metrics_interval``) and writes ``slo_rank<r>.json`` at
      shutdown; ``slo_scope`` names the job (default ``rank<r>``).
    """
    global TRACER, _DIR, _RANK, _SUFFIX, _EXPORTER, _SLO
    _RANK = rank
    METRICS.enabled = True
    RECORDER.rank = rank
    if trace:
        if TRACER is None:
            TRACER = Tracer(use_torch_profiler=torch_profiler, rank=rank)
        else:
            TRACER.rank = rank
    if telemetry_dir:
        os.makedirs(telemetry_dir, exist_ok=True)
        _DIR = telemetry_dir
        # an earlier process of this rank left artifacts here: take the
        # first free "_i<n>" suffix instead of overwriting them
        _SUFFIX = ""
        n = 0
        while any(
            os.path.exists(os.path.join(telemetry_dir,
                                        f"{kind}_rank{rank}{_SUFFIX}.json"))
            for kind in ("trace", "metrics")
        ) or glob.glob(os.path.join(telemetry_dir,
                                    f"flight_rank{rank}{_SUFFIX}_*.json")):
            n += 1
            _SUFFIX = f"_i{n}"
        RECORDER.dir = telemetry_dir
        RECORDER.tag = f"rank{rank}{_SUFFIX}"
        RECORDER.enabled = True
        _install_hooks()
    if slos and _SLO is None:
        from fedml_tpu_torch.core import slo as _slo_mod

        specs = _slo_mod.parse_specs(slos, scope=slo_scope or f"rank{rank}")
        if specs:
            _SLO = _slo_mod.SloEngine(specs, METRICS, recorder=RECORDER)
    if metrics_port is not None and _EXPORTER is None:
        from fedml_tpu_torch.core import export as _export

        _EXPORTER = _export.MetricsExporter(metrics_port, host=metrics_host)
        METRICS.gauge("telemetry.metrics_port", _EXPORTER.port)
        if _DIR is not None:
            # the bound port, for scrapers of an ephemeral bind
            with open(os.path.join(_DIR, f"export_rank{_RANK}{_SUFFIX}.json"),
                      "w") as f:
                json.dump({"port": _EXPORTER.port, "rank": rank}, f)
    if metrics_interval:
        start_metrics_timeseries(metrics_interval)
    elif _SLO is not None and _TS_THREAD is None:
        # the SLO engine rides the time series' cadence: without an
        # interval, one from the tightest window, ticking only
        w = min(s.window_s for s in _SLO.specs)
        start_metrics_timeseries(max(0.1, min(1.0, w / 5.0)), rows=False)


def _timeseries_path() -> str | None:
    if _DIR is None:
        return None
    return os.path.join(_DIR, f"metrics_rank{_RANK}{_SUFFIX}.jsonl")


def _append_timeseries_row() -> None:
    """One snapshot row, the histograms without their raw buckets (the
    ``metrics_rank<r>.json`` snapshot keeps them)."""
    path = _timeseries_path()
    if path is None:
        return
    snap = METRICS.snapshot()
    row = {
        "ts": time.time(),
        "rank": _RANK,
        "counters": snap["counters"],
        "gauges": snap["gauges"],
        "histograms": {k: {kk: vv for kk, vv in v.items() if kk != "buckets"}
                       for k, v in snap["histograms"].items()},
    }
    with _TS_LOCK, open(path, "a") as f:
        f.write(json.dumps(row, default=repr) + "\n")


def _ts_tick() -> None:
    """One beat: the SLO engine's tick, then the row (so a row carries the
    fresh ``slo.*`` gauges)."""
    slo = _SLO
    if slo is not None:
        slo.tick()
    if _TS_ROWS:
        _append_timeseries_row()


def start_metrics_timeseries(interval_s: float, rows: bool = True) -> None:
    """Start the periodic flush (idempotent): every ``interval_s`` seconds
    a snapshot row is appended to ``metrics_rank<r>.jsonl``. With an SLO
    engine the thread runs without a directory too (its ticks ride this
    cadence); ``rows=False`` ticks the engine and appends nothing.
    :func:`shutdown` stops the thread and appends one final row."""
    global _TS_STOP, _TS_THREAD, _TS_ROWS
    if (_DIR is None and _SLO is None) or interval_s <= 0 \
            or _TS_THREAD is not None:
        return
    _TS_ROWS = rows
    stop = threading.Event()

    def loop():
        while not stop.wait(interval_s):
            _ts_tick()

    t = threading.Thread(target=loop, daemon=True, name="metrics-timeseries")
    _TS_STOP, _TS_THREAD = stop, t
    t.start()


def flush_metrics() -> None:
    """Write the metrics snapshot ``metrics_rank<r>.json`` now."""
    if _DIR is None:
        return
    path = os.path.join(_DIR, f"metrics_rank{_RANK}{_SUFFIX}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(METRICS.snapshot(), f, indent=2, default=repr)
    os.replace(tmp, path)


def _stop_timeseries(write_final: bool) -> None:
    """Stop and join the periodic thread, then (optionally) one final
    beat, so the series always ends on the end state and no row of the
    thread interleaves with it. A second call appends nothing."""
    global _TS_STOP, _TS_THREAD
    stop, thread = _TS_STOP, _TS_THREAD
    _TS_STOP = _TS_THREAD = None
    if stop is not None:
        stop.set()
    if thread is not None:
        thread.join(timeout=2.0)
        if write_final:
            _ts_tick()


def flush() -> None:
    """Write the trace dump, the final time-series row, the SLO verdicts
    (``slo_rank<r>.json``) and the metrics snapshot now (also at exit once
    a telemetry directory is configured)."""
    if _DIR is None:
        return
    if TRACER is not None and TRACER.events:
        TRACER.dump(os.path.join(_DIR, f"trace_rank{_RANK}{_SUFFIX}.json"))
    _stop_timeseries(write_final=True)
    if _SLO is not None:
        _SLO.write_verdicts(os.path.join(_DIR,
                                         f"slo_rank{_RANK}{_SUFFIX}.json"),
                            rank=_RANK)
    flush_metrics()


def shutdown() -> None:
    """Flush, then return every plane to off (the tests' isolation): the
    listener stops, the SLO engine goes, and the memory and anatomy
    planes reset (only if they were ever imported)."""
    global TRACER, _DIR, _SUFFIX, _EXPORTER, _SLO, _TS_ROWS
    _stop_timeseries(write_final=_DIR is not None)
    flush()
    _TS_ROWS = True
    if _EXPORTER is not None:
        _EXPORTER.stop()
        _EXPORTER = None
    _SLO = None
    for name in ("export", "memscope", "anatomy"):
        mod = sys.modules.get(f"fedml_tpu_torch.core.{name}")
        if mod is not None:
            mod.reset()
    METRICS.enabled = False
    METRICS.reset()
    RECORDER.enabled = False
    RECORDER.dir = None
    RECORDER.tag = "rank0"
    RECORDER._ring.clear()
    RECORDER._dumps = 0
    TRACER = None
    _DIR = None
    _SUFFIX = ""


def _install_hooks() -> None:
    """The crash hooks and the exit flush, once per process. They read the
    module's globals when they fire, so after :func:`shutdown` they do
    nothing."""
    global _hooks_installed
    if _hooks_installed:
        return
    _hooks_installed = True

    prev_exc = sys.excepthook

    def on_crash(exc_type, exc, tb):
        if RECORDER.enabled:
            flight_dump("crash", error=repr(exc),
                        error_type=exc_type.__name__)
            flush()
        prev_exc(exc_type, exc, tb)

    sys.excepthook = on_crash

    prev_thread_exc = threading.excepthook

    def on_thread_crash(args):
        if RECORDER.enabled and args.exc_type is not SystemExit:
            flight_dump("crash", error=repr(args.exc_value),
                        error_type=args.exc_type.__name__,
                        thread=getattr(args.thread, "name", None))
        prev_thread_exc(args)

    threading.excepthook = on_thread_crash
    atexit.register(flush)
