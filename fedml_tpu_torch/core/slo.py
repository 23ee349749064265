"""Declarative SLOs: windowed objectives over the live registry
(``fedml_tpu.core.slo``, pure Python, copied with its imports changed).

- :class:`SloSpec` is one parsed objective,
  ``SloSpec.parse("perf.round_wall_s:p99<2.0@60s")``: metric, statistic
  (a histogram percentile, mean, max or min; a gauge's ``value``; a
  counter's ``rate``), the healthy relation, the threshold and the
  evaluation window. Specs come from ``--slo`` (repeatable) and
  ``FedConfig.slos``, with a ``scope`` (the run name).
- :class:`SloEngine` evaluates them: on each ``tick()`` (the metrics time
  series' cadence) it snapshots the registry, takes each histogram over
  the window as the difference between the cumulative buckets now and
  those of the ring entry ``window_s`` ago (cumulative counts only grow,
  so the difference is a histogram), and compares the statistic with its
  threshold.

Each spec's state is exported as gauges: ``slo.ok.<slug>`` (1 or 0),
``slo.breach_seconds.<slug>`` (seconds in breach so far) and
``slo.burn_rate.<slug>`` (the share of the trailing window in breach).
Every transition (ok to breach, breach to ok) records one flight event,
never one a tick, and calls the transition listeners (the anatomy plane's
breach profiler). At shutdown the engine writes ``slo_rank<r>.json``.
No specs, no engine and no work.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import re
import time
from typing import Any

from fedml_tpu_torch.core.telemetry import percentiles_from_histogram

_STATS = ("p50", "p95", "p99", "mean", "max", "min", "value", "rate")
_SPEC_RE = re.compile(
    r"^(?P<metric>[A-Za-z_][A-Za-z0-9_.]*)"
    r":(?P<stat>[a-z0-9]+)"
    r"(?P<op>[<>])"
    r"(?P<threshold>[-+0-9.eE]+)"
    r"@(?P<window>[0-9.]+)(?P<unit>s|m|h)$"
)
_UNIT_S = {"s": 1.0, "m": 60.0, "h": 3600.0}


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One parsed ``--slo`` objective. ``op`` is the HEALTHY relation:
    ``perf.round_wall_s:p99<2.0@60s`` is healthy while the windowed
    p99 stays BELOW 2 seconds."""

    metric: str
    stat: str  # p50|p95|p99|mean|max|min (histogram), value, rate
    op: str  # "<" | ">"
    threshold: float
    window_s: float
    scope: str = ""

    def __post_init__(self):
        if self.stat not in _STATS:
            raise ValueError(
                f"--slo statistic must be one of {_STATS}, "
                f"got {self.stat!r}"
            )
        if not math.isfinite(self.threshold):
            raise ValueError(
                f"--slo threshold must be finite, got {self.threshold!r}"
            )
        if not (self.window_s > 0):
            raise ValueError(
                f"--slo window must be positive, got {self.window_s!r}"
            )

    @staticmethod
    def parse(spec: str, scope: str = "") -> "SloSpec":
        """``metric:stat<threshold@window`` — e.g.
        ``perf.round_wall_s:p99<2.0@60s``, ``fleet.perf.round_wall_s:
        p95<1.5@5m``, ``round.quorum_lost_aborts:rate<0.01@10m``."""
        m = _SPEC_RE.match(spec.strip())
        if m is None:
            raise ValueError(
                f"malformed --slo {spec!r}: expected "
                f"'metric:stat<threshold@window' (e.g. "
                f"'perf.round_wall_s:p99<2.0@60s'; stats: "
                f"{', '.join(_STATS)}; window units: s/m/h)"
            )
        try:
            threshold = float(m.group("threshold"))
        except ValueError:
            raise ValueError(
                f"malformed --slo threshold {m.group('threshold')!r} "
                f"in {spec!r}"
            )
        return SloSpec(
            metric=m.group("metric"),
            stat=m.group("stat"),
            op=m.group("op"),
            threshold=threshold,
            window_s=float(m.group("window")) * _UNIT_S[m.group("unit")],
            scope=scope,
        )

    @property
    def slug(self) -> str:
        """Registry-safe identifier for the per-spec burn gauges
        (``slo.ok.<slug>``). The FULL spec participates — two SLOs on
        the same metric/stat with different thresholds or windows
        (a tight and a loose latency objective) must not collide on
        one gauge name."""
        op = "lt" if self.op == "<" else "gt"
        raw = (f"{self.metric}_{self.stat}_{op}_{self.threshold}"
               f"_{self.window_s}s")
        return re.sub(r"[^0-9a-zA-Z_]", "_", raw)

    def describe(self) -> str:
        w = self.window_s
        return f"{self.metric}:{self.stat}{self.op}{self.threshold}@{w}s"


def _hist_delta(cur: dict, base: dict | None) -> dict:
    """Windowed histogram = cumulative now minus cumulative at the
    window's start. Bucket counts are monotone, so the difference is a
    valid histogram; min/max keep the CURRENT cumulative values — they
    only clamp estimates derived from the windowed buckets, and a
    loose clamp degrades an estimate, never corrupts it (windowed
    min/max themselves come from :func:`_bucket_extremes`)."""
    if base is None:
        return cur
    buckets = {
        k: cur.get("buckets", {}).get(k, 0) - v
        for k, v in base.get("buckets", {}).items()
    }
    for k, v in cur.get("buckets", {}).items():
        if k not in buckets:
            buckets[k] = v
    return {
        "count": cur.get("count", 0) - base.get("count", 0),
        "sum": cur.get("sum", 0.0) - base.get("sum", 0.0),
        "min": cur.get("min", float("inf")),
        "max": cur.get("max", float("-inf")),
        "buckets": {k: v for k, v in buckets.items() if v > 0},
    }


def _bucket_extremes(delta: dict) -> tuple[float, float]:
    """Windowed (min, max) estimated from the delta's OCCUPIED
    power-of-two buckets: max is the highest occupied bucket's upper
    bound, min the lowest occupied bucket's lower bound, each clamped
    by the cumulative (all-time) extremes. Bounded by the 2x bucket
    width like every other histogram-derived statistic — the crucial
    property is that both are WINDOWED: a max-based SLO recovers once
    the slow observation ages out, instead of breaching forever on the
    all-time extreme."""
    ks = sorted(
        int(k.split("^", 1)[1]) for k in delta.get("buckets", {})
    )
    if not ks:
        return float("inf"), float("-inf")
    lo = 0.0 if ks[0] <= -20 else 2.0 ** (ks[0] - 1)
    hi = 2.0 ** ks[-1]
    cmin = delta.get("min", float("-inf"))
    cmax = delta.get("max", float("inf"))
    return max(lo, cmin), min(hi, cmax)


@dataclasses.dataclass
class _SpecState:
    breaching: bool = False
    transitions: int = 0
    breach_seconds: float = 0.0
    last_value: float | None = None
    # trailing (t0, t1, breached) tick intervals for the burn rate
    intervals: collections.deque = dataclasses.field(
        default_factory=collections.deque
    )


class SloEngine:
    """Windowed evaluator over a :class:`MetricsRegistry`.

    One engine per process; :func:`telemetry.configure` builds it from
    the ``--slo`` specs and hooks :meth:`tick` into the metrics
    time-series cadence. ``clock`` is injectable so transitions are
    testable without wall sleeps."""

    def __init__(self, specs, registry, recorder=None, clock=None):
        self.specs: list[SloSpec] = list(specs)
        self._registry = registry
        self._recorder = recorder
        self._clock = clock or time.monotonic
        # breach-transition listeners (core/anatomy.py's breach
        # profiler): called as cb(spec, breaching, value) exactly once
        # per transition, right where the flight event records — never
        # once per breached tick
        self._listeners: list = []
        self._max_window = max(
            (s.window_s for s in self.specs), default=0.0
        )
        # shared snapshot ring: (ts, histograms, counters) — every spec
        # reads the same registry, so one ring serves them all
        self._ring: collections.deque = collections.deque()
        self._state = {id(s): _SpecState() for s in self.specs}
        self._last_tick: float | None = None

    def add_transition_listener(self, cb) -> None:
        """Subscribe ``cb(spec, breaching, value)`` to breach
        transitions (idempotent per callable)."""
        if cb not in self._listeners:
            self._listeners.append(cb)

    # -- evaluation --------------------------------------------------------

    def _baseline(self, now: float, window_s: float):
        """Newest ring entry at least ``window_s`` old, as
        ``(ts, hists, counters)`` — the timestamp matters: with a tick
        interval coarser than the window the delta actually spans
        ``now - ts`` (> window), and rate-style statistics must
        normalize by the REAL covered span, not the nominal window.
        None while the run is younger than the window — the delta then
        falls back to the full cumulative state, which is exactly the
        window's content."""
        best = None
        for entry in self._ring:
            if now - entry[0] >= window_s:
                best = entry
            else:
                break
        return best

    def _value(self, spec: SloSpec, snap: dict,
               now: float) -> float | None:
        base = self._baseline(now, spec.window_s)
        if spec.stat == "value":
            g = snap["gauges"].get(spec.metric)
            if g is not None:
                return float(g)
            c = snap["counters"].get(spec.metric)
            return None if c is None else float(c)
        if spec.stat == "rate":
            cur = snap["counters"].get(spec.metric)
            if cur is None:
                return None
            prev = 0.0
            span = spec.window_s
            if base is not None:
                prev = base[2].get(spec.metric, 0.0)
                # the delta spans back to the BASELINE's timestamp,
                # which with a coarse tick interval is older than the
                # nominal window — dividing by window_s there would
                # overestimate the rate by interval/window
                span = max(now - base[0], spec.window_s)
            elif self._ring:
                span = max(now - self._ring[0][0], spec.window_s)
            return (float(cur) - float(prev)) / span
        h = snap["histograms"].get(spec.metric)
        if h is None:
            return None
        delta = _hist_delta(
            h, None if base is None else base[1].get(spec.metric)
        )
        count = delta.get("count", 0)
        if count <= 0:
            return None  # nothing observed inside the window
        if spec.stat == "mean":
            return float(delta["sum"]) / count
        if spec.stat in ("max", "min"):
            w_min, w_max = _bucket_extremes(delta)
            return float(w_max if spec.stat == "max" else w_min)
        q = float(spec.stat[1:]) / 100.0
        out = percentiles_from_histogram(delta, qs=(q,))
        return out.get(f"p{round(q * 100):d}")

    def tick(self, now: float | None = None) -> None:
        """One evaluation pass: compute each spec's windowed statistic,
        update its burn state, export the ``slo.*`` gauges, and record
        ONE flight event per breach transition. Appends the current
        snapshot to the ring afterwards, so the window never includes
        the tick's own baseline."""
        if not self.specs:
            return
        now = self._clock() if now is None else now
        snap = self._registry.snapshot()
        last = self._last_tick
        for spec in self.specs:
            st = self._state[id(spec)]
            value = self._value(spec, snap, now)
            if value is None:
                # no signal inside the window: keep the previous state
                # (an idle server is not breaching its latency SLO)
                breaching = st.breaching
            elif spec.op == "<":
                breaching = not (value < spec.threshold)
            else:
                breaching = not (value > spec.threshold)
            st.last_value = value if value is not None else st.last_value
            if breaching != st.breaching:
                st.breaching = breaching
                st.transitions += 1
                if self._recorder is not None:
                    self._recorder.record(
                        "slo_breach" if breaching else "slo_recovered",
                        slo=spec.describe(), scope=spec.scope,
                        value=value, threshold=spec.threshold,
                    )
                for cb in self._listeners:
                    try:
                        cb(spec, breaching, value)
                    except Exception:
                        pass  # a listener must not kill the evaluator
            if last is not None:
                # the just-elapsed interval is attributed to the state
                # this tick DETECTED (the crossing happened somewhere
                # inside it): a breach starts burning — and a recovery
                # stops burning — at the tick that observed it, not one
                # tick late
                st.intervals.append((last, now, st.breaching))
                if st.breaching:
                    st.breach_seconds += now - last
                while (st.intervals
                       and now - st.intervals[0][1] > spec.window_s):
                    st.intervals.popleft()
            burn_w = min(spec.window_s, (now - st.intervals[0][0])
                         if st.intervals else spec.window_s)
            burn = 0.0
            if burn_w > 0 and st.intervals:
                breached_s = sum(
                    min(t1, now) - max(t0, now - spec.window_s)
                    for t0, t1, b in st.intervals
                    if b and t1 > now - spec.window_s
                )
                burn = min(1.0, breached_s / burn_w)
            m = self._registry
            m.gauge(f"slo.ok.{spec.slug}", 0.0 if st.breaching else 1.0)
            m.gauge(f"slo.breach_seconds.{spec.slug}", st.breach_seconds)
            m.gauge(f"slo.burn_rate.{spec.slug}", burn)
        self._last_tick = now
        self._ring.append((now, snap["histograms"], snap["counters"]))
        while (len(self._ring) > 2
               and now - self._ring[1][0] >= self._max_window):
            self._ring.popleft()

    # -- verdicts ----------------------------------------------------------

    def verdicts(self) -> list[dict[str, Any]]:
        out = []
        for spec in self.specs:
            st = self._state[id(spec)]
            out.append({
                "slo": spec.describe(),
                "metric": spec.metric,
                "stat": spec.stat,
                "op": spec.op,
                "threshold": spec.threshold,
                "window_s": spec.window_s,
                "scope": spec.scope,
                "ok": not st.breaching,
                "transitions": st.transitions,
                "breach_seconds": round(st.breach_seconds, 6),
                "last_value": st.last_value,
            })
        return out

    def write_verdicts(self, path: str, rank: int = 0) -> None:
        """The shutdown artifact: one final evaluation, then the
        per-spec verdicts as ``slo_rank<r>.json`` (atomic — a crash
        mid-write must not leave a torn verdict)."""
        self.tick()
        data = {
            "rank": rank,
            "ts": time.time(),
            "slos": self.verdicts(),
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=2, default=repr)
        os.replace(tmp, path)


def parse_specs(specs, scope: str = "") -> list[SloSpec]:
    """Parse a sequence of ``--slo`` strings, deduplicating exact
    repeats (a config-file spec repeated on the CLI must not double its
    gauges)."""
    seen: dict[str, SloSpec] = {}
    for s in specs:
        parsed = SloSpec.parse(s, scope=scope)
        seen.setdefault(parsed.describe(), parsed)
    return list(seen.values())
