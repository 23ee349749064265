"""Round anatomy: each round's wall time by phase, the ``/tracez`` ring
and breach-triggered profiles (``fedml_tpu.core.anatomy``).

- :class:`RoundAnatomy` attributes each round's wall time to the fixed
  phases :data:`PHASES`, timed at the points where a round loop already
  waits (the return of the enqueueing, the host's read of the round's
  metrics, the evaluation; no new ``torch.cuda.synchronize``). The rest
  of the wall is itself a phase, ``host_gap``, so the phases always add
  up to the wall. It writes the ``perf.phase.<name>_s`` histograms and
  the ``perf.phase.dominant`` gauge and keeps the last rounds' entries,
  served as ``/tracez`` by the listener (``core/export.py``).
- :class:`BreachProfiler`: a one-shot ``torch.profiler`` window under
  ``<telemetry_dir>/profiles/breach_<n>_<reason>/``, fired by an SLO's
  breach transition or the memory plane's ``mem_headroom`` crossing, with
  a capture cap and a cooldown. The JAX package starts and stops its
  window from a timer thread; a ``torch.profiler`` session records the
  operators of the thread that starts it, and one session at a time
  lives in a process. So here a trigger (from any thread) arms a window,
  and the round loop opens and closes it at round boundaries on its own
  thread (:func:`poll_breach`): it opens once the round profiler has no
  window left to take, and closes at the first boundary ``window_s``
  after it opened, or at the end of the loop.
- :func:`fetch_corrected_time`: the per-call device time of a callable
  timed in a loop, less the cost of reading one scalar back.

The JAX module's straggler attribution and critical-path events belong
to the deploy server and are ROADMAP Queue A item 14b.

Off is the default: :data:`ANATOMY` starts disabled (every call site
checks one attribute, and the round's results are the same bit for bit)
and no breach profiler is armed until :func:`configure`.
"""

from __future__ import annotations

import collections
import json
import os
import re
import threading
import time
from typing import Any

import torch

from fedml_tpu_torch.core import perf, telemetry

#: The phases, as the JAX package names them. A simulated round fills
#: ``local`` (the wait for the round's device work) and ``eval``;
#: ``host_gap`` is always the rest.
PHASES = (
    "sample",
    "h2d",
    "local",
    "defense_agg",
    "server_update",
    "wire",
    "eval",
    "checkpoint",
    "host_gap",
)

#: the ``/tracez`` ring's depth: the last rounds' entries
RING_CAPACITY = 64

#: seconds a finished breach window keeps the next one away
DEFAULT_COOLDOWN_S = 30.0


def _check_phase(name: str) -> None:
    if name not in PHASES:
        raise ValueError(f"unknown anatomy phase {name!r}; the phases are "
                         f"fixed: {PHASES}")


class RoundAnatomy:
    """Per-round phase attribution and the ``/tracez`` ring (one per
    process, :data:`ANATOMY`). Every method returns at once while
    ``enabled`` is False; the loops check ``enabled`` themselves before
    reading a clock."""

    def __init__(self, ring_capacity: int = RING_CAPACITY):
        self.enabled = False
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=ring_capacity)
        self._open: dict[str, Any] | None = None
        self._rounds = 0

    def begin_round(self, round_idx: int, path: str = "stacked",
                    rounds: int = 1) -> None:
        """Open a round's window. ``path`` names the round's body
        (``stacked``, ``bulk``, ``fused``, ``personal``, or a GAN
        simulation's own); ``rounds`` > 1 is a fused block of that many
        rounds, whose histogram observations are divided by it."""
        if not self.enabled:
            return
        with self._lock:
            self._open = {"round": int(round_idx), "path": path,
                          "rounds": max(1, int(rounds)),
                          "t0": time.perf_counter(),
                          "phases": {}}

    def phase(self, name: str, seconds: float) -> None:
        """Add ``seconds`` to ``name`` in the open round."""
        if not self.enabled:
            return
        _check_phase(name)
        with self._lock:
            if self._open is None:
                return
            p = self._open["phases"]
            p[name] = p.get(name, 0.0) + max(0.0, float(seconds))

    def end_round(self, wall_s: float | None = None) -> dict | None:
        """Close the window: ``host_gap`` is the wall less the phases (at
        least 0), the ``perf.phase.<name>_s`` histograms (per round for a
        block) and the ``perf.phase.dominant`` gauge are written, and the
        entry goes to the ring. Returns the entry."""
        if not self.enabled:
            return None
        with self._lock:
            ent = self._open
            self._open = None
            if ent is None:
                return None
            wall = (time.perf_counter() - ent["t0"] if wall_s is None
                    else float(wall_s))
            phases = ent["phases"]
            phases["host_gap"] = max(0.0, wall - sum(phases.values()))
            k = ent["rounds"]
            dominant = max(phases, key=phases.get) if phases else None
            entry = {"round": ent["round"], "path": ent["path"], "rounds": k,
                     "wall_s": wall,
                     "phases": {n: phases[n] for n in PHASES if n in phases},
                     "dominant": dominant, "ts": time.time()}
            self._ring.append(entry)
            self._rounds += 1
        m = telemetry.METRICS
        for name, sec in phases.items():
            m.observe(f"perf.phase.{name}_s", sec / k)
        if dominant is not None:
            m.gauge("perf.phase.dominant", float(PHASES.index(dominant)))
        return entry

    def amend_last(self, name: str, seconds: float) -> None:
        """Add ``seconds`` of ``name`` to the last closed entry (a fused
        block's entry closes at its flush; its boundary evaluation comes
        after). The entry's wall grows by as much, so it stays the sum of
        its phases and ``host_gap`` is unchanged."""
        if not self.enabled:
            return
        _check_phase(name)
        sec = max(0.0, float(seconds))
        with self._lock:
            if not self._ring:
                return
            e = self._ring[-1]
            e["phases"][name] = e["phases"].get(name, 0.0) + sec
            e["wall_s"] += sec
            e["dominant"] = max(e["phases"], key=e["phases"].get)
        telemetry.METRICS.observe(f"perf.phase.{name}_s", sec)

    def tracez(self, rank: int = 0) -> dict:
        """The ``/tracez`` payload: the last closed rounds' entries, the
        newest last."""
        with self._lock:
            return {"rank": rank, "phases": list(PHASES),
                    "capacity": self._ring.maxlen, "rounds": self._rounds,
                    "entries": [dict(e) for e in self._ring]}

    def reset(self) -> None:
        with self._lock:
            self.enabled = False
            self._ring.clear()
            self._open = None
            self._rounds = 0


class BreachProfiler:
    """One-shot ``torch.profiler`` windows fired on degradation
    (``--profile_on_breach``, with ``--slo`` or ``--mem_headroom_warn`` as
    its source).

    :meth:`on_breach` (an SLO breach transition, the ``mem_headroom``
    crossing; from any thread) arms one window under
    ``<out_dir>/breach_<n>_<reason>/`` with a ``breach.json`` manifest,
    within the ``max_captures`` cap and a ``cooldown_s`` gap; a trigger
    refused counts ``profile.skipped`` and records
    ``breach_profile_skipped``. The round loop's :meth:`poll` opens the
    armed window (``breach_profile``: the breach and the artifact's path)
    once no round window is left to take, and closes it at the first
    boundary ``window_s`` later (``breach_profile_done``) or at the
    loop's end. A profiler that fails to start or stop counts
    ``profile.failed``, records ``breach_profile_failed`` and takes no
    more captures. ``clock`` is injectable."""

    def __init__(self, out_dir: str, window_s: float = 5.0,
                 max_captures: int = 3,
                 cooldown_s: float = DEFAULT_COOLDOWN_S,
                 clock=time.monotonic, device="cpu"):
        if not window_s > 0:
            raise ValueError(
                f"--profile_window_s must be > 0, got {window_s!r}")
        if max_captures < 1:
            raise ValueError(f"--profile_max_captures must be >= 1, got "
                             f"{max_captures!r}")
        self.out_dir = out_dir
        self.window_s = float(window_s)
        self.max_captures = int(max_captures)
        self.cooldown_s = float(cooldown_s)
        self.device = torch.device(device)
        self._clock = clock
        self._lock = threading.Lock()
        self._captures = 0
        self._armed: tuple[str, str, dict] | None = None
        self._open: tuple[str, Any, float] | None = None
        self._last_end: float | None = None
        self._broken = False

    @property
    def active(self) -> bool:
        return self._armed is not None or self._open is not None

    def _skip(self, reason: str, why: str) -> None:
        telemetry.METRICS.inc("profile.skipped")
        telemetry.RECORDER.record("breach_profile_skipped", reason=reason,
                                  why=why)

    def _fail(self, err: BaseException, **fields) -> None:
        self._broken = True
        telemetry.METRICS.inc("profile.failed")
        telemetry.METRICS.gauge("profile.active", 0.0)
        telemetry.RECORDER.record("breach_profile_failed", error=repr(err),
                                  **fields)

    def on_breach(self, reason: str, **attrs) -> str | None:
        """Arm one window for this breach; returns its directory (None
        for a skip)."""
        with self._lock:
            if self._broken:
                self._skip(reason, "profiler broken")
                return None
            if self.active:
                self._skip(reason, "capture window already open")
                return None
            if self._captures >= self.max_captures:
                self._skip(reason,
                           f"capture cap spent ({self.max_captures})")
                return None
            now = self._clock()
            if (self._last_end is not None
                    and now - self._last_end < self.cooldown_s):
                self._skip(reason, f"cooldown ({self.cooldown_s}s since "
                                   "last window)")
                return None
            self._captures += 1
            n = self._captures
            slug = re.sub(r"[^0-9a-zA-Z_.-]+", "_", reason)[:80]
            path = os.path.join(self.out_dir, f"breach_{n}_{slug}")
            os.makedirs(path, exist_ok=True)
            with open(os.path.join(path, "breach.json"), "w") as f:
                json.dump({"reason": reason, "capture": n,
                           "window_s": self.window_s, "ts": time.time(),
                           **{k: v if isinstance(v, (int, float, str, bool,
                                                     type(None)))
                              else repr(v) for k, v in attrs.items()}},
                          f, indent=2)
            self._armed = (path, reason, attrs)
            telemetry.METRICS.inc("profile.captures")
            return path

    def poll(self, round_profiler=None, final: bool = False) -> None:
        """At a round boundary, on the round loop's thread: close the open
        window if ``window_s`` has passed (or ``final``), else open the
        armed one if ``round_profiler`` (a
        :class:`~fedml_tpu_torch.core.perf.RoundProfiler`, or None) has no
        window left to take."""
        with self._lock:
            if self._open is not None:
                path, prof, t0 = self._open
                if final or self._clock() - t0 >= self.window_s:
                    self._open = None
                    self._last_end = self._clock()
                    try:
                        cost = perf.stop_capture(prof, path,
                                                 telemetry.rank_tag())
                    except Exception as err:
                        self._fail(err, path=path)
                        return
                    telemetry.METRICS.gauge("profile.active", 0.0)
                    telemetry.RECORDER.record("breach_profile_done",
                                              path=path, **cost)
                return
            if self._armed is None or final:
                return
            if round_profiler is not None and (round_profiler.wants_capture
                                               or round_profiler.active):
                return
            path, reason, attrs = self._armed
            self._armed = None
            try:
                prof = perf.start_capture(self.device)
            except Exception as err:
                self._fail(err, reason=reason)
                return
            self._open = (path, prof, self._clock())
            telemetry.METRICS.gauge("profile.active", 1.0)
            telemetry.RECORDER.record("breach_profile", reason=reason,
                                      path=path, window_s=self.window_s,
                                      capture=self._captures, **attrs)

    def close(self) -> None:
        """Stop an open window now (the shutdown path) and drop an armed
        one."""
        self.poll(final=True)
        with self._lock:
            self._armed = None


def fetch_corrected_time(fn, *args, n: int = 30, warmup: int = 2) -> float:
    """Per-call seconds of ``fn(*args)`` on its device: ``warmup`` calls,
    then the cost of reading one scalar back (a sum of the first output
    tensor and ``.item()``, the least of 3), then ``n`` calls closed by
    one such read; the read's cost is taken off, so the figure is the
    device's execution, not the host's turnaround."""

    def first(out):
        if isinstance(out, torch.Tensor):
            return out
        if isinstance(out, dict):
            out = list(out.values())
        return first(out[0])

    out = None
    for _ in range(max(1, warmup)):
        out = fn(*args)
    leaf = first(out)
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
    leaf.sum().item()
    fetches = []
    for _ in range(3):
        t0 = time.perf_counter()
        leaf.sum().item()
        fetches.append(time.perf_counter() - t0)
    fetch = min(fetches)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    first(out).sum().item()
    wall = time.perf_counter() - t0
    return max(wall - fetch, wall / 2) / n


#: The process's anatomy plane, off until :func:`configure`.
ANATOMY = RoundAnatomy()
_BREACH: BreachProfiler | None = None


def breach_profiler() -> BreachProfiler | None:
    return _BREACH


def poll_breach(round_profiler=None, final: bool = False) -> None:
    """The round loops' boundary hook (one global check while no breach
    profiler is armed)."""
    if _BREACH is not None:
        _BREACH.poll(round_profiler, final=final)


def notify_mem_headroom(**fields) -> None:
    """The memory plane's ``mem_headroom`` crossing: the breach
    profiler's second trigger."""
    if _BREACH is not None:
        _BREACH.on_breach("mem_headroom", **fields)


def _on_slo_transition(spec, breaching: bool, value) -> None:
    if breaching and _BREACH is not None:
        _BREACH.on_breach(f"slo_{spec.slug}", slo=spec.describe(),
                          scope=spec.scope, value=value)


def configure(anatomy: bool = False, profile_on_breach: bool = False,
              profile_window_s: float = 5.0, profile_max_captures: int = 3,
              device="cpu") -> None:
    """Arm the anatomy plane for this process (idempotent; after
    :func:`telemetry.configure`, whose directory and SLO engine the breach
    profiler uses). ``anatomy=True`` switches the phase attribution and
    the ``/tracez`` ring on; ``profile_on_breach=True`` arms the
    :class:`BreachProfiler` under ``<telemetry_dir>/profiles/`` on
    ``device`` and subscribes it to the SLO engine's transitions."""
    global _BREACH
    if anatomy:
        ANATOMY.enabled = True
    if profile_on_breach and _BREACH is None:
        tdir = telemetry.artifact_dir()
        if tdir is None:
            raise ValueError("--profile_on_breach needs a telemetry dir for "
                             "its artifacts (configure telemetry first)")
        _BREACH = BreachProfiler(
            os.path.join(tdir, "profiles"), window_s=profile_window_s,
            max_captures=profile_max_captures, device=device)
        eng = telemetry.slo_engine()
        if eng is not None:
            eng.add_transition_listener(_on_slo_transition)


def reset() -> None:
    """Back to off (``telemetry.shutdown()`` calls it)."""
    global _BREACH
    if _BREACH is not None:
        _BREACH.close()
        _BREACH = None
    ANATOMY.reset()
