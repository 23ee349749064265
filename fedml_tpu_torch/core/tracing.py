"""Tracing: structured timers and benchmark log lines
(``fedml_tpu.core.tracing``).

The reference's wall-clock timers around aggregation and its grep-able
"--Benchmark" lines (``log_communication_tick/tock``,
``log_round_start/end``) feed a structured in-memory trace, exportable to
JSON. With ``use_torch_profiler`` every span is also a
``torch.profiler.record_function`` range, so the spans appear inside a
``torch.profiler`` capture next to the device's kernels (the JAX
package's ``jax.profiler.TraceAnnotation``).

Every event carries a wall-clock ``ts`` (epoch seconds at its start), the
emitting ``rank`` and the thread id: the coordinates a merge of per-rank
dumps into one Chrome-trace timeline needs (pid = rank, tid = thread).
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import threading
import time
from typing import Any

import torch


#: the span ring's capacity
MAX_EVENTS = 200_000


class Tracer:
    """Span collector with the reference's tick/tock vocabulary.

    ``events`` is a bounded ring (:data:`MAX_EVENTS`): a run of thousands
    of rounds with tracing on keeps the most recent window instead of
    growing without bound; ``dropped`` counts evictions and is recorded
    in :meth:`dump`.
    """

    def __init__(self, use_torch_profiler: bool = False,
                 rank: int | None = None):
        self.events: collections.deque[dict[str, Any]] = collections.deque(
            maxlen=MAX_EVENTS)
        self.dropped = 0
        self._open: dict[str, tuple[float, float]] = {}
        self._torch = use_torch_profiler
        self.rank = rank
        self._lock = threading.Lock()

    def _emit(self, ev: dict[str, Any]) -> None:
        with self._lock:
            if len(self.events) == self.events.maxlen:
                self.dropped += 1
            self.events.append(ev)

    def _base(self, kind: str, ts: float, seconds: float,
              attrs: dict) -> dict[str, Any]:
        ev = {
            "kind": kind,
            "ts": ts,
            "seconds": seconds,
            "rank": self.rank,
            "tid": threading.get_ident() & 0xFFFFFFFF,
        }
        ev.update(attrs)  # attrs may override rank (shared-process worlds)
        return ev

    # -- the reference's API (communication/utils.py:4-18) -----------------
    def log_communication_tick(self, sender, receiver, tag: str = ""):
        self._open[f"comm:{sender}->{receiver}:{tag}"] = (
            time.perf_counter(), time.time())
        logging.debug("--Benchmark tick comm %s->%s %s", sender, receiver, tag)

    def log_communication_tock(self, sender, receiver, tag: str = ""):
        key = f"comm:{sender}->{receiver}:{tag}"
        t0 = self._open.pop(key, None)
        if t0 is not None:
            dt = time.perf_counter() - t0[0]
            self._emit(self._base(
                "comm", t0[1], dt,
                {"sender": sender, "receiver": receiver, "tag": tag}))
            logging.debug("--Benchmark tock comm %s %fs", key, dt)

    def log_round_start(self, round_idx: int):
        self._open[f"round:{round_idx}"] = (time.perf_counter(), time.time())

    def log_round_end(self, round_idx: int):
        t0 = self._open.pop(f"round:{round_idx}", None)
        if t0 is not None:
            self._emit(self._base("round", t0[1], time.perf_counter() - t0[0],
                                  {"round": round_idx}))

    # -- generic spans -----------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        ctx = (torch.profiler.record_function(name) if self._torch
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        ts = time.time()
        err: BaseException | None = None
        try:
            with ctx:
                yield
        except BaseException as e:
            # a raising body still leaves its span, tagged with the error
            err = e
            raise
        finally:
            ev = self._base("span", ts, time.perf_counter() - t0,
                            {"name": name, **attrs})
            if err is not None:
                ev["error"] = repr(err)
            self._emit(ev)

    def event(self, name: str, **attrs):
        """An instant event (zero duration): message sends and delivers."""
        self._emit(self._base("event", time.time(), 0.0,
                              {"name": name, **attrs}))

    def dump(self, path: str):
        with self._lock:
            events = list(self.events)
            dropped = self.dropped
        # written whole, then renamed: a crash mid-write never leaves a
        # truncated dump
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump({"rank": self.rank, "dropped": dropped,
                       "events": events}, f, indent=2, default=repr)
        os.replace(tmp, path)
