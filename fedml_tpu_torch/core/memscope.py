"""Memory observability: the programs' accounting and the live device
memory monitor (``fedml_tpu.core.memscope``).

- **Programs** (:func:`note_program`). In the JAX package a program is an
  XLA compile, and it records the compile's ``memory_analysis()``. Here a
  program is a CUDA graph capture (``algorithms/graphs.py``
  ``GraphedStep``, family ``step``) or a build in a
  :class:`~fedml_tpu_torch.core.elastic.CompiledRoundCache` (a lane
  count's step program, family ``sim_round``, ``sim_bulk`` or the GAN
  sims' own). A record holds what a capture measures: the static
  inputs' bytes (``argument_bytes``), the carry's bytes (``output_bytes``
  and ``alias_bytes``: the graph writes its carry in place), the growth
  of ``torch.cuda.memory_reserved`` across the capture (``temp_bytes``)
  and the build's wall time (the ``mem.compile_s.<family>`` histogram).
  A field it cannot measure (generated code) is left out, never written
  as 0. The records are ``mem.program.<slug>.*`` gauges, keyed by a
  stable slug ``<family>.<key parts>``.
- **Live device memory** (:class:`DeviceMemoryMonitor`): at each round
  boundary (``algorithms/fedavg.py`` ``consume_round_counters``) the
  simulation's device is read into ``mem.bytes_in_use``,
  ``mem.peak_bytes``, ``mem.high_water_bytes``, ``mem.used_frac`` and
  ``mem.headroom_frac``. On a card the reading is
  ``torch.cuda.memory_stats`` (allocated bytes now and at peak, the
  reserved bytes), marked ``source: "cuda"``, against
  ``get_device_properties().total_memory``; only a simulation on the CPU
  reads the process's RSS, marked ``source: "rss"``, against the host's
  memory. The first sample past ``headroom_warn`` (``--mem_headroom_warn``)
  leaves one ``mem_headroom`` flight event a run and fires the anatomy
  plane's breach profiler.

The JAX module's donation audit has no runtime counterpart: torch has no
buffer donation, and a graph writes its carry in place by construction
(ROADMAP Queue A item 17, the donation analogs).

Everything waits on ``telemetry.METRICS.enabled``: off, a sample is one
attribute check. The ``mem.*`` gauges ride ``/metrics``, and ``/statusz``
gains a ``memory`` section.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any

import torch

from fedml_tpu_torch.core import telemetry
from fedml_tpu_torch.core import tree as T

#: the program table's cap; past it new programs count
#: ``mem.program_overflow``
MAX_PROGRAMS = 64

#: the byte fields a program record may carry
FIELDS = ("temp_bytes", "argument_bytes", "output_bytes", "alias_bytes")

_LOCK = threading.Lock()
_PROGRAMS: dict[str, dict[str, Any]] = {}


def program_slug(family: str, key) -> str:
    """The dotted slug of one program: its family and its key's parts."""
    parts = key if isinstance(key, tuple) else (key,)
    return ".".join([str(family)] + [str(p) for p in parts])


class _MemoryStatus:
    """The ``/statusz`` ``memory`` section (the listener keeps a weak
    reference to this one instance)."""

    def status(self) -> dict[str, Any]:
        with _LOCK:
            programs = {k: dict(v) for k, v in _PROGRAMS.items()}
        return {
            "source": MONITOR.last_source,
            "devices": MONITOR.last_readings,
            "high_water_bytes": MONITOR.high_water,
            "headroom_warn": MONITOR.headroom_warn,
            "programs": programs,
        }


_STATUS = _MemoryStatus()


def _register_status() -> None:
    """(Re-)register the ``memory`` section: the listener's sources are
    cleared at shutdown, so a flag would go stale."""
    from fedml_tpu_torch.core import export

    export.register_status_source("memory", _STATUS)


def note_program(family: str, key, compile_s: float | None = None,
                 **byte_fields: int) -> dict | None:
    """Record one program just built: ``byte_fields`` (any of
    :data:`FIELDS`, each measured) as ``mem.program.<slug>.<field>``
    gauges and ``compile_s``, its build's wall time, into the
    ``mem.compile_s.<family>`` histogram. Returns the record (None while
    the metrics plane is off)."""
    m = telemetry.METRICS
    if not m.enabled:
        return None
    unknown = set(byte_fields) - set(FIELDS)
    if unknown:
        raise ValueError(f"unknown program fields {sorted(unknown)}; "
                         f"the fields are {FIELDS}")
    slug = program_slug(family, key)
    rec: dict[str, Any] = {"family": family, "key": repr(key),
                           "ts": time.time(),
                           **{k: int(v) for k, v in byte_fields.items()}}
    if compile_s is not None:
        rec["compile_s"] = float(compile_s)
        m.observe(f"mem.compile_s.{family}", float(compile_s))
    m.inc("mem.compiles")
    with _LOCK:
        overflow = slug not in _PROGRAMS and len(_PROGRAMS) >= MAX_PROGRAMS
        if not overflow:
            _PROGRAMS[slug] = rec
    if overflow:
        m.inc("mem.program_overflow")
        return rec
    for name in FIELDS:
        if name in rec:
            m.gauge(f"mem.program.{slug}.{name}", rec[name])
    _register_status()
    telemetry.RECORDER.record(
        "mem_program", program=slug,
        **{f"{k[:-6]}_mb": round(rec[k] / 1e6, 3) for k in FIELDS
           if k in rec},
        compile_s=round(compile_s, 3) if compile_s is not None else None)
    return rec


def tree_bytes(tree) -> int:
    """The bytes of every tensor in a tree (dicts, tuples, lists)."""
    return sum(x.numel() * x.element_size() for x in T.tree_leaves(tree))


# ---------------------------------------------------------------------------
# live device memory
# ---------------------------------------------------------------------------


def read_device_memory(device: torch.device | str
                       ) -> tuple[str, list[dict]]:
    """One reading of ``device``, with no registry write: ``("cuda",
    [...])`` from ``torch.cuda.memory_stats`` on a card, ``("rss", [...])``
    from ``/proc/self/statm`` against the host's memory on the CPU. Each
    reading has ``bytes_in_use``, ``peak_bytes`` (None without an
    allocator peak) and ``capacity_bytes``."""
    device = torch.device(device)
    if device.type == "cuda":
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        stats = torch.cuda.memory_stats(index)
        return "cuda", [{
            "device": f"d{index}",
            "kind": torch.cuda.get_device_name(index),
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes": int(stats.get("allocated_bytes.all.peak", 0)),
            "reserved_bytes": int(stats.get("reserved_bytes.all.current",
                                            0)),
            "capacity_bytes": int(
                torch.cuda.get_device_properties(index).total_memory),
        }]
    with open("/proc/self/statm") as f:
        rss_pages = int(f.read().split()[1])
    page = os.sysconf("SC_PAGE_SIZE")
    return "rss", [{
        "device": "rss",
        "kind": "host_rss",
        "bytes_in_use": rss_pages * page,
        "peak_bytes": None,
        "capacity_bytes": os.sysconf("SC_PHYS_PAGES") * page,
    }]


class DeviceMemoryMonitor:
    """The round-boundary sampler of one device (:attr:`device`, set by
    the simulation it serves; the CPU until then).

    ``sample()`` writes the per-device ``mem.bytes_in_use.<d>`` and
    ``mem.peak_bytes.<d>`` gauges and the aggregates ``mem.bytes_in_use``,
    ``mem.peak_bytes``, ``mem.high_water_bytes`` (the run's high-water
    mark), ``mem.used_frac`` and ``mem.headroom_frac`` (against the
    capacity) and ``mem.source_rss`` (1 on the CPU's RSS). The first
    sample whose used share reaches ``headroom_warn`` leaves one
    ``mem_headroom`` flight event for the run. Off (``METRICS.enabled``
    False) it is one attribute check."""

    def __init__(self, headroom_warn: float = 0.9):
        self.headroom_warn = float(headroom_warn)
        self.device = torch.device("cpu")
        self.high_water = 0
        self.last_source = "none"
        self.last_readings: list[dict] = []
        self._flagged = False
        self._peak_seen: dict[str, int] = {}

    def attach(self, device, headroom_warn: float) -> None:
        """Serve a simulation on ``device`` with its threshold."""
        self.device = torch.device(device)
        self.headroom_warn = float(headroom_warn)

    def reset(self) -> None:
        self.headroom_warn = 0.9
        self.device = torch.device("cpu")
        self.high_water = 0
        self.last_source = "none"
        self.last_readings = []
        self._flagged = False
        self._peak_seen.clear()

    def sample(self, tag: str | None = None) -> dict | None:
        m = telemetry.METRICS
        if not m.enabled:
            return None
        source, readings = read_device_memory(self.device)
        total = 0
        peak_max = 0
        worst_frac = 0.0
        resolved: list[dict] = []
        for r in readings:
            label = r["device"]
            used = r["bytes_in_use"]
            total += used
            # the allocator's peak where the source has one, else the
            # run's largest sample (RSS)
            peak = r["peak_bytes"]
            if peak is None:
                peak = max(self._peak_seen.get(label, 0), used)
            self._peak_seen[label] = peak
            resolved.append(dict(r, peak_bytes=peak))
            peak_max = max(peak_max, peak)
            m.gauge_labeled("mem.bytes_in_use", label, used)
            m.gauge_labeled("mem.peak_bytes", label, peak)
            if r["capacity_bytes"]:
                worst_frac = max(worst_frac, used / r["capacity_bytes"])
        self.high_water = max(self.high_water, total)
        m.gauge("mem.bytes_in_use", total)
        m.gauge("mem.peak_bytes", peak_max)
        m.gauge("mem.high_water_bytes", self.high_water)
        m.gauge("mem.source_rss", 1.0 if source == "rss" else 0.0)
        if worst_frac:
            m.gauge("mem.used_frac", worst_frac)
            m.gauge("mem.headroom_frac", max(0.0, 1.0 - worst_frac))
        summary = {"source": source, "bytes_in_use": total,
                   "peak_bytes": peak_max, "high_water_bytes": self.high_water,
                   "used_frac": worst_frac, "readings": resolved}
        self.last_source = source
        self.last_readings = resolved
        if worst_frac >= self.headroom_warn and not self._flagged:
            self._flagged = True
            telemetry.RECORDER.record(
                "mem_headroom", source=source, tag=tag,
                used_frac=round(worst_frac, 4),
                threshold=self.headroom_warn, bytes_in_use=total,
                note="device memory crossed the headroom threshold: the "
                     "next cohort or bucket growth may run out")
            # the crossing is the breach profiler's second trigger
            # (core/anatomy.py), if that plane was ever imported
            an = sys.modules.get("fedml_tpu_torch.core.anatomy")
            if an is not None:
                an.notify_mem_headroom(source=source,
                                       used_frac=round(worst_frac, 4),
                                       threshold=self.headroom_warn)
        _register_status()
        return summary


#: The process's monitor: the round loops sample it, the simulations
#: attach their device and ``--mem_headroom_warn``.
MONITOR = DeviceMemoryMonitor()


def reset() -> None:
    """Back to the pristine state (``telemetry.shutdown()`` calls it)."""
    with _LOCK:
        _PROGRAMS.clear()
    MONITOR.reset()
