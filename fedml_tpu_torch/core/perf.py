"""Performance observability: device-time breakdowns of ``torch.profiler``
captures, the MFU gauge and the round-cost model (``fedml_tpu.core.perf``).

- :func:`useful_round_cost`: the FLOPs of the useful work of one FedAvg
  round, the one definition of MFU that the live ``perf.mfu`` gauge uses
  (and that a benchmark's share of the whole step adopts). One training
  step's FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode``
  over the port's own local step on the ``meta`` device, with a
  convolution formula that counts only the taps that land inside the
  input (XLA's count, which the JAX package's ``cost_analysis`` gives):
  torch's own formula counts every tap of the window, padding included,
  up to 15% more on a 5x5 SAME convolution.
- :class:`RoundProfiler`: ``torch.profiler`` windows around the first K
  rounds (``FedConfig.profile_rounds``), one window a round (a fused
  block under ``fuse_rounds``), each written as a Chrome trace under
  ``<telemetry_dir>/torch_profile/round<k>/`` with a ``capture.json``
  manifest and parsed into a device-time breakdown (compute, collective,
  host-blocked, idle); the breakdowns go to ``perf_<tag>.json``.
- :class:`PerfMonitor`: the ``perf.round_wall_s`` histogram, the
  ``perf.rounds_per_s``, ``perf.delivered_flops_per_s`` and ``perf.mfu``
  gauges, and the dispatch-bound detector (``mfu < mfu_floor``).
- :func:`load_trace_events` and :func:`device_time_breakdown`: the
  trace's events normalized to the JAX package's event dicts, and the
  breakdown as a pure function over them.

Only one ``torch.profiler`` session can be live in a process; a round
window and a breach window (``core/anatomy.py``) never overlap: a breach
capture waits until the round windows are done.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import re
import time
from typing import Any

import numpy as np
import torch

from fedml_tpu_torch.core import telemetry

# ---------------------------------------------------------------------------
# the cards' peaks and the round-cost model
# ---------------------------------------------------------------------------

# (bf16 dense peak FLOP/s, memory bandwidth B/s, memory capacity bytes) by
# torch.cuda.get_device_name(). NVIDIA H100 SXM5 datasheet: 989 TFLOP/s
# bf16 dense (1,979 with sparsity), 3.35 TB/s HBM3, 80 GB. The MFU's
# denominator is the bf16 peak whatever the compute type, as in the JAX
# package; an unknown card gets no MFU gauge.
PEAKS: dict[str, tuple[float, float, float]] = {
    "NVIDIA H100 80GB HBM3": (989e12, 3.35e12, 80e9),
}


def device_peak_flops(kind: str) -> float | None:
    """The bf16 dense peak of a card (None for an unknown one: no
    made-up denominator)."""
    return PEAKS.get(kind, (None, None, None))[0]


def _taps(size: int, kernel: int, stride: int, dilation: int, lo: int,
          out: int) -> int:
    """The (output position, kernel tap) pairs of one spatial dim whose
    input index lands inside the ``size`` real positions, the window
    starting ``lo`` before the first."""
    n = 0
    for o in range(out):
        for k in range(kernel):
            if 0 <= o * stride + k * dilation - lo < size:
                n += 1
    return n


class _ConvTaps:
    """FlopCounterMode formulas that count a convolution's taps inside
    its input only, forward and both gradients (XLA's count). The port
    pads SAME convolutions with an odd pad (stride 2 on an even input)
    by ``F.pad`` before the convolution: the pad's output is remembered
    (by tensor identity) so the convolution, and its backward, which
    saves that tensor, see the real input's size. Transposed
    convolutions keep torch's formula."""

    def __init__(self):
        self._pads: dict[int, tuple] = {}

    def mapping(self) -> dict:
        aten = torch.ops.aten
        return {aten.constant_pad_nd: self.pad, aten.convolution: self.conv,
                aten._convolution: self.conv,
                aten.convolution_backward: self.conv_backward}

    def pad(self, x, pad, *args, out_val=None, **kwargs) -> int:
        self._pads[id(out_val)] = (out_val, list(pad), tuple(x.shape))
        return 0

    def _valid(self, x, w, stride, padding, dilation, out_spatial) -> int:
        nd = w.dim() - 2

        def per(v, i):
            return v[i] if len(v) > 1 else v[0]

        sizes = list(x.shape[2:])
        lo = [per(padding, i) for i in range(nd)]
        padded = self._pads.get(id(x))
        if padded is not None:
            _, pad, shape = padded
            for i in range(nd):  # the pad list runs from the last dim
                lo[i] += pad[2 * (nd - 1 - i)]
                sizes[i] = shape[2 + i]
        taps = 1
        for i in range(nd):
            taps *= _taps(sizes[i], w.shape[2 + i], per(stride, i),
                          per(dilation, i), lo[i], out_spatial[i])
        return taps

    def conv(self, x, w, bias, stride, padding, dilation, transposed,
             *args, out_val=None, **kwargs) -> int:
        from torch.utils.flop_counter import conv_flop_count

        if transposed:
            return conv_flop_count(x.shape, w.shape, out_val.shape,
                                   transposed=True)
        taps = self._valid(x, w, stride, padding, dilation,
                           out_val.shape[2:])
        return 2 * x.shape[0] * w.shape[0] * w.shape[1] * taps

    def conv_backward(self, grad_out, x, w, bias, stride, padding,
                      dilation, transposed, output_padding, groups,
                      output_mask, out_val=None, **kwargs) -> int:
        from torch.utils.flop_counter import conv_backward_flop

        if transposed:
            return conv_backward_flop(
                grad_out.shape, x.shape, w.shape, None, stride, padding,
                dilation, transposed, output_padding, groups, output_mask,
                [None if o is None else o.shape for o in out_val])
        # the input's gradient and the weight's each pair the same
        # (output, tap) triples as the forward
        taps = self._valid(x, w, stride, padding, dilation,
                           grad_out.shape[2:])
        one = 2 * x.shape[0] * w.shape[0] * w.shape[1] * taps
        return one * (int(output_mask[0]) + int(output_mask[1]))

    # FlopCounterMode passes these the tensors themselves, not shapes
    pad._get_raw = conv._get_raw = conv_backward._get_raw = True


def step_flops(model, task, train_cfg, x_shape, x_dtype, y_shape,
               y_dtype) -> int:
    """FLOPs of one local step (forward and backward of one batch) of
    ``model`` under ``train_cfg``: the port's own step
    (``algorithms/base.py`` ``build_local_step``: its casting policy and
    task loss) on ``meta`` tensors, counted by FlopCounterMode with the
    in-input convolution formula. Matrix products and convolutions only,
    as torch counts; XLA adds a little elementwise work."""
    from torch.utils.flop_counter import FlopCounterMode

    from fedml_tpu_torch.algorithms.base import build_local_step

    init_carry, step = build_local_step(model, task, train_cfg)
    variables = {n: torch.empty(t.shape, dtype=t.dtype, device="meta")
                 for n, t in [*model.module.named_parameters(),
                              *model.module.named_buffers()]}
    params = {k: v for k, v in variables.items()
              if k not in model.stat_names}
    x = torch.zeros(x_shape, dtype=x_dtype, device="meta")
    y = torch.zeros(y_shape, dtype=y_dtype, device="meta")
    w = torch.ones(x_shape[:1], device="meta")
    masks = {k: torch.ones(x_shape[:1] + tuple(s), dtype=torch.bool,
                           device="meta")
             for k, s in model.mask_sites.items()}
    with FlopCounterMode(display=False,
                         custom_mapping=_ConvTaps().mapping()) as counter:
        step(init_carry(variables), x, y, w, params, masks)
    return counter.get_total_flops()


_COST_CACHE: dict = {}


def useful_round_cost(sim) -> float | None:
    """FLOPs of the useful work of one round: the sampled clients times
    their mean real steps (``ceil(count / B)``) times the epochs times one
    step's FLOPs (:func:`step_flops`), as the JAX package's definition.
    Padding steps and the lanes' gated no-ops are not useful work, so MFU
    falls with them, as it should. The step count is cached by (model,
    x shape, y shape, compute dtype). None for a simulation outside the
    FedAvg family (no MFU gauge)."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgSim

    if not isinstance(sim, FedAvgSim):
        return None
    B = sim.batch_size
    x_shape = (B,) + tuple(sim.arrays.x.shape[1:])
    y_shape = (B,) + tuple(sim.arrays.y.shape[1:])
    key = (sim.cfg.model.name, x_shape, y_shape, sim.cfg.train.compute_dtype)
    if key not in _COST_CACHE:
        _COST_CACHE[key] = step_flops(sim.model, sim.task, sim.cfg.train,
                                      x_shape, sim.arrays.x.dtype, y_shape,
                                      sim.arrays.y.dtype) or None
    flops = _COST_CACHE[key]
    mean_steps = float(np.mean(np.ceil(np.asarray(sim._host_counts) / B)))
    k = sim.cfg.fed.clients_per_round * mean_steps * sim.cfg.train.epochs
    return flops * k if flops else None


# ---------------------------------------------------------------------------
# torch.profiler capture parsing
# ---------------------------------------------------------------------------

#: the trace categories of the device's activities
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the arg that marks a CPU-only capture's top-level operator: those play
#: the device ops' part when the capture holds no device activity
OP_ARG = "op"
#: NCCL's kernels are the collectives
_COLLECTIVE_RE = re.compile(r"^nccl", re.I)
#: copies and fills are the data movement the device waits on
_TRANSFER_RE = re.compile(r"^(Memcpy|Memset)")
#: the CUDA runtime calls in which the host waits on the device
_HOST_BLOCK_RE = re.compile(
    r"^(cudaStreamSynchronize|cudaEventSynchronize|cudaDeviceSynchronize|"
    r"cudaMemcpy)$")


def _trace_paths(profile_dir: str) -> list[str]:
    return sorted(
        glob.glob(os.path.join(profile_dir, "**", "*.pt.trace.json"),
                  recursive=True)
        + glob.glob(os.path.join(profile_dir, "**", "*.pt.trace.json.gz"),
                    recursive=True))


def normalize_trace(data: dict) -> list[dict[str, Any]]:
    """A Chrome trace's complete events (``ph`` "X") as the JAX package's
    event dicts ``{name, pid, tid, ts, dur, process, args}`` (``ts`` and
    ``dur`` in microseconds). The device's activities (``cat`` kernel,
    gpu_memcpy, gpu_memset) go to a process ``/device:GPU:<n>`` of their
    own; every other event keeps its host process. The top-level
    ``cpu_op`` events of each host thread carry ``args[OP_ARG]``."""
    raw = data.get("traceEvents", [])
    procs = {e.get("pid"): e.get("args", {}).get("name", "")
             for e in raw
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    events: list[dict[str, Any]] = []
    ops: dict = {}
    for e in raw:
        if e.get("ph") != "X":
            continue
        args = e.get("args") or {}
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev = args.get("device", e.get("pid", 0))
            pid = process = f"/device:GPU:{dev}"
        else:
            pid = e.get("pid", 0)
            process = procs.get(pid) or "/host:CPU"
        ev = {"name": e.get("name", ""), "pid": pid, "tid": e.get("tid", 0),
              "ts": float(e.get("ts", 0.0)), "dur": float(e.get("dur", 0.0)),
              "process": process, "args": args}
        events.append(ev)
        if cat == "cpu_op":
            ops.setdefault((pid, ev["tid"]), []).append(ev)
    for lane in ops.values():
        lane.sort(key=lambda e: (e["ts"], -e["dur"]))
        end = float("-inf")
        for ev in lane:
            if ev["ts"] >= end:  # not inside the last top-level op
                ev["args"] = {**ev["args"], OP_ARG: ev["name"]}
                end = ev["ts"] + ev["dur"]
    return events


def load_trace_events(profile_dir: str) -> list[dict[str, Any]]:
    """Every ``*.pt.trace.json[.gz]`` under ``profile_dir`` (written by
    ``export_chrome_trace`` or ``tensorboard_trace_handler``) as
    :func:`normalize_trace`'s events; ``[]`` without a capture."""
    events: list[dict[str, Any]] = []
    for p in _trace_paths(profile_dir):
        opener = gzip.open if p.endswith(".gz") else open
        with opener(p, "rt") as f:
            events.extend(normalize_trace(json.load(f)))
    return events


def _union_us(intervals: list[tuple[float, float]]) -> float:
    """Microseconds covered by (start, end) intervals: nested and
    overlapping ones (parallel streams) count once."""
    if not intervals:
        return 0.0
    intervals.sort()
    total = 0.0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s)


def _subtract_us(intervals: list[tuple[float, float]],
                 cover: list[tuple[float, float]]) -> float:
    """Microseconds of ``intervals`` not covered by ``cover``."""
    both = _union_us(list(intervals) + list(cover))
    return max(0.0, both - _union_us(list(cover)))


def device_time_breakdown(events: list[dict[str, Any]],
                          window_s: float | None = None) -> dict[str, Any]:
    """Fold a window's events into compute, collective, host-blocked and
    idle time (the JAX package's function, with torch's names):

    - the device ops are the events on a ``/device:*`` process or, in a
      capture without one (the CPU), the events marked ``args[OP_ARG]``
      (the top-level operators);
    - NCCL kernels are **collective**; memcpy and memset are charged to
      **host** (data movement the device waits on); the rest is
      **compute**;
    - host-process waits (``cudaStreamSynchronize``,
      ``cudaEventSynchronize``, ``cudaDeviceSynchronize``, the blocking
      ``cudaMemcpy``) that do not overlap device-busy time add to
      **host**;
    - **idle** is the rest of the window.

    Each category is the union of its own events' intervals, so a
    fraction reads "the share of the window in which an op of this kind
    ran"; categories may overlap in time (a collective beside compute
    counts in both), so the fractions sum to 1 only for a serial
    capture. ``window_s`` is the capture's measured wall time (by default
    the events' span)."""
    device_planes = {e["pid"] for e in events
                     if e["process"].startswith("/device:")}
    if device_planes:
        dev = [e for e in events
               if e["pid"] in device_planes and e["dur"] > 0]
    else:
        dev = [e for e in events if OP_ARG in e["args"] and e["dur"] > 0]

    def iv(evs):
        return [(e["ts"], e["ts"] + e["dur"]) for e in evs]

    def opname(e):
        return str(e["args"].get(OP_ARG) or e["name"])

    coll = [e for e in dev if _COLLECTIVE_RE.match(opname(e))]
    xfer = [e for e in dev if _TRANSFER_RE.match(opname(e))]
    nc = {id(e) for e in coll} | {id(e) for e in xfer}
    comp = [e for e in dev if id(e) not in nc]
    busy_iv = iv(dev)
    busy_us = _union_us(list(busy_iv))
    coll_us = _union_us(iv(coll))
    xfer_us = _union_us(iv(xfer))
    # the union of the compute events, not busy less the others: a
    # collective on another stream must not eat concurrent compute
    compute_us = _union_us(iv(comp))
    host_block = [e for e in events
                  if e["pid"] not in device_planes and e["dur"] > 0
                  and OP_ARG not in e["args"]
                  and _HOST_BLOCK_RE.search(e["name"])]
    host_block_us = _subtract_us(iv(host_block), busy_iv)

    if window_s is None:
        if events:
            lo = min(e["ts"] for e in events)
            hi = max(e["ts"] + e["dur"] for e in events)
            window_s = (hi - lo) / 1e6
        else:
            window_s = 0.0
    window_us = max(window_s * 1e6, busy_us + host_block_us)
    host_us = xfer_us + host_block_us
    idle_us = max(0.0, window_us - busy_us - host_block_us)

    def frac(us):
        return us / window_us if window_us > 0 else 0.0

    return {
        "window_s": window_us / 1e6,
        "device_busy_s": busy_us / 1e6,
        "compute_s": compute_us / 1e6,
        "collective_s": coll_us / 1e6,
        "host_s": host_us / 1e6,
        "idle_s": idle_us / 1e6,
        "compute_frac": frac(compute_us),
        "collective_frac": frac(coll_us),
        "host_frac": frac(host_us),
        "idle_frac": frac(idle_us),
        "n_device_ops": len(dev),
        "n_events": len(events),
        "device_planes": bool(device_planes),
    }


# ---------------------------------------------------------------------------
# the runtime layer: capture windows and live gauges
# ---------------------------------------------------------------------------


def start_capture(device: torch.device) -> torch.profiler.profile:
    """Start one ``torch.profiler`` session: the host's operators and, on
    a card, its activities (CUPTI)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def stop_capture(prof: torch.profiler.profile, directory: str,
                 tag: str) -> dict:
    """Stop the session and write its Chrome trace under ``directory``
    as ``<tag>.pt.trace.json``; returns the seconds each took (the
    capture's own cost, outside the round)."""
    t0 = time.perf_counter()
    prof.stop()
    t1 = time.perf_counter()
    prof.export_chrome_trace(os.path.join(directory, f"{tag}.pt.trace.json"))
    return {"stop_s": t1 - t0, "write_s": time.perf_counter() - t1}


class RoundProfiler:
    """``torch.profiler`` windows around the first K rounds.

    Each profiled round gets a session of its own, written under
    ``<out_dir>/torch_profile/round<k>/<tag>.pt.trace.json`` beside a
    ``capture.json`` manifest (the epoch start and the wall window, so the
    trace's timestamps can be placed on the host spans' timeline). The
    breakdowns feed the ``perf.profile.*`` gauges and go to
    ``<out_dir>/perf_<tag>.json`` at :meth:`finish`. A profiler that
    fails records ``perf_profile_failed`` and takes no more captures;
    the run goes on.
    """

    def __init__(self, rounds: int, out_dir: str, tag: str | None = None,
                 flops_per_round: float | None = None, fuse_rounds: int = 1,
                 device: torch.device | str = "cpu"):
        self.rounds = int(rounds)
        self.out_dir = out_dir
        self.tag = tag or telemetry.rank_tag()
        self.flops_per_round = flops_per_round
        # a fused run's window spans a whole block: the manifest and the
        # rows say so
        self.fuse_rounds = max(1, int(fuse_rounds or 1))
        self.device = torch.device(device)
        self.capture_dir = os.path.join(out_dir, "torch_profile")
        self.breakdowns: list[dict] = []
        self._active = None
        self._broken = False

    @property
    def wants_capture(self) -> bool:
        """True while another window can open (budget left, none open,
        the profiler healthy): the fused loop drains its pipeline before
        such a block, so a window holds exactly one block's work."""
        return (not self._broken and self._active is None
                and len(self.breakdowns) < self.rounds)

    @property
    def active(self) -> bool:
        return self._active is not None

    def _fail(self, err: BaseException) -> None:
        self._broken = True
        telemetry.RECORDER.record("perf_profile_failed", error=repr(err))

    def start_round(self, round_idx: int) -> None:
        if not self.wants_capture:
            return
        d = os.path.join(self.capture_dir, f"round{round_idx}")
        try:
            os.makedirs(d, exist_ok=True)
            prof = start_capture(self.device)
        except Exception as err:
            self._fail(err)
            return
        self._active = (round_idx, d, prof, time.perf_counter(), time.time())

    def end_round(self, round_idx: int, rounds: int = 1) -> None:
        """Close the window of ``round_idx``, after the host has read the
        round's metrics (a port round reads nothing back before that, so a
        window closed earlier would hold only the enqueueing). Under fused
        blocks ``rounds`` is the block's round count."""
        if self._active is None or self._active[0] != round_idx:
            return
        _, d, prof, t0, epoch0 = self._active
        self._active = None
        window_s = time.perf_counter() - t0
        try:
            cost = stop_capture(prof, d, self.tag)
        except Exception as err:
            self._fail(err)
            return
        with open(os.path.join(d, "capture.json"), "w") as f:
            json.dump({"round": round_idx, "t_start": epoch0,
                       "window_s": window_s, "fuse_rounds": self.fuse_rounds,
                       "rounds_in_window": int(rounds)}, f)
        t_parse = time.perf_counter()
        bd = device_time_breakdown(load_trace_events(d), window_s=window_s)
        cost["parse_s"] = time.perf_counter() - t_parse
        bd["round"] = round_idx
        bd["rounds_in_window"] = int(rounds)
        bd["capture_cost_s"] = cost
        self.breakdowns.append(bd)
        m = telemetry.METRICS
        m.inc("perf.profiled_rounds")
        for k in ("compute_frac", "collective_frac", "host_frac",
                  "idle_frac"):
            m.gauge(f"perf.profile.{k}", bd[k])
        m.gauge("perf.profile.window_s", bd["window_s"])
        telemetry.RECORDER.record(
            "perf_profile", round=round_idx,
            compute_frac=round(bd["compute_frac"], 4),
            collective_frac=round(bd["collective_frac"], 4),
            host_frac=round(bd["host_frac"], 4),
            idle_frac=round(bd["idle_frac"], 4))

    def finish(self) -> str | None:
        """Write the breakdowns' artifact; returns its path (None without a
        breakdown). A window a raising round left open is stopped."""
        if self._active is not None:
            _, _, prof, _, _ = self._active
            self._active = None
            prof.stop()
        if not self.breakdowns:
            return None
        path = os.path.join(self.out_dir, f"perf_{self.tag}.json")
        mean = {k: float(np.mean([b[k] for b in self.breakdowns]))
                for k in ("compute_frac", "collective_frac", "host_frac",
                          "idle_frac", "window_s")}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"tag": self.tag,
                       "flops_per_round": self.flops_per_round,
                       "fuse_rounds": self.fuse_rounds,
                       "rounds": self.breakdowns, "mean": mean}, f, indent=2)
        os.replace(tmp, path)
        return path


class PerfMonitor:
    """The live round-rate and MFU gauges and the dispatch-bound detector.

    ``note_round(wall_s)`` for each finished round feeds the
    ``perf.round_wall_s`` histogram (the round-latency SLO's surface), the
    smoothed ``perf.rounds_per_s`` gauge, ``perf.delivered_flops_per_s``
    and ``perf.mfu`` when the round's cost and the card's peak are known,
    and the detector: ``mfu < mfu_floor`` counts
    ``perf.dispatch_bound_rounds``, sets ``perf.latency_bound`` and leaves
    one ``perf_dispatch_bound`` flight event a run.

    The first ``warmup_rounds`` rounds (default 1) stay out of all of it:
    round 0 captures the cohort's CUDA graphs. Their wall is the
    ``perf.warmup_round_wall_s`` gauge."""

    def __init__(self, flops_per_round: float | None = None,
                 peak_flops: float | None = None, path: str = "sim",
                 mfu_floor: float = 0.005, smoothing: float = 0.5,
                 warmup_rounds: int = 1):
        self.flops_per_round = flops_per_round
        self.peak_flops = peak_flops
        self.path = path
        self.mfu_floor = mfu_floor
        self.smoothing = smoothing
        self.warmup_rounds = warmup_rounds
        self._avg_wall: float | None = None
        self._flagged = False
        self.rounds = 0

    @property
    def mfu(self) -> float | None:
        if (not self.flops_per_round or not self.peak_flops
                or not self._avg_wall):
            return None
        return self.flops_per_round / (self._avg_wall * self.peak_flops)

    def note_round(self, wall_s: float) -> None:
        self.note_block(wall_s, 1)

    def note_block(self, wall_s: float, rounds: int,
                   compiled: bool = False) -> None:
        """A finished block of ``rounds`` rounds: the wall is divided by
        the round count before it feeds the histogram, the rate and the
        MFU, so a 4-round block of 2 s is 0.5 s a round. A block holding
        a warm-up round, or one that built a program (``compiled``: a
        CUDA graph capture), is left out whole; its per-round wall is the
        ``perf.warmup_round_wall_s`` gauge."""
        if wall_s <= 0 or rounds <= 0:
            return
        first = self.rounds
        self.rounds += rounds
        per = wall_s / rounds
        if compiled or first < self.warmup_rounds:
            telemetry.METRICS.gauge("perf.warmup_round_wall_s", per)
            return
        self._avg_wall = (per if self._avg_wall is None
                          else (self.smoothing * per
                                + (1 - self.smoothing) * self._avg_wall))
        m = telemetry.METRICS
        for _ in range(rounds):
            m.observe("perf.round_wall_s", per)
        m.gauge("perf.rounds_per_s", 1.0 / self._avg_wall)
        if self.flops_per_round:
            m.gauge("perf.delivered_flops_per_s",
                    self.flops_per_round / self._avg_wall)
        mfu = self.mfu
        if mfu is None:
            return
        m.gauge("perf.mfu", mfu)
        if mfu < self.mfu_floor:
            m.inc("perf.dispatch_bound_rounds", rounds)
            m.gauge("perf.latency_bound", 1.0)
            if not self._flagged:
                self._flagged = True
                telemetry.RECORDER.record(
                    "perf_dispatch_bound", path=self.path,
                    mfu=float(f"{mfu:.3g}"),
                    flops_per_round=self.flops_per_round,
                    note="round time is dispatch/launch latency, not "
                         "flops: rounds/sec is the meaningful number")
        else:
            m.gauge("perf.latency_bound", 0.0)


def build_sim_perf(sim) -> tuple[RoundProfiler | None, PerfMonitor | None]:
    """The perf pair of a round loop (``FedAvgSim.run``, FedGDKD's
    ``run`` and the harness's loops share it). ``(None, None)`` unless
    ``cfg.fed.profile_rounds > 0``: the off path is one attribute read.
    A simulation outside the FedAvg family gets the wall-clock gauges and
    the capture windows, and no MFU."""
    cfg = sim.cfg
    k = int(cfg.fed.profile_rounds)
    if k <= 0:
        return None, None
    telemetry.METRICS.enabled = True
    out_dir = telemetry.artifact_dir()
    if out_dir is None:
        out_dir = telemetry.default_dir(cfg.out_dir, cfg.run_name)
        os.makedirs(out_dir, exist_ok=True)
    flops = useful_round_cost(sim)
    device = torch.device(sim.device)
    peak = (device_peak_flops(torch.cuda.get_device_name(device))
            if device.type == "cuda" else None)
    profiler = RoundProfiler(k, out_dir, flops_per_round=flops,
                             fuse_rounds=cfg.fed.fuse_rounds, device=device)
    monitor = PerfMonitor(flops_per_round=flops, peak_flops=peak,
                          path=type(sim).__name__)
    return profiler, monitor


class RoundPerf:
    """The perf pair of one round loop (:func:`build_sim_perf`; both None
    while the plane is off) and the breach profiler's round boundary
    (``core/anatomy.py`` ``poll_breach``). ``with rp.round(r):`` goes
    around a round's enqueueing and the host's read of its metrics;
    :meth:`close` after the loop, even one that raised."""

    def __init__(self, sim):
        self.profiler, self.monitor = build_sim_perf(sim)

    @contextlib.contextmanager
    def round(self, round_idx: int):
        t0 = time.perf_counter()
        if self.profiler is not None:
            self.profiler.start_round(round_idx)
        yield
        # the round's wall ends with the read of its metrics; the
        # capture's write and parse are not the round's
        wall = time.perf_counter() - t0
        if self.profiler is not None:
            self.profiler.end_round(round_idx)
        if self.monitor is not None:
            self.monitor.note_round(wall)
        self.poll()

    def poll(self, final: bool = False) -> None:
        from fedml_tpu_torch.core import anatomy

        anatomy.poll_breach(self.profiler, final=final)

    def close(self) -> None:
        self.poll(final=True)
        if self.profiler is not None:
            self.profiler.finish()
