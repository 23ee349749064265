"""Round fusion: the round loop in blocks of rounds, with the host reading
a block's metrics back once, at its end (``fedml_tpu.core.fuse``).

A round reads nothing back from the device (``FedAvgSim.run_round``), so
what holds the host in the per-round loop is the loop itself: every
round it converts the round's metrics to Python floats, a sync each,
before it may enqueue the next round. With ``FedConfig.fuse_rounds = K``
the loop enqueues K rounds back to back (``FedAvgSim.run_block``) and
keeps their metrics on the device, stacked per key. The JAX package
runs a block as one program (a ``lax.scan`` over the round body); the
port enqueues the same rounds one after the other: the cohort, its
size-sorted groups and each group's steps are host data drawn anew each
round, and a graph over whole rounds would need a fixed, gated step count
for every group of every round. Each local step stays one CUDA graph
replay (``algorithms/graphs.py``).

- :func:`plan_blocks` cuts the rounds into blocks that end on every
  evaluation and checkpoint round, so both see exactly the state the
  per-round loop would;
- :class:`BlockPipeline` holds one block's metrics in flight: ``push``
  copies them once, without blocking, into pinned host memory and records
  a CUDA event; ``flush`` waits on that event, the block's only sync;
- :func:`drive` is the loop, shared by ``FedAvgSim._run_fused`` and the
  harness's ``Experiment._fused_loop`` so the two cannot drift. It feeds
  the observability planes as the JAX package's does: the perf monitor
  (a block's wall over its rounds), a profiler window around a whole
  block (the pipeline drained before it), the anatomy plane's entry per
  block, a tracer span per block, and the breach profiler's boundary.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Iterable, Iterator, NamedTuple

import torch

from fedml_tpu_torch.core import anatomy as AN


def plan_blocks(start: int, total: int, fuse: int, eval_every: int,
                checkpoint_every: int = 0
                ) -> Iterator[tuple[int, int, bool]]:
    """Cut rounds ``[start, total)`` into blocks of at most ``fuse``
    rounds that never cross a boundary round. Yields ``(block_start,
    length, boundary)``; ``boundary`` is True when the block's last round
    is an evaluation round (``(r + 1) % eval_every == 0``), a checkpoint
    round or the final round, where the loop flushes and syncs. With
    ``fuse == 1`` every round is its own block: the per-round
    schedule."""
    if fuse < 1:
        raise ValueError(f"fuse must be >= 1, got {fuse}")

    def is_boundary(r: int) -> bool:
        return ((r + 1) % eval_every == 0
                or (checkpoint_every > 0 and (r + 1) % checkpoint_every == 0)
                or r == total - 1)

    r = start
    while r < total:
        n = 0
        while n < fuse and r + n < total:
            n += 1
            if is_boundary(r + n - 1):
                break
        yield r, n, is_boundary(r + n - 1)
        r += n


class Flushed(NamedTuple):
    """A block whose metrics reached the host: ``rows`` one dict of
    Python floats per round; ``wall_s`` from the block's dispatch to its
    metrics on the host (the block's execution once the next block is
    enqueued before the flush); ``compiled`` whether the block built a
    program (captured a CUDA graph), so its wall holds a capture;
    ``get_wait_s`` the seconds the flush waited."""

    start: int
    length: int
    rows: list[dict]
    wall_s: float
    compiled: bool
    get_wait_s: float


class BlockPipeline:
    """One block's device metrics in flight.

    :meth:`push` takes the just-enqueued block's metrics (``{name:
    [length] tensor}``, on one device), flushes the block before it and
    returns that one: the host converts block k while the device runs
    block k + 1. The push stacks the block's metrics into one float64
    tensor (exact for float32 values) and copies it into pinned host
    memory without blocking, then records a CUDA event; it reads nothing
    back. :meth:`flush` waits on the event and makes the rows."""

    def __init__(self) -> None:
        self._pending = None

    def push(self, start: int, length: int, metrics: dict[str, Any],
             t0: float, compiled: bool = False) -> Flushed | None:
        prev = self.flush()
        names = list(metrics)
        stacked = torch.stack([metrics[k].to(torch.float64)
                               for k in names])  # [keys, length]
        event = None
        if stacked.is_cuda:
            host = torch.empty(stacked.shape, dtype=stacked.dtype,
                               pin_memory=True)
            host.copy_(stacked, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = stacked
        self._pending = (start, length, names, host, event, t0, compiled)
        return prev

    def flush(self) -> Flushed | None:
        if self._pending is None:
            return None
        start, n, names, host, event, t0, compiled = self._pending
        self._pending = None
        t_get = time.perf_counter()
        if event is not None:
            event.synchronize()  # the block's one sync
        done = time.perf_counter()
        values = host.tolist()
        rows = [{k: values[j][i] for j, k in enumerate(names)}
                for i in range(n)]
        return Flushed(start, n, rows, done - t0, compiled, done - t_get)


def drive(run_block: Callable[[int], dict],
          blocks: Iterable[tuple[int, int, bool]], *,
          make_records: Callable[[int, list[dict]], list[dict]],
          log: Callable[[dict], None],
          boundary_hook: Callable[[int, dict], None],
          programs=None, profiler=None, monitor=None,
          span: Callable[[int, int], Any] | None = None) -> list[Flushed]:
    """The fused round loop.

    - ``run_block(length)`` enqueues one block and returns its stacked
      device metrics (the caller keeps the state);
    - ``blocks`` is a :func:`plan_blocks` schedule;
    - ``make_records(start, rows)`` shapes the block's host rows into
      the loop's records (consuming the round counters);
    - ``log(record)`` emits a finished record;
    - ``boundary_hook(r_last, last_record)`` runs at every boundary block
      with its last record held back: the caller evaluates or
      checkpoints there and logs the record itself;
    - ``programs`` (a :class:`~fedml_tpu_torch.core.elastic.
      CompiledRoundCache`) marks a block ``compiled`` when it built a
      program there (a CUDA graph capture, the port's analog of a fresh
      trace);
    - ``profiler`` and ``monitor`` (``core/perf.py``'s pair, or None): a
      block the profiler wants is captured whole, and each block's wall,
      over its rounds, feeds the monitor (a ``compiled`` block stays out
      of the round-latency surface, as a warm-up round does);
    - ``span(start, length)`` wraps each enqueueing in a context manager
      (tracer spans).

    Block k + 1 is enqueued before block k's metrics are fetched; the
    pipeline drains at boundaries and around a profiled block. Each
    flushed block is one anatomy entry: ``local`` is the flush's wait,
    the enqueueing and the rows' conversion fall in ``host_gap``, and the
    boundary's evaluation amends it. Returns every block, flushed, in
    order (its wall times and ``compiled`` flags)."""
    pipeline = BlockPipeline()
    done: list[Flushed] = []

    def emit(flushed: Flushed, hold_last: bool = False):
        done.append(flushed)
        if monitor is not None:
            monitor.note_block(flushed.wall_s, flushed.length,
                               compiled=flushed.compiled)
        if AN.ANATOMY.enabled:
            AN.ANATOMY.begin_round(flushed.start, path="fused",
                                   rounds=flushed.length)
            AN.ANATOMY.phase("local", flushed.get_wait_s)
            AN.ANATOMY.end_round(wall_s=flushed.wall_s)
        records = make_records(flushed.start, flushed.rows)
        last = records.pop() if hold_last else None
        for rec in records:
            log(rec)
        return last

    def misses() -> int:
        return programs.stats["misses"] if programs is not None else 0

    for bstart, blen, boundary in blocks:
        capturing = profiler is not None and profiler.wants_capture
        if capturing:
            # the window holds exactly this block's work
            prev = pipeline.flush()
            if prev is not None:
                emit(prev)
            profiler.start_round(bstart)
        before = misses()
        t0 = time.perf_counter()
        with (span(bstart, blen) if span is not None
              else contextlib.nullcontext()):
            metrics = run_block(blen)
        prev = pipeline.push(bstart, blen, metrics, t0, misses() > before)
        if prev is not None:
            emit(prev)
        if boundary or capturing:
            last = emit(pipeline.flush(), hold_last=boundary)
            if capturing:
                profiler.end_round(bstart, rounds=blen)
            AN.poll_breach(profiler)
            if boundary:
                boundary_hook(bstart + blen - 1, last)
    final = pipeline.flush()
    if final is not None:
        emit(final)
    return done
