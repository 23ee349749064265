"""One local step of a cohort captured as a CUDA graph.

The host cost of an eager local step is thousands of kernel launches
(ResNet-56: about 4,600), each a few microseconds of device work. A CUDA
graph launches them all at once: the step is captured once, and each
later step is one replay.
"""

from __future__ import annotations

import gc
from typing import Callable, Sequence

import torch

from fedml_tpu_torch.core import tree as T

# eager calls on a side stream before the capture: cuDNN and cuBLAS pick
# their algorithms and workspaces, and the allocator settles, outside it
WARMUP_STEPS = 3

# the side streams of the captures, one per device for the process: cuBLAS
# keeps a workspace for every stream it has run on until the process ends,
# so a new stream per capture would hold one more workspace per graph
# (64 MiB on an H100)
_CAPTURE_STREAMS: dict[int, torch.cuda.Stream] = {}


def _capture_stream() -> torch.cuda.Stream:
    device = torch.cuda.current_device()
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream()
    return _CAPTURE_STREAMS[device]


def _shapes(tree) -> list:
    return [(tuple(x.shape), x.dtype, x.device)
            for x in T.tree_leaves(tree)]


def _copy_into(dst, src) -> None:
    T.tree_map(lambda d, s: d.copy_(s), dst, src)


class GraphedStep:
    """``fn(carry, consts, fixed, inputs) -> carry`` as one CUDA graph.

    ``carry``, ``consts`` and ``inputs`` are trees of tensors (nested
    dicts, tuples, lists) of fixed shapes. The graph reads them from
    static buffers and writes the new carry back into the carry buffers,
    so that one replay follows another. :meth:`run` loads a start carry
    and the constants into the buffers once, then for each step copies
    that step's inputs in and replays, and returns a copy of the final
    carry. ``fixed`` are tensors the graph reads where they lie (the
    dataset): every run must pass the same tensor objects, alive for the
    graph's life.

    The first run captures: ``WARMUP_STEPS`` eager calls on a side
    stream, then the capture, into a private memory pool. Python's cyclic
    garbage collector is run before the capture and kept off during it:
    a dead cycle that holds another graph (a dropped simulation) would
    otherwise be freed at any allocation, and a graph destroyed while a
    capture is under way invalidates the capture (``torch.cuda.graph``
    collects on entry only under ``torch.compiler.config.
    force_cudagraph_gc``). A capture or a replay that fails raises;
    nothing falls back to running eagerly.
    """

    def __init__(self, fn: Callable):
        self.fn = fn
        self.graph: torch.cuda.CUDAGraph | None = None
        self.replays = 0  # replays over the graph's life

    def run(self, carry, consts, fixed: tuple, steps: Sequence):
        """Replay once per entry of ``steps`` (each the tree of one step's
        inputs), from ``carry``; returns the final carry."""
        if not steps:
            return T.tree_map(torch.clone, carry)
        if self.graph is None:
            self._capture(carry, consts, fixed, steps[0])
        if _shapes((carry, consts, steps[0])) != self._signature:
            raise ValueError("the graph was captured for other shapes: "
                             f"{self._signature}")
        if any(a is not b for a, b in zip(fixed, self.fixed, strict=True)):
            raise ValueError("the graph reads other fixed tensors")
        _copy_into(self.carry, carry)
        _copy_into(self.consts, consts)
        for inputs in steps:
            _copy_into(self.inputs, inputs)
            self.graph.replay()
        self.replays += len(steps)
        return T.tree_map(torch.clone, self.carry)

    def _body(self) -> None:
        _copy_into(self.carry,
                   self.fn(self.carry, self.consts, self.fixed, self.inputs))

    def _capture(self, carry, consts, fixed, inputs) -> None:
        self._signature = _shapes((carry, consts, inputs))
        self.carry, self.consts, self.inputs = (
            T.tree_map(torch.clone, t) for t in (carry, consts, inputs))
        self.fixed = tuple(fixed)
        side = _capture_stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._body()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                self._body()
        finally:
            if collecting:
                gc.enable()
        self.graph = graph
