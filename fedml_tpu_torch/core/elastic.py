"""Bucketed cohorts: a live cohort that changes size costs no new
program, the JAX package's ``core/elastic.py`` on flat ``{name: [C,
...]}`` trees.

The round runs a fixed number of lanes, the power-of-two **bucket**
above the cohort; the live clients take the first lanes and the rest
are padding. A padded row carries the global variables (its delta is
exactly 0) with weight 0, so no aggregation rule sees it: the mean and
FedNova weigh it 0, the median and trimmed mean sort it past the valid
rows, Krum scores it far and FLTrust gives it no trust (the ``valid=``
forms of :mod:`fedml_tpu_torch.core.robust`).

The JAX package compiles one XLA program per bucket and mirrors its jit
cache into ``elastic.compile_cache_{hits,misses}``. A card has no
compiler: here a program is a local step of one lane count
(:class:`~fedml_tpu_torch.algorithms.base.CohortUpdate`), captured as a
CUDA graph on the card and run eagerly on the CPU, and
:class:`CompiledRoundCache` holds them. A round that built no new program
(on the card: replayed the graph it had) counts a hit, one that built one
(on the card: captured) a miss, under the JAX package's names, and each
build is a program of the memory plane (``core/memscope.py``
``note_program``: its build time).

The live count and the mask are on the host (the JAX package traces
them), so nothing here reads the device.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Hashable

import torch

from fedml_tpu_torch.core import memscope, telemetry
from fedml_tpu_torch.core import tree as T
from fedml_tpu_torch.core.device import to_device

Tree = dict[str, torch.Tensor]


def bucket_for(n: int, min_bucket: int = 1) -> int:
    """Next power-of-two bucket that fits ``n`` cohort rows."""
    if n < 1:
        raise ValueError(f"cohort size must be >= 1, got {n}")
    b = max(1, min_bucket)
    while b < n:
        b <<= 1
    return b


def pad_stacked(stacked_vars: Tree, weights: torch.Tensor,
                global_vars: Tree, bucket: int):
    """Pad a ``[C, ...]`` stacked tree to ``[bucket, ...]``: the padded
    rows are copies of ``global_vars`` (a delta of exactly 0) with weight
    0. Returns ``(padded, padded_weights, valid)``, ``valid`` a
    ``[bucket]`` bool mask of the real rows."""
    c = int(weights.shape[0])
    if c > bucket:
        raise ValueError(f"cohort {c} does not fit bucket {bucket}")
    pad = bucket - c
    device = weights.device
    w = weights.float()
    valid = torch.arange(bucket, device=device) < c
    if pad == 0:
        return stacked_vars, w, valid
    padded = {k: torch.cat([s, global_vars[k].to(s.dtype)[None].expand(
        (pad,) + tuple(s.shape[1:]))]) for k, s in stacked_vars.items()}
    w = torch.cat([w, torch.zeros(pad, device=device)])
    return padded, w, valid


def active_mask(bucket: int, n_active: int,
                device: torch.device | str = "cpu") -> torch.Tensor:
    """``[bucket]`` bool on ``device``: the first ``n_active`` slots are
    live. Made on the host and copied without a sync."""
    return to_device(torch.arange(bucket) < n_active, torch.device(device))


def mask_padded(stacked_vars: Tree, n_k: torch.Tensor, msums: dict,
                global_vars: Tree, live: torch.Tensor):
    """Neutralize the padded slots before the screen and the aggregate:
    their variables become the global ones (delta exactly 0), their
    sample count and metric sums 0."""
    healed = {k: torch.where(T.bcast_rows(live, s), s,
                             global_vars[k][None].to(s.dtype))
              for k, s in stacked_vars.items()}
    n_k = torch.where(live, n_k, torch.zeros_like(n_k))
    msums = {k: torch.where(T.bcast_rows(live, v), v, torch.zeros_like(v))
             for k, v in msums.items()}
    return healed, n_k, msums


class CompiledRoundCache:
    """A least-recently-used store of built programs, keyed by shape
    (any hashable: a lane count, a block grid). ``cache(key)`` returns
    the program for ``key``, building it with ``build(key)`` on a miss;
    past ``max_entries`` the least recently used is dropped (a dropped
    CUDA graph frees its memory pool). ``stats`` counts hits, misses and
    evictions. A build is noted as a program of ``family`` (the memory
    plane's ``mem.compile_s.<family>``)."""

    def __init__(self, build: Callable[[Hashable], object],
                 max_entries: int = 8, family: str = "program"):
        self._build = build
        self.max_entries = max_entries
        self.family = family
        self._cache: OrderedDict = OrderedDict()
        self.stats = {"hits": 0, "misses": 0, "evictions": 0}
        self.last = None  # the program the last call returned

    def __call__(self, key: Hashable):
        if key in self._cache:
            self._cache.move_to_end(key)
            self.stats["hits"] += 1
        else:
            t0 = time.perf_counter()
            self._cache[key] = self._build(key)
            memscope.note_program(self.family, key,
                                  compile_s=time.perf_counter() - t0)
            self.stats["misses"] += 1
            if len(self._cache) > self.max_entries:
                self._cache.popitem(last=False)
                self.stats["evictions"] += 1
        self.last = self._cache[key]
        return self.last

    def __len__(self) -> int:
        return len(self._cache)

    def values(self) -> list:
        """The programs held, least recently used first."""
        return list(self._cache.values())


def mirror_jit_cache(cache: CompiledRoundCache, call: Callable,
                     counters: dict):
    """Run ``call()`` (one round) and count it, in ``counters`` and the
    registry, as ``elastic.compile_cache_misses`` if it built a program in
    ``cache``, else as ``elastic.compile_cache_hits``; the programs it
    evicted count ``elastic.compile_cache_evictions`` in the registry."""
    before = dict(cache.stats)
    out = call()
    name = ("elastic.compile_cache_misses"
            if cache.stats["misses"] > before["misses"]
            else "elastic.compile_cache_hits")
    telemetry.add_count(counters, name)
    evicted = cache.stats["evictions"] - before["evictions"]
    if evicted:
        telemetry.METRICS.inc("elastic.compile_cache_evictions", evicted)
    return out
