"""Bulk cohorts: the sampled cohort streamed through the device in blocks
of ``B`` clients, the JAX package's ``core/bulk.py``.

In the stacked round every sampled client is a row of ``[C, ...]``
tensors, so device memory grows with the cohort. Here each block of
``B`` clients runs the batched local update and is folded at once into
an O(model) partial,

    delta_wsum += sum_r n_r * (clipped, tau-normalized) delta_r
    n_sum      += sum_r n_r
    the batch statistics' weighted sums and the metric sums alike,

so a round's memory is O(B + model) whatever the cohort; the server step
(:func:`fedml_tpu_torch.algorithms.fedavg.server_update_from_partials`)
reads only the summed partials. The JAX package folds blocks through a
``lax.scan`` carry; here :func:`stream_blocks` is a host loop over
blocks whose ids, live masks and positions are on the host.

- **Exact rules**: the clip and the mean, and FedNova's tau-normalized
  mean, decompose into partial sums: bulk and stacked agree within the
  reassociation of float32 sums.
- **Streamed rules**: median, trimmed mean, Krum, multi-Krum and FLTrust
  run as two passes over the same blocks (``core/streamdef.py``).
- **Banked state**: the error-feedback residual lives in a client-keyed
  :class:`~fedml_tpu_torch.core.statebank.ClientStateBank` that each
  block gathers from and scatters to.

Elastic buckets apply to the block count (:func:`plan_blocks`): the
blocks are the power-of-two bucket of ``ceil(C / B)``, and a cohort
that changes within it reuses the one ``B``-lane program.

The partials are flat: a block's parameter deltas are one ``[B, D]``
matrix in the variables' key order
(:func:`fedml_tpu_torch.core.tree.tree_vectorize`), so its fold is a few
kernel launches whatever the number of leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from fedml_tpu_torch.core import telemetry
from fedml_tpu_torch.core import tree as T
from fedml_tpu_torch.core.elastic import bucket_for

#: reduce rules whose aggregate decomposes into partial sums (fednova is
#: an algorithm, not a robust_method, and composes too)
BULK_REDUCE_RULES = ("mean",)


@dataclasses.dataclass(frozen=True)
class BulkSpec:
    """The block-streaming mode (``FedConfig.client_block_size``; 0 is
    off: the stacked round)."""

    block_size: int = 0

    def __post_init__(self):
        if self.block_size < 0:
            raise ValueError(
                f"client_block_size must be >= 0 (0 = stacked mode), "
                f"got {self.block_size}")

    @staticmethod
    def from_fed(fed) -> "BulkSpec":
        return BulkSpec(block_size=getattr(fed, "client_block_size", 0) or 0)

    def enabled(self) -> bool:
        return self.block_size > 0


def check_bulk_compat(fed, adversary=None) -> None:
    """The bulk engine's compatibility check, at construction and at the
    CLI's parse time. Every defense (streamed), codec (banked residual),
    attack and PEFT setting (the personalized round streams its adapter
    bank) composes with it, as in the JAX package; fednova with a defense
    is refused by ``robust.check_fednova_compat``, and PEFT's own table by
    ``peft.check_peft_compat``."""
    del fed, adversary  # everything ported composes


def plan_blocks(cohort: int, block_size: int, elastic: bool) -> int:
    """Blocks for a ``cohort`` in blocks of ``block_size``; under
    ``elastic`` the count is bucketed to the next power of two (the
    headroom blocks are wholly dead)."""
    if cohort < 1:
        raise ValueError(f"cohort must be >= 1, got {cohort}")
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    nb = -(-cohort // block_size)
    return bucket_for(nb) if elastic else nb


class RoundPartials(NamedTuple):
    """What a block reduces to, and what the round sums: the
    ``[weighted-delta-sum, mass, n, metric sums]`` of the JAX package's
    streaming aggregation, with flat vectors."""

    delta_wsum: torch.Tensor  # [D] sum_r n_r (clipped[, /tau_r]) delta_r
    other_wsum: torch.Tensor  # [S] sum_r n_r * batch statistics
    n_sum: torch.Tensor  # sum_r n_r (the mass)
    tau_wsum: torch.Tensor  # sum_r n_r tau_r (fednova; 0 otherwise)
    msums: dict  # additive metric sums, scalars
    rejected: torch.Tensor  # non-finite rows screened, scalar


def stream_blocks(fold_block: Callable[..., Any], ids: np.ndarray,
                  live: np.ndarray | None, block_size: int,
                  banks: Any = None, positions: bool = False,
                  skip: Callable[[np.ndarray], bool] | None = None):
    """Fold the host ids ``ids`` (``[S]``, ``S`` a multiple of
    ``block_size``) through ``fold_block(block_ids, block_live[,
    block_pos][, banks])`` block by block and sum what it returns (a
    tree of tensors). ``live`` is the ``[S]`` host bool mask of live
    slots, or None (all live). ``positions`` passes each block's slot
    indices (``block_pos``, a host ``range``).

    With ``banks`` (a client-keyed state, e.g. a
    :class:`~fedml_tpu_torch.core.statebank.ClientStateBank`),
    ``fold_block`` takes it last and returns ``(partials, banks)``; the
    partials sum while the banks flow from block to block, and the call
    returns ``(partials, banks)``.

    ``skip(block_live)`` may name a block that adds exact zeros (a block
    of dead slots): it is not run. A single block is folded alone, with
    no sum."""
    n_slots = ids.shape[0]
    if n_slots % block_size:
        raise ValueError(f"slot count {n_slots} is not a multiple of block "
                         f"size {block_size}")
    total = None
    for start in range(0, n_slots, block_size):
        sl = slice(start, start + block_size)
        block_live = None if live is None else live[sl]
        if skip is not None and total is not None and skip(block_live):
            continue
        args = [ids[sl], block_live]
        if positions:
            args.append(range(start, start + block_size))
        if banks is None:
            out = fold_block(*args)
        else:
            out, banks = fold_block(*args, banks)
        total = out if total is None else T.tree_map(torch.add, total, out)
    return total if banks is None else (total, banks)


def note_round(counters: dict, block_size: int, n_blocks: int,
               padded_slots: int, rounds: int = 1) -> None:
    """The bulk engine's per-round accounting, under the JAX package's
    names: ``bulk.block_size``, ``bulk.blocks_per_round`` and
    ``bulk.padded_slots`` (gauges) and ``bulk.rounds`` (a count), in
    ``counters`` and the registry."""
    telemetry.set_gauge(counters, "bulk.block_size", block_size)
    telemetry.set_gauge(counters, "bulk.blocks_per_round", n_blocks)
    telemetry.set_gauge(counters, "bulk.padded_slots", padded_slots)
    telemetry.add_count(counters, "bulk.rounds", float(rounds))
