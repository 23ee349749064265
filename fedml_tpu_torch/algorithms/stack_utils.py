"""Per-client model stacks and size-sorted sub-groups of a cohort
(``fedml_tpu.algorithms.stack_utils``).

A stack is a flat dict of tensors with a leading ``[num_clients]`` axis:
the per-client stateful models of FedGDKD. A cohort's rows are gathered
from it, trained, and scattered back; evaluation averages every client's
model on the global test set.

A cohort runs as lanes, tensors with a leading client axis. Sorted by
sample count, clients of like size share a group, so each group runs only
as many steps as its own largest member. The sample counts come from the
host, so neither the sort nor a group's step count reads anything back
from the device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from fedml_tpu_torch.core import random as R
from fedml_tpu_torch.core import tree as T
from fedml_tpu_torch.core.device import to_device

Stack = dict[str, torch.Tensor]


def stack_gather(stack: Stack, ids: torch.Tensor) -> Stack:
    """Rows ``ids`` (a device index tensor) of every leaf."""
    return {k: v.index_select(0, ids) for k, v in stack.items()}


def stack_scatter(stack: Stack, ids: torch.Tensor, new: Stack) -> Stack:
    """A copy of ``stack`` with rows ``ids`` replaced by ``new``'s; every
    other row is the old one, bit for bit."""
    return {k: v.index_copy(0, ids, new[k]) for k, v in stack.items()}


def vmap_init(init_fn: Callable[[torch.Generator], Stack], n: int,
              *seed: int) -> Stack:
    """Independent inits of ``n`` clients, stacked: client ``i`` from a
    generator seeded by ``(*seed, i)``."""
    inits = [init_fn(R.generator(*seed, i)) for i in range(n)]
    return {k: torch.stack([v[k] for v in inits]) for k in inits[0]}


def evaluate_stack(evaluator: Callable, stack: Stack, test_x, test_y,
                   n: int) -> dict:
    """Every client's model on the global test set, averaged over the
    ``n`` clients (not the cohort): ``test_acc``, ``test_loss`` and
    ``per_client_acc``. One read back from the device."""
    ms = [evaluator({k: v[i] for k, v in stack.items()}, test_x, test_y)
          for i in range(n)]
    accs, losses = torch.stack([torch.stack([m["acc"] for m in ms]),
                                torch.stack([m["loss"] for m in ms])]
                               ).tolist()
    return {"test_acc": sum(accs) / n, "test_loss": sum(losses) / n,
            "per_client_acc": accs}


def resolve_cohort_groups(requested: int, cohort: int,
                          auto_group_size: int = 5) -> int:
    """Number of size-sorted sub-groups a cohort runs in. ``requested``
    is capped at cohort // 2 (a group needs at least 2 clients) and
    rounded down to a divisor of the cohort (the groups are equal); 0
    means groups of about ``auto_group_size`` clients."""
    if cohort <= 2:
        return 1
    want = (requested if requested > 0
            else max(1, round(cohort / auto_group_size)))
    want = max(1, min(want, cohort // 2))
    while cohort % want:
        want -= 1
    return want


def size_grouped_lanes(vcall: Callable, lane_args: tuple, counts,
                       requested: int, auto_group_size: int = 2,
                       host=None):
    """Run ``vcall`` over the lanes in size-sorted sub-groups.

    ``lane_args`` are trees of tensors with a leading lane axis, all on
    one device; ``counts`` are the lanes' sample counts on the host.
    ``requested`` is the raw ``TrainConfig.cohort_groups`` and is resolved
    here against the lane count, so the split always divides the lanes.
    The lanes are sorted by count, descending (a stable sort: equal counts
    keep their order), and ``vcall(*group_args, group_counts)`` runs once
    per equal group, with the group's host counts last; with ``host`` (a
    host array a lane, such as the lanes' client ids) the group's rows of
    it follow the counts. Every output of ``vcall`` must be lane-stacked;
    the outputs are concatenated and come back in the lanes' input order.
    Sorting and grouping change the schedule only: a lane's result
    depends on its own arguments."""
    counts = np.asarray(counts)
    c = counts.shape[0]
    groups = resolve_cohort_groups(requested, c, auto_group_size)
    extra = () if host is None else (np.asarray(host),)
    if groups == 1:
        return vcall(*lane_args, counts, *extra)
    sub = c // groups
    order = np.argsort(-counts, kind="stable")
    device = T.tree_leaves(lane_args)[0].device
    perm = to_device(torch.from_numpy(order), device)
    inv = to_device(torch.from_numpy(np.argsort(order)), device)
    ordered = T.tree_map(lambda a: a.index_select(0, perm), lane_args)
    outs = [
        vcall(*T.tree_map(lambda a: a[g * sub:(g + 1) * sub], ordered),
              *(h[order[g * sub:(g + 1) * sub]] for h in (counts, *extra)))
        for g in range(groups)
    ]
    cat = T.tree_map(lambda *parts: torch.cat(parts), *outs)
    return T.tree_map(lambda a: a.index_select(0, inv), cat)
