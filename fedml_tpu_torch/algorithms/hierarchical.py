"""Hierarchical FL: cloud, edge groups, clients; two-level FedAvg
(``fedml_tpu.algorithms.hierarchical``).

The clients are split into ``num_groups`` equal groups, at random and
for the whole run (``default_rng(seed).permutation(n)``). A global round
is ``group_comm_round`` inner FedAvg rounds in every group, each group
averaging only its own clients (weighted by their sample counts), then a
mean over the groups weighted by each group's sample total in its last
inner round. Every client of a group trains in every inner round.

An inner round runs every client of every group as one cohort of lanes,
each lane from its own group's variables (``CohortUpdate(starts=)``), in
size-sorted groups of lanes, one CUDA graph replay a group-step on the
card. The hook ``batch_orders(round, group, inner, client)`` gives a
client's batch orders (the JAX package folds the round key with the
group, then the inner round, then the client); the default draws them
from a generator seeded by ``(seed, round, group, inner, client)``. A
model with dropout draws its ``"dropout"`` masks at the coordinate
``round * group_comm_round + inner``, by host id.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from fedml_tpu_torch.algorithms.base import (
    CohortUpdate,
    build_evaluator,
    finalize_sums,
)
from fedml_tpu_torch.algorithms.client_sim import ClientSim
from fedml_tpu_torch.config import ExperimentConfig
from fedml_tpu_torch.core import random as R
from fedml_tpu_torch.core import tree as T
from fedml_tpu_torch.data.federated import FederatedData
from fedml_tpu_torch.models.base import FedModel, Params

# the initial model's salt, as FedAvgSim's
INIT = 0x7FFFFFFF


class HierState(NamedTuple):
    variables: Params  # the global model's variables
    round: int


def grouped_mean(stacked: Params, weights: torch.Tensor, groups: int
                 ) -> Params:
    """Per group the weighted mean of its lanes: ``stacked`` leaves
    ``[groups * size, ...]`` (group-major), ``weights`` ``[groups *
    size]``; returns ``[groups, ...]`` leaves (``tree_weighted_mean`` of
    each group's rows, in float32)."""
    w = weights.reshape(groups, -1)
    w = w / torch.clamp(w.sum(1, keepdim=True), min=1e-12)
    out = {}
    for k, v in stacked.items():
        rows = v.reshape(groups, -1, *v.shape[1:])
        wb = w.reshape(w.shape + (1,) * (v.dim() - 1)).to(T.wide(v).dtype)
        out[k] = torch.sum(T.wide(rows) * wb, dim=1).to(v.dtype)
    return out


class HierarchicalFedAvg(ClientSim):
    """Two-level FedAvg on one device. ``grouping`` (host ``[G, n / G]``)
    is the clients of each group; ``last_groups`` the last inner round's
    lane groups (clients, steps an epoch)."""

    def __init__(self, model: FedModel, data: FederatedData,
                 cfg: ExperimentConfig, device: str | torch.device = "cuda",
                 num_groups: int = 2, group_comm_round: int = 1,
                 batch_orders: Callable | None = None,
                 draws: R.Draws | None = None):
        super().__init__({"model": model}, data, cfg, device, None,
                         None, draws, {"dropout": cfg.seed},
                         p={"dropout": model.mask_keep})
        self.model = model
        n = self.arrays.num_clients
        if group_comm_round < 1:
            raise ValueError("group_comm_round must be at least 1, got "
                             f"{group_comm_round}")
        if n % num_groups:
            raise ValueError(f"{n} clients do not split into {num_groups} "
                             "equal groups")
        self.num_groups = num_groups
        self.group_size = n // num_groups
        self.group_comm_round = group_comm_round
        rng = np.random.default_rng(cfg.seed)
        self.grouping = rng.permutation(n).reshape(num_groups,
                                                   self.group_size)
        # the client's group, for the batch orders' coordinates
        self._group_of = np.empty(n, np.int64)
        for g, members in enumerate(self.grouping):
            self._group_of[members] = g
        self.batch_orders = batch_orders or self._hier_orders
        self.cohort_update = CohortUpdate(model, self.task, cfg.train,
                                          self.batch_size, self.graphed)
        self.evaluator = build_evaluator(model, self.task)

    def _hier_orders(self, round_idx, group, inner, client):
        gen = R.generator(self.cfg.seed, round_idx, group, inner, client)
        return [R.padded_perm(gen, self._host_mask[client], self.max_n)
                for _ in range(self.cfg.train.epochs)]

    def init(self) -> HierState:
        return HierState(self.model.init(R.generator(self.cfg.seed, INIT)),
                         0)

    def run_round(self, state: HierState):
        """One global round; returns the new state and the round's train
        loss and accuracy (the metric sums of every inner round)."""
        groups, size = self.num_groups, self.group_size
        hosts = self.grouping.reshape(-1)  # group-major lanes
        group_vars = {k: v.expand(groups, *v.shape)
                      for k, v in state.variables.items()}
        sums, g_n = None, None
        for inner in range(self.group_comm_round):
            lane_vars = {k: v.repeat_interleave(size, dim=0)
                         for k, v in group_vars.items()}
            orders = self._stack_orders(hosts, lambda c: self.batch_orders(
                state.round, int(self._group_of[c]), inner, c))
            stacked, n_k, msums = self._train_lanes(
                self.cohort_update, self.model, hosts, lane_vars, orders,
                state.round * self.group_comm_round + inner)
            group_vars = grouped_mean(stacked, n_k, groups)
            # the last inner round's totals weigh the groups
            g_n = n_k.reshape(groups, size).sum(1)
            step = {k: v.sum() for k, v in msums.items()}
            sums = step if sums is None else {k: sums[k] + step[k]
                                              for k in sums}
        new_vars = T.tree_weighted_mean(group_vars, g_n)
        fin = finalize_sums(sums)
        return (HierState(new_vars, state.round + 1),
                {"train_loss": fin["loss"], "train_acc": fin["acc"]})

    def evaluate_global(self, state: HierState) -> dict:
        m = self.evaluator(state.variables, self.arrays.test_x,
                           self.arrays.test_y)
        return {k: float(v) for k, v in m.items()}
