"""FedNAS: federated neural architecture search over the DARTS space
(``fedml_tpu.algorithms.fednas``).

Each client of the round's cohort runs first-order DARTS on its data:
every epoch's batch order (real samples first) is split into halves by
position, the architecture half ``order[1::2]`` and the weight half
``order[0::2]``; each step first takes the architect's step (adam at
``arch_lr``) on the alphas at the current weights on an architecture
batch, keeping that forward's BatchNorm statistics, then the weight
optimizer's step on a weight batch, each gated on its own batch's
weights. The server takes the sample-weighted mean of the weights, the
alphas and the statistics. The batch is capped at half the padded
client size, so each half holds at least one batch.

The cohort runs as lanes in size-sorted groups, one step of a group (both
optimizers' steps of every lane) one CUDA graph replay on the card
(:class:`NASUpdate`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from fedml_tpu_torch.algorithms import gan_core as G
from fedml_tpu_torch.algorithms.base import (
    Optimizer,
    apply_updates,
    build_evaluator,
    make_client_optimizer,
)
from fedml_tpu_torch.algorithms.client_sim import ClientSim
from fedml_tpu_torch.algorithms.hierarchical import INIT
from fedml_tpu_torch.config import ExperimentConfig, TrainConfig
from fedml_tpu_torch.core import random as R
from fedml_tpu_torch.core import tree as T
from fedml_tpu_torch.data.federated import FederatedData
from fedml_tpu_torch.models.base import FedModel, Params
from fedml_tpu_torch.models.darts import ARCH

# the architect's learning rate (the reference's arch_lr, adam)
ARCH_LR = 3e-4
EVAL_BATCH = 64


def _gate(valid: torch.Tensor, new, old):
    return T.tree_map(lambda n, o: torch.where(valid, n, o), new, old)


class NASUpdate:
    """``update(lane_vars, idx_rows, mask_rows, x, y, orders, steps) ->
    lane_vars``: the DARTS search of G lanes from their variables, with
    fresh optimizers: ``epochs`` epochs of ``steps`` steps, each the
    architect's step on ``order[1::2]``'s batch then the weights' on
    ``order[0::2]``'s (``orders`` ``[G, epochs, max_n]``)."""

    def __init__(self, model: FedModel, train_cfg: TrainConfig,
                 arch_lr: float, batch_size: int, graphed: bool):
        self.model, self.batch_size = model, batch_size
        self.epochs = train_cfg.epochs
        self.w_opt = make_client_optimizer(train_cfg)
        self.a_opt = Optimizer("adam", arch_lr)
        self.grad_w = torch.func.grad_and_value(self._loss, argnums=0,
                                                has_aux=True)
        self.grad_a = torch.func.grad_and_value(self._loss, argnums=1,
                                                has_aux=True)
        self.vstep = torch.func.vmap(self._lane_step)
        self.programs = G.graph_programs(graphed, self._graph_step,
                                         "fednas_step")

    def _loss(self, weights, arch, stats, xb, yb, wb):
        logits, new = self.model.apply_train({**weights, **arch, **stats},
                                             xb)
        return G.ce(logits, yb, wb), {k: new[k] for k in stats}

    def _lane_step(self, carry, xv, yv, wv, xt, yt, wt):
        w, a, s = carry["params"], carry["arch"], carry["stats"]
        # 1. the architect on the architecture batch, first order
        grads, (_, stats_v) = self.grad_a(w, a, s, xv, yv, wv)
        updates, a_opt = self.a_opt.update(grads, carry["a_opt"], a)
        a, s, a_opt = _gate(torch.sum(wv) > 0,
                            (apply_updates(a, updates), stats_v, a_opt),
                            (a, s, carry["a_opt"]))
        # 2. the weights on the weight batch, at the new alphas
        grads, (_, stats_t) = self.grad_w(w, a, s, xt, yt, wt)
        updates, w_opt = self.w_opt.update(grads, carry["w_opt"], w)
        w, s, w_opt = _gate(torch.sum(wt) > 0,
                            (apply_updates(w, updates), stats_t, w_opt),
                            (w, s, carry["w_opt"]))
        return {"params": w, "arch": a, "stats": s, "w_opt": w_opt,
                "a_opt": a_opt}

    def _graph_step(self, carry, consts, fixed, batch):
        x, y = fixed
        b_v, w_v, b_t, w_t = batch
        return self.vstep(carry, x[b_v], y[b_v], w_v, x[b_t], y[b_t], w_t)

    def __call__(self, lane_vars: Params, idx_rows, mask_rows, x, y,
                 orders, steps: int) -> Params:
        lanes, b = idx_rows.shape[0], self.batch_size
        halves = []
        for part in (orders[:, :, 1::2], orders[:, :, 0::2]):
            flat = part.reshape(lanes, -1)
            halves.append((
                torch.gather(idx_rows, 1, flat).long().view(lanes,
                                                            self.epochs, -1),
                torch.gather(mask_rows, 1, flat).view(lanes, self.epochs,
                                                      -1)))
        (bv, wv), (bt, wt) = halves
        batches = [(bv[:, e, s * b:(s + 1) * b], wv[:, e, s * b:(s + 1) * b],
                    bt[:, e, s * b:(s + 1) * b], wt[:, e, s * b:(s + 1) * b])
                   for e in range(self.epochs) for s in range(steps)]
        stats = {k: v.detach().clone() for k, v in lane_vars.items()
                 if k in self.model.stat_names}
        arch = {k: lane_vars[k].detach().clone() for k in ARCH}
        weights = {k: v.detach().clone() for k, v in lane_vars.items()
                   if k not in stats and k not in arch}
        carry = {"params": weights, "arch": arch, "stats": stats,
                 "w_opt": self.w_opt.init(weights, (lanes,)),
                 "a_opt": self.a_opt.init(arch, (lanes,))}
        carry = G.run_steps(self.programs, lanes, self._graph_step, carry,
                            {}, (x, y), batches)
        merged = {**carry["params"], **carry["arch"], **carry["stats"]}
        return {k: merged[k] for k in lane_vars}


class FedNASState(NamedTuple):
    variables: Params  # weights, alphas and statistics
    round: int


class FedNASSim(ClientSim):
    """Federated first-order DARTS on ``model`` (a
    :class:`~fedml_tpu_torch.models.darts.DARTSNetwork`). The hooks are
    :class:`ClientSim`'s: ``sampler(round, num_clients,
    clients_per_round)`` and ``batch_orders(round, client)`` (a client's
    epoch orders, real samples first). ``last_steps`` counts the last
    round's group-steps."""

    def __init__(self, model: FedModel, data: FederatedData,
                 cfg: ExperimentConfig, device: str | torch.device = "cuda",
                 arch_lr: float = ARCH_LR, sampler: Callable | None = None,
                 batch_orders: Callable | None = None):
        super().__init__({"model": model}, data, cfg, device, sampler,
                         batch_orders, None, {"dropout": cfg.seed})
        missing = [k for k in ARCH if k not in dict(
            model.module.named_parameters())]
        if missing:
            raise ValueError(f"FedNAS needs a model with alphas: {missing}")
        self.model = model
        # each half of a client's data holds at least one batch
        self.batch_size = max(1, min(self.batch_size, self.max_n // 2))
        self.half_steps = max(1, (self.max_n // 2) // self.batch_size)
        self.update = NASUpdate(model, cfg.train, arch_lr, self.batch_size,
                                self.graphed)
        self.evaluator = build_evaluator(model, self.task, EVAL_BATCH)
        self.last_steps = 0

    def init(self) -> FedNASState:
        return FedNASState(self.model.init(R.generator(self.cfg.seed, INIT)),
                           0)

    def _nas_steps(self, counts: np.ndarray) -> int:
        """A group's steps an epoch: past ``ceil(ceil(n_k / 2) / B)`` both
        halves of every lane are padding."""
        real = -(-int(np.max(counts)) // 2)
        return min(-(-real // self.batch_size), self.half_steps)

    def run_round(self, state: FedNASState):
        r = state.round
        cohort = self._cohort(r)
        lanes = len(cohort)
        start = {k: v.detach().expand(lanes, *v.shape).clone()
                 for k, v in state.variables.items()}
        self.last_steps = 0

        def run_group(ids_g, steps, hosts_g, orders_g, vars_g):
            idx, mask = self._rows(ids_g)
            steps = self._nas_steps(self._host_counts[hosts_g])
            self.last_groups[-1] = (len(hosts_g), steps)
            self.last_steps += self.update.epochs * steps
            return (self.update(vars_g, idx, mask, self.arrays.x,
                                self.arrays.y, orders_g, steps),
                    mask.sum(1))

        orders = self._stack_orders(cohort, lambda c: self.batch_orders(r, c))
        stacked, n_k = self._grouped(run_group, cohort, (orders, start))
        return FedNASState(T.tree_weighted_mean(stacked, n_k), r + 1), {}

    def evaluate(self, state: FedNASState) -> dict:
        """Test accuracy at batch 64, the last batch padded."""
        m = self.evaluator(state.variables, self.arrays.test_x,
                           self.arrays.test_y)
        return {"test_acc": float(m["acc"])}
