"""Decentralized (serverless) FL: DSGD and push-sum gossip, and
decentralized online learning on a stream
(``fedml_tpu.algorithms.decentralized``).

Every client's variables live stacked ``[N, ...]``; a gossip round is
local SGD on each client's own data from its own variables (one cohort
of N lanes, ``CohortUpdate(starts=)``, size-sorted groups of lanes, one
CUDA graph replay a group-step on the card), then the mixing: per leaf
``theta' = W @ theta``, one ``[N, N] x [N, P]`` product (every leaf,
BatchNorm statistics included). DSGD mixes with the row-stochastic
``W``; push-sum with ``P = W / colsum(W)`` and carries the scalar
weights ``w`` mixed by the same matrix, training the de-biased ``theta /
w``. The float32 products need TF32 off on the card for parity with the
CPU (torch's default).

:class:`OnlineDecentralizedSim` is the reference's DOL setting: a binary
logistic model a node, one sample a node an iteration, the loss at the
current estimate, a step, a mixing; the regret is the running mean loss.
On the card one iteration is one CUDA graph replay (the stream, the
topology stack and the loss rows stay on the device, the iteration's
index the replay's one input).
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
from fedml_tpu_torch.algorithms.graphs import GraphedStep
from fedml_tpu_torch.algorithms.hierarchical import INIT
from fedml_tpu_torch.config import ExperimentConfig
from fedml_tpu_torch.core import random as R
from fedml_tpu_torch.core.device import resolve_device, to_device
from fedml_tpu_torch.core.topology import SymmetricTopologyManager
from fedml_tpu_torch.data.federated import FederatedData
from fedml_tpu_torch.models.base import FedModel, Params

METHODS = ("dsgd", "pushsum")


class DecentralizedState(NamedTuple):
    stacked_vars: Params  # [N, ...] every client's variables
    push_weights: torch.Tensor  # [N] push-sum's scalar weights
    round: int


def _rows(w: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """``w`` [N] shaped to scale ``leaf``'s rows."""
    return w.reshape((-1,) + (1,) * (leaf.dim() - 1))


def mix(matrix: torch.Tensor, stacked: Params) -> Params:
    """The gossip step: every leaf's ``[N, ...]`` rows replaced by
    ``matrix @ rows``, one product a leaf."""
    n = matrix.shape[0]
    return {k: (matrix @ v.reshape(n, -1)).reshape(v.shape)
            for k, v in stacked.items()}


class DecentralizedSim(ClientSim):
    """DSGD or push-sum (``method``) over a fixed mixing topology (by
    default the ring with 2 neighbours). ``batch_orders(round, client)``
    and ``draws`` are :class:`ClientSim`'s hooks; every client trains
    every round."""

    def __init__(self, model: FedModel, data: FederatedData,
                 cfg: ExperimentConfig, device: str | torch.device = "cuda",
                 topology: SymmetricTopologyManager | None = None,
                 method: str = "dsgd",
                 batch_orders: Callable | None = None,
                 draws: R.Draws | None = None):
        if method not in METHODS:
            raise ValueError(f"method {method!r} is not one of {METHODS}")
        super().__init__({"model": model}, data, cfg, device, None,
                         batch_orders, draws, {"dropout": cfg.seed},
                         p={"dropout": model.mask_keep})
        self.model = model
        self.method = method
        n = self.arrays.num_clients
        topology = topology or SymmetricTopologyManager(n, neighbor_num=2)
        self.W = torch.tensor(topology.mixing_matrix(), dtype=torch.float32,
                              device=self.device)
        # push-sum mixes with a column-stochastic matrix, so sum(w) is
        # kept and w tracks the stationary bias
        self.P = self.W / torch.clamp(self.W.sum(0, keepdim=True),
                                      min=1e-12)
        self.cohort_update = CohortUpdate(model, self.task, cfg.train,
                                          self.batch_size, self.graphed)
        self.evaluator = build_evaluator(model, self.task)

    def init(self) -> DecentralizedState:
        n = self.arrays.num_clients
        variables = self.model.init(R.generator(self.cfg.seed, INIT))
        stacked = {k: v.expand(n, *v.shape).clone()
                   for k, v in variables.items()}
        return DecentralizedState(stacked, torch.ones(n, device=self.device),
                                  0)

    def run_round(self, state: DecentralizedState):
        """Local training of every client, then one mixing; returns the
        new state and the round's train loss and accuracy."""
        n = self.arrays.num_clients
        w = state.push_weights
        z = state.stacked_vars
        if self.method == "pushsum":
            # SGP: train the de-biased estimate z = x / w, re-bias after
            z = {k: v * _rows(1.0 / torch.clamp(w, min=1e-8), v)
                 for k, v in z.items()}
        hosts = np.arange(n)
        new_z, _, msums = self._train_lanes(
            self.cohort_update, self.model, hosts, z,
            self._stack_orders(hosts, lambda c: self.batch_orders(
                state.round, c)), state.round)
        if self.method == "pushsum":
            biased = {k: v * _rows(w, v) for k, v in new_z.items()}
            new_w, matrix = self.P @ w, self.P
        else:
            biased, new_w, matrix = new_z, w, self.W
        fin = finalize_sums({k: v.sum() for k, v in msums.items()})
        return (DecentralizedState(mix(matrix, biased), new_w,
                                   state.round + 1),
                {"train_loss": fin["loss"], "train_acc": fin["acc"]})

    def _debiased(self, state: DecentralizedState) -> Params:
        w = torch.clamp(state.push_weights, min=1e-8)
        return {k: v / _rows(w, v) for k, v in state.stacked_vars.items()}

    def evaluate_consensus(self, state: DecentralizedState) -> dict:
        """The clients' mean (de-biased) model on the test set."""
        avg = {k: v.mean(0) for k, v in self._debiased(state).items()}
        m = self.evaluator(avg, self.arrays.test_x, self.arrays.test_y)
        return {k: float(v) for k, v in m.items()}

    def consensus_distance(self, state: DecentralizedState) -> float:
        """The clients' mean squared distance from their mean model, every
        variable counted."""
        est = self._debiased(state)
        total = sum(torch.sum((v - v.mean(0)[None]) ** 2)
                    for v in est.values())
        return float(total / state.push_weights.shape[0])


def _bce(params, xi, yi):
    """One node's binary cross-entropy at its logistic model, the stable
    logit form (the JAX package's). ``max(logit, 0)`` is a ``where``: its
    derivative at 0 is 0, as ``jnp.maximum``'s is (``torch.maximum``
    splits a tie's gradient in halves), and every node's first logit is
    exactly 0."""
    w, b = params
    logit = xi @ w + b
    return (torch.where(logit > 0, logit, torch.zeros_like(logit))
            - logit * yi + torch.log1p(torch.exp(-torch.abs(logit))))


class OnlineDecentralizedSim:
    """Decentralized online learning on ``stream_x`` [N, T, d] and
    ``stream_y`` [N, T] in {0, 1} with cumulative regret: at iteration t
    each node takes the gradient of its loss on its t-th sample at its
    estimate z, steps (push-sum on its re-biased mass), and the nodes mix
    with the topology's matrix (push-sum: also the mass omega, z = x /
    omega). ``time_varying`` draws a new topology an iteration (a ring of
    2 neighbours with ``max(2, n // 4)`` extra links, seeded ``seed +
    t``), built on the host as a ``[T, N, N]`` stack. The stream, the
    stack and the ``[T, N]`` losses live on ``device``."""

    # sink-logging cadence; the harness sets it from fed.eval_every
    log_every: int = 10

    def __init__(self, stream_x, stream_y, method: str = "dsgd",
                 topology: SymmetricTopologyManager | None = None,
                 lr: float = 0.1, weight_decay: float = 0.0,
                 time_varying: bool = False, seed: int = 0,
                 device: str | torch.device = "cuda"):
        if method not in METHODS:
            raise ValueError(f"method {method!r} is not one of {METHODS}")
        self.method = method
        self.lr = lr
        self.wd = weight_decay
        self.device = resolve_device(device)
        xs = np.asarray(stream_x, np.float32)
        ys = np.asarray(stream_y, np.float32)
        n, t = ys.shape
        self.n, self.t = n, t
        if time_varying:
            mats = np.stack([SymmetricTopologyManager(
                n, neighbor_num=2, extra_links=max(2, n // 4),
                seed=seed + it).mixing_matrix() for it in range(t)])
        else:
            topo = topology or SymmetricTopologyManager(n, neighbor_num=2,
                                                        seed=seed)
            mats = np.broadcast_to(topo.mixing_matrix()[None], (t, n, n))
        W = torch.tensor(np.ascontiguousarray(mats), dtype=torch.float32)
        if method == "pushsum":
            # column-stochastic per matrix: matrix t's column sums are the
            # reduction over axis 1 of the [T, N, N] stack
            W = W / torch.clamp(W.sum(1, keepdim=True), min=1e-12)
        self.W = to_device(W, self.device)
        self.x = to_device(torch.from_numpy(
            np.ascontiguousarray(xs.swapaxes(0, 1))), self.device)
        self.y = to_device(torch.from_numpy(
            np.ascontiguousarray(ys.swapaxes(0, 1))), self.device)
        self._grad = torch.func.vmap(torch.func.grad_and_value(_bce))
        # every run writes each row; the graph reads this same buffer
        self.losses = torch.zeros(t, n, device=self.device)
        # the program of one iteration: a CUDA graph on the card
        self.graph = (GraphedStep(self._step) if self.device.type == "cuda"
                      else None)

    def _step(self, carry, consts, fixed, inputs):
        """Iteration ``inputs[0]`` (a one-element index tensor) from the
        carry ``(z_w, z_b, omega)``; writes the iteration's losses into
        row t of the losses buffer (``fixed[3]``)."""
        z_w, z_b, omega = carry
        x, y, W, losses = fixed
        (t,) = inputs
        xi, yi = x.index_select(0, t)[0], y.index_select(0, t)[0]
        wt = W.index_select(0, t)[0]
        (g_w, g_b), loss = self._grad((z_w, z_b), xi, yi)
        if self.wd > 0:
            g_w = g_w + self.wd * z_w
        if self.method == "dsgd":
            x_w = z_w - self.lr * g_w
            x_b = z_b - self.lr * g_b
        else:
            x_w = z_w * omega[:, None] - self.lr * g_w * omega[:, None]
            x_b = z_b * omega - self.lr * g_b * omega
        x_w = wt @ x_w
        x_b = wt @ x_b
        if self.method == "pushsum":
            omega = wt @ omega
            z_w = x_w / torch.clamp(omega[:, None], min=1e-8)
            z_b = x_b / torch.clamp(omega, min=1e-8)
        else:
            z_w, z_b = x_w, x_b
        losses.index_copy_(0, t, loss[None])
        return z_w, z_b, omega

    def run(self, metrics_sink=None, log_every: int | None = None) -> dict:
        """The whole stream: returns ``losses`` [T, N], the running mean
        regret ``regret`` [T] (``sum_{s <= t} sum_i loss / (N (t + 1))``),
        the final ``params`` ``(z_w, z_b)`` and ``final_regret``. With a
        ``metrics_sink`` the regret is logged every ``log_every``
        iterations, then once more with ``final_regret``."""
        n, t, d = self.n, self.t, self.x.shape[-1]
        dev = self.device
        carry = (torch.zeros(n, d, device=dev), torch.zeros(n, device=dev),
                 torch.ones(n, device=dev))
        fixed = (self.x, self.y, self.W, self.losses)
        steps = [(i,) for i in torch.arange(t, device=dev).split(1)]
        if self.graph is not None:
            carry = self.graph.run(carry, (), fixed, steps)
        else:
            for inputs in steps:
                carry = self._step(carry, (), fixed, inputs)
        z_w, z_b, _ = carry
        losses = self.losses.clone()
        per_iter = losses.sum(1)
        regret = torch.cumsum(per_iter, 0) / (
            n * torch.arange(1, t + 1, device=dev))
        r_host = regret.cpu().numpy()
        out = {"losses": losses, "regret": regret, "params": (z_w, z_b),
               "final_regret": float(r_host[-1])}
        if metrics_sink is not None:
            every = max(1, int(self.log_every if log_every is None
                               else log_every))
            for it in range(every - 1, t - 1, every):
                metrics_sink.log({"round": it, "regret": float(r_host[it])})
            metrics_sink.log({"round": t - 1, "regret": float(r_host[-1]),
                              "final_regret": float(r_host[-1])})
        return out
