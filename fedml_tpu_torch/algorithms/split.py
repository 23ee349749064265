"""Split-compute FL: FedGKT, SplitNN and classical vertical FL
(``fedml_tpu.algorithms.split``).

Activations, logits or features cross the client-server cut instead of
weights; in the simulator the cut is a handoff between separately
optimized parameter groups.

- **FedGKT**: every client trains its edge model on ``CE + alpha *
  KL_T(logits, server logits)`` (the KL off until the server has sent
  logits), size-sorted groups of lanes, one CUDA graph replay a
  group-step on the card (:class:`GKTEdgeUpdate`). The server then
  trains client by client and epoch by epoch on ``KL_T(out, client
  logits) + alpha * CE``, recomputing each batch's features from the
  frozen edge model in eval mode (no feature bank), its optimizer state
  kept across rounds, one replay a step (:class:`GKTServerUpdate`).
  Last, the server's per-sample logits go back to the clients through an
  ``[N_total + 1, K]`` bank (the padded rows to a scratch row).
- **SplitNN**: the clients train one after the other around a ring,
  each step a joint forward and backward through both stacks; the
  client's optimizer is fresh for each client and round, the server's
  persists around the ring and across rounds. One graph of the joint
  step, replayed around the ring (:class:`SplitUpdate`).
- **Vertical FL**: the parties hold column slices of one matrix; a step
  is one joint step on the BCE of the sum of their logit components.

The hooks replay the JAX package's draws: ``batch_orders(round,
client)`` (:class:`~fedml_tpu_torch.algorithms.client_sim.ClientSim`'s)
gives a client's epoch orders; FedGKT's ``server_orders(round, epoch,
client)`` the server's order of a client's samples in an epoch. The
defaults draw from generators seeded by the coordinates.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from fedml_tpu_torch.algorithms import gan_core as G
from fedml_tpu_torch.algorithms.base import (
    apply_updates,
    lane_batches,
    make_client_optimizer,
)
from fedml_tpu_torch.algorithms.client_sim import ClientSim
from fedml_tpu_torch.algorithms.distill import finish, lane_carry, lane_step
from fedml_tpu_torch.algorithms.fedavg import check_ported
from fedml_tpu_torch.algorithms.hierarchical import INIT
from fedml_tpu_torch.algorithms.kd import soft_target
from fedml_tpu_torch.algorithms.stack_utils import vmap_init
from fedml_tpu_torch.config import ExperimentConfig, TrainConfig
from fedml_tpu_torch.core import random as R
from fedml_tpu_torch.core import tree as T
from fedml_tpu_torch.core.device import resolve_device, to_device
from fedml_tpu_torch.data.federated import FederatedData
from fedml_tpu_torch.models.base import FedModel, Params

# the server orders' salt in their default seed
SERVER = 0x5EAF
# the composed path's evaluation batch
EVAL_BATCH = 256


@torch.no_grad()
def composed_accuracy(lower: Callable, upper: Callable, x: torch.Tensor,
                      y: torch.Tensor, batch: int = EVAL_BATCH) -> float:
    """The accuracy of ``upper(lower(x))`` in batches of ``batch``: one
    read back from the device."""
    correct = torch.zeros((), device=x.device)
    for s in range(0, x.shape[0], batch):
        out = upper(lower(x[s:s + batch]))
        correct += torch.sum(out.argmax(-1) == y[s:s + batch])
    return float(correct) / max(x.shape[0], 1)


# ---------------------------------------------------------------------------
# FedGKT
# ---------------------------------------------------------------------------


class GKTEdgeUpdate:
    """``update(lane_vars, bank, use_kd, idx_rows, mask_rows, x, y, orders,
    steps) -> lane_vars``: the edge training of G lanes, each from its own
    variables with a fresh client optimizer: ``epochs`` epochs of
    ``steps`` gated steps on ``CE + alpha * KL_T(logits, bank[rows])``,
    the KL weighted by ``use_kd`` (0 before the server has sent logits).
    One replay a group-step on the card (the bank and the weight are the
    graph's per-run constants)."""

    def __init__(self, model: FedModel, train_cfg: TrainConfig,
                 temperature: float, alpha: float, batch_size: int,
                 graphed: bool):
        self.model, self.T, self.alpha = model, temperature, alpha
        self.batch_size, self.epochs = batch_size, train_cfg.epochs
        self.opt = make_client_optimizer(train_cfg)
        self.grad = torch.func.grad_and_value(self._loss, has_aux=True)
        self.vstep = torch.func.vmap(self._lane_step,
                                     in_dims=(0, 0, 0, 0, 0, None))
        self.programs = G.graph_programs(graphed, self._graph_step,
                                         "gkt_edge")

    def _loss(self, params, stats, xb, yb, tb, wb, kd_w):
        (_, logits), new = self.model.apply_train({**params, **stats}, xb)
        loss = G.ce(logits, yb, wb) + kd_w * soft_target(logits, tb,
                                                         self.T, wb)
        return loss, ({k: new[k] for k in stats}, ())

    def _lane_step(self, carry, xb, yb, tb, wb, kd_w):
        return lane_step(self.opt, self.grad, carry,
                         (xb, yb, tb, wb, kd_w), valid=torch.sum(wb) > 0)[0]

    def _graph_step(self, carry, consts, fixed, batch):
        x, y = fixed
        b_idx, w_b = batch
        return self.vstep(carry, x[b_idx], y[b_idx],
                          consts["bank"][b_idx], w_b, consts["kd_w"])

    def __call__(self, lane_vars, bank, kd_w, idx_rows, mask_rows, x, y,
                 orders, steps: int) -> Params:
        lanes = idx_rows.shape[0]
        batches = lane_batches(idx_rows, mask_rows, orders, self.epochs,
                               steps, self.batch_size)
        carry = G.run_steps(self.programs, lanes, self._graph_step,
                            lane_carry(self.model, self.opt, lane_vars),
                            {"bank": bank, "kd_w": kd_w}, (x, y), batches)
        return finish(carry, lane_vars)


class GKTServerUpdate:
    """``update(carry, client_stack, x, y, steps) -> carry``: the server's
    sequential steps; each step ``(client [1], rows [B], weights [B])``
    recomputes the batch's features and teacher logits with the client's
    frozen edge model in eval mode, then steps the server on ``KL_T(out,
    teacher) + alpha * CE`` (gated where the weights are all 0). The
    carry is the server's ``params``, ``stats`` and ``opt``; the edge
    stack is the graph's per-run constant. One replay a step on the
    card."""

    def __init__(self, client: FedModel, server: FedModel,
                 train_cfg: TrainConfig, temperature: float, alpha: float,
                 graphed: bool):
        self.client, self.server = client, server
        self.T, self.alpha = temperature, alpha
        self.opt = make_client_optimizer(train_cfg)
        self.grad = torch.func.grad_and_value(self._loss, has_aux=True)
        self.programs = G.graph_programs(graphed, self._graph_step,
                                         "gkt_server")

    def _loss(self, params, stats, fb, yb, tb, wb):
        out, new = self.server.apply_train({**params, **stats}, fb)
        loss = (soft_target(out, tb, self.T, wb)
                + self.alpha * G.ce(out, yb, wb))
        return loss, ({k: new[k] for k in stats}, ())

    def _graph_step(self, carry, consts, fixed, batch):
        x, y = fixed
        c, b_idx, w_b = batch
        c_vars = {k: v.index_select(0, c)[0]
                  for k, v in consts["clients"].items()}
        with torch.no_grad():
            fb, tb = self.client.apply_eval(c_vars, x[b_idx])
        return lane_step(self.opt, self.grad, carry,
                         (fb, y[b_idx], tb, w_b),
                         valid=torch.sum(w_b) > 0)[0]

    def __call__(self, carry, client_stack, x, y, steps: Sequence):
        return G.run_steps(self.programs, 1, self._graph_step, carry,
                           {"clients": client_stack}, (x, y), steps)


class FedGKTState(NamedTuple):
    client_stack: Params  # [N, ...] the edge models
    server_vars: Params
    server_opt_state: dict  # the server optimizer's, kept across rounds
    server_logits: torch.Tensor  # [N_total, K] per-sample teacher logits
    has_server_logits: bool
    round: int


class FedGKTSim(ClientSim):
    """Group Knowledge Transfer: every client takes part every round.
    ``client_model`` returns ``(features, logits)`` of an input;
    ``server_model`` classifies the features. ``last_steps`` counts the
    last round's edge group-steps (``"edge"``) and the server's steps
    (``"server"``). With ``time_phases`` set, ``run_round`` synchronizes
    around each phase and writes its seconds into ``last_phase_s``
    (``"edge"``, ``"server"``, ``"logits"``)."""

    def __init__(self, client_model: FedModel, server_model: FedModel,
                 data: FederatedData, cfg: ExperimentConfig,
                 device: str | torch.device = "cuda",
                 temperature: float = 3.0, alpha: float = 1.0,
                 batch_orders: Callable | None = None,
                 server_orders: Callable | None = None):
        super().__init__({"edge model": client_model,
                          "server model": server_model}, data, cfg, device,
                         None, batch_orders, None, {"dropout": cfg.seed})
        self.client_model, self.server_model = client_model, server_model
        self.T, self.alpha = float(temperature), float(alpha)
        self.n_total = self.arrays.x.shape[0]
        self.num_classes = self.arrays.num_classes
        self.server_orders = server_orders or self._server_orders
        self.edge_update = GKTEdgeUpdate(client_model, cfg.train, self.T,
                                         self.alpha, self.batch_size,
                                         self.graphed)
        self.server_update = GKTServerUpdate(client_model, server_model,
                                             cfg.train, self.T, self.alpha,
                                             self.graphed)
        self.last_steps: dict[str, int] = {}
        self.time_phases = False
        self.last_phase_s: dict[str, float] = {}

    def _server_orders(self, round_idx, epoch, client):
        gen = R.generator(self.cfg.seed, round_idx, SERVER, epoch, client)
        return R.padded_perm(gen, self._host_mask[client], self.max_n)

    def init(self) -> FedGKTState:
        n = self.arrays.num_clients
        stack = vmap_init(self.client_model.init, n, self.cfg.seed, INIT, 0)
        server = self.server_model.init(R.generator(self.cfg.seed, INIT, 1))
        params = {k: v for k, v in server.items()
                  if k not in self.server_model.stat_names}
        return FedGKTState(
            stack, server, self.server_update.opt.init(params),
            torch.zeros(self.n_total, self.num_classes, device=self.device),
            False, 0)

    def run_round(self, state: FedGKTState):
        """The edge phase, the server phase, the logits back; no
        metrics, as in the JAX package."""
        self.last_steps, self.last_phase_s = {}, {}
        stack = self._phase("edge", self.edge_phase, state)
        server_vars, opt_state = self._phase("server", self.server_phase,
                                             state, stack)
        bank = self._phase("logits", self.logits_phase, stack, server_vars)
        return FedGKTState(stack, server_vars, opt_state, bank, True,
                           state.round + 1), {}

    def _phase(self, name: str, fn: Callable, *args):
        if not self.time_phases:
            return fn(*args)
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else lambda _: None)
        sync(self.device)
        t0 = time.perf_counter()
        out = fn(*args)
        sync(self.device)
        self.last_phase_s[name] = time.perf_counter() - t0
        return out

    def edge_phase(self, state: FedGKTState) -> Params:
        """Every client's edge training, in size-sorted groups of lanes;
        returns the new edge stack."""
        r = state.round
        hosts = np.arange(self.arrays.num_clients)
        kd_w = torch.full((), self.alpha if state.has_server_logits else 0.0,
                          device=self.device)

        def run_group(ids_g, steps, hosts_g, orders_g, vars_g):
            idx, mask = self._rows(ids_g)
            self.last_steps["edge"] = (self.last_steps.get("edge", 0)
                                       + self.edge_update.epochs * steps)
            return self.edge_update(vars_g, state.server_logits, kd_w, idx,
                                    mask, self.arrays.x, self.arrays.y,
                                    orders_g, steps)

        orders = self._stack_orders(hosts, lambda c: self.batch_orders(r, c))
        return self._grouped(run_group, hosts, (orders, state.client_stack))

    def server_phase(self, state: FedGKTState, stack: Params):
        """The server's steps, epoch by epoch and client by client, each
        client's real batches in its server order; returns the server's
        variables and optimizer state."""
        a, r, b = self.arrays, state.round, self.batch_size
        n = a.num_clients
        epochs = self.cfg.train.epochs
        orders = torch.stack([torch.stack([
            torch.as_tensor(self.server_orders(r, e, c)) for c in range(n)])
            for e in range(epochs)]).long()
        orders = to_device(orders, self.device)  # [epochs, N, max_n]
        clients = torch.arange(n, device=self.device)
        steps = []
        for e in range(epochs):
            b_all = torch.gather(a.idx, 1, orders[e]).long()
            w_all = torch.gather(a.mask, 1, orders[e])
            for c in range(n):
                for s in range(self._steps(self._host_counts[c:c + 1])):
                    sl = slice(s * b, (s + 1) * b)
                    steps.append((clients[c:c + 1], b_all[c, sl],
                                  w_all[c, sl]))
        self.last_steps["server"] = len(steps)
        params, stats = G.split_vars(state.server_vars,
                                     self.server_model.stat_names)
        carry = self.server_update(
            {"params": params, "stats": stats,
             "opt": state.server_opt_state}, stack, a.x, a.y, steps)
        return finish(carry, state.server_vars), carry["opt"]

    @torch.no_grad()
    def logits_phase(self, stack: Params, server_vars: Params
                     ) -> torch.Tensor:
        """The server's logits of every client's samples, through the
        client's edge features, into the ``[N_total, K]`` bank (padded
        rows to the scratch row ``N_total``, dropped)."""
        a = self.arrays
        dtype = next(iter(server_vars.values())).dtype
        bank = torch.zeros(self.n_total + 1, self.num_classes, dtype=dtype,
                           device=self.device)
        scratch = torch.full((), self.n_total, device=self.device,
                             dtype=torch.long)
        for c in range(a.num_clients):
            c_vars = {k: v[c] for k, v in stack.items()}
            for s in range(0, self.max_n, EVAL_BATCH):
                take = a.idx[c, s:s + EVAL_BATCH].long()
                fb, _ = self.client_model.apply_eval(c_vars, a.x[take])
                out = self.server_model.apply_eval(server_vars, fb)
                safe = torch.where(a.mask[c, s:s + EVAL_BATCH] > 0, take,
                                   scratch)
                bank[safe] = out
        return bank[:self.n_total]

    def evaluate(self, state: FedGKTState, client_idx: int = 0) -> dict:
        """The composed edge and server path of client ``client_idx`` on
        the test set, at batch 256."""
        c_vars = {k: v[client_idx] for k, v in state.client_stack.items()}
        acc = composed_accuracy(
            lambda x: self.client_model.apply_eval(c_vars, x)[0],
            lambda f: self.server_model.apply_eval(state.server_vars, f),
            self.arrays.test_x, self.arrays.test_y)
        return {"test_acc": acc}


# ---------------------------------------------------------------------------
# SplitNN
# ---------------------------------------------------------------------------


class SplitUpdate:
    """``update(carry, x, y, steps) -> carry``: one client's turn of the
    ring. A step ``(rows [B], weights [B])`` runs the joint forward
    through the client's and the server's stacks and the backward into
    both, steps each with its own optimizer (gated where the weights are
    all 0) and adds the loss (of valid steps), the weighted correct count
    and the weight total to the carry's sums. The carry is ``{"client":
    {"params", "opt"}, "server": {...}, "sums": ...}``. One replay a step
    on the card."""

    def __init__(self, client: FedModel, server: FedModel,
                 train_cfg: TrainConfig, graphed: bool):
        for m in (client, server):
            if m.stat_names:
                raise ValueError("SplitNN's stacks have no batch "
                                 "statistics in the JAX package")
        self.client, self.server = client, server
        self.opt = make_client_optimizer(train_cfg)
        self.grad = torch.func.grad_and_value(self._loss, argnums=(0, 1),
                                              has_aux=True)
        self.programs = G.graph_programs(graphed, self._graph_step,
                                         "splitnn_step")

    def _loss(self, c_params, s_params, xb, yb, wb):
        acts, _ = self.client.apply_train(c_params, xb)
        logits, _ = self.server.apply_train(s_params, acts)
        correct = torch.sum((logits.argmax(-1) == yb).float() * wb)
        return G.ce(logits, yb, wb), correct

    def _graph_step(self, carry, consts, fixed, batch):
        x, y = fixed
        b_idx, w_b = batch
        c, s = carry["client"], carry["server"]
        (cg, sg), (loss, correct) = self.grad(c["params"], s["params"],
                                              x[b_idx], y[b_idx], w_b)
        valid = torch.sum(w_b) > 0
        out = {}
        for name, part, g in (("client", c, cg), ("server", s, sg)):
            updates, opt = self.opt.update(g, part["opt"], part["params"])
            new = {"params": apply_updates(part["params"], updates),
                   "opt": opt}
            out[name] = T.tree_map(lambda n, o: torch.where(valid, n, o),
                                   new, part)
        sums = carry["sums"]
        out["sums"] = {
            "loss": sums["loss"] + torch.where(valid, loss,
                                               torch.zeros_like(loss)),
            "correct": sums["correct"] + correct,
            "n": sums["n"] + torch.sum(w_b)}
        return out

    def __call__(self, carry, x, y, steps: Sequence):
        return G.run_steps(self.programs, 1, self._graph_step, carry, {},
                           (x, y), steps)


class SplitNNState(NamedTuple):
    client_stack: Params  # [N, ...] the clients' lower stacks
    server_vars: Params
    server_opt_state: dict  # kept around the ring and across rounds
    round: int


class SplitNNSim(ClientSim):
    """The SplitNN ring: client by client, one epoch each over its real
    batches in its batch order. ``train_loss`` is the sum of the valid
    steps' losses over ``N * (max_n // B)``, counting the padding steps
    too, as in the JAX package; ``train_acc`` the weighted correct count
    over the real samples."""

    def __init__(self, client_model: FedModel, server_model: FedModel,
                 data: FederatedData, cfg: ExperimentConfig,
                 device: str | torch.device = "cuda",
                 batch_orders: Callable | None = None):
        super().__init__({"client model": client_model,
                          "server model": server_model}, data, cfg, device,
                         None, batch_orders, None, {"dropout": cfg.seed})
        self.client_model, self.server_model = client_model, server_model
        self.update = SplitUpdate(client_model, server_model, cfg.train,
                                  self.graphed)
        self.last_steps = 0

    def init(self) -> SplitNNState:
        stack = vmap_init(self.client_model.init, self.arrays.num_clients,
                          self.cfg.seed, INIT, 0)
        server = self.server_model.init(R.generator(self.cfg.seed, INIT, 1))
        return SplitNNState(stack, server, self.update.opt.init(server), 0)

    def run_round(self, state: SplitNNState):
        a, r, b = self.arrays, state.round, self.batch_size
        n = a.num_clients
        orders = to_device(torch.stack([
            torch.as_tensor(self.batch_orders(r, c)[0]) for c in range(n)
        ]).long(), self.device)
        b_all = torch.gather(a.idx, 1, orders).long()
        w_all = torch.gather(a.mask, 1, orders)
        zero = torch.zeros((), device=self.device)
        server = {"params": state.server_vars,
                  "opt": state.server_opt_state}
        sums = {"loss": zero, "correct": zero, "n": zero}
        stack = {k: v.clone() for k, v in state.client_stack.items()}
        self.last_steps = 0
        for c in range(n):
            params = {k: v[c] for k, v in stack.items()}
            steps = [(b_all[c, s * b:(s + 1) * b], w_all[c, s * b:(s + 1) * b])
                     for s in range(self._steps(self._host_counts[c:c + 1]))]
            self.last_steps += len(steps)
            carry = self.update(
                {"client": {"params": params,
                            "opt": self.update.opt.init(params)},
                 "server": server, "sums": sums}, a.x, a.y, steps)
            server, sums = carry["server"], carry["sums"]
            for k, v in carry["client"]["params"].items():
                stack[k][c] = v
        metrics = {"train_loss": sums["loss"] / (n * self.steps_per_epoch),
                   "train_acc": sums["correct"] / torch.clamp(sums["n"],
                                                              min=1.0)}
        return SplitNNState(stack, server["params"], server["opt"],
                            r + 1), metrics

    def evaluate(self, state: SplitNNState, client_idx: int = 0,
                 batch: int = EVAL_BATCH) -> dict:
        """The composed lower and upper stacks of client ``client_idx`` on
        the test set."""
        c_vars = {k: v[client_idx] for k, v in state.client_stack.items()}
        acc = composed_accuracy(
            lambda x: self.client_model.apply_eval(c_vars, x),
            lambda h: self.server_model.apply_eval(state.server_vars, h),
            self.arrays.test_x, self.arrays.test_y, batch)
        return {"test_acc": acc}


# ---------------------------------------------------------------------------
# Classical vertical FL
# ---------------------------------------------------------------------------


class VFLState(NamedTuple):
    party_vars: tuple  # per party (local model's, dense model's) variables
    opt_states: tuple  # per party (local, dense) optimizer states
    step: int


def sigmoid_bce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """optax's ``sigmoid_binary_cross_entropy``, per row."""
    return -y * F.logsigmoid(logits) - (1.0 - y) * F.logsigmoid(-logits)


class VFLSim:
    """Vertical (feature-partitioned) logistic FL: the guest (party 0)
    holds the labels; party ``p`` computes a logit component from its
    columns ``feature_splits[p]`` through its ``(local, dense)`` models;
    the loss is the mean BCE of the components' sum, and every party steps
    on the common gradient. An epoch's order is ``default_rng(step)
    .permutation(n)``, keyed by the step counter. Evaluation: accuracy at
    0.5 and the AUC by the rank formula (no tie handling)."""

    def __init__(self, party_models: Sequence[tuple[FedModel, FedModel]],
                 feature_splits: Sequence[tuple[int, int]],
                 x_train: np.ndarray, y_train: np.ndarray,
                 x_test: np.ndarray, y_test: np.ndarray,
                 cfg: ExperimentConfig, device: str | torch.device = "cuda"):
        if len(party_models) != len(feature_splits):
            raise ValueError("one (local, dense) pair of models a party")
        check_ported(cfg)
        self.device = resolve_device(device)
        self.party_models = list(party_models)
        self.splits = [tuple(s) for s in feature_splits]
        self.cfg = cfg

        def on(a):
            return to_device(torch.as_tensor(np.asarray(a, np.float32)),
                             self.device)

        self.x_train, self.y_train = on(x_train), on(y_train)
        self.x_test, self.y_test = on(x_test), on(y_test)
        self.batch_size = cfg.data.batch_size
        self.opt = make_client_optimizer(cfg.train)
        self.grad = torch.func.grad_and_value(self._loss)
        self.counters: dict[str, float] = {}

    def _slice(self, x: torch.Tensor, p: int) -> torch.Tensor:
        lo, hi = self.splits[p]
        return x[:, lo:hi]

    def _logit_sum(self, party_vars, x: torch.Tensor, train: bool):
        total = 0.0
        for p, (local_m, dense_m) in enumerate(self.party_models):
            lv, dv = party_vars[p]
            apply = ((lambda m, v, h: m.apply_train(v, h)[0]) if train
                     else (lambda m, v, h: m.apply_eval(v, h)))
            h = apply(local_m, lv, self._slice(x, p))
            total = total + apply(dense_m, dv, h)[:, 0]
        return total

    def init(self) -> VFLState:
        pv, os_ = [], []
        for p, (local_m, dense_m) in enumerate(self.party_models):
            lv = local_m.init(R.generator(self.cfg.seed, INIT, p, 0))
            dv = dense_m.init(R.generator(self.cfg.seed, INIT, p, 1))
            pv.append((lv, dv))
            os_.append((self.opt.init(lv), self.opt.init(dv)))
        return VFLState(tuple(pv), tuple(os_), 0)

    def _loss(self, party_vars, xb, yb):
        return torch.mean(sigmoid_bce(self._logit_sum(party_vars, xb, True),
                                      yb))

    def _step(self, state: VFLState, xb, yb):
        """One joint step: autodiff through the sum gives every party the
        guest's common gradient."""
        grads, loss = self.grad(state.party_vars, xb, yb)
        new_pv, new_os = [], []
        for p, (lv, dv) in enumerate(state.party_vars):
            (lo, do), (lg, dg) = state.opt_states[p], grads[p]
            lu, lo = self.opt.update(lg, lo, lv)
            du, do = self.opt.update(dg, do, dv)
            new_pv.append((apply_updates(lv, lu), apply_updates(dv, du)))
            new_os.append((lo, do))
        return VFLState(tuple(new_pv), tuple(new_os), state.step + 1), loss

    def run_round(self, state: VFLState):
        """One round is one epoch (the harness's protocol)."""
        state, loss = self.run_epoch(state)
        return state, {"train_loss": loss}

    def run_epoch(self, state: VFLState) -> tuple[VFLState, float]:
        """An epoch of joint steps over ``n // batch`` batches; returns
        the state and the mean of its steps' losses (one read back)."""
        n, bs = self.x_train.shape[0], self.batch_size
        perm = to_device(torch.from_numpy(
            np.random.default_rng(int(state.step)).permutation(n)),
            self.device)
        losses = []
        for s in range(n // bs):
            take = perm[s * bs:(s + 1) * bs]
            state, loss = self._step(state, self.x_train[take],
                                     self.y_train[take])
            losses.append(loss.detach())
        if not losses:
            return state, 0.0
        return state, float(torch.stack(losses).double().mean())

    @torch.no_grad()
    def predict(self, state: VFLState, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self._logit_sum(state.party_vars, x, False))

    def evaluate(self, state: VFLState) -> dict:
        probs = self.predict(state, self.x_test).cpu().numpy()
        y = self.y_test.cpu().numpy()
        acc = float(np.mean((probs > 0.5) == (y > 0.5)))
        order = np.argsort(probs)
        ranks = np.empty_like(order, dtype=np.float64)
        ranks[order] = np.arange(1, len(probs) + 1)
        pos = y > 0.5
        n_pos, n_neg = pos.sum(), (~pos).sum()
        auc = ((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
               if n_pos and n_neg else float("nan"))
        return {"test_acc": acc, "test_auc": float(auc)}
