"""Task definitions, optimizers, the client local update and the evaluator.

Padding discipline, as in the JAX package: every client's index row is
padded to ``max_n``, and each epoch's batch order puts the real samples
first (:func:`fedml_tpu_torch.core.random.padded_perm`), so a client's
real data fills its first ``ceil(n_k / B)`` batches of an epoch. The
local step is gated: a batch whose loss weights sum to 0 (all padding)
leaves the parameters, the statistics and the optimizer state exactly as
they were, so a client can take more steps than it has real batches, as
a small client does in a group with a larger one. A partial last batch
still holds padded rows (the client's own first sample): they carry no
loss weight but enter BatchNorm's batch statistics, as in the JAX
package, whose BatchNorm is not masked either.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from fedml_tpu_torch.algorithms.graphs import GraphedStep
from fedml_tpu_torch.config import TrainConfig
from fedml_tpu_torch.core import tree as T
from fedml_tpu_torch.core.elastic import CompiledRoundCache
from fedml_tpu_torch.models.base import FedModel, Params


# ---------------------------------------------------------------------------
# Tasks (loss + metrics)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Task:
    """``metric_sums(logits, y, w)`` returns additive sums: ``loss_sum``
    (weighted loss numerator), ``w_sum`` (its denominator), ``correct`` /
    ``count`` (accuracy numerator / denominator). Reduce sums over
    batches and clients first, then call :func:`finalize_sums`."""

    name: str
    metric_sums: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], dict]


def zero_sums(device: torch.device | str = "cpu", shape=()) -> dict:
    return {k: torch.zeros(shape, device=device)
            for k in ("loss_sum", "correct", "count", "w_sum")}


def finalize_sums(sums: dict) -> dict:
    """Reduced metric sums to {loss, acc}; the clamps apply once, after
    the final reduction."""
    return {
        "loss": sums["loss_sum"] / torch.clamp(sums["w_sum"], min=1.0),
        "acc": sums["correct"] / torch.clamp(sums["count"], min=1.0),
    }


def _classification_sums(logits, y, w):
    ce = F.cross_entropy(T.wide(logits), y.long(), reduction="none")
    correct = (logits.argmax(-1) == y).float()
    return {
        "loss_sum": torch.sum(ce * w),
        "correct": torch.sum(correct * w),
        "count": torch.sum(w),
        "w_sum": torch.sum(w),
    }


def _nwp_sums(logits, y, w):
    """Next-token prediction: logits [B, T, V], y [B, T]; token-level
    accuracy."""
    b, t, v = logits.shape
    ce = F.cross_entropy(
        T.wide(logits).reshape(b * t, v), y.reshape(-1).long(),
        reduction="none",
    ).reshape(b, t)
    correct = (logits.argmax(-1) == y).float()
    tokens = torch.sum(w) * t
    return {
        "loss_sum": torch.sum(ce * w[:, None]),
        "correct": torch.sum(correct * w[:, None]),
        "count": tokens,
        "w_sum": tokens,
    }


_TASKS = {"classification": _classification_sums, "nwp": _nwp_sums}


def make_task(name: str) -> Task:
    if name not in _TASKS:
        raise ValueError(f"task {name!r} is not ported to fedml_tpu_torch "
                         f"yet (available: {sorted(_TASKS)})")
    return Task(name, _TASKS[name])


# ---------------------------------------------------------------------------
# Optimizers (optax's update order, on dicts of tensors)
# ---------------------------------------------------------------------------


# the accumulators' starting values of optax.adagrad (scale_by_rss) and
# optax.yogi (scale_by_yogi, both moments)
ADAGRAD_INITIAL_ACCUMULATOR = 0.1
YOGI_INITIAL_ACCUMULATOR = 1e-6


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """optax's transformations, on dicts of tensors. Each ends by scaling
    by -lr.

    - "sgd": clip -> add weight decay -> momentum trace
      (``optax.chain(clip_by_global_norm, add_decayed_weights, sgd)``).
    - "adam": clip -> adam moments with bias correction -> add weight
      decay (``optax.adamw``; with weight decay 0 it is ``optax.adam``).
    - "adagrad": ``optax.adagrad``: the sum of squares starts at
      ``ADAGRAD_INITIAL_ACCUMULATOR``, the update is ``g * rsqrt(sum +
      eps)`` (eps inside the root; 0 where the sum is 0). Use eps 1e-7.
    - "yogi": ``optax.yogi``: both moments start at
      ``YOGI_INITIAL_ACCUMULATOR``; ``nu <- nu - (1 - b2) * sign(nu - g^2)
      * g^2``; adam's bias correction and ``mu / (sqrt(nu) + eps)``. Use
      eps 1e-3.

    The server optimizers are these with no clip and no weight decay."""

    kind: str
    lr: float
    momentum: float = 0.0
    weight_decay: float = 0.0
    clip_norm: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Params, batch_shape=()) -> dict:
        """Fresh state for ``params``; ``batch_shape`` is the leading shape
        of stacked params (``(G,)`` for G clients), which the step count
        of adam and yogi takes. The state is all tensors, so a gate can
        select it and vmap can batch it."""
        def full(value):
            return {k: torch.full_like(v, value) for k, v in params.items()}

        if self.kind in ("adam", "yogi"):
            device = next(iter(params.values())).device
            start = 0.0 if self.kind == "adam" else YOGI_INITIAL_ACCUMULATOR
            return {"mu": full(start), "nu": full(start),
                    "count": torch.zeros(batch_shape, device=device)}
        if self.kind == "adagrad":
            return {"sum_of_squares": full(ADAGRAD_INITIAL_ACCUMULATOR)}
        if self.momentum:
            return {"trace": T.tree_zeros_like(params)}
        return {}

    def update(self, grads: Params, state: dict, params: Params):
        """Returns (updates, new_state); apply with :func:`apply_updates`."""
        g = grads
        if self.clip_norm > 0:
            g_norm = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
            clipped = {k: (x / g_norm) * self.clip_norm for k, x in g.items()}
            keep = g_norm < self.clip_norm
            g = {k: torch.where(keep, g[k], clipped[k]) for k in g}
        if self.kind in ("adam", "yogi"):
            count = state["count"] + 1
            mu = {k: (1 - self.b1) * g[k] + self.b1 * state["mu"][k]
                  for k in g}
            if self.kind == "adam":
                nu = {k: (1 - self.b2) * g[k] ** 2 + self.b2 * state["nu"][k]
                      for k in g}
            else:
                nu = {k: v - (1 - self.b2) * torch.sign(v - g[k] ** 2)
                      * g[k] ** 2 for k, v in state["nu"].items()}
            # bias corrections in float32, as optax computes them; made
            # on the count's device, so a step creates no host tensor
            bc1 = 1 - torch.full_like(count, self.b1) ** count
            bc2 = 1 - torch.full_like(count, self.b2) ** count
            u = {k: (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps)
                 for k in g}
            u = {k: u[k] + self.weight_decay * params[k] for k in u}
            new_state = {"mu": mu, "nu": nu, "count": count}
        elif self.kind == "adagrad":
            sums = {k: g[k] ** 2 + state["sum_of_squares"][k] for k in g}
            u = {k: torch.where(sums[k] > 0, torch.rsqrt(sums[k] + self.eps),
                                0.0) * g[k] for k in g}
            new_state = {"sum_of_squares": sums}
        elif self.kind == "sgd":
            if self.weight_decay > 0:
                g = {k: g[k] + self.weight_decay * params[k] for k in g}
            if self.momentum:
                u = {k: g[k] + self.momentum * state["trace"][k] for k in g}
                new_state = {"trace": u}
            else:
                u, new_state = g, state
        else:
            raise ValueError(f"unknown optimizer: {self.kind}")
        return {k: x * (-self.lr) for k, x in u.items()}, new_state


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: params[k] + updates[k] for k in params}


def make_client_optimizer(cfg: TrainConfig) -> Optimizer:
    """Client optimizers: SGD (momentum, weight decay) or AdamW, each with
    an optional global-norm clip."""
    if cfg.optimizer not in ("sgd", "adam"):
        raise ValueError(f"unknown client optimizer: {cfg.optimizer}")
    return Optimizer(cfg.optimizer, cfg.lr, momentum=cfg.momentum,
                     weight_decay=cfg.weight_decay, clip_norm=cfg.clip_norm)


# ---------------------------------------------------------------------------
# Mixed precision and the local update (the client loop)
# ---------------------------------------------------------------------------


def compute_dtype(cfg: TrainConfig) -> torch.dtype:
    """``cfg.compute_dtype`` as a torch floating type."""
    dtype = getattr(torch, cfg.compute_dtype, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r} is not a "
                         "torch floating type")
    return dtype


def build_local_step(model: FedModel, task: Task, cfg: TrainConfig,
                     partition=None):
    """One client's local step as a function of tensors alone (the JAX
    package's ``step_body``). Returns ``(init_carry, step)``:

    - ``init_carry(global_vars, lanes=None, starts=None)``: the carry a
      client starts a round from: ``params`` and ``stats`` (the global
      model's), the optimizer's fresh state ``opt`` and zero metric
      ``sums``; with ``lanes``, stacked for that many clients on a leading
      axis. ``starts`` (``{name: [lanes, ...]}``) gives some parameters a
      start of each lane's own in place of the global one (a personalized
      client's private adapters).
    - ``step(carry, x_b, y_b, w_b, global_params) -> carry``: one
      minibatch ``x_b``/``y_b`` with loss weights ``w_b``.
      The gradient comes from ``torch.func.grad_and_value``, so the step
      composes with ``torch.func.vmap``. It is gated: where the batch's
      weight total is 0 the parameters, the statistics and the optimizer
      state keep their old values (``torch.where``, no branch); the
      metric sums add on every step.

    Only the parameters are differentiated and seen by the optimizer; the
    batch statistics (``model.stat_names``) are replaced after each step
    by the ones the train-mode forward returned. Under a
    ``compute_dtype`` other than float32 the parameters and inputs are
    cast to it at the loss boundary, the batch statistics stay float32,
    the logits and new statistics come back as float32, and the master
    parameters and the optimizer state stay float32 (the JAX package's
    policy); float64 stays float64 throughout (``compute_dtype="float64"``
    with float64 variables: a reference round).

    With ``partition`` (a :class:`~fedml_tpu_torch.peft.partition.
    ParamPartition`) only its trainable parameters are in the carry,
    differentiated and stepped; the frozen ones enter the forward from
    ``global_params``, one unbatched copy shared by every lane (the JAX
    package closes over the frozen base as a per-round constant). The
    FedProx term is the merged tree's: its frozen leaves add exact zeros,
    so it is summed over the trainable ones, against each lane's own
    start where ``starts`` gave one (the carry's ``anchor``)."""
    opt = make_client_optimizer(cfg)
    dtype = compute_dtype(cfg)
    stat_names = model.stat_names

    def loss_fn(params, stats, x_b, y_b, w_b, global_params, anchor):
        """Weighted-sum loss over the batch's weight total, so masked
        samples add nothing; plus the FedProx term. Returns the loss and,
        as aux, the metric sums and the new batch statistics."""
        full = params
        if partition is not None:
            full = partition.merge(params, partition.frozen(global_params))
        compute_params, x_c = full, x_b
        if dtype != torch.float32:
            compute_params = {k: v.to(dtype) for k, v in full.items()}
            # token inputs stay integer
            x_c = x_b.to(dtype) if torch.is_floating_point(x_b) else x_b
        logits, new_vars = model.apply_train({**compute_params, **stats},
                                             x_c)
        sums = task.metric_sums(T.wide(logits), y_b, w_b)
        loss = sums["loss_sum"] / torch.clamp(sums["w_sum"], min=1.0)
        if cfg.prox_mu > 0:
            ref = {k: anchor.get(k, global_params[k]) for k in params}
            diff = T.tree_sub(params, ref)
            loss = loss + 0.5 * cfg.prox_mu * T.tree_dot(diff, diff)
        return loss, (sums, {k: T.wide(new_vars[k]) for k in stat_names})

    grad_fn = torch.func.grad_and_value(loss_fn, has_aux=True)

    def init_carry(global_vars: Params, lanes: int | None = None,
                   starts: Params | None = None) -> dict:
        def start(v):
            v = v.detach()
            return v if lanes is None else v.expand(lanes, *v.shape).clone()

        starts = starts or {}
        params = {k: starts[k].detach().clone() if k in starts else start(v)
                  for k, v in global_vars.items()
                  if k not in stat_names
                  and (partition is None or partition.select(k))}
        shape = () if lanes is None else (lanes,)
        device = next(iter(params.values())).device
        carry = {"params": params,
                 "stats": {k: start(global_vars[k]) for k in stat_names},
                 "opt": opt.init(params, shape),
                 "sums": zero_sums(device, shape)}
        if cfg.prox_mu > 0 and starts:
            carry["anchor"] = {k: v.detach().clone()
                               for k, v in starts.items()}
        return carry

    def step(carry, x_b, y_b, w_b, global_params):
        params = carry["params"]
        grads, (_, (sums, stats)) = grad_fn(
            params, carry["stats"], x_b, y_b, w_b, global_params,
            carry.get("anchor", {}))
        updates, opt_state = opt.update(grads, carry["opt"], params)
        new = {"params": apply_updates(params, updates), "stats": stats,
               "opt": opt_state}
        valid = sums["w_sum"] > 0
        out = T.tree_map(lambda n, o: torch.where(valid, n, o), new,
                         {k: carry[k] for k in new})
        out["sums"] = {k: carry["sums"][k] + sums[k] for k in sums}
        if "anchor" in carry:
            out["anchor"] = carry["anchor"]
        return out

    return init_carry, step


def _finish(carry: dict, global_vars: Params) -> Params:
    """The trained variables in ``global_vars``' order: every variable,
    or under a partition the trainable parameters and the statistics."""
    new_vars = {**carry["params"], **carry["stats"]}
    return {k: new_vars[k] for k in global_vars if k in new_vars}


def build_local_update(model: FedModel, task: Task, cfg: TrainConfig,
                       batch_size: int, max_n: int, partition=None):
    """Build ``local_update(global_vars, idx_row, mask_row, x, y, orders,
    steps=None) -> (variables, n_k, metric sums)`` for one client:
    ``cfg.epochs`` passes of :func:`build_local_step`'s gated step over
    the client's padded data, epoch ``e`` in the batch order ``orders[e]``
    (a ``[max_n]`` index tensor with the real samples first, from
    :func:`fedml_tpu_torch.core.random.padded_perm` or replayed from the
    JAX package). ``steps`` is the host's count of steps per epoch; by
    default every batch of ``max_n`` is stepped, the trailing all-padding
    ones as gated no-ops, as the JAX package's scan does. With
    ``partition`` the client trains, and returns, only the trainable
    parameters (and the statistics); see :func:`build_local_step`."""
    if max_n % batch_size:
        raise ValueError(f"max_n {max_n} is not a multiple of the batch "
                         f"size {batch_size}")
    steps_per_epoch = max_n // batch_size
    init_carry, step = build_local_step(model, task, cfg, partition)
    stat_names = model.stat_names

    def local_update(global_vars, idx_row, mask_row, x, y, orders,
                     steps: int | None = None):
        global_params = {k: v for k, v in global_vars.items()
                         if k not in stat_names}
        carry = init_carry(global_vars)
        for order in orders[:cfg.epochs]:
            for s in range(steps_per_epoch if steps is None else steps):
                take = order[s * batch_size:(s + 1) * batch_size]
                b_idx = idx_row[take].long()
                carry = step(carry, x[b_idx], y[b_idx], mask_row[take],
                             global_params)
        return _finish(carry, global_vars), torch.sum(mask_row), \
            carry["sums"]

    return local_update


def lane_batches(idx_rows, mask_rows, orders, epochs: int, steps: int,
                 batch_size: int) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The batches of ``steps`` steps an epoch for ``epochs`` epochs of G
    lanes, epoch-major: each ``(b_idx [G, B] int64 rows of x/y, w_b [G, B]
    loss weights)``, lane ``g``'s epoch ``e`` taking its samples in the
    order ``orders[g, e]``."""
    lanes, b = idx_rows.shape[0], batch_size
    flat = orders[:, :epochs].reshape(lanes, -1)
    b_all = torch.gather(idx_rows, 1, flat).long().view(lanes, epochs, -1)
    w_all = torch.gather(mask_rows, 1, flat).view(lanes, epochs, -1)
    return [(b_all[:, e, s * b:(s + 1) * b], w_all[:, e, s * b:(s + 1) * b])
            for e in range(epochs) for s in range(steps)]


class CohortUpdate:
    """``cohort_update(global_vars, idx_rows, mask_rows, x, y, orders,
    steps, starts=None) -> (stacked variables, n_k, metric sums)``: the
    local update of
    :func:`build_local_update` for G clients at once, its step
    ``torch.func.vmap``-ped over lanes stacked on a leading axis, with the
    global variables and ``x``/``y`` shared by every lane (the JAX
    package's ``in_axes=(None, 0, 0, None, None, 0)``). ``idx_rows`` and
    ``mask_rows`` are ``[G, max_n]``, ``orders`` ``[G, epochs, max_n]``
    int64; ``steps`` is the host's count of steps per epoch (the group's
    largest client's real batches); a lane with fewer real batches steps
    on padding, a gated no-op. Under a ``partition`` only the trainable
    parameters are stacked per lane (the carry, the optimizer state and
    the result); the frozen ones are read from the one global copy, and
    ``starts`` (``{name: [G, ...]}``) gives lanes their own start for some
    trainable parameters (a personalized cohort's private adapters).

    With ``graphed`` (the card) each step is one replay of a CUDA graph
    (:class:`~fedml_tpu_torch.algorithms.graphs.GraphedStep`), captured
    at the first call for its lane count; that is the only path on the
    card. Without it (the CPU) the same vmapped step runs eagerly. The
    programs, one per lane count, live in :attr:`programs` (a
    :class:`~fedml_tpu_torch.core.elastic.CompiledRoundCache`), whose
    misses count the captures."""

    def __init__(self, model: FedModel, task: Task, cfg: TrainConfig,
                 batch_size: int, graphed: bool, partition=None):
        self.batch_size = batch_size
        self.epochs = cfg.epochs
        self.stat_names = model.stat_names
        self.graphed = graphed
        self.init_carry, step = build_local_step(model, task, cfg,
                                                 partition)
        self.vstep = torch.func.vmap(step, in_dims=(0, 0, 0, 0, None))
        self.programs = CompiledRoundCache(self._program)

    def _program(self, lanes: int) -> GraphedStep | None:
        """The program for ``lanes`` lanes: a CUDA graph of the step on
        the card, None on the CPU (the step runs eagerly)."""
        del lanes  # a graph takes its shapes from its first run
        if not self.graphed:
            return None
        return GraphedStep(lambda carry, gp, xy, batch: self.step(
            carry, *xy, *batch, gp))

    @property
    def graph(self) -> GraphedStep | None:
        """The CUDA graph of the lane count last run (None on the CPU
        and before the first step)."""
        return self.programs.last

    def step(self, carry, x, y, b_idx, w_b, global_params):
        """One vmapped step of every lane: lane ``g`` takes rows
        ``b_idx[g]`` of ``x``/``y`` with weights ``w_b[g]``."""
        return self.vstep(carry, x[b_idx], y[b_idx], w_b, global_params)

    def __call__(self, global_vars, idx_rows, mask_rows, x, y, orders,
                 steps: int, starts: Params | None = None):
        lanes = idx_rows.shape[0]
        batches = lane_batches(idx_rows, mask_rows, orders, self.epochs,
                               steps, self.batch_size)
        global_params = {k: v for k, v in global_vars.items()
                         if k not in self.stat_names}
        carry = self.init_carry(global_vars, lanes, starts)
        if batches:
            graph = self.programs(lanes)
            if graph is not None:
                carry = graph.run(carry, global_params, (x, y), batches)
            else:
                for batch in batches:
                    carry = self.step(carry, x, y, *batch, global_params)
        return _finish(carry, global_vars), mask_rows.sum(1), carry["sums"]


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


def build_evaluator(model: FedModel, task: Task, eval_batch: int = 256):
    """Global-test evaluation: pad to a multiple of ``eval_batch`` with
    zero-weight rows, run the batches in eval mode (BatchNorm on the
    running statistics) in the variables' own float32, reduce the metric
    sums."""

    @torch.no_grad()
    def evaluate(params, x, y):
        n = x.shape[0]
        pad = (-n) % eval_batch
        xp = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
        yp = torch.cat([y, y.new_zeros((pad,) + y.shape[1:])])
        w = torch.cat([torch.ones(n, device=x.device),
                       torch.zeros(pad, device=x.device)])
        sums = zero_sums(x.device)
        for i in range(0, n + pad, eval_batch):
            sl = slice(i, i + eval_batch)
            logits = model.apply_eval(params, xp[sl])
            s = task.metric_sums(logits, yp[sl], w[sl])
            sums = {k: sums[k] + s[k] for k in sums}
        return {**finalize_sums(sums), "count": sums["count"]}

    return evaluate
