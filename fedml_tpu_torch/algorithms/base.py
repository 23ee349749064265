"""Task definitions, optimizers, the client local update and the evaluator.

Padding discipline, as in the JAX package: every client's index row is
padded to ``max_n``, and each epoch's batch order puts the real samples
first (:func:`fedml_tpu_torch.core.random.padded_perm`), so a client takes
exactly ``ceil(n_k / B)`` optimizer steps per epoch; the trailing batches
hold only padding and leave the parameters and the optimizer state as
they are, which is the JAX package's gated no-op step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

from fedml_tpu_torch.config import TrainConfig
from fedml_tpu_torch.core import tree as T
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


def zero_sums(device: torch.device | str = "cpu") -> dict:
    return {k: torch.zeros((), device=device)
            for k in ("loss_sum", "correct", "count", "w_sum")}


def finalize_sums(sums: dict) -> dict:
    """Reduced metric sums to {loss, acc}; the clamps apply once, after
    the final reduction."""
    return {
        "loss": sums["loss_sum"] / torch.clamp(sums["w_sum"], min=1.0),
        "acc": sums["correct"] / torch.clamp(sums["count"], min=1.0),
    }


def _classification_sums(logits, y, w):
    ce = F.cross_entropy(logits.float(), y.long(), reduction="none")
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
        logits.float().reshape(b * t, v), y.reshape(-1).long(),
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


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``kind`` "sgd": clip -> add weight decay -> momentum trace ->
    scale by -lr (``optax.chain(clip_by_global_norm, add_decayed_weights,
    sgd)``); ``kind`` "adam": clip -> adam moments with bias correction ->
    add weight decay -> scale by -lr (``optax.adamw``)."""

    kind: str
    lr: float
    momentum: float = 0.0
    weight_decay: float = 0.0
    clip_norm: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Params) -> dict:
        if self.kind == "adam":
            return {"mu": T.tree_zeros_like(params),
                    "nu": T.tree_zeros_like(params), "count": 0}
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
        if self.kind == "adam":
            count = state["count"] + 1
            mu = {k: (1 - self.b1) * g[k] + self.b1 * state["mu"][k]
                  for k in g}
            nu = {k: (1 - self.b2) * g[k] ** 2 + self.b2 * state["nu"][k]
                  for k in g}
            # bias corrections in float32, as optax computes them
            c = torch.tensor(float(count))
            bc1 = 1 - torch.tensor(self.b1) ** c
            bc2 = 1 - torch.tensor(self.b2) ** c
            u = {k: (mu[k] / bc1.to(mu[k].device))
                 / (torch.sqrt(nu[k] / bc2.to(nu[k].device)) + self.eps)
                 for k in g}
            u = {k: u[k] + self.weight_decay * params[k] for k in u}
            new_state = {"mu": mu, "nu": nu, "count": count}
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
# Local update (the client loop)
# ---------------------------------------------------------------------------


def build_local_update(model: FedModel, task: Task, cfg: TrainConfig,
                       batch_size: int, max_n: int):
    """Build ``local_update(global_params, idx_row, mask_row, x, y,
    orders) -> (params, n_k, metric sums)``: ``cfg.epochs`` passes of
    minibatch training over the client's padded data, epoch ``e`` in the
    batch order ``orders[e]`` (a ``[max_n]`` index tensor with the real
    samples first, from :func:`fedml_tpu_torch.core.random.padded_perm`
    or replayed from the JAX package)."""
    if max_n % batch_size:
        raise ValueError(f"max_n {max_n} is not a multiple of the batch "
                         f"size {batch_size}")
    steps_per_epoch = max_n // batch_size
    opt = make_client_optimizer(cfg)

    def loss_fn(params, x_b, y_b, w_b, global_params):
        """Weighted-sum loss over the batch's weight total, so masked
        samples add nothing; plus the FedProx term."""
        logits, _ = model.apply_train(params, x_b)
        sums = task.metric_sums(logits, y_b, w_b)
        loss = sums["loss_sum"] / torch.clamp(sums["w_sum"], min=1.0)
        if cfg.prox_mu > 0:
            diff = T.tree_sub(params, global_params)
            loss = loss + 0.5 * cfg.prox_mu * T.tree_dot(diff, diff)
        return loss, sums

    def local_update(global_params, idx_row, mask_row, x, y, orders):
        n_k = torch.sum(mask_row)
        # real samples come first, so only these steps hold any
        steps = min(math.ceil(float(n_k) / batch_size), steps_per_epoch)
        params = {k: v.detach() for k, v in global_params.items()}
        opt_state = opt.init(params)
        msums = zero_sums(mask_row.device)
        for order in orders[:cfg.epochs]:
            for step in range(steps):
                take = order[step * batch_size:(step + 1) * batch_size]
                b_idx = idx_row[take].long()
                w_b = mask_row[take]
                live = {k: v.requires_grad_(True) for k, v in params.items()}
                loss, sums = loss_fn(live, x[b_idx], y[b_idx], w_b,
                                     global_params)
                grads = torch.autograd.grad(loss, list(live.values()))
                grads = dict(zip(live.keys(), grads))
                with torch.no_grad():
                    updates, opt_state = opt.update(grads, opt_state, params)
                    params = apply_updates(params, updates)
                msums = {k: msums[k] + sums[k].detach() for k in msums}
        return params, n_k, msums

    return local_update


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


def build_evaluator(model: FedModel, task: Task, eval_batch: int = 256):
    """Global-test evaluation: pad to a multiple of ``eval_batch`` with
    zero-weight rows, run the batches, reduce the metric sums."""

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
