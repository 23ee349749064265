"""FedAvg: sample a cohort, train each client locally, take the weighted
mean on the server, evaluate the global model.

The plain FedAvg path of ``fedml_tpu.algorithms.fedavg`` with the default
defense (weighted mean, no clip, no noise), the non-finite screen, global
momentum and the SGD server optimizer, in float32 or with a bf16 compute
type. The cohort runs as a Python loop over clients. Settings of the JAX
package that this package has not ported make :class:`FedAvgSim` raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from fedml_tpu_torch.algorithms.base import (
    Optimizer,
    apply_updates,
    build_evaluator,
    build_local_update,
    finalize_sums,
    make_task,
)
from fedml_tpu_torch.config import ExperimentConfig, FedConfig
from fedml_tpu_torch.core import random as R
from fedml_tpu_torch.core import robust
from fedml_tpu_torch.core import tree as T
from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.data.federated import FederatedData, arrays_and_batch
from fedml_tpu_torch.models.base import FedModel, Params

# (setting, its default, the ROADMAP item that ports it)
_NOT_PORTED = (
    ("fed.robust_method", "mean", "robust methods other than mean"),
    ("fed.robust_norm_clip", 0.0, "robust methods other than mean"),
    ("fed.robust_noise_stddev", 0.0, "robust methods other than mean"),
    ("fed.server_optimizer", "sgd", "the other server optimizers"),
    ("fed.elastic_buckets", False, "Slice 2 item 9 (core/elastic.py)"),
    ("fed.client_block_size", 0, "Slice 2 item 9 (core/bulk.py)"),
    ("fed.fuse_rounds", 1, "Slice 2 item 8 (core/fuse.py)"),
    ("fed.compress", "none", "Slice 2 item 10 (core/compress.py)"),
    ("fed.peft", "none", "Slice 3 item 15 (PEFT)"),
)


def check_ported(cfg: ExperimentConfig) -> None:
    """Raise ``NotImplementedError`` for a setting this package does not
    port yet, naming the ROADMAP item that will."""
    for path, default, item in _NOT_PORTED:
        section, field = path.split(".")
        value = getattr(getattr(cfg, section), field)
        if value != default:
            raise NotImplementedError(
                f"{path}={value!r} is not ported to fedml_tpu_torch yet "
                f"(ROADMAP: {item})"
            )
    if cfg.fed.algorithm == "fednova":
        raise NotImplementedError(
            "algorithm='fednova' is not ported to fedml_tpu_torch yet "
            "(ROADMAP: FedNova)"
        )
    if cfg.adversary.enabled():
        raise NotImplementedError(
            "adversary injection is not ported to fedml_tpu_torch yet "
            "(ROADMAP: Slice 2 item 10, core/adversary.py)"
        )


def consume_round_counters(train_metrics: dict, counters: dict) -> dict:
    """Pop the counter values out of a round's metrics into ``counters``
    (``robust.nonfinite_rejected``: client results screened out) and
    return the remaining metrics as floats."""
    rejected = float(train_metrics.pop("nonfinite_rejected", 0.0))
    if rejected:
        counters["robust.nonfinite_rejected"] = (
            counters.get("robust.nonfinite_rejected", 0.0) + rejected
        )
    return {k: float(v) for k, v in train_metrics.items()}


class ServerState(NamedTuple):
    variables: Params  # the global model's variables (params and stats)
    opt_state: Any  # server optimizer state, over the params only
    momentum: Params  # global momentum buffer (gmf), params only
    round: int


class Reducer(NamedTuple):
    """How per-client quantities are reduced over the cohort:
    ``wmean(stacked, w)`` is the weighted mean over all clients."""

    wmean: Callable[[Params, torch.Tensor], Params]


def local_reducer() -> Reducer:
    return Reducer(wmean=T.tree_weighted_mean)


def make_server_optimizer(name: str, lr: float, momentum: float
                          ) -> Optimizer:
    """Server optimizer; "sgd" with lr 1 and no momentum is plain
    FedAvg."""
    if name == "sgd":
        return Optimizer("sgd", lr, momentum=momentum)
    raise NotImplementedError(
        f"server optimizer {name!r} is not ported to fedml_tpu_torch yet "
        "(ROADMAP: the other server optimizers)"
    )


def _server_delta_step(fed: FedConfig, state: ServerState, params: Params,
                       agg_delta: Params):
    """Global momentum buffer + server optimizer step on the aggregated
    delta of ``params``. Returns ``(new_params, new_opt_state,
    new_momentum)``."""
    if fed.gmf > 0:
        new_momentum = T.tree_add(T.tree_scale(state.momentum, fed.gmf),
                                  agg_delta)
        agg_delta = new_momentum
    else:
        new_momentum = state.momentum
    opt = make_server_optimizer(fed.server_optimizer, fed.server_lr,
                                fed.server_momentum)
    pseudo_grad = T.tree_scale(agg_delta, -1.0)
    updates, new_opt_state = opt.update(pseudo_grad, state.opt_state, params)
    return apply_updates(params, updates), new_opt_state, new_momentum


@torch.no_grad()
def server_update(fed: FedConfig, state: ServerState, stacked_vars: Params,
                  n_k: torch.Tensor, red: Reducer,
                  stat_names: tuple[str, ...] = ()) -> ServerState:
    """One server step from stacked client results. Parameters: the
    weighted mean of the clients' deltas, then
    :func:`_server_delta_step`. Batch statistics (``stat_names``): the
    plain weighted mean of the clients' values; they never pass through
    the global momentum or the server optimizer."""
    params = {k: v for k, v in state.variables.items()
              if k not in stat_names}
    deltas = {k: stacked_vars[k] - v[None] for k, v in params.items()}
    agg_delta = red.wmean(deltas, n_k)
    new_params, new_opt_state, new_momentum = _server_delta_step(
        fed, state, params, agg_delta
    )
    stats = red.wmean({k: stacked_vars[k] for k in stat_names}, n_k)
    new_vars = {**new_params, **stats}
    return ServerState({k: new_vars[k] for k in state.variables},
                       new_opt_state, new_momentum, state.round + 1)


Sampler = Callable[[int, int, int], torch.Tensor]
BatchOrders = Callable[[int, int], list]


class FedAvgSim:
    """Federated simulation on one device.

    ``sampler(round, num_clients, clients_per_round)`` returns the round's
    cohort ids; the default draws from a generator seeded by
    ``(cfg.seed, round)``. ``batch_orders(round, client)`` returns the
    client's per-epoch batch orders (real samples first); the default
    draws them from a generator seeded by ``(cfg.seed, round, client)``.
    Both hooks let a test replay the JAX package's draws."""

    def __init__(self, model: FedModel, data: FederatedData,
                 cfg: ExperimentConfig, device: str | torch.device = "cuda",
                 sampler: Sampler | None = None,
                 batch_orders: BatchOrders | None = None):
        check_ported(cfg)
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, the simulation "
                             f"on {self.device}")
        self.cfg = cfg
        self.model = model
        self.task = make_task(data.task)
        self.arrays, self.batch_size = arrays_and_batch(data, cfg.data,
                                                        self.device)
        # an embedding table smaller than the data's id space would index
        # out of range
        vocab = getattr(model.module, "vocab_size", None)
        if (self.task.name == "nwp" and vocab is not None
                and vocab < self.arrays.num_classes):
            raise ValueError(
                f"model vocab_size {vocab} < the dataset's token-id space "
                f"{self.arrays.num_classes}: set num_classes (or model "
                f"extra vocab_size) to {self.arrays.num_classes}"
            )
        self.max_n = self.arrays.max_client_samples
        self.local_update = build_local_update(
            model, self.task, cfg.train, self.batch_size, self.max_n
        )
        self.evaluator = build_evaluator(model, self.task)
        self.sampler = sampler or self._sample
        self.batch_orders = batch_orders or self._orders
        self.counters: dict[str, float] = {}

    def _sample(self, round_idx, num_clients, clients_per_round):
        return R.sample_clients(R.generator(self.cfg.seed, round_idx),
                                num_clients, clients_per_round)

    def _orders(self, round_idx, client):
        gen = R.generator(self.cfg.seed, round_idx, client)
        mask_row = self.arrays.mask[client]
        return [R.padded_perm(gen, mask_row, self.max_n)
                for _ in range(self.cfg.train.epochs)]

    def init(self) -> ServerState:
        variables = self.model.init(R.generator(self.cfg.seed, 0x7FFFFFFF))
        params = {k: v for k, v in variables.items()
                  if k not in self.model.stat_names}
        fed = self.cfg.fed
        opt = make_server_optimizer(fed.server_optimizer, fed.server_lr,
                                    fed.server_momentum)
        return ServerState(variables, opt.init(params),
                           T.tree_zeros_like(params), 0)

    def _screen_nonfinite(self, state, stacked_vars, n_k):
        """A client result with a NaN or Inf is replaced by the global
        model with zero weight, so it never enters the aggregate."""
        ok = robust.finite_client_mask(stacked_vars, n_k)

        def heal(s, g):
            return torch.where(ok.reshape((-1,) + (1,) * (s.ndim - 1)), s,
                               g[None].to(s.dtype))

        cleaned = {k: heal(v, state.variables[k])
                   for k, v in stacked_vars.items()}
        n_k = torch.where(ok, n_k, torch.zeros_like(n_k))
        rejected = (ok.shape[0] - ok.sum()).float()
        return cleaned, n_k, rejected

    def run_round(self, state: ServerState):
        fed = self.cfg.fed
        a = self.arrays
        cohort = self.sampler(state.round, a.num_clients,
                              fed.clients_per_round)
        results, counts, sums = [], [], []
        for c in torch.as_tensor(cohort).tolist():
            params, n_k, msums = self.local_update(
                state.variables, a.idx[c], a.mask[c], a.x, a.y,
                orders=self.batch_orders(state.round, c),
            )
            results.append(params)
            counts.append(n_k)
            sums.append(msums)
        stacked = T.tree_stack(results)
        n_k = torch.stack(counts)
        stacked, n_k, rejected = self._screen_nonfinite(state, stacked, n_k)
        new_state = server_update(fed, state, stacked, n_k, local_reducer(),
                                  self.model.stat_names)
        reduced = {k: sum(s[k] for s in sums) for k in sums[0]}
        fin = finalize_sums(reduced)
        return new_state, {"train_loss": fin["loss"],
                           "train_acc": fin["acc"],
                           "nonfinite_rejected": rejected}

    def evaluate_global(self, state: ServerState) -> dict:
        m = self.evaluator(state.variables, self.arrays.test_x,
                           self.arrays.test_y)
        return {k: float(v) for k, v in m.items()}

    def evaluate_train(self, state: ServerState) -> dict:
        m = self.evaluator(state.variables, self.arrays.x, self.arrays.y)
        return {k: float(v) for k, v in m.items()}

    def run(self, metrics_sink=None) -> ServerState:
        """The round loop: train, log the round's metrics, evaluate every
        ``eval_every`` rounds and after the last."""
        state = self.init()
        fed = self.cfg.fed
        for r in range(fed.num_rounds):
            state, train_m = self.run_round(state)
            record = {"round": r,
                      **consume_round_counters(train_m, self.counters)}
            if (r + 1) % fed.eval_every == 0 or r == fed.num_rounds - 1:
                test_m = self.evaluate_global(state)
                record.update({"test_acc": test_m["acc"],
                               "test_loss": test_m["loss"]})
            if metrics_sink is not None:
                metrics_sink.log(record)
        return state
