"""FedAvg: sample a cohort, train each client locally, take the
aggregate on the server, evaluate the global model.

The FedAvg family of ``fedml_tpu.algorithms.fedavg`` (fedavg, fedopt,
fedprox through ``TrainConfig.prox_mu``, fednova) with its defended,
attacked and compressed round, in the JAX package's order: the local
updates; seeded Byzantine adversaries replace their clients' parameters
(``core/adversary.py``); every result goes through the wire codec with
its error-feedback residual carried across rounds
(``core/compress.py``); the non-finite screen; the server step, whose
aggregation rule is the defense pipeline (``core/robust.py``: clip, one
of six rules, noise), then global momentum and the server optimizers
sgd, adam, adagrad and yogi. Float32 or a bf16 compute type. The cohort
runs batched, as in the JAX package: the local step vmapped over
stacked clients, in size-sorted groups of ``TrainConfig.cohort_groups``;
eagerly on the CPU, one CUDA graph replay per step on a card. Settings
of the JAX package that this package has not ported make
:class:`FedAvgSim` raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, NamedTuple

import torch

from fedml_tpu_torch.algorithms.base import (
    CohortUpdate,
    Optimizer,
    apply_updates,
    build_evaluator,
    build_local_update,
    finalize_sums,
    make_task,
)
from fedml_tpu_torch.algorithms.stack_utils import (
    resolve_cohort_groups,
    size_grouped_lanes,
)
from fedml_tpu_torch.config import ExperimentConfig, FedConfig
from fedml_tpu_torch.core import adversary as A
from fedml_tpu_torch.core import compress as C
from fedml_tpu_torch.core import random as R
from fedml_tpu_torch.core import robust
from fedml_tpu_torch.core import tree as T
from fedml_tpu_torch.core.device import resolve_device, to_device
from fedml_tpu_torch.data.federated import FederatedData, arrays_and_batch
from fedml_tpu_torch.models.base import FedModel, Params

# (setting, its default, the ROADMAP item that ports it)
_NOT_PORTED = (
    ("fed.elastic_buckets", False, "Queue A item 6 (core/elastic.py)"),
    ("fed.client_block_size", 0, "Queue A item 6 (core/bulk.py)"),
    ("fed.fuse_rounds", 1, "Queue A item 7 (core/fuse.py)"),
    ("fed.peft", "none", "Queue A item 12 (PEFT)"),
)


def check_ported(cfg: ExperimentConfig) -> None:
    """Raise ``NotImplementedError`` for a setting this package does not
    port yet, naming the ROADMAP item that will; ``ValueError`` for
    fednova with a reducing defense, as the JAX package does."""
    robust.check_fednova_compat(cfg.fed.algorithm, cfg.fed.robust_method)
    for path, default, item in _NOT_PORTED:
        section, field = path.split(".")
        value = getattr(getattr(cfg, section), field)
        if value != default:
            raise NotImplementedError(
                f"{path}={value!r} is not ported to fedml_tpu_torch yet "
                f"(ROADMAP: {item})"
            )


def consume_round_counters(train_metrics: dict, counters: dict) -> dict:
    """Pop the counter values out of a round's metrics into ``counters``
    (``robust.nonfinite_rejected``: client results screened out, summed;
    ``compress.residual_norm``: the error-feedback carry's norm, the last
    round's) and return the remaining metrics as floats."""
    rejected = float(train_metrics.pop("nonfinite_rejected", 0.0))
    if rejected:
        counters["robust.nonfinite_rejected"] = (
            counters.get("robust.nonfinite_rejected", 0.0) + rejected
        )
    residual = train_metrics.pop("compress_residual_norm", None)
    if residual is not None:
        counters["compress.residual_norm"] = float(residual)
    return {k: float(v) for k, v in train_metrics.items()}


class ServerState(NamedTuple):
    variables: Params  # the global model's variables (params and stats)
    opt_state: Any  # server optimizer state, over the params only
    momentum: Params  # global momentum buffer (gmf), params only
    round: int


class Reducer(NamedTuple):
    """How per-client quantities are reduced over the cohort:
    ``wmean(stacked, w)`` is the weighted mean over all clients,
    ``sum_scalar`` the sum of a scalar over them, ``gather`` the whole
    stacked tree (for the coordinate and selection defenses). On one
    device the last two are the identity."""

    wmean: Callable[[Params, torch.Tensor], Params]
    sum_scalar: Callable[[torch.Tensor], torch.Tensor]
    gather: Callable[[Any], Any]


def local_reducer() -> Reducer:
    return Reducer(wmean=T.tree_weighted_mean, sum_scalar=lambda s: s,
                   gather=lambda t: t)


def make_server_optimizer(name: str, lr: float, momentum: float
                          ) -> Optimizer:
    """Server optimizers with optax's defaults (``optax.sgd``,
    ``optax.adam``, ``optax.adagrad``, ``optax.yogi``); "sgd" with lr 1
    and no momentum is plain FedAvg."""
    if name == "sgd":
        return Optimizer("sgd", lr, momentum=momentum)
    if name == "adam":
        return Optimizer("adam", lr)
    if name == "adagrad":
        return Optimizer("adagrad", lr, eps=1e-7)
    if name == "yogi":
        return Optimizer("yogi", lr, eps=1e-3)
    raise ValueError(f"unknown server optimizer: {name}")


class LocalSteps(NamedTuple):
    """How many local steps a client takes: FedNova's tau."""

    batch_size: int
    steps_per_epoch: int
    epochs: int

    def tau(self, n_k: torch.Tensor) -> torch.Tensor:
        """``[C]``: each client's real steps, ``clip(ceil(n_k / B), 1,
        steps_per_epoch) * epochs`` (real samples fill the first batches
        of an epoch, so this is exact)."""
        return torch.clamp(torch.ceil(n_k / self.batch_size), 1,
                           self.steps_per_epoch) * self.epochs


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
                  stat_names: tuple[str, ...] = (),
                  steps: LocalSteps | None = None,
                  normals: Callable[[Mapping[str, tuple]], Params] | None
                  = None) -> ServerState:
    """One server step from stacked client results. Parameters: the
    clients' deltas through the defense pipeline
    (:class:`~fedml_tpu_torch.core.robust.DefensePipeline` from ``fed``:
    clip, then the reduce rule weighted by ``n_k``, then noise from
    ``normals(shapes)``, standard normal draws), then
    :func:`_server_delta_step`. Batch statistics (``stat_names``): the
    plain weighted mean of the clients' values; they never pass through
    the defenses, the global momentum or the server optimizer.

    FedNova (``fed.algorithm == "fednova"``, which needs ``steps``): each
    clipped delta is normalized by its client's steps ``tau_k``, and the
    aggregate is ``tau_eff * wmean(delta_k / tau_k, n_k)`` with ``tau_eff
    = sum(n_k tau_k) / sum(n_k)``; it takes the place of the reduce rule.
    A padded or screened row has weight 0 wherever ``n_k`` appears, so it
    adds nothing."""
    params = {k: v for k, v in state.variables.items()
              if k not in stat_names}
    deltas = {k: stacked_vars[k] - v[None] for k, v in params.items()}
    pipe = robust.DefensePipeline.from_fed(fed)
    deltas = pipe.preprocess(deltas)
    robust.check_fednova_compat(fed.algorithm, pipe.method)
    if fed.algorithm == "fednova":
        if steps is None:
            raise ValueError("fednova's server step needs the clients' "
                             "LocalSteps")
        tau = steps.tau(n_k)
        n_total = red.sum_scalar(torch.sum(n_k))
        tau_eff = red.sum_scalar(torch.sum(n_k * tau)) / n_total
        normed = {k: v / tau.reshape((-1,) + (1,) * (v.ndim - 1))
                  for k, v in deltas.items()}
        agg_delta = T.tree_scale(red.wmean(normed, n_k), tau_eff)
    else:
        agg_delta = pipe.reduce(deltas, n_k, red)
    agg_delta = pipe.postprocess(agg_delta, normals)
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
    client's per-epoch batch orders (real samples first) as host tensors;
    the default draws them from a generator seeded by ``(cfg.seed, round,
    client)``. ``draws(stream, round, slots, shapes)`` makes the defended
    round's draws (:data:`fedml_tpu_torch.core.random.Draws`: the
    aggregate's noise, the quantizer's uniforms per cohort slot, the
    adversaries' gaussians); the default,
    :class:`~fedml_tpu_torch.core.random.DeviceDraws`, draws on the
    simulation's device. The hooks let a test replay the JAX package's
    draws.

    A round reads nothing back from the device: the cohort, the batch
    orders and the sample counts that sort the cohort into groups and
    set each group's steps are on the host (:meth:`_locals`), and so are
    the adversaries' slots. The error-feedback residual of a compressed
    run (``ef_residual``, ``[C, ...]`` by cohort slot) is carried from
    round to round on the device."""

    def __init__(self, model: FedModel, data: FederatedData,
                 cfg: ExperimentConfig, device: str | torch.device = "cuda",
                 sampler: Sampler | None = None,
                 batch_orders: BatchOrders | None = None,
                 draws: R.Draws | None = None):
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
        self.local_steps = LocalSteps(self.batch_size,
                                      self.max_n // self.batch_size,
                                      cfg.train.epochs)
        # host copies, read once: the default batch orders and the
        # cohort's grouping and step counts come from them
        self._host_mask = self.arrays.mask.cpu()
        self._host_counts = self.arrays.counts.cpu().numpy()
        # the per-client update (the tests' reference, one client at a
        # time) and the batched one the round runs
        self.local_update = build_local_update(
            model, self.task, cfg.train, self.batch_size, self.max_n
        )
        self.cohort_update = CohortUpdate(
            model, self.task, cfg.train, self.batch_size,
            graphed=self.device.type == "cuda",
        )
        # cfg.train.cohort_fused (the JAX package's cohort-grouped network)
        # is read and ignored: the cohort runs as the vmapped update
        self._cohort_groups = resolve_cohort_groups(
            cfg.train.cohort_groups,
            min(cfg.fed.clients_per_round, self.arrays.num_clients),
        )
        # the last round's groups: (clients, steps per epoch) each
        self.last_groups: list[tuple[int, int]] = []
        self.evaluator = build_evaluator(model, self.task)
        self.sampler = sampler or self._sample
        self.batch_orders = batch_orders or self._orders
        # both raise ValueError where the JAX package refuses the setting
        # (a multikrum that keeps every client, an unknown rule or codec)
        self.defense = robust.DefensePipeline.from_fed(cfg.fed)
        self.cspec = C.CompressionSpec.from_fed(cfg.fed, seed=cfg.seed)
        self.ef_residual: Params | None = None  # made at the first round
        self.draws = draws or R.DeviceDraws(
            {"noise": cfg.seed, "quant": self.cspec.seed,
             "gauss": cfg.adversary.seed, "collude": cfg.adversary.seed},
            self.device)
        self.counters: dict[str, float] = {}

    def _sample(self, round_idx, num_clients, clients_per_round):
        return R.sample_clients(R.generator(self.cfg.seed, round_idx),
                                num_clients, clients_per_round)

    def _orders(self, round_idx, client):
        gen = R.generator(self.cfg.seed, round_idx, client)
        mask_row = self._host_mask[client]
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

    def _cohort(self, state: ServerState) -> list[int]:
        """The round's cohort ids, on the host."""
        return torch.as_tensor(self.sampler(
            state.round, self.arrays.num_clients,
            self.cfg.fed.clients_per_round)).tolist()

    def _locals(self, state: ServerState, cohort: list[int] | None = None):
        """The local updates of ``cohort`` (by default the round's):
        returns the cohort's stacked variables, n_k and metric sums, in
        cohort order.

        The cohort's batch orders go to the device as one ``[C, epochs,
        max_n]`` tensor; the lanes are sorted by their host sample counts
        into ``cohort_groups`` groups, and each group takes
        ``min(ceil(max n_k / B), steps per epoch)`` steps per epoch, set
        by its largest client (the JAX package's ``cohort_steps``)."""
        a = self.arrays
        epochs = self.cfg.train.epochs
        if cohort is None:
            cohort = self._cohort(state)
        orders = torch.stack([
            torch.stack(list(self.batch_orders(state.round, c))[:epochs])
            for c in cohort]).long()
        self.last_groups = []

        def group(ids, orders, counts):
            steps = min(-(-int(counts.max()) // self.batch_size),
                        self.max_n // self.batch_size)
            self.last_groups.append((len(counts), steps))
            return self.cohort_update(
                state.variables, a.idx.index_select(0, ids),
                a.mask.index_select(0, ids), a.x, a.y, orders, steps)

        lanes = (to_device(torch.tensor(cohort), self.device),
                 to_device(orders, self.device))
        return size_grouped_lanes(group, lanes, self._host_counts[cohort],
                                  self._cohort_groups)

    def _draw(self, round_idx: int):
        """``draw(stream, slots, shapes)``: :attr:`draws` at
        ``round_idx``."""
        return lambda stream, slots, shapes: self.draws(
            stream, round_idx, slots, shapes)

    def _inject_adversaries(self, state, stacked_vars, cohort):
        """The adversaries' slots of the cohort get ``global + attacked
        delta`` as parameters; honest slots and every slot's statistics
        keep the local update's exact output (the choice is made on the
        variables, not through a subtract and add)."""
        adv = self.cfg.adversary
        mask = to_device(A.cohort_mask(adv, cohort, self.arrays.num_clients),
                         self.device)
        params = [k for k in state.variables if k not in self.model.stat_names]
        deltas = {k: stacked_vars[k] - state.variables[k][None]
                  for k in params}
        attacked = A.corrupt_stacked_deltas(adv, deltas, cohort,
                                            self._draw(state.round))
        out = dict(stacked_vars)
        for k in params:
            s, g = stacked_vars[k], state.variables[k]
            out[k] = torch.where(mask.reshape((-1,) + (1,) * (s.ndim - 1)),
                                 (g[None] + attacked[k]).to(s.dtype), s)
        return out

    def _wire_roundtrip(self, state, stacked_vars):
        """The wire model: each slot's delta against the global variables
        (statistics included), plus its carried residual, through
        compress and decompress; the variables rebuilt from what was
        decompressed. Returns them and the new residual."""
        if self.ef_residual is None:
            c = next(iter(stacked_vars.values())).shape[0]
            self.ef_residual = C.zero_residual(state.variables, c)
            self.counters["compress.ratio"] = C.wire_ratio(self.cspec,
                                                           state.variables)
        gv = state.variables
        deltas = {k: v - gv[k][None] for k, v in stacked_vars.items()}
        shapes = self.cspec.draw_shapes(gv)
        draws = self.draws("quant", state.round, range(
            next(iter(deltas.values())).shape[0]), shapes) if shapes else None
        deq, residual = C.roundtrip_stacked(self.cspec, deltas,
                                            self.ef_residual, draws)
        return {k: (gv[k][None] + d).to(d.dtype) for k, d in deq.items()}, \
            residual

    def run_round(self, state: ServerState):
        """One round: locals, adversaries, the wire, the screen, the
        server step. The metrics stay on the device."""
        cohort = self._cohort(state)
        stacked, n_k, sums = self._locals(state, cohort)
        if self.cfg.adversary.enabled():
            stacked = self._inject_adversaries(state, stacked, cohort)
        residual = None
        if self.cspec.enabled():
            stacked, residual = self._wire_roundtrip(state, stacked)
            self.ef_residual = residual
        stacked, n_k, rejected = self._screen_nonfinite(state, stacked, n_k)
        draw = self._draw(state.round)
        new_state = server_update(
            self.cfg.fed, state, stacked, n_k, local_reducer(),
            self.model.stat_names, self.local_steps,
            normals=lambda shapes: {k: v[0] for k, v in draw(
                "noise", [0], shapes).items()})
        fin = finalize_sums({k: v.sum() for k, v in sums.items()})
        metrics = {"train_loss": fin["loss"], "train_acc": fin["acc"],
                   "nonfinite_rejected": rejected}
        if residual is not None:
            metrics["compress_residual_norm"] = T.tree_l2_norm(residual)
        return new_state, metrics

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
