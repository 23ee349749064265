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
eagerly on the CPU, one CUDA graph replay per step on a card.

Three round machineries of the JAX package come with it:

- **elastic buckets** (``FedConfig.elastic_buckets``, ``core/elastic.py``):
  the round runs the power-of-two bucket above the cohort, the live
  clients first, so :meth:`FedAvgSim.set_cohort_size` changes the live
  cohort without a new program;
- **the bulk engine** (``FedConfig.client_block_size``, ``core/bulk.py``):
  the cohort streams through the device in blocks of ``B`` clients, each
  folded into O(model) partial sums (:func:`fold_block_partials`,
  :func:`server_update_from_partials`); the selection and quantile
  defenses run as two streamed passes (``core/streamdef.py``) and the
  error-feedback residual lives in a client-keyed bank
  (``core/statebank.py``);
- **fused blocks** (``FedConfig.fuse_rounds``, ``core/fuse.py``):
  :meth:`FedAvgSim.run` enqueues blocks of K rounds back to back and
  reads each block's metrics back once (:meth:`FedAvgSim.run_block`).

The observability planes ride :meth:`FedAvgSim.run`, off by default: the
perf pair (``core/perf.py``: capture windows, round rate, MFU), the
anatomy plane's ``local`` and ``eval`` phases (``core/anatomy.py``), the
memory sample at each round boundary (``core/memscope.py``) and the
breach profiler's boundary. Its rounds are also ``sim_round`` tracer
spans (``sim_block`` for fused blocks) and set the ``/statusz`` run
block, which the JAX package leaves to its harness's own loop.

PEFT (``FedConfig.peft="lora"``, ``fedml_tpu_torch/peft``): the model's
targeted projections get LoRA adapters, the clients train only the
adapters and the LM head, and every aggregation step (adversaries, the
wire, the screen, the server step) runs on the view of the aggregated
variables, the frozen base merged back unchanged after it. Under
``peft_personalize`` the adapters stay in a private bank of a row per
client (:attr:`FedAvgSim.adapter_bank`) and only the head aggregates.

Settings of the JAX package that this package has not ported make
:class:`FedAvgSim` raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, NamedTuple

import time

import numpy as np
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
from fedml_tpu_torch.core import anatomy as AN
from fedml_tpu_torch.core import bulk as BK
from fedml_tpu_torch.core import compress as C
from fedml_tpu_torch.core import elastic as E
from fedml_tpu_torch.core import export
from fedml_tpu_torch.core import fuse as FU
from fedml_tpu_torch.core import memscope as M
from fedml_tpu_torch.core import perf as P
from fedml_tpu_torch.core import random as R
from fedml_tpu_torch.core import robust, telemetry
from fedml_tpu_torch.core import statebank as SB
from fedml_tpu_torch.core import streamdef as SD
from fedml_tpu_torch.core import tree as T
from fedml_tpu_torch.core.device import resolve_device, to_device
from fedml_tpu_torch.data.federated import FederatedData, arrays_and_batch
from fedml_tpu_torch.models.base import FedModel, Params
from fedml_tpu_torch import peft as PF
from fedml_tpu_torch.peft import personal as PP

# (setting, its default, the ROADMAP item that ports it): every FedConfig
# setting of the FedAvg family is ported
_NOT_PORTED: tuple[tuple[str, object, str], ...] = ()


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


def check_dropout_compat(model: FedModel, cfg: ExperimentConfig) -> None:
    """A model with dropout runs the stacked round (and its fused blocks
    and elastic buckets), whose local steps take the cohort's keep masks;
    the bulk engine and the PEFT rounds do not carry masks yet, and raise
    ``NotImplementedError`` naming the ROADMAP item that will."""
    if not model.has_dropout:
        return
    for setting, on in (("client_block_size", cfg.fed.client_block_size),
                        ("peft", cfg.fed.peft != "none"
                         or cfg.fed.peft_personalize)):
        if on:
            raise NotImplementedError(
                f"a model with dropout ({type(model.module).__name__}) "
                f"under FedConfig.{setting} is not ported to "
                "fedml_tpu_torch yet (ROADMAP: Queue A item 13c, dropout "
                "in the bulk engine and the PEFT rounds)")


def consume_round_counters(train_metrics: dict, counters: dict) -> dict:
    """Pop the counter values out of a round's metrics into ``counters``
    and the registry (``robust.nonfinite_rejected``: client results
    screened out, summed, with a flight event; ``compress.residual_norm``:
    the error-feedback carry's norm, the last round's) and return the
    remaining metrics as floats. Every round loop passes here once a
    round, as the host reads the round's metrics: the memory plane's
    round-boundary sample is taken here."""
    rejected = float(train_metrics.pop("nonfinite_rejected", 0.0))
    if rejected:
        telemetry.add_count(counters, "robust.nonfinite_rejected", rejected)
        telemetry.RECORDER.record("nonfinite_rejected", count=rejected,
                                  path="sim")
    residual = train_metrics.pop("compress_residual_norm", None)
    if residual is not None:
        telemetry.set_gauge(counters, "compress.residual_norm",
                            float(residual))
    out = {k: float(v) for k, v in train_metrics.items()}
    M.MONITOR.sample()
    return out


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
                  = None, valid: torch.Tensor | None = None
                  ) -> ServerState:
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
    adds nothing.

    ``valid`` (``[C]`` bool) marks the live rows of a bucket-padded
    cohort (``core/elastic.py``): every rule reduces over them only."""
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
        agg_delta = pipe.reduce(deltas, n_k, red, valid)
    agg_delta = pipe.postprocess(agg_delta, normals)
    new_params, new_opt_state, new_momentum = _server_delta_step(
        fed, state, params, agg_delta
    )
    stats = red.wmean({k: stacked_vars[k] for k in stat_names}, n_k)
    new_vars = {**new_params, **stats}
    return ServerState({k: new_vars[k] for k in state.variables},
                       new_opt_state, new_momentum, state.round + 1)


def block_deltas(fed: FedConfig, state: ServerState, stacked_vars: Params,
                 stat_names: tuple[str, ...] = ()) -> torch.Tensor:
    """``[B, D]``: a block's parameter deltas against the global ones,
    flattened in the variables' key order, each row clipped as the
    defense pipeline clips it (float32; float64 variables stay float64):
    what the stacked reducer's rules see, one row per client."""
    names = [k for k in state.variables if k not in stat_names]
    flat = robust.flatten_clients({k: stacked_vars[k] for k in names})
    glob = T.wide(T.tree_vectorize({k: state.variables[k] for k in names}))
    d = flat - glob[None]
    clip = robust.DefensePipeline.from_fed(fed).clip
    if clip > 0:
        norms = torch.sqrt(torch.sum(d * d, dim=1))
        d = d * torch.clamp(clip / torch.clamp(norms, min=1e-12),
                            max=1.0)[:, None]
    return d


def fold_block_partials(fed: FedConfig, steps: LocalSteps,
                        state: ServerState, stacked_vars: Params,
                        n_k: torch.Tensor, msums: dict,
                        rejected: torch.Tensor,
                        stat_names: tuple[str, ...] = ()
                        ) -> BK.RoundPartials:
    """One block of (attacked, decompressed, healed, screened) client
    results reduced to its O(model) :class:`~fedml_tpu_torch.core.bulk.
    RoundPartials`: the head of :func:`server_update`, a block at a time.
    The deltas are clipped per row (:func:`block_deltas`), FedNova's are
    divided by each client's steps; the weighted sums are float32, like
    ``tree_weighted_mean``'s, so bulk and stacked rounds differ by the
    order of float32 sums only."""
    d = block_deltas(fed, state, stacked_vars, stat_names)
    nf = n_k.to(d.dtype)
    if fed.algorithm == "fednova":
        tau = steps.tau(n_k).to(d.dtype)
        d = d / tau[:, None]
        tau_wsum = torch.sum(nf * tau)
    else:
        tau_wsum = torch.zeros((), dtype=d.dtype, device=d.device)
    if stat_names:
        stats = robust.flatten_clients({k: stacked_vars[k]
                                        for k in stat_names})
        other = torch.sum(stats * nf[:, None].to(stats.dtype), dim=0)
    else:
        other = d.new_zeros(0)
    return BK.RoundPartials(
        delta_wsum=torch.sum(d * nf[:, None], dim=0), other_wsum=other,
        n_sum=torch.sum(nf), tau_wsum=tau_wsum,
        msums={k: v.sum() for k, v in msums.items()}, rejected=rejected)


@torch.no_grad()
def server_update_from_partials(
        fed: FedConfig, state: ServerState, partials: BK.RoundPartials,
        stat_names: tuple[str, ...] = (),
        normals: Callable[[Mapping[str, tuple]], Params] | None = None,
        agg_delta: torch.Tensor | None = None) -> ServerState:
    """One server step from partials summed over every block: the bulk
    twin of :func:`server_update`, sharing its tail
    (:func:`_server_delta_step`). The mean and FedNova take their
    aggregate from the partials; a streamed defense
    (``core/streamdef.py``) passes its decided aggregate ``agg_delta``
    (flat, ``[D]``). The batch statistics are the partials' weighted
    mean under any rule, as in the stacked reducer."""
    pipe = robust.DefensePipeline.from_fed(fed)
    if pipe.method not in BK.BULK_REDUCE_RULES and agg_delta is None:
        raise ValueError(f"robust_method={pipe.method!r} streams its "
                         "aggregate: pass agg_delta")
    params = {k: v for k, v in state.variables.items()
              if k not in stat_names}
    # the max(sum w, 1e-12) guard of tree_weighted_mean: a round of zero
    # weight degrades the same way
    denom = torch.clamp(partials.n_sum, min=1e-12)
    if agg_delta is None:
        agg = T.tree_unvectorize(partials.delta_wsum / denom, params)
        if fed.algorithm == "fednova":
            agg = T.tree_scale(agg, partials.tau_wsum / partials.n_sum)
    else:
        agg = T.tree_unvectorize(agg_delta, params)
    agg = pipe.postprocess(agg, normals)
    new_params, new_opt_state, new_momentum = _server_delta_step(
        fed, state, params, agg)
    stats = T.tree_unvectorize(partials.other_wsum / denom,
                               {k: state.variables[k] for k in stat_names})
    new_vars = {**new_params, **stats}
    return ServerState({k: new_vars[k] for k in state.variables},
                       new_opt_state, new_momentum, state.round + 1)


Sampler = Callable[[int, int, int], torch.Tensor]
SlotSampler = Callable[[int, int, int], torch.Tensor]
BatchOrders = Callable[[int, int], list]


class FedAvgSim:
    """Federated simulation on one device.

    ``sampler(round, num_clients, clients_per_round)`` returns the round's
    cohort ids; the default draws from a generator seeded by
    ``(cfg.seed, round)``. ``slot_sampler(round, num_clients, n)`` returns
    the ``n`` ids of an elastic round's slots, the live ones first (a
    permutation of the population when ``n`` covers it); the default
    draws the first ``n`` of a permutation from the same generator.
    ``batch_orders(round, client)`` returns the client's per-epoch batch
    orders (real samples first) as host tensors; the default draws them
    from a generator seeded by ``(cfg.seed, round, client)``.
    ``draws(stream, round, slots, shapes)`` makes the defended round's
    draws (:data:`fedml_tpu_torch.core.random.Draws`: the aggregate's
    noise, the quantizer's uniforms per cohort slot (per client id in
    the bulk engine), the adversaries' gaussians, the streamed defenses'
    projections); the default,
    :class:`~fedml_tpu_torch.core.random.DeviceDraws`, draws on the
    simulation's device. The hooks let a test replay the JAX package's
    draws.

    A round reads nothing back from the device: the cohort, the live
    mask, the batch orders and the sample counts that sort the cohort
    into groups and set each group's steps are on the host, and so are
    the adversaries' slots and a bulk round's blocks. The error-feedback
    residual of a compressed run is carried from round to round on the
    device: ``[C, ...]`` by cohort slot (``ef_residual``), or in the bulk
    engine a bank with a row per client (``ef_bank``). Under PEFT the
    model is the LoRA-injected one (``model`` is the base) and a
    personalized run keeps its private adapters in ``adapter_bank``."""

    def __init__(self, model: FedModel, data: FederatedData,
                 cfg: ExperimentConfig, device: str | torch.device = "cuda",
                 sampler: Sampler | None = None,
                 batch_orders: BatchOrders | None = None,
                 draws: R.Draws | None = None,
                 slot_sampler: SlotSampler | None = None):
        check_ported(cfg)
        check_dropout_compat(model, cfg)
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, the simulation "
                             f"on {self.device}")
        self.cfg = cfg
        # PEFT (fedml_tpu_torch/peft): the adapters are injected and the
        # rounds train and aggregate only the adapters and the head; off,
        # the model and every path are unchanged
        model, self.peft = PF.build_peft(model, cfg)
        self.model = model
        # the private adapters of a personalized run, a row per client,
        # made at the first round
        self.adapter_bank: SB.ClientStateBank | None = None
        partition = self.peft.part if self.peft is not None else None
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
        # the orders of a lane that does not train (any will do)
        self._idle_orders = torch.arange(self.max_n).expand(
            cfg.train.epochs, self.max_n)
        # the per-client update (the tests' reference, one client at a
        # time) and the batched one the round runs
        self.local_update = build_local_update(
            model, self.task, cfg.train, self.batch_size, self.max_n,
            partition=partition,
        )
        self.cohort_update = CohortUpdate(
            model, self.task, cfg.train, self.batch_size,
            graphed=self.device.type == "cuda", partition=partition,
            family="sim_bulk" if cfg.fed.client_block_size else "sim_round",
        )
        num_clients = self.arrays.num_clients
        cohort = min(cfg.fed.clients_per_round, num_clients)
        # elastic buckets (core/elastic.py): the round runs the bucket's
        # lanes, the first n_active live; set_cohort_size moves n_active
        self._elastic = bool(cfg.fed.elastic_buckets)
        if self._elastic and sampler is not None:
            raise ValueError(
                "elastic_buckets=True is incompatible with a custom cohort "
                "sampler: the bucketed round draws its own full-bucket "
                "permutation (core/elastic.py). Disable elastic buckets or "
                "drop the sampler.")
        # fused blocks (core/fuse.py): run() goes through run_block
        self._fuse = int(cfg.fed.fuse_rounds)
        if self._fuse < 1:
            raise ValueError(
                f"fuse_rounds must be >= 1, got {cfg.fed.fuse_rounds}")
        # the blocks of the last fused run(), flushed (core/fuse.Flushed)
        self.last_blocks: list[FU.Flushed] = []
        self._bucket = (min(E.bucket_for(cohort), num_clients)
                        if self._elastic else cohort)
        self._n_active = cohort
        # the bulk engine (core/bulk.py): blocks of B lanes; under elastic
        # buckets the block count is bucketed
        self._bulk = BK.BulkSpec.from_fed(cfg.fed)
        self._stream_defense = (
            cfg.fed.robust_method
            if self._bulk.enabled()
            and cfg.fed.robust_method in SD.STREAM_METHODS else None)
        if self._bulk.enabled():
            BK.check_bulk_compat(cfg.fed, cfg.adversary)
            self._block_size = self._bulk.block_size
            self._n_blocks = BK.plan_blocks(cohort, self._block_size,
                                            self._elastic)
            self._slots = self._n_blocks * self._block_size
            # the live cohort may grow into the headroom blocks, never
            # past the population
            self._max_live = min(self._slots, num_clients)
        # a block of wholly dead slots adds exact zeros: it is not run
        self._skip_dead_blocks = True
        # cfg.train.cohort_fused (the JAX package's cohort-grouped network)
        # is read and ignored: the cohort runs as the vmapped update. The
        # groups divide the lanes: the bucket's under elastic buckets
        self._cohort_groups = resolve_cohort_groups(
            cfg.train.cohort_groups, self._bucket)
        # the last round's groups (a bulk round's blocks): (clients, steps
        # per epoch) each
        self.last_groups: list[tuple[int, int]] = []
        self.evaluator = build_evaluator(model, self.task)
        self.sampler = sampler or self._sample
        self.slot_sampler = slot_sampler or self._sample_slots
        self.batch_orders = batch_orders or self._orders
        # both raise ValueError where the JAX package refuses the setting
        # (a multikrum that keeps every client, an unknown rule or codec)
        self.defense = robust.DefensePipeline.from_fed(cfg.fed)
        self.cspec = C.CompressionSpec.from_fed(cfg.fed, seed=cfg.seed)
        self.ef_residual: Params | None = None  # made at the first round
        self.ef_bank: SB.ClientStateBank | None = None  # bulk: per client
        self.draws = draws or R.DeviceDraws(
            {"noise": cfg.seed, "quant": self.cspec.seed,
             "gauss": cfg.adversary.seed, "collude": cfg.adversary.seed,
             "proj": cfg.seed, "dropout": cfg.seed}, self.device,
            p={"dropout": model.mask_keep})
        self.counters: dict[str, float] = {}
        # the memory plane samples this simulation's device
        M.MONITOR.attach(self.device, cfg.fed.mem_headroom_warn)

    def _sample(self, round_idx, num_clients, clients_per_round):
        return R.sample_clients(R.generator(self.cfg.seed, round_idx),
                                num_clients, clients_per_round)

    def _sample_slots(self, round_idx, num_clients, n):
        return torch.randperm(num_clients, generator=R.generator(
            self.cfg.seed, round_idx))[:n]

    def _orders(self, round_idx, client):
        gen = R.generator(self.cfg.seed, round_idx, client)
        mask_row = self._host_mask[client]
        return [R.padded_perm(gen, mask_row, self.max_n)
                for _ in range(self.cfg.train.epochs)]

    def init(self) -> ServerState:
        """The round-0 state. Under PEFT the server optimizer's state and
        the momentum cover the aggregated parameters only."""
        variables = self.model.init(R.generator(self.cfg.seed, 0x7FFFFFFF))
        params = {k: v for k, v in self._view_vars(variables).items()
                  if k not in self.model.stat_names}
        fed = self.cfg.fed
        opt = make_server_optimizer(fed.server_optimizer, fed.server_lr,
                                    fed.server_momentum)
        if self.peft is not None:
            self._note_peft(variables)
        return ServerState(variables, opt.init(params),
                           T.tree_zeros_like(params), 0)

    # -- PEFT (fedml_tpu_torch/peft) ----------------------------------------

    def _view_vars(self, variables: Params) -> Params:
        """The variables the aggregation sees: all of them, or under PEFT
        the aggregated ones."""
        return (variables if self.peft is None
                else self.peft.agg_variables(variables))

    def _view(self, state: ServerState) -> ServerState:
        return state if self.peft is None else self.peft.view_state(state)

    def _merge(self, new_view: ServerState, state: ServerState
               ) -> ServerState:
        return (new_view if self.peft is None
                else self.peft.merge_state(new_view, state))

    def _note_peft(self, variables: Params) -> None:
        """The ``peft.*`` counters (the JAX package's gauges): trainable
        and frozen parameter counts, one client's update in MB, and the
        full-model-equivalent wire reduction."""
        plan = self.peft
        trainable, frozen = plan.counts(variables)
        c = self.counters
        telemetry.set_gauge(c, "peft.trainable_params", trainable)
        telemetry.set_gauge(c, "peft.frozen_params", frozen)
        telemetry.set_gauge(c, "peft.adapter_wire_mb",
                            plan.adapter_wire_bytes(variables) / 1e6)
        telemetry.set_gauge(c, "peft.wire_ratio", PF.compound_wire_ratio(
            plan, self.cspec, variables))

    def _personalized(self) -> bool:
        return self.peft is not None and self.peft.personalized

    # -- elastic cohort control (core/elastic.py) ------------------------------

    def set_cohort_size(self, n: int) -> None:
        """Change the live cohort for the next rounds, within the bucket
        (the bulk engine: within its block grid), with no new program."""
        if not self._elastic:
            raise ValueError(
                "set_cohort_size requires FedConfig(elastic_buckets=True) "
                "— the static round program bakes the cohort size into "
                "its shapes")
        if self._bulk.enabled():
            if not 1 <= n <= self._max_live:
                raise ValueError(
                    f"cohort size {n} does not fit the compiled "
                    f"{self._n_blocks}x{self._block_size} block grid "
                    f"(live cohort must stay in [1, {self._max_live}]; "
                    "grow needs a new simulator)")
        elif not 1 <= n <= self._bucket:
            raise ValueError(
                f"cohort size {n} does not fit the compiled bucket "
                f"{self._bucket} (grow needs a new simulator; within "
                f"[1, {self._bucket}] changes are free)")
        self._n_active = n

    def _slot_ids(self, round_idx: int, n: int) -> np.ndarray:
        """``n`` host ids whose live prefix is the round's cohort."""
        ids = np.asarray(self.slot_sampler(
            round_idx, self.arrays.num_clients, n), np.int64)
        if ids.shape != (n,):
            raise ValueError(f"slot_sampler returned {ids.shape[0]} ids, "
                             f"not {n}")
        return ids

    # -- one round ---------------------------------------------------------

    def _screen_nonfinite(self, state, stacked_vars, n_k, ok=None):
        """A client result with a NaN or Inf is replaced by the global
        model with zero weight, so it never enters the aggregate. ``ok``
        is :func:`robust.finite_client_mask`, if the caller has it."""
        if ok is None:
            ok = robust.finite_client_mask(stacked_vars, n_k)
        cleaned = {k: torch.where(T.bcast_rows(ok, v), v,
                                  state.variables[k][None].to(v.dtype))
                   for k, v in stacked_vars.items()}
        n_k = torch.where(ok, n_k, torch.zeros_like(n_k))
        rejected = (ok.shape[0] - ok.sum()).float()
        return cleaned, n_k, rejected

    def _cohort(self, state: ServerState) -> list[int]:
        """The round's cohort ids, on the host."""
        return torch.as_tensor(self.sampler(
            state.round, self.arrays.num_clients,
            self.cfg.fed.clients_per_round)).tolist()

    def _locals(self, state: ServerState, cohort=None, on=None,
                groups: int | None = None, starts: Params | None = None):
        """The local updates of ``cohort`` (by default the round's):
        returns the cohort's stacked variables, n_k and metric sums, in
        cohort order. ``starts`` (``{name: [C, ...]}``, in cohort order)
        are the lanes' own starts of some parameters (a personalized
        cohort's private adapters).

        The cohort's batch orders go to the device as one ``[C, epochs,
        max_n]`` tensor; the lanes are sorted by their host sample counts
        into ``groups`` groups (by default ``cohort_groups``), and each
        group takes ``min(ceil(max n_k / B), steps per epoch)`` steps per
        epoch, set by its largest client (the JAX package's
        ``cohort_steps``). ``on`` (host bools) marks the lanes that
        train; the others (padding, dead slots, sentinel ids) get an
        all-zero mask: every step of theirs is gated, their n_k is 0 and
        they come back as the global variables. A model with dropout
        takes each group's keep masks (``"dropout"`` draws by host id,
        ``[epochs, steps, B, *site]`` a lane at the group's own steps),
        drawn before the group's first step."""
        a = self.arrays
        epochs = self.cfg.train.epochs
        if cohort is None:
            cohort = self._cohort(state)
        ids = np.asarray(cohort, np.int64)
        if on is None:
            on = np.ones(ids.shape, bool)
        else:
            ids = np.where(on, ids, 0)  # a sentinel id reads client 0
        orders = torch.stack([
            torch.stack(list(self.batch_orders(state.round, c))[:epochs])
            if live else self._idle_orders
            for c, live in zip(ids.tolist(), on)]).long()
        self.last_groups = []

        sites = self.model.mask_sites

        def group(ids, orders, lane_on, *rest):
            if sites:
                *rest, hosts = rest
            *lane_starts, counts = rest
            steps = min(-(-int(counts.max()) // self.batch_size),
                        self.max_n // self.batch_size)
            self.last_groups.append((len(counts), steps))
            mask = a.mask.index_select(0, ids) * lane_on[:, None]
            extra = {"starts": lane_starts[0]} if lane_starts else {}
            if sites:
                extra["masks"] = self.draws(
                    "dropout", state.round, hosts.tolist(),
                    R.mask_shapes(sites, (epochs, steps), self.batch_size))
            return self.cohort_update(
                state.variables, a.idx.index_select(0, ids), mask, a.x,
                a.y, orders, steps, **extra)

        lanes = (to_device(torch.from_numpy(ids), self.device),
                 to_device(orders, self.device),
                 to_device(torch.from_numpy(on.astype(np.float32)),
                           self.device))
        if starts is not None:
            lanes += (starts,)
        return size_grouped_lanes(
            group, lanes, self._host_counts[ids] * on,
            self._cohort_groups if groups is None else groups,
            host=ids if sites else None)

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
            out[k] = torch.where(T.bcast_rows(mask, s),
                                 (g[None] + attacked[k]).to(s.dtype), s)
        return out

    def _wire(self, state, stacked_vars, residual, draw_ids):
        """Each row's delta against the global variables (statistics
        included), plus its carried residual, through compress and
        decompress, the quantizer's draws keyed by ``draw_ids``; the
        variables rebuilt from what was decompressed. Returns them and
        the new residual."""
        gv = state.variables
        deltas = {k: v - gv[k][None] for k, v in stacked_vars.items()}
        shapes = self.cspec.draw_shapes(gv)
        draws = (self.draws("quant", state.round, draw_ids, shapes)
                 if shapes else None)
        deq, residual = C.roundtrip_rows(self.cspec, deltas, residual, draws)
        return {k: (gv[k][None] + d).to(d.dtype) for k, d in deq.items()}, \
            residual

    def _wire_roundtrip(self, state, stacked_vars, live=None):
        """The stacked wire model: the quantizer keyed by cohort slot, the
        residual ``[C, ...]`` by slot; an elastic round's dead slots get
        their residual zeroed (a slot that just left the live prefix must
        not carry its stale residual into a healed row)."""
        c = next(iter(stacked_vars.values())).shape[0]
        if self.ef_residual is None:
            self.ef_residual = C.zero_residual(state.variables, c)
            telemetry.set_gauge(self.counters, "compress.ratio",
                                C.wire_ratio(self.cspec, state.variables))
        stacked, residual = self._wire(state, stacked_vars,
                                       self.ef_residual, range(c))
        if live is not None:
            residual = {k: torch.where(T.bcast_rows(live, r), r,
                                       torch.zeros((), dtype=r.dtype,
                                                   device=r.device))
                        for k, r in residual.items()}
        return stacked, residual

    def run_round(self, state: ServerState):
        """One round: locals, adversaries, the wire, the screen, the
        server step; streamed in blocks by the bulk engine. The metrics
        stay on the device. Under elastic buckets the round counts in
        ``counters`` as a hit or a miss of the program cache."""
        if self._elastic:
            return E.mirror_jit_cache(self.cohort_update.programs,
                                      lambda: self._round(state),
                                      self.counters)
        return self._round(state)

    def _round(self, state: ServerState):
        if self._bulk.enabled():
            BK.note_round(self.counters, self._block_size, self._n_blocks,
                          self._slots - self._n_active)
            if self._stream_defense is not None:
                n_params = sum(v.numel() for k, v in
                               self._view_vars(state.variables).items()
                               if k not in self.model.stat_names)
                SD.note_defense(self.counters, self._stream_defense,
                                n_params, self._slots)
            return self._bulk_round(state)
        return self._stacked_round(state)

    def run_block(self, state: ServerState, length: int):
        """``length`` rounds enqueued back to back; returns ``(state,
        metrics)`` with every metric stacked ``[length]`` on the device.
        Nothing is read back inside the block, on any round path: the
        error-feedback residual (or the bulk engine's bank) is carried
        from round to round as in :meth:`run_round`, and each round is
        the same computation on the same state, so a block equals
        ``length`` calls of :meth:`run_round` bit for bit. Under elastic
        buckets the block counts once in ``counters``, a hit or a miss of
        the program cache, as the JAX package's block program does; a
        :meth:`set_cohort_size` between blocks takes effect at the next
        block. Needs ``fuse_rounds > 1``, as in the JAX package."""
        if self._fuse < 2:
            raise ValueError(
                "run_block requires FedConfig(fuse_rounds > 1) (the JAX "
                "package builds the block program at construction)")

        def block():
            nonlocal state
            rows = []
            for _ in range(length):
                state, m = self._round(state)
                rows.append(m)
            return {k: torch.stack([m[k] for m in rows]) for k in rows[0]}

        if self._elastic:
            metrics = E.mirror_jit_cache(self.cohort_update.programs, block,
                                         self.counters)
        else:
            metrics = block()
        return state, metrics

    def _stacked_cohort(self, state: ServerState):
        """The stacked round's cohort (host ids), its host mask of lanes
        that train and its device mask of live slots (None and None
        unless elastic: every lane trains)."""
        if not self._elastic:
            return self._cohort(state), None, None
        cohort = self._slot_ids(state.round, self._bucket)
        on = np.arange(self._bucket) < self._n_active
        return (cohort.tolist(), on,
                E.active_mask(self._bucket, self._n_active, self.device))

    def _noise(self, round_idx: int):
        """The server step's ``normals``: the round's "noise" draws."""
        draw = self._draw(round_idx)
        return lambda shapes: {k: v[0] for k, v in draw(
            "noise", [0], shapes).items()}

    def _stacked_round(self, state: ServerState):
        """One stacked round. Under PEFT the clients return the trainable
        variables, and everything after the local updates runs on the
        view of the aggregated ones; the frozen base is merged back
        unchanged."""
        if self._personalized():
            return self._personal_round(state)
        cohort, on, live = self._stacked_cohort(state)
        stacked, n_k, sums = self._locals(
            state, *((cohort,) if on is None else (cohort, on)))
        view = self._view(state)
        if self.cfg.adversary.enabled():
            stacked = self._inject_adversaries(view, stacked, cohort)
        residual = None
        if self.cspec.enabled():
            stacked, residual = self._wire_roundtrip(view, stacked, live)
            self.ef_residual = residual
        if live is not None:
            # the dead slots become the global model with zero weight
            # before the screen, and leave the round's metrics alone
            stacked, n_k, sums = E.mask_padded(stacked, n_k, sums,
                                               view.variables, live)
        stacked, n_k, rejected = self._screen_nonfinite(view, stacked, n_k)
        new_view = server_update(
            self.cfg.fed, view, stacked, n_k, local_reducer(),
            self.model.stat_names, self.local_steps,
            normals=self._noise(state.round), valid=live)
        fin = finalize_sums({k: v.sum() for k, v in sums.items()})
        metrics = {"train_loss": fin["loss"], "train_acc": fin["acc"],
                   "nonfinite_rejected": rejected}
        if residual is not None:
            metrics["compress_residual_norm"] = T.tree_l2_norm(residual)
        return self._merge(new_view, state), metrics

    # -- personalized PEFT (fedml_tpu_torch/peft/personal.py) ---------------

    def _split_private(self, trained: Params) -> tuple[Params, Params]:
        """A cohort's trained variables as (shared, private): the head and
        statistics, and the adapters."""
        private = self.peft.private
        return ({k: v for k, v in trained.items() if not private.select(k)},
                {k: v for k, v in trained.items() if private.select(k)})

    def _screen_personal(self, view, shared, private, n_k, live):
        """The non-finite screen over both halves of each client's update:
        a poisoned client adds nothing to the shared aggregate and keeps
        its pre-round bank row. A non-live slot (already healed, zero
        weight) is no rejection. Returns ``(shared, n_k, rejected, keep)``,
        ``keep`` the slots whose trained bank rows are written."""
        ok = robust.finite_client_mask({**shared, **private}, n_k)
        if live is not None:
            ok = ok | ~live
        shared, n_k, rejected = self._screen_nonfinite(view, shared, n_k, ok)
        return shared, n_k, rejected, ok if live is None else ok & live

    def _personal_round(self, state: ServerState):
        """The personalized round (the JAX package's ``_personal_round``):
        each client of the cohort trains from its own bank row of
        adapters; only the shared leaves (the head) aggregate, and the
        trained rows go back to the bank (a rejected or non-live slot
        keeps its pre-round row). The server's adapter leaves are not in
        the aggregated view, so they stay at init."""
        self._ensure_adapter_bank(state)
        bank = self.adapter_bank
        cohort, on, live = self._stacked_cohort(state)
        rows = bank.gather(cohort)
        trained, n_k, sums = self._locals(state, cohort, on, starts=rows)
        view = self._view(state)
        shared, private = self._split_private(trained)
        if live is not None:
            shared, n_k, sums = E.mask_padded(shared, n_k, sums,
                                              view.variables, live)
        shared, n_k, rejected, keep = self._screen_personal(
            view, shared, private, n_k, live)
        new_view = server_update(
            self.cfg.fed, view, shared, n_k, local_reducer(),
            self.model.stat_names, self.local_steps,
            normals=self._noise(state.round), valid=live)
        bank.put(cohort, private, keep=keep, gathered=rows)
        SB.note_round_io(self.counters, 1, 1)
        fin = finalize_sums({k: v.sum() for k, v in sums.items()})
        return self._merge(new_view, state), {
            "train_loss": fin["loss"], "train_acc": fin["acc"],
            "nonfinite_rejected": rejected}

    # -- the bulk engine (core/bulk.py) ------------------------------------

    def _bulk_slots(self, state: ServerState):
        """The round's ``[slots]`` host ids (sentinel ``num_clients`` past
        the cohort) and live mask (None: every slot live)."""
        n = self.arrays.num_clients
        if self._elastic:
            ids = SB.pad_ids(self._slot_ids(state.round, self._max_live),
                             self._slots, n)
            return ids, np.arange(self._slots) < self._n_active
        cohort = self._cohort(state)
        ids = SB.pad_ids(cohort, self._slots, n)
        live = (np.arange(self._slots) < len(cohort)
                if len(cohort) < self._slots else None)
        return ids, live

    def _bulk_round(self, state: ServerState):
        """The block-streamed round (the JAX package's ``_bulk_round``):
        each block of ``B`` slots runs the stacked round's head (the
        batched local update, the adversaries, the wire against the
        client-keyed residual bank, the heal of dead slots, the screen)
        and is folded by :func:`fold_block_partials`; the server step is
        :func:`server_update_from_partials`. No ``[C, ...]`` tensor is
        made: a round's memory is O(B + model + sketch). Under PEFT the
        blocks fold the aggregated view, as in the stacked round."""
        fed = self.cfg.fed
        stat_names = self.model.stat_names
        ids, live = self._bulk_slots(state)
        view = self._view(state)
        skip = ((lambda block_live: block_live is not None
                 and not block_live.any())
                if self._skip_dead_blocks else None)
        if self._personalized():
            return self._bulk_personal(state, view, ids, live, skip)
        bank = None
        if self.cspec.enabled():
            self._ensure_ef_bank(state)
            bank = self.ef_bank
        groups = []

        def local_block(block_ids, block_live, bank, write_bank=True):
            """``(stacked variables, n_k, metric sums, rejected)`` of one
            block; with ``bank`` (and ``write_bank``) the block's
            residual rows are written back."""
            on = (np.ones(block_ids.shape, bool) if block_live is None
                  else block_live)
            sv, n_k, msums = self._locals(state, block_ids, on, groups=1)
            groups.extend(self.last_groups)
            if self.cfg.adversary.enabled():
                sv = self._inject_adversaries(view, sv, block_ids.tolist())
            rows = new_rows = None
            if bank is not None:
                rows = bank.gather(block_ids)
                sv, new_rows = self._wire(view, sv, rows, block_ids.tolist())
            live_dev = None
            if not on.all():
                live_dev = to_device(torch.from_numpy(on), self.device)
                sv, n_k, msums = E.mask_padded(sv, n_k, msums,
                                               view.variables, live_dev)
            ok = robust.finite_client_mask(sv, n_k)
            sv, n_k, rejected = self._screen_nonfinite(view, sv, n_k, ok)
            if bank is not None:
                SB.note_round_io(self.counters, 1, int(write_bank))
                if write_bank:
                    # a screened or dead slot keeps its pre-round row;
                    # sentinel ids are dropped
                    bank.put(block_ids, new_rows, gathered=rows,
                             keep=ok if live_dev is None else ok & live_dev)
            return sv, n_k, msums, rejected

        def partials_of(sv, n_k, msums, rejected):
            return fold_block_partials(fed, self.local_steps, view, sv, n_k,
                                       msums, rejected, stat_names)

        agg = None
        if self._stream_defense is None:
            def fold_block(block_ids, block_live, *banks):
                out = partials_of(*local_block(block_ids, block_live, bank))
                return (out, *banks) if banks else out

            partials = BK.stream_blocks(fold_block, ids, live,
                                        self._block_size, banks=bank,
                                        skip=skip)
            if bank is not None:
                partials = partials[0]
        else:
            partials, agg = self._defended_fold(view, ids, live, bank,
                                                local_block, partials_of,
                                                skip)
        self.last_groups = groups
        new_view = server_update_from_partials(
            fed, view, partials, stat_names,
            normals=self._noise(state.round), agg_delta=agg)
        fin = finalize_sums(partials.msums)
        return self._merge(new_view, state), {
            "train_loss": fin["loss"], "train_acc": fin["acc"],
            "nonfinite_rejected": partials.rejected}

    def _bulk_personal(self, state, view, ids, live, skip):
        """The personalized round streamed in blocks (the JAX package's
        ``_bulk_personal``): each block gathers its clients' bank rows,
        trains from them, folds the shared half into its partials and
        writes its trained rows back, under :meth:`_personal_round`'s
        screen."""
        fed = self.cfg.fed
        stat_names = self.model.stat_names
        self._ensure_adapter_bank(state)
        groups = []

        def fold_block(block_ids, block_live, bank):
            on = (np.ones(block_ids.shape, bool) if block_live is None
                  else block_live)
            rows = bank.gather(block_ids)
            trained, n_k, msums = self._locals(state, block_ids, on,
                                               groups=1, starts=rows)
            groups.extend(self.last_groups)
            shared, private = self._split_private(trained)
            live_dev = None
            if block_live is not None:
                live_dev = to_device(torch.from_numpy(block_live),
                                     self.device)
                shared, n_k, msums = E.mask_padded(shared, n_k, msums,
                                                   view.variables, live_dev)
            shared, n_k, rejected, keep = self._screen_personal(
                view, shared, private, n_k, live_dev)
            bank.put(block_ids, private, keep=keep, gathered=rows)
            SB.note_round_io(self.counters, 1, 1)
            return fold_block_partials(fed, self.local_steps, view, shared,
                                       n_k, msums, rejected, stat_names), bank

        partials, self.adapter_bank = BK.stream_blocks(
            fold_block, ids, live, self._block_size, banks=self.adapter_bank,
            skip=skip)
        self.last_groups = groups
        new_view = server_update_from_partials(
            fed, view, partials, stat_names,
            normals=self._noise(state.round))
        fin = finalize_sums(partials.msums)
        return self._merge(new_view, state), {
            "train_loss": fin["loss"], "train_acc": fin["acc"],
            "nonfinite_rejected": partials.rejected}

    def _defended_fold(self, state, ids, live, bank, local_block,
                       partials_of, skip):
        """The two streamed passes of a selection or quantile rule
        (``core/streamdef.py``). Pass 1 folds the partials and the sketch
        (the residual rows read, not written); the rule decides from the
        sketch; pass 2 recomputes the same blocks, folds the decided
        aggregate and writes the residual bank. Returns ``(partials,
        aggregate)``, the aggregate flat. ``state`` is the aggregated
        view."""
        fed = self.cfg.fed
        stat_names = self.model.stat_names
        method = self.defense.method
        quantile = method in SD.QUANTILE_METHODS
        params = {k: v for k, v in state.variables.items()
                  if k not in stat_names}
        n_slots = ids.shape[0]

        def deltas_of(sv):
            return block_deltas(fed, state, sv, stat_names)

        def votes(block_live, like):
            # the quantile rules vote over live rows: a screened client
            # votes its healed zero delta, as in the stacked reducer
            if block_live is None:
                return torch.ones(like.shape[0], dtype=like.dtype,
                                  device=like.device)
            return to_device(torch.from_numpy(block_live.astype(np.float32)),
                             self.device).to(like.dtype)

        normals = None
        if not quantile:
            # the projection's blocks, drawn once for the round: every
            # block and both passes use the same matrix
            normals = {k: v[0] for k, v in self.draws(
                "proj", state.round, [0], SD.proj_shapes(params)).items()}

        def pass1(block_ids, block_live, block_pos):
            sv, n_k, msums, rejected = local_block(block_ids, block_live,
                                                   bank, write_bank=False)
            p = partials_of(sv, n_k, msums, rejected)
            d = deltas_of(sv)
            lv = votes(block_live, d)
            if quantile:
                return p, SD.fold_moments(d, lv)
            return p, SD.fold_proj(_split(d, params), n_k, lv, block_pos,
                                   n_slots, normals)

        partials, sketch = BK.stream_blocks(pass1, ids, live,
                                            self._block_size,
                                            positions=True, skip=skip)
        if quantile:
            lo, width = SD.hist_edges(sketch)

            def fold2(sv, n_k, block_live, block_pos):
                d = deltas_of(sv)
                return SD.fold_hist(d, votes(block_live, d), lo, width)
        else:
            w, den = SD.selection_weights(method, sketch,
                                          self.defense.num_adversaries,
                                          self.defense.multikrum_m)

            def fold2(sv, n_k, block_live, block_pos):
                d = deltas_of(sv)
                wb = w[block_pos.start:block_pos.stop].to(d.dtype)
                return torch.sum(d * wb[:, None], dim=0)

        def pass2(block_ids, block_live, block_pos, *banks):
            sv, n_k, _, _ = local_block(block_ids, block_live, bank)
            out = fold2(sv, n_k, block_live, block_pos)
            return (out, *banks) if banks else out

        folded = BK.stream_blocks(pass2, ids, live, self._block_size,
                                  banks=bank, positions=True, skip=skip)
        if bank is not None:
            folded = folded[0]
        if not quantile:
            return partials, folded / den
        if method == "median":
            return partials, SD.median_from_hist(folded, lo, width,
                                                 sketch.count)
        ks = to_device(SD.trim_table(self.defense.trim_frac, n_slots),
                       self.device)
        return partials, SD.trimmed_mean_from_hist(folded, lo, width,
                                                   sketch.count, ks)

    # -- the client-keyed banks (core/statebank.py) ------------------------

    def _ensure_ef_bank(self, state: ServerState) -> None:
        """The bulk engine's error-feedback bank, made at the first
        compressed round: a zero row per client of what goes on the wire
        (the aggregated variables; round 0 sends the uncorrected delta,
        as the stacked zero residual)."""
        if self.ef_bank is not None:
            return
        wire = self._view_vars(state.variables)
        self.ef_bank = SB.ClientStateBank.zeros(
            "ef_residual", wire, self.arrays.num_clients)
        telemetry.set_gauge(self.counters, "compress.ratio",
                            C.wire_ratio(self.cspec, wire))
        SB.note_bank(self.ef_bank, self.counters)

    def _ensure_adapter_bank(self, state: ServerState) -> None:
        """The private adapter bank of a personalized run, made at its
        first round from the state's (init-valued) adapters, so that
        calling :meth:`init` again for a snapshot never resets a trained
        bank."""
        if self.adapter_bank is not None:
            return
        rows = PP.init_bank(self.peft, state.variables,
                            self.arrays.num_clients)
        self.adapter_bank = SB.ClientStateBank("adapter", rows)
        telemetry.set_gauge(self.counters, "peft.personal_bank_mb",
                            PP.bank_bytes(rows) / 1e6)
        SB.note_bank(self.adapter_bank, self.counters)

    def bank_state(self) -> dict:
        """The client-state banks, ``{name: rows}`` (the adapter bank and
        the bulk engine's error-feedback bank); empty before a bank is
        made."""
        return {bank.name: bank.savable()
                for bank in (self.adapter_bank, self.ef_bank)
                if bank is not None}

    def restore_banks(self, state: ServerState, blob) -> None:
        """Adopt banked rows (the inverse of :meth:`bank_state`). An empty
        blob, or one without this run's banks, leaves the fresh banks to
        be made at the first round."""
        if not blob:
            return
        if "adapter" in blob and self._personalized():
            self._ensure_adapter_bank(state)
            self.adapter_bank = SB.ClientStateBank.from_savable(
                "adapter", self.adapter_bank.rows, blob["adapter"])
        if ("ef_residual" in blob and self._bulk.enabled()
                and self.cspec.enabled()):
            self._ensure_ef_bank(state)
            self.ef_bank = SB.ClientStateBank.from_savable(
                "ef_residual", self.ef_bank.rows, blob["ef_residual"])

    def evaluate_global(self, state: ServerState) -> dict:
        m = self.evaluator(state.variables, self.arrays.test_x,
                           self.arrays.test_y)
        return {k: float(v) for k, v in m.items()}

    def evaluate_train(self, state: ServerState) -> dict:
        m = self.evaluator(state.variables, self.arrays.x, self.arrays.y)
        return {k: float(v) for k, v in m.items()}

    def _anatomy_path(self) -> str:
        """The anatomy ring's name for the round's body."""
        if self._bulk.enabled():
            return "bulk"
        if self._personalized():
            return "personal"
        return "stacked"

    def run(self, metrics_sink=None) -> ServerState:
        """The round loop: train, log the round's metrics, evaluate every
        ``eval_every`` rounds and after the last. With ``fuse_rounds >
        1`` the loop runs in fused blocks (:meth:`_run_fused`). With
        ``profile_rounds > 0`` the perf pair rides along
        (``core/perf.py``), and the anatomy plane times the ``local`` and
        ``eval`` phases; the round's wall and its ``local`` phase end when
        the host has read the round's metrics (the round's one sync), so
        they cover the device's work, not the enqueueing."""
        state = self.init()
        fed = self.cfg.fed
        rp = P.RoundPerf(self)
        try:
            if self._fuse > 1:
                return self._run_fused(state, metrics_sink, rp.profiler,
                                       rp.monitor)
            anat = AN.ANATOMY.enabled
            path = self._anatomy_path()
            for r in range(fed.num_rounds):
                export.set_round(r, self.cfg)
                if anat:
                    AN.ANATOMY.begin_round(r, path=path)
                with rp.round(r), telemetry.maybe_span("sim_round", round=r):
                    state, train_m = self.run_round(state)
                    t_disp = time.perf_counter() if anat else 0.0
                    record = {"round": r, **consume_round_counters(
                        train_m, self.counters)}
                    if anat:
                        AN.ANATOMY.phase("local",
                                         time.perf_counter() - t_disp)
                if (r + 1) % fed.eval_every == 0 or r == fed.num_rounds - 1:
                    t_ev = time.perf_counter() if anat else 0.0
                    test_m = self.evaluate_global(state)
                    if anat:
                        AN.ANATOMY.phase("eval", time.perf_counter() - t_ev)
                    record.update({"test_acc": test_m["acc"],
                                   "test_loss": test_m["loss"]})
                if metrics_sink is not None:
                    metrics_sink.log(record)
                if anat:
                    AN.ANATOMY.end_round()
        finally:
            rp.close()
        return state

    def _run_fused(self, state: ServerState, metrics_sink, profiler=None,
                   monitor=None) -> ServerState:
        """The round loop in blocks of up to ``fuse_rounds`` rounds
        (``core/fuse.py`` ``drive``, shared with the harness): block k + 1
        is enqueued before block k's metrics come back, and the blocks
        end on every evaluation round, so the evaluation sees the state
        the per-round loop would. The records equal the per-round
        loop's."""
        fed = self.cfg.fed
        box = [state]

        def run_block(length):
            box[0], metrics = self.run_block(box[0], length)
            return metrics

        def make_records(start, rows):
            return [{"round": start + i,
                     **consume_round_counters(row, self.counters)}
                    for i, row in enumerate(rows)]

        def log(record):
            if metrics_sink is not None:
                metrics_sink.log(record)

        def boundary_hook(r_last, last):
            export.set_round(r_last, self.cfg)
            if (r_last + 1) % fed.eval_every == 0 or (
                    r_last == fed.num_rounds - 1):
                anat = AN.ANATOMY.enabled
                t_ev = time.perf_counter() if anat else 0.0
                test_m = self.evaluate_global(box[0])
                if anat:
                    # the block's entry closed at its flush
                    AN.ANATOMY.amend_last("eval", time.perf_counter() - t_ev)
                last.update({"test_acc": test_m["acc"],
                             "test_loss": test_m["loss"]})
            log(last)

        self.last_blocks = FU.drive(
            run_block, FU.plan_blocks(0, fed.num_rounds, self._fuse,
                                      fed.eval_every),
            make_records=make_records, log=log, boundary_hook=boundary_hook,
            programs=self.cohort_update.programs, profiler=profiler,
            monitor=monitor, span=lambda start, rounds: telemetry.maybe_span(
                "sim_block", start=start, rounds=rounds))
        return box[0]


def _split(flat: torch.Tensor, like: Params) -> Params:
    """``[B, D]`` as a tree of ``[B, d_leaf]`` column views, leaves in
    ``like``'s order."""
    out, off = {}, 0
    for k, v in like.items():
        out[k] = flat[:, off:off + v.numel()]
        off += v.numel()
    return out
