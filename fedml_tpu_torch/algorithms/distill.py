"""The fork's distillation baselines without a generator
(``fedml_tpu.algorithms.distill``): FedMD, FD (+FAug) and FedArjun.

- :class:`FedMDSim`: a public set made of client shares
  (:func:`build_public_set`). Every client pretrains on the public set,
  then on its own data. A round: the cohort's eval-mode logits on the
  public set, their mean (the consensus), then each member's *digest*
  (mean CE plus ``kd_lambda`` x the logits' MSE toward the consensus, in
  the public set's order) and *revisit* (``revisit_epochs`` epochs of
  CE on its own data, one optimizer lifetime).
- :class:`FDSim`: federated distillation by per-label mean logits. Each
  member trains with ``(1 - g) CE + g CE(logits, softmax(teacher[y]))``,
  ``g = kd_gamma`` where some other client has shared logits for the
  label and 0 elsewhere, and sums its train-mode logits per label; the
  server hands each member the leave-one-out mean of the others' label
  means. (FAug's shared-GAN augmentation is a TODO in the reference, as
  in the JAX package.)
- :class:`FedArjunSim`: a shared adapter (``cfg.model``) and a private
  local model (``lr``) a client. A round: adapter -> local KD, local
  training, local -> adapter KD, then the adapters' ``n_k``-weighted
  mean. The KD loss is ``(1 - kd_lambda) CE + kd_lambda
  SoftTarget(T)``, the teacher in eval mode, the student in train mode.

Every phase runs lanes, ``torch.func.vmap``-ped gated steps, eagerly on
the CPU and one CUDA graph replay a group-step on the card: a cohort in
size-sorted groups (``stack_utils.size_grouped_lanes``, each group
stepping its largest member's ``ceil(n_k / B)`` steps an epoch), FedMD's
digest and public pretraining as one group of every lane (the same
public batch for each). A model with dropout takes its keep masks as
step inputs, drawn a group at a time before its first step, each phase
from a stream of its own (``core/random.py``). The hooks (``sampler``,
``batch_orders(round, client, phase, epochs)``, ``draws``) are
:class:`~fedml_tpu_torch.algorithms.client_sim.ClientSim`'s; FedMD's
pretraining draws at round 0. A round reads nothing back from the
device.

Stated divergences from the JAX package: the masks are drawn per group
at the group's own step count, not per step from a key; FD's label sums
add ``one_hot(y)`` outer ``logits * w`` over the batch, where the JAX
package scatter-adds the rows (the float sums run in another order).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from fedml_tpu_torch.algorithms import gan_core as G
from fedml_tpu_torch.algorithms.base import (
    CohortUpdate,
    apply_updates,
    build_evaluator,
    finalize_sums,
    lane_batches,
    make_client_optimizer,
    step_masks,
)
from fedml_tpu_torch.algorithms.client_sim import ClientSim
from fedml_tpu_torch.algorithms.kd import logits_mse, soft_target
from fedml_tpu_torch.algorithms.stack_utils import (
    evaluate_stack,
    stack_gather,
    stack_scatter,
    vmap_init,
)
from fedml_tpu_torch.config import ExperimentConfig, TrainConfig
from fedml_tpu_torch.core import random as R
from fedml_tpu_torch.core import tree as T
from fedml_tpu_torch.core.device import to_device
from fedml_tpu_torch.data.federated import FederatedData
from fedml_tpu_torch.models.base import FedModel, Params

# init salts: client i's model from (seed, INIT, i); FedArjun's adapter
# from (seed, INIT, 0) and client i's local model from (seed, INIT, 1, i)
INIT = 0x7FFFFFFF


def build_public_set(data: FederatedData, public_size: int, batch_size: int,
                     seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The FedMD public set from equal client shares (the reference's
    ``share_data``): ``public_size`` rounded down to whole batches (at
    least one), ``ceil(size / N)`` samples drawn without replacement from
    each client, topped up from the samples no client gave, then by
    repeats; a copy of the JAX package's numpy draws, bit for bit."""
    rng = np.random.default_rng(seed)
    n_clients = data.num_clients
    public_size = max(batch_size, (public_size // batch_size) * batch_size)
    per_client = -(-public_size // n_clients)
    picks = []
    for i in range(n_clients):
        idx = data.train_idx_map[i]
        picks.append(rng.choice(idx, min(per_client, len(idx)),
                                replace=False))
    picked = np.concatenate(picks)
    if len(picked) < public_size:
        pool = np.setdiff1d(np.arange(len(data.x_train)), picked)
        extra = rng.choice(pool, min(len(pool), public_size - len(picked)),
                           replace=False)
        picked = np.concatenate([picked, extra])
    if len(picked) < public_size:
        reps = rng.choice(picked, public_size - len(picked), replace=True)
        picked = np.concatenate([picked, reps])
    picked = picked[:public_size]
    return data.x_train[picked], data.y_train[picked]


def lane_step(opt, grad_fn, carry, args, valid=None):
    """One optimizer step of a lane from ``grad_fn(params, stats, *args)
    -> (grads, (loss, (new stats, aux)))``; with ``valid`` (a bool
    tensor) a gated one: where it is False the parameters, statistics and
    optimizer state keep their values. Returns the new carry and aux."""
    params = carry["params"]
    grads, (_, (stats, aux)) = grad_fn(params, carry["stats"], *args)
    updates, opt_state = opt.update(grads, carry["opt"], params)
    new = {"params": apply_updates(params, updates), "stats": stats,
           "opt": opt_state}
    if valid is not None:
        new = T.tree_map(lambda n, o: torch.where(valid, n, o), new,
                         {k: carry[k] for k in new})
    return {**carry, **new}, aux


def lane_carry(model: FedModel, opt, lane_vars: Params) -> dict:
    """The carry of lanes that start from their own ``lane_vars`` (``[G,
    ...]``): parameters, statistics and a fresh optimizer state."""
    params, stats = G.split_vars(lane_vars, model.stat_names)
    lanes = next(iter(params.values())).shape[0]
    return {"params": {k: v.detach().clone() for k, v in params.items()},
            "stats": {k: v.detach().clone() for k, v in stats.items()},
            "opt": opt.init(params, (lanes,))}


def finish(carry: dict, like: Params) -> Params:
    merged = {**carry["params"], **carry["stats"]}
    return {k: merged[k] for k in like}


class PublicUpdate:
    """``update(lane_vars, x, y, epochs, teacher=None, masks=None) ->
    lane_vars``: FedMD's supervised loop over the public set for G lanes
    (the JAX package's ``_build_supervised_kd_loop``): ``epochs`` passes
    over the ``S / B`` batches of ``x``/``y`` in order, the same batch for
    every lane, each step the mean CE, plus with ``kd_weight`` that times
    :func:`~fedml_tpu_torch.algorithms.kd.logits_mse` toward the rows of
    ``teacher`` (``[S, K]``, one for every lane: the digest), a fresh
    client optimizer each call. ``masks`` (``{site: [G, epochs, S / B, B,
    ...]}``) are the lanes' keep masks. One CUDA graph replay a step on
    the card."""

    def __init__(self, model: FedModel, train_cfg: TrainConfig, size: int,
                 batch_size: int, graphed: bool, kd_weight: float | None,
                 family: str):
        if size % batch_size:
            raise ValueError(f"size {size} is not a multiple of the batch "
                             f"size {batch_size}")
        self.model, self.size, self.batch_size = model, size, batch_size
        self.kd_weight = kd_weight
        self.opt = make_client_optimizer(train_cfg)
        self.grad = torch.func.grad_and_value(self._loss, has_aux=True)
        self.vstep = torch.func.vmap(self._lane_step,
                                     in_dims=(0, None, None, None, 0))
        self.programs = G.graph_programs(graphed, self._graph_step, family)

    def _loss(self, params, stats, xb, yb, tb, masks):
        logits, new = self.model.apply_train({**params, **stats}, xb,
                                             masks=masks)
        loss = F.cross_entropy(logits, yb.long())
        if self.kd_weight is not None:
            loss = loss + self.kd_weight * logits_mse(logits, tb)
        return loss, ({k: new[k] for k in stats}, ())

    def _lane_step(self, carry, xb, yb, tb, masks):
        return lane_step(self.opt, self.grad, carry, (xb, yb, tb, masks))[0]

    def _graph_step(self, carry, consts, fixed, batch):
        x, y = fixed
        i, masks = batch
        # the batch's rows by a device index, so every replay reads its own
        rows = torch.arange(self.batch_size, device=x.device) \
            + i * self.batch_size
        tb = consts["teacher"].index_select(0, rows) if consts else None
        return self.vstep(carry, x.index_select(0, rows),
                          y.index_select(0, rows), tb, masks)

    def __call__(self, lane_vars: Params, x, y, epochs: int, teacher=None,
                 masks=None) -> Params:
        lanes = next(iter(lane_vars.values())).shape[0]
        n_b = self.size // self.batch_size
        starts = to_device(torch.arange(n_b), x.device)
        batches = [(starts[i], step_masks(masks, e, i))
                   for e in range(epochs) for i in range(n_b)]
        carry = G.run_steps(self.programs, lanes, self._graph_step,
                            lane_carry(self.model, self.opt, lane_vars),
                            {} if teacher is None else {"teacher": teacher},
                            (x, y), batches)
        return finish(carry, lane_vars)


class FDUpdate:
    """``update(lane_vars, teacher, has_teacher, idx_rows, mask_rows, x, y,
    orders, steps, masks=None) -> (lane_vars, label means [G, K, K], label
    counts [G, K])``: FD's local training of G lanes (the JAX package's
    ``FDSim._build_local_update``, vmapped). Each step:
    ``(1 - g) CE + g CE(logits, softmax(teacher[y]))`` per row, ``g =
    kd_gamma * has_teacher[y]``, the ``w``-weighted sum over ``max(sum w,
    1)``; gated where the batch's weights are all 0. The step's
    train-mode logits, weighted, add to the lane's per-label sums."""

    def __init__(self, model: FedModel, train_cfg: TrainConfig,
                 kd_gamma: float, num_classes: int, batch_size: int,
                 graphed: bool):
        self.model, self.kd_gamma, self.k = model, kd_gamma, num_classes
        self.batch_size, self.epochs = batch_size, train_cfg.epochs
        self.opt = make_client_optimizer(train_cfg)
        self.grad = torch.func.grad_and_value(self._loss, has_aux=True)
        self.vstep = torch.func.vmap(self._lane_step)
        self.programs = G.graph_programs(graphed, self._graph_step,
                                         "fd_step")

    def _loss(self, params, stats, xb, yb, wb, teacher, use_t, masks):
        logits, new = self.model.apply_train({**params, **stats}, xb,
                                             masks=masks)
        ce = F.cross_entropy(logits, yb, reduction="none")
        soft = F.softmax(teacher[yb], dim=-1)
        kd_ce = -torch.sum(soft * F.log_softmax(logits, dim=-1), dim=-1)
        gamma = self.kd_gamma * use_t[yb]
        per_row = (1 - gamma) * ce + gamma * kd_ce
        loss = torch.sum(per_row * wb) / torch.clamp(torch.sum(wb), min=1.0)
        return loss, ({k: new[k] for k in stats}, logits)

    def _lane_step(self, carry, xb, yb, wb, masks):
        yb = yb.long()
        out, logits = lane_step(
            self.opt, self.grad, carry,
            (xb, yb, wb, carry["teacher"], carry["use_t"], masks),
            valid=torch.sum(wb) > 0)
        onehot = (yb[:, None] == torch.arange(self.k, device=yb.device)
                  ).to(logits.dtype)
        out["lab_sum"] = carry["lab_sum"] + torch.sum(
            onehot[:, :, None] * (logits.detach() * wb[:, None])[:, None],
            dim=0)
        out["lab_cnt"] = carry["lab_cnt"] + torch.sum(
            onehot * wb[:, None], dim=0)
        return out

    def step(self, carry, x, y, b_idx, w_b, masks=None):
        return self.vstep(carry, x[b_idx], y[b_idx], w_b, masks or {})

    def _graph_step(self, carry, consts, fixed, batch):
        return self.step(carry, *fixed, *batch)

    def __call__(self, lane_vars, teacher, has_teacher, idx_rows, mask_rows,
                 x, y, orders, steps: int, masks=None):
        lanes = idx_rows.shape[0]
        carry = lane_carry(self.model, self.opt, lane_vars)
        carry.update(teacher=teacher.clone(),
                     use_t=has_teacher.to(teacher.dtype),
                     lab_sum=torch.zeros_like(teacher),
                     lab_cnt=torch.zeros(teacher.shape[:2],
                                         device=teacher.device))
        batches = [(b_idx, w_b, step_masks(masks, i // steps, i % steps))
                   for i, (b_idx, w_b) in enumerate(lane_batches(
                       idx_rows, mask_rows, orders, self.epochs, steps,
                       self.batch_size))]
        carry = G.run_steps(self.programs, lanes, self._graph_step, carry,
                            {}, (x, y), batches)
        lab_avg = carry["lab_sum"] / torch.clamp(carry["lab_cnt"],
                                                 min=1.0)[..., None]
        return finish(carry, lane_vars), lab_avg, carry["lab_cnt"]


def leave_one_out_labels(lab_avg: torch.Tensor, lab_cnt: torch.Tensor):
    """FD's exchange: ``[C, K, K]`` label means and ``[C, K]`` counts to
    each member's teacher, ``(sum over the members that saw label l of
    their means - its own) / (their number - its own share)``, and where
    some other member saw l (``have``, ``[C, K]`` bool)."""
    seen = (lab_cnt > 0).to(lab_avg.dtype)
    tot_sum = torch.sum(lab_avg * seen[..., None], dim=0)
    tot_m = torch.sum(seen, dim=0)
    m_other = torch.clamp(tot_m[None] - seen, min=1.0)
    loo = (tot_sum[None] - lab_avg * seen[..., None]) / m_other[..., None]
    return loo, (tot_m[None] - seen) > 0


class TransferUpdate:
    """``update(student_vars, teacher_vars, idx_rows, mask_rows, x, y,
    orders, steps, masks=None) -> student_vars``: FedArjun's KD transfer
    of G lanes over each lane's own padded data (the JAX package's
    ``_build_kd_transfer``): ``epochs`` epochs of gated steps, each the
    loss ``(1 - kd_lambda) CE_w + kd_lambda soft_target(s, t, T, w)``,
    the student in train mode (``masks`` its keep masks, ``{site: [G,
    epochs, S, B, ...]}``), the teacher in eval mode; a fresh client
    optimizer each call. Both are lane-stacked ``[G, ...]``."""

    def __init__(self, student: FedModel, teacher: FedModel,
                 train_cfg: TrainConfig, kd_lambda: float,
                 temperature: float, epochs: int, batch_size: int,
                 graphed: bool, family: str):
        self.student, self.teacher = student, teacher
        self.kd_lambda, self.temperature = kd_lambda, temperature
        self.epochs, self.batch_size = epochs, batch_size
        self.opt = make_client_optimizer(train_cfg)
        self.grad = torch.func.grad_and_value(self._loss, has_aux=True)
        self.vstep = torch.func.vmap(self._lane_step)
        self.programs = G.graph_programs(graphed, self._graph_step, family)

    def _loss(self, params, stats, t_vars, xb, yb, wb, masks):
        s_logits, new = self.student.apply_train({**params, **stats}, xb,
                                                 masks=masks)
        t_logits = self.teacher.apply_eval(t_vars, xb).detach()
        ce = G.ce(s_logits, yb, wb)
        kd = soft_target(s_logits, t_logits, self.temperature, w=wb)
        loss = (1 - self.kd_lambda) * ce + self.kd_lambda * kd
        return loss, ({k: new[k] for k in stats}, ())

    def _lane_step(self, carry, t_vars, xb, yb, wb, masks):
        return lane_step(self.opt, self.grad, carry,
                         (t_vars, xb, yb, wb, masks),
                         valid=torch.sum(wb) > 0)[0]

    def _graph_step(self, carry, consts, fixed, batch):
        x, y = fixed
        b_idx, w_b, masks = batch
        return self.vstep(carry, consts, x[b_idx], y[b_idx], w_b, masks)

    def __call__(self, student_vars, teacher_vars, idx_rows, mask_rows, x,
                 y, orders, steps: int, masks=None):
        lanes = idx_rows.shape[0]
        batches = [(b_idx, w_b, step_masks(masks, i // steps, i % steps))
                   for i, (b_idx, w_b) in enumerate(lane_batches(
                       idx_rows, mask_rows, orders, self.epochs, steps,
                       self.batch_size))]
        carry = G.run_steps(self.programs, lanes, self._graph_step,
                            lane_carry(self.student, self.opt, student_vars),
                            teacher_vars, (x, y), batches)
        return finish(carry, student_vars)


class DistillSim(ClientSim):
    """What the three sims share: the hooks, the size-sorted groups of a
    cohort, the clients' evaluation (of the state's ``CLIENTS`` field)
    and the counts of group-steps run (``last_steps``, by the phase's
    mask stream, the last round's or FedMD's pretraining)."""

    CLIENTS = "model_stack"
    STREAMS = ("dropout", "dropout_public", "dropout_pretrain",
               "dropout_pretrain_private", "dropout_a2l", "dropout_l2a")

    def __init__(self, models: dict[str, FedModel], keep: dict,
                 data: FederatedData, cfg: ExperimentConfig, device,
                 sampler, batch_orders, draws):
        super().__init__(models, data, cfg, device, sampler, batch_orders,
                         draws, {s: cfg.seed for s in self.STREAMS},
                         p=keep)
        self.last_steps: dict[str, int] = {}

    def _lane_orders(self, round_idx: int, ids, phase: str, epochs: int):
        """``[lanes, epochs, max_n]`` batch orders of host ids ``ids`` on
        the device, one copy."""
        return self._stack_orders(ids, lambda c: self.batch_orders(
            round_idx, c, phase, epochs), epochs)

    def _count(self, stream: str, steps: int) -> None:
        self.last_steps[stream] = self.last_steps.get(stream, 0) + steps

    def _local(self, update: CohortUpdate, model: FedModel, stream: str,
               round_idx: int, ids_g, steps, hosts, lane_vars, phase="local"):
        """``update`` (a :class:`CohortUpdate` with its own epochs) of a
        group's lanes from their own variables, on their rows, orders of
        ``phase`` and ``stream``'s masks."""
        epochs = update.epochs
        idx, mask = self._rows(ids_g)
        self._count(stream, epochs * steps)
        # every variable starts from the lane's own; lane 0 gives shapes
        return update({k: v[0] for k, v in lane_vars.items()}, idx, mask,
                      self.arrays.x, self.arrays.y,
                      self._lane_orders(round_idx, hosts, phase, epochs),
                      steps, starts=lane_vars,
                      masks=self._site_masks(stream, round_idx, hosts,
                                             model.mask_sites,
                                             (epochs, steps)))

    def evaluate_clients(self, state) -> dict:
        """Every client's model on the global test set, averaged over all
        ``num_clients`` clients."""
        a = self.arrays
        return evaluate_stack(self.evaluator, getattr(state, self.CLIENTS),
                              a.test_x, a.test_y, a.num_clients)


def _with_epochs(train: TrainConfig, epochs: int) -> TrainConfig:
    return dataclasses.replace(train, epochs=max(1, epochs))


class FedMDState(NamedTuple):
    model_stack: Params  # [num_clients, ...] the clients' models
    round: int


class FedMDSim(DistillSim):
    """FedMD on one device (the module docstring). ``init(pretrain=True)``
    pretrains every client: the public set (``pretrain_epochs_public``
    epochs, one group of every lane), then its own data
    (``pretrain_epochs_private``, size-sorted groups). Metric:
    ``train_loss``, the revisit's weighted mean loss over the cohort."""

    def __init__(self, model: FedModel, data: FederatedData,
                 cfg: ExperimentConfig, device: str | torch.device = "cuda",
                 sampler: Callable | None = None,
                 batch_orders: Callable | None = None,
                 draws: R.Draws | None = None):
        super().__init__({"model": model},
                         {s: model.mask_keep for s in self.STREAMS}, data,
                         cfg, device, sampler, batch_orders, draws)
        self.model = model
        g, b = cfg.gan, self.batch_size
        px, py = build_public_set(data, g.public_size, b, cfg.data.seed)
        self.pub_x = to_device(torch.as_tensor(px, dtype=torch.float32),
                               self.device)
        self.pub_y = to_device(torch.as_tensor(py).long(), self.device)
        self.pub_size = px.shape[0]
        self.pub_train = PublicUpdate(model, cfg.train, self.pub_size, b,
                                      self.graphed, None, "public_step")
        self.digest = PublicUpdate(model, cfg.train, self.pub_size, b,
                                   self.graphed, g.kd_lambda, "digest_step")
        self.pretrain_local = CohortUpdate(
            model, self.task, _with_epochs(cfg.train,
                                           g.pretrain_epochs_private),
            b, self.graphed)
        # revisit: revisit_epochs epochs of private CE, one optimizer
        # lifetime
        self.revisit = CohortUpdate(
            model, self.task, _with_epochs(cfg.train, g.revisit_epochs), b,
            self.graphed)
        self.extract = G.build_logit_extractor(model)
        self.evaluator = build_evaluator(model, self.task)

    def _public(self, update: PublicUpdate, stream: str, round_idx: int,
                hosts, lane_vars, epochs: int, teacher=None):
        n_b = self.pub_size // self.batch_size
        self._count(stream, epochs * n_b)
        return update(lane_vars, self.pub_x, self.pub_y, epochs, teacher,
                      self._site_masks(stream, round_idx, hosts,
                                       self.model.mask_sites,
                                       (epochs, n_b)))

    def pretrain(self, stack: Params) -> Params:
        """Transfer learning (the reference's ``model_trainer.py:21-48``):
        the public set, then each client's own data."""
        g = self.cfg.gan
        n = self.arrays.num_clients
        everyone = np.arange(n)
        self.last_steps = {}
        stack = self._public(self.pub_train, "dropout_pretrain", 0,
                             everyone, stack,
                             max(1, g.pretrain_epochs_public))
        stack, _, _ = self._grouped(
            lambda ids_g, steps, hosts, lane_vars: self._local(
                self.pretrain_local, self.model,
                "dropout_pretrain_private", 0, ids_g, steps, hosts,
                lane_vars, phase="pretrain"),
            everyone, (stack,))
        return stack

    def init(self, pretrain: bool = True) -> FedMDState:
        stack = vmap_init(self.model.init, self.arrays.num_clients,
                          self.cfg.seed, INIT)
        if pretrain:
            stack = self.pretrain(stack)
        return FedMDState(stack, 0)

    def run_round(self, state: FedMDState):
        """One round; the metric stays on the device."""
        r, g = state.round, self.cfg.gan
        cohort = self._cohort(r)
        ids = self._ids(cohort)
        self.last_steps = {}
        mvars = stack_gather(state.model_stack, ids)
        consensus = torch.mean(self.extract(mvars, self.pub_x), 0)
        mvars = self._public(self.digest, "dropout_public", r, cohort, mvars,
                             max(1, g.digest_epochs), consensus)
        mvars, _, sums = self._grouped(
            lambda ids_g, steps, hosts, lane_vars: self._local(
                self.revisit, self.model, "dropout", r, ids_g, steps, hosts,
                lane_vars),
            cohort, (mvars,))
        fin = finalize_sums({k: v.sum() for k, v in sums.items()})
        return (FedMDState(stack_scatter(state.model_stack, ids, mvars),
                           r + 1), {"train_loss": fin["loss"]})


class FDState(NamedTuple):
    model_stack: Params  # [num_clients, ...]
    teacher: torch.Tensor  # [num_clients, K, K] per-label teacher logits
    has_teacher: torch.Tensor  # [num_clients, K] bool, a teacher a label
    round: int


class FDSim(DistillSim):
    """FD (federated distillation by label-mean logits), the FD half of
    FD+FAug: the cohort's local training with the per-label soft teacher
    (:class:`FDUpdate`, size-sorted groups), then the leave-one-out
    exchange (:func:`leave_one_out_labels`): a member's teacher rows and
    flags change only for labels some other member saw; the clients a
    round did not sample keep theirs, and their models, bit for bit. No
    metrics, as in the JAX package."""

    def __init__(self, model: FedModel, data: FederatedData,
                 cfg: ExperimentConfig, device: str | torch.device = "cuda",
                 sampler: Callable | None = None,
                 batch_orders: Callable | None = None,
                 draws: R.Draws | None = None):
        super().__init__({"model": model}, {"dropout": model.mask_keep},
                         data, cfg, device, sampler, batch_orders, draws)
        self.model = model
        self.num_classes = self.arrays.num_classes
        self.fd_update = FDUpdate(model, cfg.train, cfg.gan.kd_gamma,
                                  self.num_classes, self.batch_size,
                                  self.graphed)
        self.evaluator = build_evaluator(model, self.task)

    def init(self) -> FDState:
        n, k = self.arrays.num_clients, self.num_classes
        return FDState(
            vmap_init(self.model.init, n, self.cfg.seed, INIT),
            torch.zeros(n, k, k, device=self.device),
            torch.zeros(n, k, dtype=torch.bool, device=self.device), 0)

    def run_round(self, state: FDState):
        r = state.round
        cohort = self._cohort(r)
        ids = self._ids(cohort)
        self.last_steps = {}
        teacher = state.teacher.index_select(0, ids)
        has = state.has_teacher.index_select(0, ids)

        def run(ids_g, steps, hosts, lane_vars, teacher_g, has_g):
            idx, mask = self._rows(ids_g)
            epochs = self.cfg.train.epochs
            self._count("dropout", epochs * steps)
            return self.fd_update(
                lane_vars, teacher_g, has_g, idx, mask, self.arrays.x,
                self.arrays.y, self._lane_orders(r, hosts, "local", epochs),
                steps, self._site_masks("dropout", r, hosts,
                                        self.model.mask_sites,
                                        (epochs, steps)))

        mvars, lab_avg, lab_cnt = self._grouped(
            run, cohort, (stack_gather(state.model_stack, ids), teacher,
                          has))
        loo, have = leave_one_out_labels(lab_avg, lab_cnt)
        return FDState(
            stack_scatter(state.model_stack, ids, mvars),
            state.teacher.index_copy(
                0, ids, torch.where(have[..., None], loo, teacher)),
            state.has_teacher.index_copy(0, ids, has | have), r + 1), {}


class FedArjunState(NamedTuple):
    adapter_vars: Params  # the shared adapter
    local_stack: Params  # [num_clients, ...] the private local models
    round: int


class FedArjunSim(DistillSim):
    """FedArjun on one device (the module docstring): per size-sorted
    group of the cohort, adapter -> local KD (:class:`TransferUpdate`,
    ``kd_epochs`` epochs), local training (:class:`CohortUpdate`,
    ``train.epochs``), local -> adapter KD; then the adapters'
    ``n_k``-weighted mean. Only the sampled clients' local models change.
    No metrics, as in the JAX package."""

    CLIENTS = "local_stack"

    def __init__(self, adapter: FedModel, local: FedModel,
                 data: FederatedData, cfg: ExperimentConfig,
                 device: str | torch.device = "cuda",
                 sampler: Callable | None = None,
                 batch_orders: Callable | None = None,
                 draws: R.Draws | None = None):
        super().__init__(
            {"adapter": adapter, "local model": local},
            {"dropout_a2l": local.mask_keep, "dropout": local.mask_keep,
             "dropout_l2a": adapter.mask_keep},
            data, cfg, device, sampler, batch_orders, draws)
        self.adapter, self.local = adapter, local
        g, b = cfg.gan, self.batch_size
        self.kd_epochs = max(g.kd_epochs, 1)
        kw = dict(train_cfg=cfg.train, kd_lambda=g.kd_lambda,
                  temperature=g.kd_temperature, epochs=self.kd_epochs,
                  batch_size=b, graphed=self.graphed)
        self.a2l = TransferUpdate(local, adapter, family="a2l_step", **kw)
        self.l2a = TransferUpdate(adapter, local, family="l2a_step", **kw)
        self.local_train = CohortUpdate(local, self.task, cfg.train, b,
                                        self.graphed)
        self.evaluator = build_evaluator(local, self.task)

    def init(self) -> FedArjunState:
        seed = self.cfg.seed
        return FedArjunState(
            self.adapter.init(R.generator(seed, INIT, 0)),
            vmap_init(self.local.init, self.arrays.num_clients, seed, INIT,
                      1), 0)

    def _transfer(self, update: TransferUpdate, stream: str, round_idx,
                  ids_g, steps, hosts, student, teacher):
        idx, mask = self._rows(ids_g)
        self._count(stream, self.kd_epochs * steps)
        return update(
            student, teacher, idx, mask, self.arrays.x, self.arrays.y,
            self._lane_orders(round_idx, hosts, stream[len("dropout_"):],
                              self.kd_epochs),
            steps, self._site_masks(stream, round_idx, hosts,
                                    update.student.mask_sites,
                                    (self.kd_epochs, steps)))

    def run_round(self, state: FedArjunState):
        r = state.round
        cohort = self._cohort(r)
        ids = self._ids(cohort)
        self.last_steps = {}

        def run(ids_g, steps, hosts, l_vars):
            adapters = G.lanes_of(state.adapter_vars, len(hosts))
            l_vars = self._transfer(self.a2l, "dropout_a2l", r, ids_g,
                                    steps, hosts, l_vars, adapters)
            l_vars, n_k, _ = self._local(self.local_train, self.local,
                                         "dropout", r, ids_g, steps, hosts,
                                         l_vars)
            a_vars = self._transfer(self.l2a, "dropout_l2a", r, ids_g, steps,
                                    hosts, adapters, l_vars)
            return l_vars, a_vars, n_k

        l_vars, a_stack, n_k = self._grouped(
            run, cohort, (stack_gather(state.local_stack, ids),))
        return FedArjunState(T.tree_weighted_mean(a_stack, n_k),
                             stack_scatter(state.local_stack, ids, l_vars),
                             r + 1), {}
