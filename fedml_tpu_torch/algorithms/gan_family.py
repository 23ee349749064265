"""FedGDKD, the fork's GAN-based data-free knowledge distillation
(``fedml_tpu.algorithms.gan_family.FedGDKDSim``): a federated conditional
generator and per-client stateful classifiers.

A round, in the JAX package's order:

1. Drift correction: the cohort's members that were not in the last
   round's cohort distill from the last round's distillation set against
   its mean teacher (from round 1 on).
2. The adversarial phase: each member trains the global generator and its
   own classifier (the discriminator) on its data
   (:class:`~fedml_tpu_torch.algorithms.gan_core.GanCohortUpdate`), the
   cohort in size-sorted groups.
3. FedAvg of the generators only, weighted by the clients' sample counts.
4. The distillation set, generated by the averaged generator.
5. Each member's classifier distills against the leave-one-out mean
   teacher, ``(sum of the cohort's logits - its own) / max(C - 1, 1)``;
   the mean of the logits becomes the next round's teacher.

A round reads nothing back from the device: the cohort, the last round's
cohort (``prev_sampled``, a host tensor), the batch orders and the sample
counts that group the cohort and set each group's steps are on the host,
so whether a member is new is a host decision. ``TrainConfig.cohort_fused``
(the JAX package's cohort-grouped networks) is read and ignored: the
lanes run ``vmap``-ped, the JAX package's ``cohort_fused=False`` path.
As in the JAX package, the GAN family trains in float32 whatever
``compute_dtype`` says and ignores ``prox_mu``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from fedml_tpu_torch.algorithms import gan_core as G
from fedml_tpu_torch.algorithms.base import build_evaluator, make_task
from fedml_tpu_torch.algorithms.stack_utils import (
    evaluate_stack,
    size_grouped_lanes,
    stack_gather,
    stack_scatter,
    vmap_init,
)
from fedml_tpu_torch.config import ExperimentConfig
from fedml_tpu_torch.core import random as R
from fedml_tpu_torch.core import tree as T
from fedml_tpu_torch.core.device import resolve_device, to_device
from fedml_tpu_torch.data.federated import FederatedData, arrays_and_batch
from fedml_tpu_torch.models.base import FedModel, Params
from fedml_tpu_torch.models.gan import GanModel

# init salts: the generator from (seed, INIT, 0), client i's classifier
# from (seed, INIT, 1, i)
INIT = 0x7FFFFFFF


class FedGDKDState(NamedTuple):
    gen_vars: Params  # the global generator
    cls_stack: Params  # [num_clients, ...] the clients' classifiers
    prev_synth_x: torch.Tensor  # the last round's distillation set
    prev_synth_y: torch.Tensor
    prev_teacher: torch.Tensor  # [S, K] the last cohort's mean logits
    prev_sampled: torch.Tensor  # [num_clients] bool, on the host
    round: int


class FedGDKDSim:
    """FedGDKD on one device.

    ``sampler(round, num_clients, clients_per_round)`` returns the round's
    cohort ids and ``batch_orders(round, client)`` a client's per-epoch
    batch orders (real samples first), as in
    :class:`~fedml_tpu_torch.algorithms.fedavg.FedAvgSim`.
    ``draws(stream, round, slots, shapes)``
    (:data:`fedml_tpu_torch.core.random.Draws`) makes the round's draws:
    ``"gan_z"`` (``{"z": (epochs, S, B, nz)}``, standard normal) and
    ``"gan_labels"`` (``{"labels": (epochs, S, B)}``, whole numbers in
    ``[0, K)``) for each cohort member's adversarial steps, ``S`` the
    largest steps an epoch; ``"synth"`` (``{"z": (S_set / B, B, nz)}``,
    slot 0) for the distillation set. The default,
    :class:`~fedml_tpu_torch.core.random.DeviceDraws`, draws on the
    device; the hooks let a test replay the JAX package's draws. All of a
    round's draws are made before its first step, so no random op runs
    inside a graph.

    ``counters["fedgdkd.drift_corrected"]`` counts the drift-corrected
    members over the run; ``last_groups`` holds the last round's groups
    (clients, steps an epoch) and ``last_drift`` its drift-corrected
    members."""

    def __init__(self, gen: GanModel, classifier: FedModel,
                 data: FederatedData, cfg: ExperimentConfig,
                 device: str | torch.device = "cuda",
                 sampler: Callable | None = None,
                 batch_orders: Callable | None = None,
                 draws: R.Draws | None = None):
        self.device = resolve_device(device)
        for name, m in (("generator", gen.model), ("classifier",
                                                   classifier)):
            if m.device != self.device:
                raise ValueError(f"the {name} is on {m.device}, the "
                                 f"simulation on {self.device}")
        self.gen, self.classifier, self.cfg = gen, classifier, cfg
        self.task = make_task(data.task)
        if self.task.name != "classification":
            raise ValueError("FedGDKD distills classifiers; the data's task "
                             f"is {self.task.name!r}")
        self.arrays, self.batch_size = arrays_and_batch(data, cfg.data,
                                                        self.device)
        b = self.batch_size
        self.max_n = self.arrays.max_client_samples
        self.steps_per_epoch = self.max_n // b
        self.synth_size = (cfg.gan.distillation_size // b) * b or b
        graphed = self.device.type == "cuda"
        self.gan_update = G.GanCohortUpdate(gen, classifier, cfg.train,
                                            cfg.gan, b, graphed)
        self.generate = G.build_dataset_generator(gen, self.synth_size, b)
        self.extract = G.build_logit_extractor(classifier)
        self.kd_update = G.KDUpdate(classifier, cfg.train, cfg.gan,
                                    self.synth_size, b, graphed)
        self.evaluator = build_evaluator(classifier, self.task)
        self._host_mask = self.arrays.mask.cpu()
        self._host_counts = self.arrays.counts.cpu().numpy()
        self.sampler = sampler or self._sample
        self.batch_orders = batch_orders or self._orders
        seed = cfg.seed
        self.draws = draws or R.DeviceDraws(
            {"gan_z": seed, "gan_labels": seed, "synth": seed}, self.device,
            high={"gan_labels": max(gen.num_classes, 1)})
        self.counters: dict[str, float] = {"fedgdkd.drift_corrected": 0}
        self.last_groups: list[tuple[int, int]] = []
        self.last_drift = 0

    def _sample(self, round_idx, num_clients, clients_per_round):
        return R.sample_clients(R.generator(self.cfg.seed, round_idx),
                                num_clients, clients_per_round)

    def _orders(self, round_idx, client):
        gen = R.generator(self.cfg.seed, round_idx, client)
        return [R.padded_perm(gen, self._host_mask[client], self.max_n)
                for _ in range(self.cfg.train.epochs)]

    def init(self) -> FedGDKDState:
        n, seed = self.arrays.num_clients, self.cfg.seed
        x_shape = tuple(self.arrays.x.shape[1:])
        s, dev = self.synth_size, self.device
        return FedGDKDState(
            gen_vars=self.gen.init(R.generator(seed, INIT, 0)),
            cls_stack=vmap_init(self.classifier.init, n, seed, INIT, 1),
            prev_synth_x=torch.zeros((s,) + x_shape, device=dev),
            prev_synth_y=torch.zeros(s, dtype=torch.int64, device=dev),
            prev_teacher=torch.zeros(s, self.arrays.num_classes, device=dev),
            prev_sampled=torch.zeros(n, dtype=torch.bool),
            round=0)

    def _ids(self, host_ids: Sequence[int]) -> torch.Tensor:
        return to_device(torch.as_tensor(np.asarray(host_ids, np.int64)),
                         self.device)

    def _drift_correct(self, state: FedGDKDState, cohort: np.ndarray,
                       cls_vars: Params) -> Params:
        """Step 1: the members new to this round's cohort distill from the
        last round's set against its mean teacher; the others keep their
        classifiers."""
        prev = state.prev_sampled.numpy()
        new = (np.flatnonzero(~prev[cohort]) if state.round > 0
               else np.zeros(0, np.int64))
        self.last_drift = len(new)
        if not len(new):
            return cls_vars
        self.counters["fedgdkd.drift_corrected"] += len(new)
        pos = self._ids(new)
        teachers = state.prev_teacher.expand(len(new),
                                             *state.prev_teacher.shape)
        corrected, _ = self.kd_update(stack_gather(cls_vars, pos),
                                      state.prev_synth_x,
                                      state.prev_synth_y, teachers)
        return stack_scatter(cls_vars, pos, corrected)

    def _adversarial(self, state: FedGDKDState, cohort: np.ndarray,
                     ids: torch.Tensor, cls_vars: Params):
        """Step 2: the cohort's adversarial training in size-sorted groups
        of ``cohort_groups`` (0: groups of about 2), each group stepping
        its largest member's ``ceil(n_k / B)`` steps an epoch."""
        a, cfg, b = self.arrays, self.cfg, self.batch_size
        epochs, r = cfg.train.epochs, state.round
        orders = torch.stack([
            torch.stack(list(self.batch_orders(r, c))[:epochs])
            for c in cohort.tolist()]).long()
        shape = (epochs, self.steps_per_epoch, b)
        slots = cohort.tolist()
        z = self.draws("gan_z", r, slots, {"z": shape + (self.gen.nz,)})["z"]
        labels = self.draws("gan_labels", r, slots,
                            {"labels": shape})["labels"].long()
        self.last_groups = []

        def group(cls_g, ids_g, orders_g, z_g, labels_g, counts):
            steps = G.dynamic_trip_count(counts.max(), b,
                                         self.steps_per_epoch)
            self.last_groups.append((len(counts), steps))
            return self.gan_update(
                state.gen_vars, cls_g, a.idx.index_select(0, ids_g),
                a.mask.index_select(0, ids_g), a.x, a.y, orders_g, z_g,
                labels_g, steps)

        return size_grouped_lanes(
            group, (cls_vars, ids, to_device(orders, self.device), z, labels),
            self._host_counts[cohort], cfg.train.cohort_groups)

    def run_round(self, state: FedGDKDState):
        """One round; the metrics (``g_loss``, ``d_loss``, ``kd_loss``)
        stay on the device."""
        a = self.arrays
        cohort = np.asarray(torch.as_tensor(self.sampler(
            state.round, a.num_clients,
            self.cfg.fed.clients_per_round)).tolist(), np.int64)
        ids = self._ids(cohort)
        cls_vars = stack_gather(state.cls_stack, ids)
        cls_vars = self._drift_correct(state, cohort, cls_vars)
        g_stack, cls_vars, n_k, sums = self._adversarial(state, cohort, ids,
                                                         cls_vars)
        gen_vars = T.tree_weighted_mean(g_stack, n_k)
        z = self.draws("synth", state.round, [0], {
            "z": (self.synth_size // self.batch_size, self.batch_size,
                  self.gen.nz)})["z"][0]
        synth_x, synth_y = self.generate(gen_vars, z)
        logits = self.extract(cls_vars, synth_x)  # [C, S, K]
        cls_vars, kd_sums = self.kd_update(cls_vars, synth_x, synth_y,
                                           G.leave_one_out_teacher(logits))
        sampled = torch.zeros_like(state.prev_sampled)
        sampled[torch.from_numpy(cohort)] = True

        def mean(total, batches):
            return torch.sum(total) / torch.clamp(torch.sum(batches), min=1.0)

        metrics = {
            "g_loss": mean(sums["g_loss_sum"], sums["batches"]),
            "d_loss": mean(sums["d_loss_sum"], sums["batches"]),
            "kd_loss": mean(kd_sums["kd_loss_sum"], kd_sums["batches"]),
        }
        return FedGDKDState(
            gen_vars=gen_vars,
            cls_stack=stack_scatter(state.cls_stack, ids, cls_vars),
            prev_synth_x=synth_x, prev_synth_y=synth_y,
            prev_teacher=torch.mean(logits, 0), prev_sampled=sampled,
            round=state.round + 1), metrics

    def evaluate_clients(self, state: FedGDKDState) -> dict:
        """Every client's classifier on the global test set, averaged over
        all ``num_clients`` clients."""
        a = self.arrays
        return evaluate_stack(self.evaluator, state.cls_stack, a.test_x,
                              a.test_y, a.num_clients)

    def run(self, metrics_sink=None) -> FedGDKDState:
        """The round loop: train, log the round's losses, evaluate the
        clients every ``eval_every`` rounds and after the last."""
        state = self.init()
        fed = self.cfg.fed
        for r in range(fed.num_rounds):
            state, m = self.run_round(state)
            record = {"round": r, **{k: float(v) for k, v in m.items()}}
            if (r + 1) % fed.eval_every == 0 or r == fed.num_rounds - 1:
                ev = self.evaluate_clients(state)
                record.update({"test_acc": ev["test_acc"],
                               "test_loss": ev["test_loss"]})
            if metrics_sink is not None:
                metrics_sink.log(record)
        return state
