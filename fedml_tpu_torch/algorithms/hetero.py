"""Heterogeneous-model clients (``fedml_tpu.algorithms.hetero``): the
fork's ``[(model, freq)]`` config, clients bucketed by architecture, and
FedGDKD over them.

The fork gives each client its own architecture from a JSON config
(``experiment_client_configs/*.json``: entries with ``model``, ``freq``
and, for ``cnn_custom``, ``layers``). Different architectures cannot
share one ``vmap``, so the clients are bucketed by architecture: one
stacked ``[len(client_ids), ...]`` set of variables a bucket, its own
updates (one CUDA graph a bucket, phase and lane count), a host loop over
the buckets (the fork's configs hold up to about 4 architectures), and
the shared object, the generator, aggregated across all of them.

Cohorts are sampled on the host with the reference's seeding
(``np.random.default_rng(round)``, :func:`sample_cohort`), bit for bit
the JAX package's, and split by bucket. The JAX package pads each
bucket's cohort to a fixed width (copies of member 0 at weight 0) so
that its compiled programs keep one shape; here each bucket runs only its
live members, in size-sorted groups, each group a CUDA graph of its lane
count.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Sequence

import numpy as np
import torch

from fedml_tpu_torch.algorithms import gan_core as G
from fedml_tpu_torch.algorithms.base import build_evaluator
from fedml_tpu_torch.algorithms.gan_family import INIT, GanSim, loss_mean
from fedml_tpu_torch.algorithms.stack_utils import (
    evaluate_stack,
    stack_gather,
    stack_scatter,
    vmap_init,
)
from fedml_tpu_torch.config import ExperimentConfig, ModelConfig
from fedml_tpu_torch.core import random as R
from fedml_tpu_torch.core import tree as T
from fedml_tpu_torch.data.federated import FederatedData
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.base import FedModel, Params
from fedml_tpu_torch.models.gan import GanModel

# a bucket's stack is initialised from (seed, INIT, BUCKET + bucket, i)
BUCKET = 0xB0


@dataclasses.dataclass(frozen=True)
class ClientModelSpec:
    """One entry of the fork's ``client_models`` config."""

    model: ModelConfig
    freq: int


def parse_client_config(config: str | dict, num_classes: int,
                        input_shape: tuple[int, ...]
                        ) -> list[ClientModelSpec]:
    """The fork's JSON client-model config (a path or the parsed dict):
    each entry of ``client_models`` has ``model`` and ``freq``, and a
    ``cnn_custom`` its conv widths as ``layers`` (the model's ``convs``)."""
    if isinstance(config, str):
        with open(config) as f:
            config = json.load(f)
    specs = []
    for entry in config["client_models"]:
        name = entry["model"]
        extra = (("convs", tuple(entry["layers"])),) \
            if name == "cnn_custom" else ()
        specs.append(ClientModelSpec(
            model=ModelConfig(name=name, num_classes=num_classes,
                              input_shape=tuple(input_shape), extra=extra),
            freq=int(entry["freq"])))
    return specs


@dataclasses.dataclass
class Bucket:
    """The clients of one architecture: ``client_ids`` (global, ascending
    in config order), their stacked variables ``stack`` (``[len(
    client_ids), ...]``, on the model's device) and ``pos``, a member's
    row in the stack by global id."""

    model: FedModel
    client_ids: np.ndarray
    stack: Params | None = None
    pos: dict | None = None

    def __post_init__(self):
        self.pos = {int(c): i for i, c in enumerate(self.client_ids)}


def build_buckets(specs: Sequence[ClientModelSpec], seed: int,
                  num_clients: int, device: str | torch.device = "cuda"
                  ) -> list[Bucket]:
    """Client ids assigned to architectures in config order (``freq``
    clients an entry, one after the other); entries with equal model
    configs merge into one bucket, in the order of their first entry.
    Bucket ``b``'s client ``i`` is initialised from ``(seed, INIT, BUCKET
    + b, i)``."""
    assert sum(s.freq for s in specs) == num_clients, (
        "client_models freqs must sum to num_clients")
    by_cfg: dict[ModelConfig, list[int]] = {}
    cid = 0
    for s in specs:
        by_cfg.setdefault(s.model, []).extend(range(cid, cid + s.freq))
        cid += s.freq
    buckets = []
    for b, (mcfg, ids) in enumerate(by_cfg.items()):
        model = create_model(mcfg, device)
        buckets.append(Bucket(model=model, client_ids=np.asarray(ids),
                              stack=vmap_init(model.init, len(ids), seed,
                                              INIT, BUCKET + b)))
    return buckets


def sample_cohort(round_idx: int, num_clients: int,
                  clients_per_round: int) -> np.ndarray:
    """The reference's seeded sampling: ``default_rng(round)``, a choice
    without replacement, sorted; every client when the cohort covers the
    population. It does not depend on the experiment's seed."""
    if clients_per_round >= num_clients:
        return np.arange(num_clients)
    rng = np.random.default_rng(round_idx)
    return np.sort(rng.choice(num_clients, clients_per_round, replace=False))


def bucket_cohorts(buckets: Sequence[Bucket], cohort: np.ndarray,
                   pad_to: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """The cohort split by bucket: for each, the members' rows in its
    stack padded with 0 to ``pad_to``, and the validity mask (1.0 for a
    member, 0.0 for padding)."""
    out = []
    cohort_set = set(int(c) for c in cohort)
    for b in buckets:
        members = [b.pos[c] for c in sorted(cohort_set) if c in b.pos]
        k = len(members)
        padded = np.zeros(pad_to, np.int32)
        padded[:k] = members
        valid = np.zeros(pad_to, np.float32)
        valid[:k] = 1.0
        out.append((padded, valid))
    return out


class HeteroFedGDKD(GanSim):
    """FedGDKD with per-client heterogeneous classifiers
    (``fedml_tpu.algorithms.hetero.HeteroFedGDKD``): the generator is the
    one object of a shared architecture; the classifiers live in the
    buckets' stacks (:func:`build_buckets`, :attr:`buckets`). The sim
    keeps its state, as the JAX package's does: :attr:`gen_vars`, the
    buckets' stacks and the last round's distillation set, mean teacher
    and cohort.

    A round (``run_round()``), in the JAX package's order:

    1. Drift correction: each bucket's members that were not in the last
       round's cohort distill from the last round's set against its mean
       teacher (from round 1 on).
    2. The adversarial phase: each bucket runs its members through its
       own ssgan :class:`~fedml_tpu_torch.algorithms.gan_core.
       GanCohortUpdate` in size-sorted groups.
    3. The generator: the sum over every bucket of its lanes' generators
       weighted by ``n_k``, over ``max(sum of n_k, 1)``.
    4. The distillation set, generated once.
    5. Each bucket's logits on it, concatenated bucket by bucket (each in
       its members' order) into the cohort's ``[C, S, K]``, whose
       leave-one-out means are the teachers.
    6. Each bucket's members distill against their teachers; only they
       are written back.
    7. The set, ``logits.mean(0)`` and the cohort are kept for the next
       round.

    Hooks as :class:`~fedml_tpu_torch.algorithms.gan_family.GanSim`'s;
    ``sampler`` defaults to :func:`sample_cohort`. A bucket's dropout
    masks come from streams of its own (:func:`~fedml_tpu_torch.core.
    random.scoped` by bucket index: ``"dropout@b"``, ``"dropout_kd@b"``,
    ``"dropout_drift@b"``), each at its model's keep probabilities. A
    round reads nothing back from the device.

    ``counters["fedgdkd.drift_corrected"]`` counts the drift-corrected
    members over the run, ``last_drift`` the last round's by bucket, and
    ``last_groups`` the last round's adversarial groups by bucket."""

    def __init__(self, gen: GanModel, specs: Sequence[ClientModelSpec],
                 data: FederatedData, cfg: ExperimentConfig,
                 device: str | torch.device = "cuda",
                 sampler: Callable | None = None,
                 batch_orders: Callable | None = None,
                 draws: R.Draws | None = None):
        self.buckets = build_buckets(specs, cfg.seed, data.num_clients,
                                     gen.model.device)
        masked = {R.scoped(stream, b): bucket.model
                  for b, bucket in enumerate(self.buckets)
                  for stream in ("dropout", "dropout_kd", "dropout_drift")}
        super().__init__(
            gen, {f"bucket {b}": bucket.model
                  for b, bucket in enumerate(self.buckets)}, data, cfg,
            device, sampler or sample_cohort, batch_orders, draws, masked)
        if self.task.name != "classification":
            raise ValueError("FedGDKD distills classifiers; the data's task "
                             f"is {self.task.name!r}")
        b = self.batch_size
        self.generate = G.build_dataset_generator(gen, self.synth_size, b)
        self._gan, self._kd, self._extract, self._eval = [], [], [], []
        for bucket in self.buckets:
            model = bucket.model
            self._gan.append(G.GanCohortUpdate(gen, model, cfg.train,
                                               cfg.gan, b, self.graphed))
            self._kd.append(G.KDUpdate(model, cfg.train, cfg.gan,
                                       self.synth_size, b, self.graphed))
            self._extract.append(G.build_logit_extractor(model))
            self._eval.append(build_evaluator(model, self.task))
        self.gen_vars = gen.init(R.generator(cfg.seed, INIT, 0))
        self.round = 0
        # the drift correction's state: the last round's set, mean teacher
        # and cohort (host bools)
        self._prev_synth: tuple | None = None
        self._prev_teacher: torch.Tensor | None = None
        self._prev_sampled = np.zeros(self.arrays.num_clients, bool)
        self.counters["fedgdkd.drift_corrected"] = 0
        self.last_drift: list[int] = []
        self.last_groups: list[list[tuple[int, int]]] = []

    def _rows_of(self, bucket: Bucket, gids: np.ndarray) -> torch.Tensor:
        """The stack rows of global ids ``gids``, on the device."""
        return self._ids([bucket.pos[int(c)] for c in gids])

    def _drift_correct(self, r: int, members: list[np.ndarray]) -> None:
        px, py = self._prev_synth
        self.last_drift = []
        for bi, (bucket, gids) in enumerate(zip(self.buckets, members)):
            new = gids[~self._prev_sampled[gids]]
            self.last_drift.append(len(new))
            if not len(new):
                continue
            rows = self._rows_of(bucket, new)
            teachers = self._prev_teacher.expand(len(new),
                                                 *self._prev_teacher.shape)
            corrected, _ = self._kd[bi](
                stack_gather(bucket.stack, rows), px, py, teachers,
                self._kd_masks(R.scoped("dropout_drift", bi), r, new))
            bucket.stack = stack_scatter(bucket.stack, rows, corrected)
        self.counters["fedgdkd.drift_corrected"] += sum(self.last_drift)

    def run_round(self) -> dict:
        """One round: returns the cohort (host ids), the bucket count, the
        drift-corrected members by bucket and the losses (on the device:
        ``g_loss``, ``d_loss``, ``kd_loss``, means over the steps that
        ran)."""
        a, r = self.arrays, self.round
        cohort = self._cohort(r)
        members = [np.asarray([c for c in np.sort(cohort) if int(c) in b.pos],
                              np.int64) for b in self.buckets]
        if self._prev_teacher is not None:
            self._drift_correct(r, members)
        else:
            self.last_drift = [0] * len(self.buckets)

        gen_sums = n_total = None
        trained, sums, groups = [], [], []
        for bi, (bucket, gids) in enumerate(zip(self.buckets, members)):
            if not len(gids):
                trained.append(None)
                groups.append([])
                continue
            update, stream = self._gan[bi], R.scoped("dropout", bi)

            def run(orders, z, labels, masks, steps, ids_g, cls_g,
                    update=update, stream=stream):
                idx, mask = self._rows(ids_g)
                return update(self.gen_vars, cls_g, idx, mask, a.x, a.y,
                              orders, z, labels, steps, masks[stream])

            rows = self._rows_of(bucket, gids)
            g_stack, cls_vars, n_k, adv = self._local_phase(
                run, {stream: G.GanCohortUpdate.CALLS}, r, gids,
                self._ids(gids), (stack_gather(bucket.stack, rows),))
            groups.append(self.last_groups)
            wsum = T.tree_weighted_sum(g_stack, n_k)
            gen_sums = wsum if gen_sums is None else T.tree_add(gen_sums,
                                                               wsum)
            n_total = (torch.sum(n_k) if n_total is None
                       else n_total + torch.sum(n_k))
            trained.append((rows, cls_vars))
            sums.append(adv)
        self.last_groups = groups
        total = torch.clamp(n_total, min=1.0)
        self.gen_vars = {k: v / total for k, v in gen_sums.items()}

        synth_x, synth_y = self._synth_set(self.gen_vars, r)
        logits = torch.cat([self._extract[bi](entry[1], synth_x)
                            for bi, entry in enumerate(trained)
                            if entry is not None])  # [C, S, K]
        teachers = G.leave_one_out_teacher(logits)
        offset, kd_sums = 0, []
        for bi, entry in enumerate(trained):
            if entry is None:
                continue
            rows, cls_vars = entry
            k = len(members[bi])
            cls_vars, kd = self._kd[bi](
                cls_vars, synth_x, synth_y, teachers[offset:offset + k],
                self._kd_masks(R.scoped("dropout_kd", bi), r, members[bi]))
            offset += k
            bucket = self.buckets[bi]
            bucket.stack = stack_scatter(bucket.stack, rows, cls_vars)
            kd_sums.append(kd)

        self._prev_synth = (synth_x, synth_y)
        self._prev_teacher = torch.mean(logits, 0)  # [S, K]
        self._prev_sampled = np.zeros(a.num_clients, bool)
        self._prev_sampled[cohort] = True
        self.round += 1

        def mean(parts, name, count):
            return loss_mean(torch.cat([p[name] for p in parts]),
                             torch.cat([p[count] for p in parts]))

        return {"cohort": cohort.tolist(), "num_buckets": len(self.buckets),
                "drift_corrected": list(self.last_drift),
                "g_loss": mean(sums, "g_loss_sum", "batches"),
                "d_loss": mean(sums, "d_loss_sum", "batches"),
                "kd_loss": mean(kd_sums, "kd_loss_sum", "batches")}

    def evaluate_clients(self) -> dict:
        """Every client's classifier on the global test set:
        ``per_client_acc`` in bucket order, each bucket in its ids' order;
        ``test_acc`` and ``test_loss`` the means over all clients. One
        read back from the device a bucket."""
        a = self.arrays
        accs, loss_sum = [], 0.0
        for bi, bucket in enumerate(self.buckets):
            n = len(bucket.client_ids)
            ev = evaluate_stack(self._eval[bi], bucket.stack, a.test_x,
                                a.test_y, n)
            accs.extend(ev["per_client_acc"])
            loss_sum += ev["test_loss"] * n
        return {"test_acc": float(np.mean(accs)),
                "test_loss": loss_sum / len(accs),
                "per_client_acc": accs}
