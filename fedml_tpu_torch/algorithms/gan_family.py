"""The fork's GAN-based FL family (``fedml_tpu.algorithms.gan_family``):
FedGAN, FedGDKD and FedDTG; FedSSGAN and FedUAGAN are in
:mod:`~fedml_tpu_torch.algorithms.sgan`.

- :class:`FedGANSim`, federated ACGAN: each sampled client trains the
  shared generator and discriminator adversarially (acgan mode) on its
  data; the server takes the sample-weighted means of both.
- :class:`FedGDKDSim`, the fork's own algorithm: a federated conditional
  generator and per-client stateful classifiers. A round, in the JAX
  package's order:

  1. Drift correction: the cohort's members that were not in the last
     round's cohort distill from the last round's distillation set
     against its mean teacher (from round 1 on).
  2. The adversarial phase: each member trains the global generator and
     its own classifier (the discriminator, ssgan mode) on its data.
  3. FedAvg of the generators only, weighted by the sample counts.
  4. The distillation set, generated by the averaged generator.
  5. Each member's classifier distills against the leave-one-out mean
     teacher, ``(sum of the cohort's logits - its own) / max(C - 1, 1)``;
     the mean of the logits becomes the next round's teacher.
- :class:`FedDTGSim`: the shared generator and discriminator and
  per-client classifiers, trained together a step at a time, the
  generator through the classifier with its gradient reversed
  (:func:`reverse_grad`); FedAvg of G and D, then steps 4-5 above.

Each phase runs the cohort in size-sorted groups of lanes
(``stack_utils.size_grouped_lanes``), one CUDA graph replay a
group-step on the card. A round reads nothing back from the device: the
cohort, the last round's cohort (``prev_sampled``, a host tensor), the
batch orders and the sample counts that group the cohort and set each
group's steps are on the host, and all of a group's draws (noise, fake
labels, dropout masks) are made before its first step.
``TrainConfig.cohort_fused`` (the JAX package's cohort-grouped networks)
is read and ignored: the lanes run ``vmap``-ped, the JAX package's
``cohort_fused=False`` path. As in the JAX package, the GAN family trains
in float32 whatever ``compute_dtype`` says and ignores ``prox_mu``.
"""

from __future__ import annotations

from typing import Callable, Mapping, NamedTuple

import numpy as np
import torch

from fedml_tpu_torch.algorithms import gan_core as G
from fedml_tpu_torch.algorithms.base import (
    apply_updates,
    build_evaluator,
    lane_batches,
    make_client_optimizer,
)
from fedml_tpu_torch.algorithms.client_sim import ClientSim
from fedml_tpu_torch.algorithms.stack_utils import (
    evaluate_stack,
    size_grouped_lanes,
    stack_gather,
    stack_scatter,
    vmap_init,
)
from fedml_tpu_torch.config import ExperimentConfig
from fedml_tpu_torch.core import perf as P
from fedml_tpu_torch.core import random as R
from fedml_tpu_torch.core import tree as T
from fedml_tpu_torch.core.device import to_device
from fedml_tpu_torch.data.federated import FederatedData
from fedml_tpu_torch.models.base import FedModel, Params
from fedml_tpu_torch.models.gan import GanModel

# init salts: the generator from (seed, INIT, 0), the discriminator (or
# client i's) from (seed, INIT, 1[, i]), client i's classifier beside a
# discriminator from (seed, INIT, 2, i)
INIT = 0x7FFFFFFF


def loss_mean(total: torch.Tensor, batches: torch.Tensor) -> torch.Tensor:
    """A loss sum's mean over the batches that ran, on the device."""
    return torch.sum(total) / torch.clamp(torch.sum(batches), min=1.0)


class GanSim(ClientSim):
    """What the GAN family's simulations share, on one device: the hooks
    and the cohort of :class:`~fedml_tpu_torch.algorithms.client_sim.
    ClientSim`, the generator, the local phase and the distillation set.

    ``batch_orders(round, client)`` gives a client's per-epoch batch
    orders. ``draws(stream, round, slots, shapes)`` makes the round's
    draws: ``"gan_z"`` (``{"z": (epochs, S, B, nz)}``, standard normal)
    and ``"gan_labels"`` (``{"labels": (epochs, S, B)}``, whole numbers in
    ``[0, K)``) for each cohort member's adversarial steps, ``S`` the
    largest steps an epoch; ``"synth"`` (``{"z": (S_set / B, B, nz)}``,
    slot 0) for a distillation set; and the dropout masks (``{site:
    (*lead, B, *site_shape)}``, bool keep masks, per client id) of each
    model with dropout, a stream a phase (``masked``: ``{stream:
    model}``): ``"dropout"`` for the discriminator's calls of the local
    steps (``lead`` ``(epochs, steps, calls)``, drawn per group at its
    own steps), ``"dropout_cls"`` for FedDTG's classifier there,
    ``"dropout_kd"`` and ``"dropout_drift"`` for the leave-one-out
    distillation and FedGDKD's drift correction (``lead`` ``(kd_epochs,
    S_set / B)``). The default, :class:`~fedml_tpu_torch.core.random.
    DeviceDraws`, draws on the device, each stream at its model's keep
    probabilities; the hooks let a test replay the JAX package's draws.
    """

    def __init__(self, gen: GanModel, models: dict[str, FedModel],
                 data: FederatedData, cfg: ExperimentConfig,
                 device: str | torch.device = "cuda",
                 sampler: Callable | None = None,
                 batch_orders: Callable | None = None,
                 draws: R.Draws | None = None,
                 masked: Mapping[str, FedModel] | None = None):
        masked = {s: m for s, m in (masked or {}).items() if m.has_dropout}
        # each dropout stream's sites, {stream: {site: shape}}
        self.mask_sites = {s: G.dropout_sites(m) for s, m in masked.items()}
        seed = cfg.seed
        super().__init__(
            {"generator": gen.model, **models}, data, cfg, device, sampler,
            batch_orders, draws,
            {"gan_z": seed, "gan_labels": seed, "synth": seed,
             **{s: seed for s in masked}},
            high={"gan_labels": max(gen.num_classes, 1)},
            p={s: m.mask_keep for s, m in masked.items()})
        self.gen = gen
        self.synth_size = (cfg.gan.distillation_size // self.batch_size
                           ) * self.batch_size or self.batch_size

    def _masks(self, round_idx: int, slots, prefix: tuple,
               stream: str = "dropout") -> dict | None:
        """``stream``'s dropout masks of ``slots``' calls, ``{site:
        [len(slots), *prefix, B, *site_shape]}``; None for a stream
        without sites."""
        return self._site_masks(stream, round_idx, slots,
                                self.mask_sites.get(stream, {}), prefix)

    def _kd_masks(self, stream: str, round_idx: int, slots) -> dict | None:
        """The masks of ``slots``' classifiers over a distillation (one a
        step: ``kd_epochs`` passes of ``S_set / B`` batches)."""
        return self._masks(round_idx, slots, (
            self.cfg.gan.kd_epochs, self.synth_size // self.batch_size),
            stream)

    def _local_phase(self, run_group: Callable, calls: Mapping[str, int],
                     round_idx: int, cohort: np.ndarray, ids: torch.Tensor,
                     stacked: tuple = ()):
        """The cohort's adversarial training in size-sorted groups of
        ``cohort_groups`` (0: groups of about 2), each group stepping its
        largest member's ``ceil(n_k / B)`` steps an epoch:
        ``run_group(orders, z, labels, masks, steps, ids, *stacked)`` for
        each group, on its lanes' rows of ``ids``, the batch orders, the
        noise and fake labels, and of the lane-stacked trees ``stacked``;
        ``masks`` holds the group's dropout masks by stream (``calls``:
        ``{stream: calls a step}``; None for a stream without sites)."""
        cfg, b = self.cfg, self.batch_size
        epochs = cfg.train.epochs
        orders = torch.stack([
            torch.stack(list(self.batch_orders(round_idx, c))[:epochs])
            for c in cohort.tolist()]).long()
        shape = (epochs, self.steps_per_epoch, b)
        slots = cohort.tolist()
        z = self.draws("gan_z", round_idx, slots,
                       {"z": shape + (self.gen.nz,)})["z"]
        labels = self.draws("gan_labels", round_idx, slots,
                            {"labels": shape})["labels"].long()
        self.last_groups = []

        def group(ids_g, orders_g, z_g, labels_g, *rest):
            *stacked_g, counts, hosts = rest
            steps = G.dynamic_trip_count(counts.max(), b,
                                         self.steps_per_epoch)
            self.last_groups.append((len(counts), steps))
            masks = {stream: self._masks(round_idx, hosts,
                                         (epochs, steps, n), stream)
                     for stream, n in calls.items()}
            return run_group(orders_g, z_g, labels_g, masks, steps, ids_g,
                             *stacked_g)

        return size_grouped_lanes(
            group, (ids, to_device(orders, self.device), z, labels,
                    *stacked),
            self._host_counts[cohort], cfg.train.cohort_groups,
            host=cohort)

    def _synth_set(self, gen_vars: Params, round_idx: int):
        """The distillation set of ``gen_vars`` (eval mode) from the
        round's ``"synth"`` noise."""
        z = self.draws("synth", round_idx, [0], {
            "z": (self.synth_size // self.batch_size, self.batch_size,
                  self.gen.nz)})["z"][0]
        return self.generate(gen_vars, z)

    def sample_images(self, state, n: int, seed: int = 0,
                      z: torch.Tensor | None = None) -> torch.Tensor:
        """``n`` images of the state's generator in eval mode, row ``i`` of
        class ``i % K`` (the reference's ``log_gan_images``); ``z``
        ``[n, nz]`` defaults to a standard normal draw seeded by
        ``seed``."""
        if z is None:
            z = to_device(torch.randn(n, self.gen.nz,
                                      generator=R.generator(seed)),
                          self.device)
        labels = self.gen.balanced_labels(n) if self.gen.conditional \
            else None
        with torch.no_grad():
            return self.gen.apply_eval(state.gen_vars, z, labels)


class FedGANState(NamedTuple):
    gen_vars: Params
    disc_vars: Params
    round: int


class FedGANSim(GanSim):
    """Federated ACGAN (``fedml_tpu.algorithms.gan_family.FedGANSim``):
    every sampled client trains the shared (G, D) adversarially on its
    data (:class:`~fedml_tpu_torch.algorithms.gan_core.GanCohortUpdate` in
    acgan mode, both models broadcast from the global ones); the server
    takes the ``n_k``-weighted means of both, their BatchNorm statistics
    included. The dropout masks of a step's three discriminator calls are
    G's (on the fakes), then D's on the fakes, then D's on the real
    batch. Metrics: ``g_loss`` and ``d_loss``, the mean losses over every
    step that ran."""

    mode = "acgan"

    def __init__(self, gen: GanModel, disc: FedModel, data: FederatedData,
                 cfg: ExperimentConfig, device: str | torch.device = "cuda",
                 sampler: Callable | None = None,
                 batch_orders: Callable | None = None,
                 draws: R.Draws | None = None):
        super().__init__(gen, {"discriminator": disc}, data, cfg, device,
                         sampler, batch_orders, draws,
                         masked={"dropout": disc})
        self.disc = disc
        self.gan_update = G.GanCohortUpdate(
            gen, disc, cfg.train, cfg.gan, self.batch_size, self.graphed,
            mode=self.mode, shared_disc=True)
        self.labelled = None

    def init(self) -> FedGANState:
        seed = self.cfg.seed
        return FedGANState(self.gen.init(R.generator(seed, INIT, 0)),
                           self.disc.init(R.generator(seed, INIT, 1)), 0)

    def _locals(self, state):
        a = self.arrays
        cohort = self._cohort(state.round)

        def run(orders, z, labels, masks, steps, ids_g):
            idx, mask = self._rows(ids_g)
            return self.gan_update(state.gen_vars, state.disc_vars, idx,
                                   mask, a.x, a.y, orders, z, labels, steps,
                                   masks["dropout"], self.labelled)

        return self._local_phase(run, {"dropout": G.GanCohortUpdate.CALLS},
                                 state.round, cohort, self._ids(cohort))

    def run_round(self, state: FedGANState):
        """One round; the metrics stay on the device."""
        g_stack, d_stack, n_k, sums = self._locals(state)
        metrics = {"g_loss": loss_mean(sums["g_loss_sum"], sums["batches"]),
                   "d_loss": loss_mean(sums["d_loss_sum"], sums["batches"])}
        return FedGANState(T.tree_weighted_mean(g_stack, n_k),
                           T.tree_weighted_mean(d_stack, n_k),
                           state.round + 1), metrics


class FedGDKDState(NamedTuple):
    gen_vars: Params  # the global generator
    cls_stack: Params  # [num_clients, ...] the clients' classifiers
    prev_synth_x: torch.Tensor  # the last round's distillation set
    prev_synth_y: torch.Tensor
    prev_teacher: torch.Tensor  # [S, K] the last cohort's mean logits
    prev_sampled: torch.Tensor  # [num_clients] bool, on the host
    round: int


class FedGDKDSim(GanSim):
    """FedGDKD on one device (the module docstring's steps 1-5), with the
    hooks of :class:`GanSim`. A classifier with dropout takes masks in
    every train-mode call, each phase from its own stream by client id:
    the adversarial steps' three calls (``"dropout"``: G's on the fakes,
    then D's on the fakes and on the real batch), the leave-one-out
    distillation's steps (``"dropout_kd"``) and the drift correction's
    (``"dropout_drift"``); the logit extraction runs in eval mode.

    ``counters["fedgdkd.drift_corrected"]`` counts the drift-corrected
    members over the run; ``last_drift`` holds the last round's."""

    def __init__(self, gen: GanModel, classifier: FedModel,
                 data: FederatedData, cfg: ExperimentConfig,
                 device: str | torch.device = "cuda",
                 sampler: Callable | None = None,
                 batch_orders: Callable | None = None,
                 draws: R.Draws | None = None):
        super().__init__(gen, {"classifier": classifier}, data, cfg, device,
                         sampler, batch_orders, draws,
                         masked={s: classifier for s in (
                             "dropout", "dropout_kd", "dropout_drift")})
        self.classifier = classifier
        if self.task.name != "classification":
            raise ValueError("FedGDKD distills classifiers; the data's task "
                             f"is {self.task.name!r}")
        b = self.batch_size
        self.gan_update = G.GanCohortUpdate(gen, classifier, cfg.train,
                                            cfg.gan, b, self.graphed)
        self.generate = G.build_dataset_generator(gen, self.synth_size, b)
        self.extract = G.build_logit_extractor(classifier)
        self.kd_update = G.KDUpdate(classifier, cfg.train, cfg.gan,
                                    self.synth_size, b, self.graphed)
        self.evaluator = build_evaluator(classifier, self.task)
        self.counters["fedgdkd.drift_corrected"] = 0
        self.last_drift = 0

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
        corrected, _ = self.kd_update(
            stack_gather(cls_vars, pos), state.prev_synth_x,
            state.prev_synth_y, teachers,
            self._kd_masks("dropout_drift", state.round, cohort[new]))
        return stack_scatter(cls_vars, pos, corrected)

    def run_round(self, state: FedGDKDState):
        """One round; the metrics (``g_loss``, ``d_loss``, ``kd_loss``)
        stay on the device."""
        a = self.arrays
        cohort = self._cohort(state.round)
        ids = self._ids(cohort)
        cls_vars = stack_gather(state.cls_stack, ids)
        cls_vars = self._drift_correct(state, cohort, cls_vars)

        def run(orders, z, labels, masks, steps, ids_g, cls_g):
            idx, mask = self._rows(ids_g)
            return self.gan_update(state.gen_vars, cls_g, idx, mask, a.x,
                                   a.y, orders, z, labels, steps,
                                   masks["dropout"])

        g_stack, cls_vars, n_k, sums = self._local_phase(
            run, {"dropout": G.GanCohortUpdate.CALLS}, state.round, cohort,
            ids, (cls_vars,))
        gen_vars = T.tree_weighted_mean(g_stack, n_k)
        synth_x, synth_y = self._synth_set(gen_vars, state.round)
        logits = self.extract(cls_vars, synth_x)  # [C, S, K]
        cls_vars, kd_sums = self.kd_update(
            cls_vars, synth_x, synth_y, G.leave_one_out_teacher(logits),
            self._kd_masks("dropout_kd", state.round, cohort))
        sampled = torch.zeros_like(state.prev_sampled)
        sampled[torch.from_numpy(cohort)] = True
        metrics = {
            "g_loss": loss_mean(sums["g_loss_sum"], sums["batches"]),
            "d_loss": loss_mean(sums["d_loss_sum"], sums["batches"]),
            "kd_loss": loss_mean(kd_sums["kd_loss_sum"], kd_sums["batches"]),
        }
        return FedGDKDState(
            gen_vars=gen_vars,
            cls_stack=stack_scatter(state.cls_stack, ids, cls_vars),
            prev_synth_x=synth_x, prev_synth_y=synth_y,
            prev_teacher=torch.mean(logits, 0), prev_sampled=sampled,
            round=state.round + 1), metrics

    def evaluate_clients(self, state) -> dict:
        """Every client's classifier on the global test set, averaged over
        all ``num_clients`` clients."""
        a = self.arrays
        return evaluate_stack(self.evaluator, state.cls_stack, a.test_x,
                              a.test_y, a.num_clients)

    def run(self, metrics_sink=None) -> FedGDKDState:
        """The round loop: train, log the round's losses, evaluate the
        clients every ``eval_every`` rounds and after the last. With
        ``profile_rounds > 0`` the perf pair rides along
        (``core/perf.py``: capture windows and the round rate, no MFU),
        each round's window and wall ending once the host has read its
        losses."""
        state = self.init()
        fed = self.cfg.fed
        rp = P.RoundPerf(self)
        try:
            for r in range(fed.num_rounds):
                with rp.round(r):
                    state, m = self.run_round(state)
                    record = {"round": r,
                              **{k: float(v) for k, v in m.items()}}
                if (r + 1) % fed.eval_every == 0 or r == fed.num_rounds - 1:
                    ev = self.evaluate_clients(state)
                    record.update({"test_acc": ev["test_acc"],
                                   "test_loss": ev["test_loss"]})
                if metrics_sink is not None:
                    metrics_sink.log(record)
        finally:
            rp.close()
        return state


class _ReverseGrad(torch.autograd.Function):
    """The identity forward; the backward negates the gradient."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return torch.neg(g)


def reverse_grad(x: torch.Tensor) -> torch.Tensor:
    """Gradient reversal (FedDTG's ``register_hook(lambda g: -g)``): ``x``
    unchanged forward, ``-g`` backward; composes with ``torch.func.grad``
    and ``vmap``."""
    return _ReverseGrad.apply(x)


class DTGCohortUpdate:
    """``update(gen_vars, disc_vars, cls_vars, idx_rows, mask_rows, x, y,
    orders, z, gen_labels, steps, masks=None, cls_masks=None) -> (gen
    stack, disc stack, cls stack, n_k)``: FedDTG's local training of G
    lanes (the JAX
    package's ``FedDTGSim._build_local_update`` vmapped with
    ``in_axes=(None, None, 0, 0, 0, None, None, 0)``). Every lane starts
    from the global generator and discriminator; ``cls_vars`` are the
    lanes' own classifiers, stacked. ``orders``, ``z``, ``gen_labels``
    and ``steps`` are as in
    :class:`~fedml_tpu_torch.algorithms.gan_core.GanCohortUpdate`;
    ``masks`` (``{site: [G, epochs, S, 3, B, H, W, C]}``) are the
    discriminator's, for its calls of a step in order: G's (on the
    fakes), D's on the real batch, D's on the fakes; a classifier with
    dropout takes ``cls_masks`` (``{site: [G, epochs, S, 3, B,
    *site_shape]}``) for its calls in the same order: G's, then the
    classifier step's on the real batch and on the fakes.

    A step is a G step, a D step and a classifier step:

    - G: ``0.5 * (BCE(validity of the fakes, 0.9) + CE(classifier of the
      fakes, their labels))``, the discriminator and the classifier in
      train mode (their new statistics dropped), the classifier's logits
      through :func:`reverse_grad`; the generator's optimizer steps.
    - D: on the real batch, then on the fakes (detached), the second call
      from the first's statistics: ``0.5 * (BCE(real, 0.9) + BCE(fakes,
      0))``; the generator's optimizer at ``gen_lr`` steps (the JAX
      package's ``d_opt = make_gen_optimizer``).
    - Classifier: on the real batch, then on the fakes: ``0.5 *
      (CE(real) + CE(fakes, their labels))``; the client's optimizer.

    A batch whose loss weights are all 0 leaves all three models, their
    statistics and the three optimizer states as they were."""

    CALLS = 3
    REAL_LABEL = 0.9

    def __init__(self, gen: GanModel, disc: FedModel, classifier: FedModel,
                 train_cfg, gan_cfg, batch_size: int, graphed: bool):
        self.gen, self.disc, self.cls = gen, disc, classifier
        self.sites = G.dropout_sites(disc)
        self.batch_size, self.epochs = batch_size, train_cfg.epochs
        self.g_opt = G.make_gen_optimizer(gan_cfg)
        self.d_opt = G.make_gen_optimizer(gan_cfg)
        self.c_opt = make_client_optimizer(train_cfg)
        self.g_grad = torch.func.grad_and_value(self._g_loss, has_aux=True)
        self.d_grad = torch.func.grad_and_value(self._d_loss, has_aux=True)
        self.c_grad = torch.func.grad_and_value(self._c_loss, has_aux=True)
        self.vstep = torch.func.vmap(self._lane_step)
        self.programs = G.graph_programs(graphed, self._graph_step,
                                           "dtg_step")

    @property
    def graph(self):
        return self.programs.last

    def _validity(self, variables, x, masks):
        kwargs = {"masks": masks} if self.sites else {}
        (_, val), new = self.disc.apply_train(variables, x, validity=True,
                                              **kwargs)
        return val, new

    def _g_loss(self, g_params, g_stats, d_vars, c_vars, z, gen_labels, w,
                masks, cls_masks):
        fakes, new_g = self.gen.apply_train({**g_params, **g_stats}, z,
                                            gen_labels)
        val, _ = self._validity(d_vars, fakes, masks)
        pred, _ = self.cls.apply_train(c_vars, fakes, masks=cls_masks)
        pred = reverse_grad(pred)
        loss = 0.5 * (G.bce_logits(val, self.REAL_LABEL, w)
                      + G.ce(pred, gen_labels, w))
        return loss, ({k: new_g[k] for k in g_stats}, fakes)

    def _d_loss(self, d_params, d_stats, fakes, x_b, w, masks_real,
                masks_fake):
        v_r, vars1 = self._validity({**d_params, **d_stats}, x_b, masks_real)
        v_f, vars2 = self._validity(vars1, fakes, masks_fake)
        loss = 0.5 * (G.bce_logits(v_r, self.REAL_LABEL, w)
                      + G.bce_logits(v_f, 0.0, w))
        return loss, {k: vars2[k] for k in d_stats}

    def _c_loss(self, c_params, c_stats, fakes, gen_labels, x_b, y_b, w,
                masks_real, masks_fake):
        p_real, vars1 = self.cls.apply_train({**c_params, **c_stats}, x_b,
                                             masks=masks_real)
        p_fake, vars2 = self.cls.apply_train(vars1, fakes, masks=masks_fake)
        loss = 0.5 * (G.ce(p_real, y_b, w) + G.ce(p_fake, gen_labels, w))
        return loss, {k: vars2[k] for k in c_stats}

    def _lane_step(self, carry, x_b, y_b, w_b, z, gen_labels, masks,
                   cls_masks):
        gp, dp, cp = carry["g_params"], carry["d_params"], carry["c_params"]
        g_grads, (_, (g_stats, fakes)) = self.g_grad(
            gp, carry["g_stats"], {**dp, **carry["d_stats"]},
            {**cp, **carry["c_stats"]}, z, gen_labels, w_b,
            G.call_masks(masks, 0), G.call_masks(cls_masks, 0))
        g_upd, g_opt = self.g_opt.update(g_grads, carry["g_opt"], gp)
        fakes = fakes.detach()
        d_grads, (_, d_stats) = self.d_grad(
            dp, carry["d_stats"], fakes, x_b, w_b, G.call_masks(masks, 1),
            G.call_masks(masks, 2))
        d_upd, d_opt = self.d_opt.update(d_grads, carry["d_opt"], dp)
        c_grads, (_, c_stats) = self.c_grad(
            cp, carry["c_stats"], fakes, gen_labels, x_b, y_b, w_b,
            G.call_masks(cls_masks, 1), G.call_masks(cls_masks, 2))
        c_upd, c_opt = self.c_opt.update(c_grads, carry["c_opt"], cp)
        new = {"g_params": apply_updates(gp, g_upd), "g_stats": g_stats,
               "g_opt": g_opt, "d_params": apply_updates(dp, d_upd),
               "d_stats": d_stats, "d_opt": d_opt,
               "c_params": apply_updates(cp, c_upd), "c_stats": c_stats,
               "c_opt": c_opt}
        valid = torch.sum(w_b) > 0
        return T.tree_map(lambda n, o: torch.where(valid, n, o), new, carry)

    def step(self, carry, x, y, b_idx, w_b, z, gen_labels, masks=None,
             cls_masks=None):
        return self.vstep(carry, x[b_idx], y[b_idx], w_b, z, gen_labels,
                          masks or {}, cls_masks or {})

    def _graph_step(self, carry, consts, fixed, batch):
        return self.step(carry, *fixed, *batch)

    def init_carry(self, gen_vars, disc_vars, cls_vars) -> dict:
        lanes = next(iter(cls_vars.values())).shape[0]
        carry = {}
        for tag, variables, model, opt in (
                ("g", G.lanes_of(gen_vars, lanes), self.gen, self.g_opt),
                ("d", G.lanes_of(disc_vars, lanes), self.disc, self.d_opt),
                ("c", cls_vars, self.cls, self.c_opt)):
            params, stats = G.split_vars(variables, model.stat_names)
            carry.update({f"{tag}_params": params, f"{tag}_stats": stats,
                          f"{tag}_opt": opt.init(params, (lanes,))})
        return carry

    def __call__(self, gen_vars, disc_vars, cls_vars, idx_rows, mask_rows,
                 x, y, orders, z, gen_labels, steps: int, masks=None,
                 cls_masks=None):
        lanes = idx_rows.shape[0]
        batches = [
            (b_idx, w_b, z[:, i // steps, i % steps],
             gen_labels[:, i // steps, i % steps],
             G.step_masks(masks, i // steps, i % steps),
             G.step_masks(cls_masks, i // steps, i % steps))
            for i, (b_idx, w_b) in enumerate(lane_batches(
                idx_rows, mask_rows, orders, self.epochs, steps,
                self.batch_size))]
        carry = G.run_steps(self.programs, lanes, self._graph_step,
                            self.init_carry(gen_vars, disc_vars, cls_vars),
                            {}, (x, y), batches)
        out = []
        for tag, like in (("g", gen_vars), ("d", disc_vars),
                          ("c", cls_vars)):
            merged = {**carry[f"{tag}_params"], **carry[f"{tag}_stats"]}
            out.append({k: merged[k] for k in like})
        return (*out, mask_rows.sum(1))


class FedDTGState(NamedTuple):
    gen_vars: Params
    disc_vars: Params
    cls_stack: Params  # [num_clients, ...] the clients' classifiers
    round: int


class FedDTGSim(GanSim):
    """FedDTG (``fedml_tpu.algorithms.gan_family.FedDTGSim``): the shared
    (G, D) and per-client classifiers. A round: the cohort's local
    training (:class:`DTGCohortUpdate`) in size-sorted groups; the
    ``n_k``-weighted means of G and D; the distillation set of the new
    generator; each member's classifier distills against the leave-one-out
    mean teacher (``KDUpdate``; no drift correction). The classifiers of
    the clients a round did not sample are untouched. A classifier with
    dropout takes the masks of its local steps (``"dropout_cls"``) and
    of its distillation (``"dropout_kd"``). Metric: ``kd_loss``."""

    def __init__(self, gen: GanModel, disc: FedModel, classifier: FedModel,
                 data: FederatedData, cfg: ExperimentConfig,
                 device: str | torch.device = "cuda",
                 sampler: Callable | None = None,
                 batch_orders: Callable | None = None,
                 draws: R.Draws | None = None):
        super().__init__(gen, {"discriminator": disc,
                               "classifier": classifier}, data, cfg,
                         device, sampler, batch_orders, draws,
                         masked={"dropout": disc,
                                 "dropout_cls": classifier,
                                 "dropout_kd": classifier})
        self.disc, self.classifier = disc, classifier
        b = self.batch_size
        self.dtg_update = DTGCohortUpdate(gen, disc, classifier, cfg.train,
                                          cfg.gan, b, self.graphed)
        self.generate = G.build_dataset_generator(gen, self.synth_size, b)
        self.extract = G.build_logit_extractor(classifier)
        self.kd_update = G.KDUpdate(classifier, cfg.train, cfg.gan,
                                    self.synth_size, b, self.graphed)
        self.evaluator = build_evaluator(classifier, self.task)

    def init(self) -> FedDTGState:
        n, seed = self.arrays.num_clients, self.cfg.seed
        return FedDTGState(
            self.gen.init(R.generator(seed, INIT, 0)),
            self.disc.init(R.generator(seed, INIT, 1)),
            vmap_init(self.classifier.init, n, seed, INIT, 2), 0)

    def run_round(self, state: FedDTGState):
        """One round; the metric (``kd_loss``) stays on the device."""
        a = self.arrays
        cohort = self._cohort(state.round)
        ids = self._ids(cohort)

        def run(orders, z, labels, masks, steps, ids_g, cls_g):
            idx, mask = self._rows(ids_g)
            return self.dtg_update(state.gen_vars, state.disc_vars, cls_g,
                                   idx, mask, a.x, a.y, orders, z, labels,
                                   steps, masks["dropout"],
                                   masks["dropout_cls"])

        g_stack, d_stack, cls_vars, n_k = self._local_phase(
            run, {"dropout": DTGCohortUpdate.CALLS,
                  "dropout_cls": DTGCohortUpdate.CALLS}, state.round,
            cohort, ids, (stack_gather(state.cls_stack, ids),))
        gen_vars = T.tree_weighted_mean(g_stack, n_k)
        synth_x, synth_y = self._synth_set(gen_vars, state.round)
        logits = self.extract(cls_vars, synth_x)
        cls_vars, kd_sums = self.kd_update(
            cls_vars, synth_x, synth_y, G.leave_one_out_teacher(logits),
            self._kd_masks("dropout_kd", state.round, cohort))
        return FedDTGState(
            gen_vars, T.tree_weighted_mean(d_stack, n_k),
            stack_scatter(state.cls_stack, ids, cls_vars),
            state.round + 1), {
                "kd_loss": loss_mean(kd_sums["kd_loss_sum"],
                                     kd_sums["batches"])}

    def evaluate_clients(self, state: FedDTGState) -> dict:
        """Every client's classifier on the global test set, averaged over
        all ``num_clients`` clients."""
        a = self.arrays
        return evaluate_stack(self.evaluator, state.cls_stack, a.test_x,
                              a.test_y, a.num_clients)
