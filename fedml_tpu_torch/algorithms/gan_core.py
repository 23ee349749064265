"""The building blocks of the GAN family (``fedml_tpu.algorithms.
gan_core``): the adversarial local update of a cohort in its two modes,
the distillation set's generation, the cohort's logits on it, and the
distillation update.

Two adversarial modes:

- ``ssgan`` (FedGDKD, FedSSGAN): each client's K-way classifier is its
  own discriminator; the real/fake confidence is ``logsumexp(logits)``
  and the adversarial terms are softplus terms.
- ``acgan`` (FedGAN): BCE on the discriminator's validity logit and CE on
  its class logits (:class:`~fedml_tpu_torch.models.gan.
  ACGANDiscriminator`, called with ``validity=True``).

The adversarial update (:class:`GanCohortUpdate`) and the distillation
update (:class:`KDUpdate`) run a group of clients as lanes, their step
``torch.func.vmap``-ped over tensors with a leading lane axis; eagerly
on the CPU, one CUDA graph replay a step on the card
(``algorithms/graphs.py`` ``GraphedStep``), a graph per lane count. A
discriminator with dropout takes its masks as step inputs, drawn before
the group's first step, so no random op runs inside a graph. The JAX
package's cohort-grouped networks (``apply_cohort_train``,
``build_cohort_gan_update``, ``build_cohort_kd_update``) are TPU
lowerings of the same functions and are not ported: under ``vmap`` cuDNN
already runs the lanes' convolutions as one grouped convolution.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from fedml_tpu_torch.algorithms.base import (
    Optimizer,
    apply_updates,
    lane_batches,
    make_client_optimizer,
)
from fedml_tpu_torch.algorithms.graphs import GraphedStep
from fedml_tpu_torch.algorithms.kd import soft_target
from fedml_tpu_torch.config import GanConfig, TrainConfig
from fedml_tpu_torch.core import tree as T
from fedml_tpu_torch.core.elastic import CompiledRoundCache
from fedml_tpu_torch.models.base import FedModel, Params
from fedml_tpu_torch.models.gan import GanModel


def make_gen_optimizer(cfg: GanConfig) -> Optimizer:
    """The generator's optimizer: ``optax.adam`` or ``optax.sgd`` at
    ``gen_lr``."""
    if cfg.gen_optimizer in ("adam", "sgd"):
        return Optimizer(cfg.gen_optimizer, cfg.gen_lr)
    raise ValueError(f"unknown gen optimizer: {cfg.gen_optimizer}")


def masked_mean(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.sum(v * w) / torch.clamp(torch.sum(w), min=1.0)


def ce(logits: torch.Tensor, labels: torch.Tensor, w: torch.Tensor):
    """The cross-entropy, weighted by ``w`` and averaged over its total."""
    return masked_mean(F.cross_entropy(logits, labels.long(),
                                       reduction="none"), w)


def bce_logits(v_logit: torch.Tensor, target: float, w: torch.Tensor):
    """``optax.sigmoid_binary_cross_entropy`` of the validity logits
    ``v_logit[:, 0]`` against the constant ``target``, weighted by ``w``
    and averaged over its total (the reference's in-module Sigmoid and
    BCELoss). The target is a float32 tensor, so ``1 - target`` rounds as
    the JAX package's does."""
    v = v_logit[:, 0]
    t = torch.full_like(v, target)
    b = -t * F.logsigmoid(v) - (1.0 - t) * F.logsigmoid(-v)
    return masked_mean(b, w)


def generator_loss_ssgan(cls_logits_gen, gen_labels, w) -> torch.Tensor:
    """errG: the mean of (the CE of the fakes' logits against their labels)
    and (``-logz + softplus(logz)``, ``logz = logsumexp(logits)``)."""
    logz = torch.logsumexp(cls_logits_gen, dim=-1)
    aux = ce(cls_logits_gen, gen_labels, w)
    adv = masked_mean(-logz + F.softplus(logz), w)
    return 0.5 * (adv + aux)


def discriminator_loss_ssgan(cls_fake, gen_labels, cls_real, real_labels,
                             w, lab_w=None) -> torch.Tensor:
    """errD: half of (CE + ``softplus(logz)``) on the fakes, plus half of
    (CE + ``-logz + softplus(logz)``) on the real batch. The real batch's
    CE takes the weights ``lab_w`` where given (FedSSGAN: the labelled
    rows only), its adversarial term every real row's ``w``."""
    logz_f = torch.logsumexp(cls_fake, dim=-1)
    fake_half = 0.5 * (ce(cls_fake, gen_labels, w)
                       + masked_mean(F.softplus(logz_f), w))
    logz_r = torch.logsumexp(cls_real, dim=-1)
    real_half = 0.5 * (ce(cls_real, real_labels, w if lab_w is None
                          else lab_w)
                       + masked_mean(-logz_r + F.softplus(logz_r), w))
    return fake_half + real_half


def generator_loss_acgan(cls_gen, v_gen, gen_labels, w) -> torch.Tensor:
    """errG: the mean of the fakes' BCE against "real" (1) and their CE
    against their labels."""
    return 0.5 * (bce_logits(v_gen, 1.0, w) + ce(cls_gen, gen_labels, w))


def discriminator_loss_acgan(cls_fake, v_fake, gen_labels, cls_real, v_real,
                             real_labels, w) -> torch.Tensor:
    """errD: the mean of the real half (BCE against 1, CE against the
    labels) and the fake half (BCE against 0, CE against the fake
    labels)."""
    d_real = 0.5 * (bce_logits(v_real, 1.0, w) + ce(cls_real, real_labels,
                                                    w))
    d_fake = 0.5 * (bce_logits(v_fake, 0.0, w) + ce(cls_fake, gen_labels,
                                                    w))
    return 0.5 * (d_real + d_fake)


def leave_one_out_teacher(logits: torch.Tensor) -> torch.Tensor:
    """``[C, S, K]`` logits of a cohort to each member's teacher: the mean
    of the others' logits, ``(sum - own) / max(C - 1, 1)``."""
    c = logits.shape[0]
    return (torch.sum(logits, 0)[None] - logits) / max(c - 1, 1)


def dynamic_trip_count(n_k: int, batch_size: int, max_steps: int) -> int:
    """A client's steps an epoch, ``ceil(n_k / B)`` up to ``max_steps``:
    with its real samples first in every epoch's order, the steps past it
    are all padding. From host counts."""
    return min(-(-int(n_k) // batch_size), max_steps)


def graph_programs(graphed: bool, fn) -> CompiledRoundCache:
    """One program per lane count: a CUDA graph of ``fn`` on the card (a
    graph takes its shapes from its first run), None on the CPU."""
    return CompiledRoundCache(
        lambda lanes: GraphedStep(fn) if graphed else None)


def run_steps(programs: CompiledRoundCache, lanes: int, step: Callable,
              carry, consts, fixed: tuple, batches: Sequence):
    """``step(carry, consts, fixed, batch)`` once per batch from
    ``carry``: one replay each of the lane count's graph on the card, the
    same step eagerly on the CPU. Returns the last carry."""
    if not batches:
        return carry
    graph = programs(lanes)
    if graph is not None:
        return graph.run(carry, consts, fixed, batches)
    for batch in batches:
        carry = step(carry, consts, fixed, batch)
    return carry


def split_vars(variables: Params, stat_names) -> tuple[Params, Params]:
    params = {k: v for k, v in variables.items() if k not in stat_names}
    return params, {k: variables[k] for k in stat_names}


def lanes_of(variables: Params, lanes: int) -> Params:
    """One model's variables as ``lanes`` identical rows (a global model
    every lane starts from)."""
    return {k: v.detach().expand(lanes, *v.shape).clone()
            for k, v in variables.items()}


def dropout_sites(model: FedModel) -> dict:
    """The model's dropout sites (``{name: (H, W, C)}`` of one sample's
    mask), empty for a model without dropout."""
    shapes = getattr(model.module, "mask_shapes", None)
    return shapes() if shapes is not None else {}


def step_masks(masks: dict | None, e: int, s: int) -> dict:
    """Epoch ``e``, step ``s`` of a group's masks (``{site: [G, epochs,
    steps, calls, B, H, W, C]}``): ``{site: [G, calls, B, H, W, C]}``."""
    return {k: v[:, e, s] for k, v in (masks or {}).items()}


def call_masks(masks: dict, i: int) -> dict:
    """Call ``i``'s masks of a lane's step (``{site: [calls, ...]}``)."""
    return {k: v[i] for k, v in masks.items()}


class GanCohortUpdate:
    """``update(gen_vars, disc_vars, idx_rows, mask_rows, x, y, orders, z,
    gen_labels, steps, masks=None, labelled=None) -> (gen stack, disc
    stack, n_k, loss sums)``: the adversarial local training of G clients
    (the JAX package's ``build_gan_local_update`` vmapped with
    ``in_axes=(None, 0, 0, 0, None, None, 0)``, or with
    ``shared_disc`` ``(None, None, 0, 0, None, None, 0)``). Every lane's
    generator starts from the one global ``gen_vars``; ``disc_vars`` are
    the lanes' own discriminators, stacked, or with ``shared_disc`` one
    global discriminator every lane starts from (FedGAN, FedSSGAN).
    ``orders`` ``[G, epochs, max_n]`` are the batch orders, real samples
    first; ``z`` ``[G, epochs, S, B, nz]`` and ``gen_labels`` ``[G,
    epochs, S, B]`` the steps' noise and fake labels (``S`` at least
    ``steps``); ``steps`` is the host's count of steps an epoch, the
    group's largest ``ceil(n_k / B)``. A discriminator with dropout takes
    ``masks`` (``{site: [G, epochs, S, 3, B, H, W, C]}`` bool, one mask a
    discriminator call of a step); ``labelled`` (``[N_train]`` 0/1)
    restricts the real batch's supervised CE to labelled samples
    (FedSSGAN).

    A step is one generator step and then one discriminator step:

    - G: ``grad_and_value`` over the generator's parameters of the
      mode's generator loss (:func:`generator_loss_ssgan`,
      :func:`generator_loss_acgan`) of the discriminator's train-mode
      outputs on fresh fakes (call 0's masks; the discriminator's new
      statistics are dropped); the generator's BatchNorm statistics move;
      the generator's optimizer (:func:`make_gen_optimizer`) steps.
    - D: on the fakes, detached (call 1), then on the real batch (call 2),
      the discriminator in train mode both times (the second call from
      the first's statistics); the mode's discriminator loss; the
      client's optimizer steps.

    A batch whose loss weights are all 0 (padding: a lane smaller than its
    group's largest) leaves everything as it was: both models' parameters
    and statistics, both optimizer states (adam's per-lane step count
    included) and the loss sums (``g_loss_sum``, ``d_loss_sum``,
    ``batches``, each ``[G]``)."""

    CALLS = 3  # discriminator calls a step: G's, then D's fakes and real

    def __init__(self, gen: GanModel, disc: FedModel, train_cfg: TrainConfig,
                 gan_cfg: GanConfig, batch_size: int, graphed: bool,
                 mode: str = "ssgan", shared_disc: bool = False):
        if mode not in ("ssgan", "acgan"):
            raise ValueError(f"unknown adversarial mode {mode!r}")
        self.gen, self.disc = gen, disc
        self.mode, self.shared_disc = mode, shared_disc
        self.sites = dropout_sites(disc)
        self.batch_size = batch_size
        self.epochs = train_cfg.epochs
        self.g_opt = make_gen_optimizer(gan_cfg)
        self.d_opt = make_client_optimizer(train_cfg)
        self.g_grad = torch.func.grad_and_value(self._g_loss, has_aux=True)
        self.d_grad = torch.func.grad_and_value(self._d_loss, has_aux=True)
        self.vstep = torch.func.vmap(self._lane_step)
        self.programs = graph_programs(graphed, self._graph_step)

    @property
    def graph(self) -> GraphedStep | None:
        """The CUDA graph of the lane count last run (None on the CPU)."""
        return self.programs.last

    def _disc_train(self, variables, x, masks):
        kwargs = {}
        if self.sites:
            kwargs["masks"] = masks
        if self.mode == "acgan":
            kwargs["validity"] = True
        return self.disc.apply_train(variables, x, **kwargs)

    def _g_loss(self, g_params, g_stats, d_vars, z, gen_labels, w, masks):
        fakes, new_g = self.gen.apply_train({**g_params, **g_stats}, z,
                                            gen_labels)
        out, _ = self._disc_train(d_vars, fakes, masks)
        if self.mode == "acgan":
            loss = generator_loss_acgan(*out, gen_labels, w)
        else:
            loss = generator_loss_ssgan(out, gen_labels, w)
        return loss, ({k: new_g[k] for k in g_stats}, fakes)

    def _d_loss(self, d_params, d_stats, fakes, gen_labels, x_b, y_b, w,
                lab_w, masks_fake, masks_real):
        out_f, vars1 = self._disc_train({**d_params, **d_stats}, fakes,
                                        masks_fake)
        out_r, vars2 = self._disc_train(vars1, x_b, masks_real)
        if self.mode == "acgan":
            loss = discriminator_loss_acgan(*out_f, gen_labels, *out_r, y_b,
                                            w)
        else:
            loss = discriminator_loss_ssgan(out_f, gen_labels, out_r, y_b, w,
                                            lab_w)
        return loss, {k: vars2[k] for k in d_stats}

    def _lane_step(self, carry, x_b, y_b, w_b, lab_w, z, gen_labels, masks):
        g_params, d_params = carry["g_params"], carry["d_params"]
        d_vars = {**d_params, **carry["d_stats"]}
        g_grads, (g_loss, (g_stats, fakes)) = self.g_grad(
            g_params, carry["g_stats"], d_vars, z, gen_labels, w_b,
            call_masks(masks, 0))
        g_upd, g_opt = self.g_opt.update(g_grads, carry["g_opt"], g_params)
        d_grads, (d_loss, d_stats) = self.d_grad(
            d_params, carry["d_stats"], fakes.detach(), gen_labels, x_b,
            y_b, w_b, lab_w, call_masks(masks, 1), call_masks(masks, 2))
        d_upd, d_opt = self.d_opt.update(d_grads, carry["d_opt"], d_params)
        new = {"g_params": apply_updates(g_params, g_upd),
               "g_stats": g_stats, "g_opt": g_opt,
               "d_params": apply_updates(d_params, d_upd),
               "d_stats": d_stats, "d_opt": d_opt}
        valid = torch.sum(w_b) > 0
        out = T.tree_map(lambda n, o: torch.where(valid, n, o), new,
                         {k: carry[k] for k in new})
        sums = carry["sums"]
        out["sums"] = {
            "g_loss_sum": sums["g_loss_sum"] + torch.where(valid, g_loss, 0.0),
            "d_loss_sum": sums["d_loss_sum"] + torch.where(valid, d_loss, 0.0),
            "batches": sums["batches"] + valid.float(),
        }
        return out

    def step(self, carry, x, y, b_idx, w_b, z, gen_labels, masks=None,
             labelled=None):
        """One step of every lane: lane ``g`` takes rows ``b_idx[g]`` of
        ``x``/``y`` with weights ``w_b[g]``, noise ``z[g]``, fake labels
        ``gen_labels[g]`` and dropout masks ``masks`` (``{site: [G, 3, B,
        H, W, C]}``); with ``labelled`` the real CE's weights are ``w_b *
        labelled[b_idx]``."""
        lab_w = w_b if labelled is None else w_b * labelled[b_idx]
        return self.vstep(carry, x[b_idx], y[b_idx], w_b, lab_w, z,
                          gen_labels, masks or {})

    def _graph_step(self, carry, consts, fixed, batch):
        x, y, labelled = fixed
        return self.step(carry, x, y, *batch, labelled=labelled)

    def init_carry(self, gen_vars: Params, disc_vars: Params,
                   lanes: int | None = None) -> dict:
        """The carry G lanes start from: the global generator on every
        lane, the lanes' discriminators (or with ``shared_disc`` the global
        one on every lane, ``lanes`` of them), fresh optimizer states, zero
        sums."""
        if not self.shared_disc:
            lanes = next(iter(disc_vars.values())).shape[0]
        else:
            disc_vars = lanes_of(disc_vars, lanes)
        g_params, g_stats = split_vars(lanes_of(gen_vars, lanes),
                                       self.gen.stat_names)
        d_params, d_stats = split_vars(disc_vars, self.disc.stat_names)
        device = next(iter(g_params.values())).device
        return {"g_params": g_params, "g_stats": g_stats,
                "g_opt": self.g_opt.init(g_params, (lanes,)),
                "d_params": d_params, "d_stats": d_stats,
                "d_opt": self.d_opt.init(d_params, (lanes,)),
                "sums": {k: torch.zeros(lanes, device=device)
                         for k in ("g_loss_sum", "d_loss_sum", "batches")}}

    def __call__(self, gen_vars, disc_vars, idx_rows, mask_rows, x, y,
                 orders, z, gen_labels, steps: int, masks=None,
                 labelled=None):
        lanes = idx_rows.shape[0]
        # lane_batches is epoch-major: batch i is epoch i // steps, step
        # i % steps
        batches = [
            (b_idx, w_b, z[:, i // steps, i % steps],
             gen_labels[:, i // steps, i % steps],
             step_masks(masks, i // steps, i % steps))
            for i, (b_idx, w_b) in enumerate(lane_batches(
                idx_rows, mask_rows, orders, self.epochs, steps,
                self.batch_size))]
        carry = run_steps(self.programs, lanes, self._graph_step,
                          self.init_carry(gen_vars, disc_vars, lanes), {},
                          (x, y, labelled), batches)
        g = {**carry["g_params"], **carry["g_stats"]}
        d = {**carry["d_params"], **carry["d_stats"]}
        return ({k: g[k] for k in gen_vars}, {k: d[k] for k in disc_vars},
                mask_rows.sum(1), carry["sums"])


def build_dataset_generator(gen: GanModel, size: int, batch_size: int):
    """``generate(gen_vars, z) -> (synth_x [S, H, W, C], labels [S])``:
    the distillation set, ``size`` images from the generator in eval mode
    (BatchNorm on its running statistics), row ``i`` of class ``i % K``
    (0 for an unconditional generator); ``z`` ``[S / B, B, nz]`` is one
    noise draw per generation batch. Eval mode makes every row a function
    of its own noise and label, so the batches run as one call."""
    if size % batch_size:
        raise ValueError(f"size {size} is not a multiple of the batch size "
                         f"{batch_size}")

    @torch.no_grad()
    def generate(gen_vars: Params, z: torch.Tensor):
        labels = (gen.balanced_labels(size) if gen.conditional
                  else torch.zeros(size, dtype=torch.int64,
                                   device=z.device))
        x = gen.apply_eval(gen_vars, z.reshape(size, -1), labels)
        return x, labels

    return generate


def build_logit_extractor(disc: FedModel):
    """``extract(cls_vars, synth_x) -> [C, S, K]``: every lane's classifier
    in eval mode on the whole set, in one vmapped call."""

    @torch.no_grad()
    def extract(cls_vars: Params, synth_x: torch.Tensor) -> torch.Tensor:
        return torch.func.vmap(disc.apply_eval, in_dims=(0, None))(
            cls_vars, synth_x)

    return extract


class KDUpdate:
    """``kd(cls_vars, synth_x, synth_y, teachers) -> (cls_vars, sums)``:
    the distillation of G lanes' classifiers (the JAX package's
    ``build_kd_update`` vmapped with ``in_axes=(0, None, None, 0, 0)``).
    ``kd_epochs`` passes over the ``S / B`` batches of the set in order,
    each step the loss ``(1 - kd_alpha) * CE + kd_alpha *
    soft_target(T)`` against the lane's teacher logits (``teachers`` ``[G,
    S, K]``), with a fresh client optimizer at each call. The batch is the
    same for every lane; the sums (``kd_loss_sum``, ``dist_loss_sum``,
    ``batches``) are ``[G]``. One CUDA graph replay a step on the card."""

    def __init__(self, disc: FedModel, train_cfg: TrainConfig,
                 gan_cfg: GanConfig, size: int, batch_size: int,
                 graphed: bool):
        if size % batch_size:
            raise ValueError(f"size {size} is not a multiple of the batch "
                             f"size {batch_size}")
        self.disc = disc
        self.size, self.batch_size = size, batch_size
        self.kd_epochs = gan_cfg.kd_epochs
        self.alpha, self.temperature = gan_cfg.kd_alpha, gan_cfg.kd_temperature
        self.opt = make_client_optimizer(train_cfg)
        self.grad = torch.func.grad_and_value(self._loss, has_aux=True)
        self.vstep = torch.func.vmap(self._lane_step,
                                     in_dims=(0, None, None, 0))
        self.programs = graph_programs(graphed, self._graph_step)

    @property
    def graph(self) -> GraphedStep | None:
        return self.programs.last

    def _loss(self, params, stats, xb, yb, tb):
        logits, new_vars = self.disc.apply_train({**params, **stats}, xb)
        kd = soft_target(logits, tb, self.temperature)
        loss = ((1 - self.alpha) * F.cross_entropy(logits, yb.long())
                + self.alpha * kd)
        return loss, ({k: new_vars[k] for k in stats}, kd)

    def _lane_step(self, carry, xb, yb, tb):
        params = carry["params"]
        grads, (loss, (stats, kd)) = self.grad(params, carry["stats"], xb,
                                               yb, tb)
        updates, opt = self.opt.update(grads, carry["opt"], params)
        sums = carry["sums"]
        return {"params": apply_updates(params, updates), "stats": stats,
                "opt": opt,
                "sums": {"kd_loss_sum": sums["kd_loss_sum"] + kd,
                         "dist_loss_sum": sums["dist_loss_sum"] + loss,
                         "batches": sums["batches"] + 1.0}}

    def _graph_step(self, carry, consts, fixed, batch):
        return self.vstep(carry, *batch)

    def __call__(self, cls_vars: Params, synth_x, synth_y, teachers):
        lanes = teachers.shape[0]
        params, stats = split_vars(cls_vars, self.disc.stat_names)
        carry = {"params": params, "stats": stats,
                 "opt": self.opt.init(params, (lanes,)),
                 "sums": {k: torch.zeros(lanes, device=teachers.device)
                          for k in ("kd_loss_sum", "dist_loss_sum",
                                    "batches")}}
        b = self.batch_size
        batches = [(synth_x[i * b:(i + 1) * b], synth_y[i * b:(i + 1) * b],
                    teachers[:, i * b:(i + 1) * b])
                   for _ in range(self.kd_epochs)
                   for i in range(self.size // b)]
        carry = run_steps(self.programs, lanes, self._graph_step, carry, {},
                          (), batches)
        new = {**carry["params"], **carry["stats"]}
        return {k: new[k] for k in cls_vars}, carry["sums"]
