"""Semi-supervised and universally aggregated federated GANs
(``fedml_tpu.algorithms.sgan``).

- :class:`FedSSGANSim`, the federated semi-supervised GAN: the shared
  generator and a shared K-way discriminator (the ACGAN trunk without
  its validity head), trained with the ssgan losses; the supervised
  real CE counts only the labelled samples (a fixed ``label_fraction``
  of the training set); whole-model FedAvg.
- :class:`FedUAGANSim`, UA-GAN: one central conditional generator
  against a bank of private client discriminators. Each round every
  client's discriminator trains on its real data against one shared
  batch of fakes; then the generator takes one step through the
  sample-count-weighted mean of all the discriminators' outputs (the
  "universal" discriminator). Discriminators are never averaged.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from fedml_tpu_torch.algorithms import gan_core as G
from fedml_tpu_torch.algorithms.base import (
    apply_updates,
    make_client_optimizer,
)
from fedml_tpu_torch.algorithms.gan_family import (
    INIT,
    FedGANSim,
    FedGANState,
    GanSim,
)
from fedml_tpu_torch.algorithms.stack_utils import vmap_init
from fedml_tpu_torch.config import ExperimentConfig
from fedml_tpu_torch.core import random as R
from fedml_tpu_torch.core import tree as T
from fedml_tpu_torch.core.device import to_device
from fedml_tpu_torch.data.federated import FederatedData
from fedml_tpu_torch.models.base import FedModel, Params
from fedml_tpu_torch.models.gan import GanModel

# the labelled subset's salt (the JAX package seeds it by seed ^ 0x55)
LABELLED = 0x55

FedSSGANState = FedGANState


class FedSSGANSim(FedGANSim):
    """The federated semi-supervised GAN (``fedml_tpu.algorithms.sgan.
    FedSSGANSim``): FedGAN's round in ssgan mode, on a discriminator
    without a validity head, with the real batch's CE weighted by ``w *
    labelled``. ``labelled`` (``[N_train]``, 0 or 1) defaults to a uniform
    draw seeded by ``(seed, LABELLED)`` below ``label_fraction``; the hook
    lets a test give the JAX package's. No metrics."""

    mode = "ssgan"

    def __init__(self, gen: GanModel, disc: FedModel, data: FederatedData,
                 cfg: ExperimentConfig, device: str | torch.device = "cuda",
                 sampler: Callable | None = None,
                 batch_orders: Callable | None = None,
                 draws: R.Draws | None = None,
                 label_fraction: float = 0.5,
                 labelled: torch.Tensor | None = None):
        super().__init__(gen, disc, data, cfg, device, sampler, batch_orders,
                         draws)
        self.label_fraction = float(label_fraction)
        if labelled is None:
            u = torch.rand(self.arrays.x.shape[0],
                           generator=R.generator(cfg.seed, LABELLED))
            labelled = (u < self.label_fraction).float()
        self.labelled = to_device(
            torch.as_tensor(labelled, dtype=torch.float32), self.device)

    def run_round(self, state: FedSSGANState):
        """One round: the cohort's ssgan training, then the weighted means
        of the generator and the discriminator."""
        g_stack, d_stack, n_k, _ = self._locals(state)
        return FedSSGANState(T.tree_weighted_mean(g_stack, n_k),
                             T.tree_weighted_mean(d_stack, n_k),
                             state.round + 1), {}

    def generate_synthetic_dataset(self, state: FedSSGANState,
                                   target_size: int, seed: int = 0,
                                   z: torch.Tensor | None = None,
                                   labels: torch.Tensor | None = None):
        """``(images, pseudo_labels, keep)``: ``target_size`` images of the
        generator in eval mode, the discriminator's most likely class for
        each (eval mode) and whether its probability reaches
        ``pseudo_label_threshold`` (rows below it are masked, not dropped).
        ``z`` and ``labels`` default to draws seeded by ``seed``."""
        gen = R.generator(seed)
        if z is None:
            z = to_device(torch.randn(target_size, self.gen.nz,
                                      generator=gen), self.device)
        if labels is None:
            labels = to_device(torch.randint(
                0, self.gen.num_classes, (target_size,), generator=gen),
                self.device)
        with torch.no_grad():
            imgs = self.gen.apply_eval(state.gen_vars, z, labels)
            probs = F.softmax(self.disc.apply_eval(state.disc_vars, imgs),
                              dim=-1)
        conf, pseudo = probs.max(dim=-1)
        return imgs, pseudo, conf >= self.cfg.gan.pseudo_label_threshold


class UADiscUpdate:
    """``update(disc_stack, fakes, gen_labels, idx_rows, mask_rows, x, y,
    takes, masks=None) -> disc stack``: one round of every client's
    private discriminator (the JAX package's ``FedUAGANSim.
    _build_disc_update`` vmapped over all N clients): ``takes`` ``[N,
    steps, B]`` are the positions (into each client's padded rows) of
    each step's batch, a random subset that may hold padding, weighted
    out; every lane steps ``steps`` times against the same ``fakes`` ``[B,
    H, W, C]`` of labels ``gen_labels``, with a fresh client optimizer.
    A step runs the discriminator in train mode on the real batch, then on
    the fakes (the second call from the first's statistics; ``masks``
    ``{site: [N, steps, 2, B, H, W, C]}`` in that order), and takes
    ``discriminator_loss_acgan``. A batch whose weights are all 0 leaves
    the lane's discriminator and optimizer state as they were."""

    CALLS = 2

    def __init__(self, disc: FedModel, train_cfg, batch_size: int,
                 graphed: bool):
        self.disc = disc
        self.sites = G.dropout_sites(disc)
        self.batch_size = batch_size
        self.opt = make_client_optimizer(train_cfg)
        self.grad = torch.func.grad_and_value(self._loss, has_aux=True)
        self.vstep = torch.func.vmap(self._lane_step,
                                     in_dims=(0, 0, 0, 0, None, None, 0))
        self.programs = G.graph_programs(graphed, self._graph_step)

    @property
    def graph(self):
        return self.programs.last

    def _call(self, variables, x, masks):
        kwargs = {"masks": masks} if self.sites else {}
        return self.disc.apply_train(variables, x, validity=True, **kwargs)

    def _loss(self, params, stats, x_b, y_b, w_b, fakes, gen_labels, masks):
        (cls_r, v_r), vars1 = self._call({**params, **stats}, x_b,
                                         G.call_masks(masks, 0))
        (cls_f, v_f), vars2 = self._call(vars1, fakes,
                                         G.call_masks(masks, 1))
        loss = G.discriminator_loss_acgan(cls_f, v_f, gen_labels, cls_r, v_r,
                                          y_b, w_b)
        return loss, {k: vars2[k] for k in stats}

    def _lane_step(self, carry, x_b, y_b, w_b, fakes, gen_labels, masks):
        params = carry["params"]
        grads, (_, stats) = self.grad(params, carry["stats"], x_b, y_b, w_b,
                                      fakes, gen_labels, masks)
        updates, opt = self.opt.update(grads, carry["opt"], params)
        new = {"params": apply_updates(params, updates), "stats": stats,
               "opt": opt}
        valid = torch.sum(w_b) > 0
        return T.tree_map(lambda n, o: torch.where(valid, n, o), new, carry)

    def _graph_step(self, carry, consts, fixed, batch):
        x, y = fixed
        b_idx, w_b, masks = batch
        return self.vstep(carry, x[b_idx], y[b_idx], w_b, consts["fakes"],
                          consts["labels"], masks)

    def __call__(self, disc_stack: Params, fakes, gen_labels, idx_rows,
                 mask_rows, x, y, takes, masks=None) -> Params:
        lanes, steps = takes.shape[:2]
        params, stats = G.split_vars(disc_stack, self.disc.stat_names)
        carry = {"params": params, "stats": stats,
                 "opt": self.opt.init(params, (lanes,))}
        batches = [(torch.gather(idx_rows, 1, takes[:, s]).long(),
                    torch.gather(mask_rows, 1, takes[:, s]),
                    {k: v[:, s] for k, v in (masks or {}).items()})
                   for s in range(steps)]
        carry = G.run_steps(self.programs, lanes, self._graph_step, carry,
                            {"fakes": fakes, "labels": gen_labels}, (x, y),
                            batches)
        new = {**carry["params"], **carry["stats"]}
        return {k: new[k] for k in disc_stack}


class FedUAGANState(NamedTuple):
    gen_vars: Params
    gen_opt_state: dict  # the generator's optimizer, across rounds
    disc_stack: Params  # [N, ...] the clients' private discriminators
    round: int


class FedUAGANSim(GanSim):
    """UA-GAN (``fedml_tpu.algorithms.sgan.FedUAGANSim``). A round:

    1. Discriminators: one batch of fakes from the current generator in
       eval mode (``"gan_z"`` and ``"gan_labels"`` slot 0, row 0); every
       client's discriminator takes ``max_n // B`` steps
       (:class:`UADiscUpdate`), all N as the lanes of one group.
    2. Generator: one step of the generator's optimizer (its state kept in
       the round state) on ``0.5 * (adv + aux)``, where the N
       discriminators in eval mode see train-mode fakes (row 1 of the
       draws; the generator's new statistics are dropped), and
       ``adv = -mean(log p)``, ``aux = -mean(log q[label])`` from the
       count-weighted means ``p`` of ``sigmoid(validity)`` (clipped to
       ``[1e-6, 1 - 1e-6]``) and ``q`` of ``softmax(class logits)``
       (clipped below at 1e-9).

    ``batch_orders(round, client)`` gives a client's ``[steps, B]`` batch
    positions (default: the first B of a seeded permutation of ``max_n``
    a step). Metric: ``g_loss``."""

    REAL_LABEL = 1.0

    def __init__(self, gen: GanModel, disc: FedModel, data: FederatedData,
                 cfg: ExperimentConfig, device: str | torch.device = "cuda",
                 batch_orders: Callable | None = None,
                 draws: R.Draws | None = None):
        if not getattr(disc.module, "validity_head", False):
            raise ValueError("UA-GAN needs an ACGAN discriminator with its "
                             "validity head")
        super().__init__(gen, {"discriminator": disc}, data, cfg, device,
                         None, batch_orders, draws, dropout_model=disc)
        self.disc = disc
        self.g_opt = G.make_gen_optimizer(cfg.gan)
        self.g_grad = torch.func.grad_and_value(self._g_loss)
        self.disc_update = UADiscUpdate(disc, cfg.train, self.batch_size,
                                        self.graphed)
        counts = self.arrays.counts.float()
        self.weights = counts / torch.sum(counts)

    def _orders(self, round_idx, client):
        gen = R.generator(self.cfg.seed, round_idx, client)
        return torch.stack([torch.randperm(self.max_n, generator=gen)
                            [:self.batch_size]
                            for _ in range(self.steps_per_epoch)])

    def init(self) -> FedUAGANState:
        n, seed = self.arrays.num_clients, self.cfg.seed
        gen_vars = self.gen.init(R.generator(seed, INIT, 0))
        params, _ = G.split_vars(gen_vars, self.gen.stat_names)
        return FedUAGANState(gen_vars, self.g_opt.init(params),
                             vmap_init(self.disc.init, n, seed, INIT, 1), 0)

    def _g_loss(self, g_params, g_stats, disc_stack, z, gen_labels):
        fakes, _ = self.gen.apply_train({**g_params, **g_stats}, z,
                                        gen_labels)
        cls, val = torch.func.vmap(
            lambda d: self.disc.apply_eval(d, fakes, validity=True))(
                disc_stack)
        w = self.weights
        ua_prob = torch.einsum("c,cbo->bo", w, torch.sigmoid(val)).clamp(
            1e-6, 1 - 1e-6)
        ua_cls = torch.einsum("c,cbk->bk", w, F.softmax(cls, dim=-1)).clamp(
            min=1e-9)
        real = self.REAL_LABEL
        adv = -torch.mean(real * torch.log(ua_prob)
                          + (1 - real) * torch.log1p(-ua_prob))
        picked = ua_cls[torch.arange(gen_labels.shape[0],
                                     device=gen_labels.device), gen_labels]
        aux = -torch.mean(torch.log(picked))
        return 0.5 * (adv + aux)

    def run_round(self, state: FedUAGANState):
        """One round; the metric (``g_loss``) stays on the device."""
        a, b, r = self.arrays, self.batch_size, state.round
        n = a.num_clients
        takes = to_device(torch.stack([
            torch.as_tensor(self.batch_orders(r, c)) for c in range(n)
        ]).long(), self.device)
        z = self.draws("gan_z", r, [0], {"z": (2, b, self.gen.nz)})["z"][0]
        labels = self.draws("gan_labels", r, [0],
                            {"labels": (2, b)})["labels"][0].long()
        with torch.no_grad():
            fakes = self.gen.apply_eval(state.gen_vars, z[0], labels[0])
        masks = self._masks(r, range(n), (self.steps_per_epoch,
                                          UADiscUpdate.CALLS))
        self.last_groups = [(n, self.steps_per_epoch)]
        disc_stack = self.disc_update(state.disc_stack, fakes, labels[0],
                                      a.idx, a.mask, a.x, a.y, takes, masks)
        g_params, g_stats = G.split_vars(state.gen_vars,
                                         self.gen.stat_names)
        grads, g_loss = self.g_grad(g_params, g_stats, disc_stack, z[1],
                                    labels[1])
        updates, opt_state = self.g_opt.update(grads, state.gen_opt_state,
                                               g_params)
        gen_vars = {**state.gen_vars, **apply_updates(g_params, updates)}
        return FedUAGANState(gen_vars, opt_state, disc_stack, r + 1), {
            "g_loss": g_loss}
