"""Seeded draws: client sampling, per-epoch batch orders, the draws of
the defended round (the aggregate's noise, the quantizer's stochastic
rounding, the adversaries' gaussians, the streamed defenses' random
projection), the GAN family's (the adversarial steps' noise and fake
labels, the distillation set's noise) and the dropout masks of every
model with dropout, a stream a phase.

Every draw comes from a ``torch.Generator`` seeded by a seed and the
draw's coordinates (round, client, slot, ...), so each is a function of
``(seed, coordinates)`` alone, as in the JAX package. Cohorts and batch
orders are drawn on the host by CPU generators; the draws the size of
the model (:class:`DeviceDraws`) are made on the simulation's device by
a generator of that device, so they cost no host pass and no copy.
Torch cannot reproduce ``jax.random`` bits; parity tests therefore inject
the JAX package's draws through the simulation's hooks instead
(``FedAvgSim(sampler=, batch_orders=, draws=)``).
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

import numpy as np
import torch

# the streams of the defended round: (salt, distribution). Each stream's
# generator is seeded by (seed, salt, round, slot); the salts are the
# JAX package's fold_in salts (the noise folds the round key with 1, the
# codec and the adversary have their own)
STREAMS = {
    "noise": (1, "normal"),  # the aggregate's noise, slot 0
    "quant": (0x43505253, "uniform"),  # stochastic rounding, per slot
    "gauss": (0x41D5, "normal"),  # gauss adversaries, per client id
    "collude": (0x41D6, "normal"),  # collude's shared delta, slot 0
    "proj": (0x534B5348, "normal"),  # streamed defenses' projection, slot 0
    # FedGDKD: each client's adversarial steps ([epochs, steps, B, nz]
    # noise and [epochs, steps, B] labels in [0, classes)), per client id;
    # the distillation set's noise ([batches, B, nz]), slot 0
    "gan_z": (0x47414E5A, "normal"),
    "gan_labels": (0x47414E4C, "randint"),
    "synth": (0x5EED, "normal"),
    # dropout: bool keep masks, per client id, a group's at a time: the
    # GAN family's discriminator calls ([epochs, steps, calls, B, H, W, C]
    # a site), a classifier's local steps ([epochs, steps, B, *site])
    "dropout": (0x44524F50, "bernoulli"),
    # the distillation family's other phases, each its own stream so no
    # two phases of a round share masks, per client id: FedMD's digest
    # and public pretraining ([epochs, batches, B, *site]), its private
    # pretraining (as "dropout"; the pretraining at round 0), FedArjun's
    # two transfers (as "dropout")
    "dropout_public": (0x44505542, "bernoulli"),
    "dropout_pretrain": (0x44505254, "bernoulli"),
    "dropout_pretrain_private": (0x44505056, "bernoulli"),
    "dropout_a2l": (0x4441324C, "bernoulli"),
    "dropout_l2a": (0x444C3241, "bernoulli"),
    # the GAN family's classifiers: FedDTG's classifier in a local step
    # (G's call, then the classifier step's real and fake calls,
    # [epochs, steps, 3, B, *site]); the leave-one-out distillation and
    # FedGDKD's drift correction ([kd_epochs, batches, B, *site]), per
    # client id
    "dropout_cls": (0x44434C53, "bernoulli"),
    "dropout_kd": (0x44524B44, "bernoulli"),
    "dropout_drift": (0x44524654, "bernoulli"),
}

# a stream of one of several models (a bucket of HeteroFedGDKD) is the
# stream's name, "@" and the model's tag: the same salt and distribution,
# its own seed and keep probabilities
SCOPE = "@"


def scoped(stream: str, tag) -> str:
    """``stream`` of the model tagged ``tag``, e.g. ``"dropout_kd@2"``."""
    return f"{stream}{SCOPE}{tag}"


def base_stream(stream: str) -> str:
    """The stream in :data:`STREAMS` that ``stream`` (scoped or not)
    draws from."""
    return stream.partition(SCOPE)[0]

# (stream, round, slots, {name: shape}) -> {name: [len(slots), *shape]}
Draws = Callable[[str, int, Sequence[int], Mapping[str, tuple]],
                 dict[str, torch.Tensor]]


def generator(seed: int, *coords: int,
              device: str | torch.device = "cpu") -> torch.Generator:
    """A fresh generator on ``device`` for the draw at ``coords`` under
    ``seed``."""
    mixed = np.random.SeedSequence([seed, *coords]).generate_state(
        1, np.uint64
    )[0]
    return torch.Generator(device=device).manual_seed(
        int(mixed) & ((1 << 63) - 1))


class DeviceDraws:
    """The default :data:`Draws`: for each slot, one generator on
    ``device`` seeded by ``(seeds[stream], salt, round, slot)`` fills one
    row of a ``[len(slots), total]`` float32 buffer (standard normal,
    uniform on [0, 1), or for a "randint" stream whole numbers uniform on
    ``[0, high[stream])``, by stream), and each leaf is a view of its
    columns. One kernel per slot, whatever the number of leaves.

    A "bernoulli" stream (the dropout masks) gives bool leaves, leaf
    ``site`` True with probability ``p[stream][site]``: the keep
    probabilities are the model's (``FedModel.mask_keep``), keyed by
    stream then site, so two models whose sites share a name draw each at
    its own rate from streams of their own (:func:`scoped`). Each slot's
    generator draws each leaf one leading index at a time, uniform on [0,
    1) compared with the site's keep probability, so the float32 staging
    is one such slice, never the whole draw (a group's masks at full
    width are hundreds of millions of values). A scoped stream draws
    with its base stream's salt and distribution."""

    def __init__(self, seeds: Mapping[str, int], device: torch.device,
                 high: Mapping[str, int] | None = None,
                 p: Mapping[str, float] | None = None):
        self.seeds = dict(seeds)
        self.device = torch.device(device)
        self.high = dict(high or {})
        self.p = {k: dict(v) for k, v in (p or {}).items()}

    def __call__(self, stream: str, round_idx: int, slots: Sequence[int],
                 shapes: Mapping[str, tuple]) -> dict[str, torch.Tensor]:
        salt, kind = STREAMS[base_stream(stream)]
        if kind == "bernoulli":
            return self._bernoulli(stream, salt, round_idx, slots, shapes)
        sizes = [int(np.prod(s)) for s in shapes.values()]
        buf = torch.empty((len(slots), sum(sizes)), device=self.device)
        for row, slot in zip(buf, slots):
            gen = generator(self.seeds[stream], salt, round_idx, int(slot),
                            device=self.device)
            if kind == "normal":
                row.normal_(generator=gen)
            elif kind == "randint":
                row.random_(0, self.high[stream], generator=gen)
            else:
                row.uniform_(generator=gen)
        out, off = {}, 0
        for (name, shape), n in zip(shapes.items(), sizes):
            out[name] = buf[:, off:off + n].reshape(len(slots), *shape)
            off += n
        return out

    def _bernoulli(self, stream, salt, round_idx, slots, shapes):
        out = {name: torch.empty((len(slots), *shape), dtype=torch.bool,
                                 device=self.device)
               for name, shape in shapes.items()}
        p = self.p[stream]
        for row, slot in enumerate(slots):
            gen = generator(self.seeds[stream], salt, round_idx, int(slot),
                            device=self.device)
            for name, shape in shapes.items():
                keep = p[name]
                for i in range(shape[0]):
                    u = torch.rand(shape[1:], generator=gen,
                                   device=self.device)
                    torch.lt(u, keep, out=out[name][row, i])
        return out


def mask_shapes(sites: Mapping[str, tuple], lead: tuple, batch: int
                ) -> dict[str, tuple]:
    """A dropout draw's shapes for a lane: ``{site: (*lead, batch,
    *site_shape)}``, ``lead`` the steps' coordinates (a classifier's
    ``(epochs, steps)``, a discriminator's ``(epochs, steps, calls)``)."""
    return {k: tuple(lead) + (batch,) + tuple(s) for k, s in sites.items()}


def sample_clients(
    gen: torch.Generator, num_clients: int, clients_per_round: int
) -> torch.Tensor:
    """A cohort drawn without replacement; a cohort that covers the
    population is ``arange``."""
    if clients_per_round >= num_clients:
        return torch.arange(num_clients)
    return torch.randperm(num_clients, generator=gen)[:clients_per_round]


def padded_perm(
    gen: torch.Generator, mask_row: torch.Tensor, max_n: int
) -> torch.Tensor:
    """One epoch's batch order for one client: shuffle, then stable-sort
    so the real samples fill the first ``ceil(n_k / B)`` batches and the
    trailing batches are all padding."""
    perm = torch.randperm(max_n, generator=gen).to(mask_row.device)
    order = torch.argsort(1.0 - mask_row[perm], stable=True)
    return perm[order]
