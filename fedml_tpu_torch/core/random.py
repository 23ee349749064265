"""Seeded draws: client sampling, per-epoch batch orders, and the draws of
the defended round (the aggregate's noise, the quantizer's stochastic
rounding, the adversaries' gaussians).

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
}

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
    row of a ``[len(slots), total]`` float32 buffer (standard normal or
    uniform on [0, 1), by stream), and each leaf is a view of its
    columns. One kernel per slot, whatever the number of leaves."""

    def __init__(self, seeds: Mapping[str, int], device: torch.device):
        self.seeds = dict(seeds)
        self.device = torch.device(device)

    def __call__(self, stream: str, round_idx: int, slots: Sequence[int],
                 shapes: Mapping[str, tuple]) -> dict[str, torch.Tensor]:
        salt, kind = STREAMS[stream]
        sizes = [int(np.prod(s)) for s in shapes.values()]
        buf = torch.empty((len(slots), sum(sizes)), device=self.device)
        for row, slot in zip(buf, slots):
            gen = generator(self.seeds[stream], salt, round_idx, int(slot),
                            device=self.device)
            if kind == "normal":
                row.normal_(generator=gen)
            else:
                row.uniform_(generator=gen)
        out, off = {}, 0
        for (name, shape), n in zip(shapes.items(), sizes):
            out[name] = buf[:, off:off + n].reshape(len(slots), *shape)
            off += n
        return out


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
