"""Seeded draws: client sampling and per-epoch batch orders.

Every draw comes from a CPU ``torch.Generator`` seeded by the experiment
seed and the draw's coordinates (round, client, ...), so cohorts and batch
orders are a function of ``(seed, round)`` alone, as in the JAX package.
Torch cannot reproduce ``jax.random`` bits; parity tests therefore inject
the JAX package's draws through the samplers' hooks instead.
"""

from __future__ import annotations

import numpy as np
import torch


def generator(seed: int, *coords: int) -> torch.Generator:
    """A fresh CPU generator for the draw at ``coords`` under ``seed``."""
    mixed = np.random.SeedSequence([seed, *coords]).generate_state(
        1, np.uint64
    )[0]
    return torch.Generator().manual_seed(int(mixed) & ((1 << 63) - 1))


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
