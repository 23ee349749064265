"""What the simulations of per-client models share: the device, the
data's arrays, the replay hooks, the cohort and the draws.

The GAN family (``algorithms/gan_family.py``, ``algorithms/sgan.py``) and
the distillation family (``algorithms/distill.py``) run on one device
with three hooks, each a function of its coordinates alone so a test can
replay the JAX package's: ``sampler(round, num_clients,
clients_per_round)`` gives the round's cohort ids, ``batch_orders(round,
client, ...)`` a client's per-epoch batch orders (real samples first) and
``draws(stream, round, slots, shapes)``
(:data:`fedml_tpu_torch.core.random.Draws`) the draws the size of the
model, dropout masks included. A round reads nothing back from the
device: the cohort, the batch orders and the sample counts that group
the cohort and set each group's steps are on the host.
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from fedml_tpu_torch.algorithms.base import make_task
from fedml_tpu_torch.config import ExperimentConfig
from fedml_tpu_torch.core import memscope as M
from fedml_tpu_torch.core import random as R
from fedml_tpu_torch.core.device import resolve_device, to_device
from fedml_tpu_torch.data.federated import FederatedData, arrays_and_batch
from fedml_tpu_torch.models.base import FedModel


class ClientSim:
    """A simulation of per-client models on one device.

    ``models`` names the sim's models (each must be on ``device``).
    ``streams`` are the default draws' seeds by stream, ``high`` and
    ``p`` as :class:`~fedml_tpu_torch.core.random.DeviceDraws` takes them.
    The default ``batch_orders(round, client, phase="local", epochs=None)``
    draws ``epochs`` (by default ``train.epochs``) orders from a
    generator seeded by ``(seed, round, client)``, or for another phase
    ``(seed, round, client, phase salt)`` (``PHASES``); the GAN family
    calls it with the first two only.

    ``counters`` holds the run's counters; ``last_groups`` the last
    phase's groups (clients, steps an epoch)."""

    # a phase's salt in its batch orders' seed
    PHASES = {"pretrain": 1, "a2l": 2, "l2a": 3}

    def __init__(self, models: Mapping[str, FedModel], data: FederatedData,
                 cfg: ExperimentConfig, device: str | torch.device,
                 sampler: Callable | None, batch_orders: Callable | None,
                 draws: R.Draws | None, streams: Mapping[str, int],
                 high: Mapping[str, int] | None = None,
                 p: Mapping[str, object] | None = None):
        self.device = resolve_device(device)
        for name, m in models.items():
            if m.device != self.device:
                raise ValueError(f"the {name} is on {m.device}, the "
                                 f"simulation on {self.device}")
        self.cfg = cfg
        # the memory plane samples this simulation's device
        M.MONITOR.attach(self.device, cfg.fed.mem_headroom_warn)
        self.task = make_task(data.task)
        self.arrays, self.batch_size = arrays_and_batch(data, cfg.data,
                                                        self.device)
        self.max_n = self.arrays.max_client_samples
        self.steps_per_epoch = self.max_n // self.batch_size
        self.graphed = self.device.type == "cuda"
        self._host_mask = self.arrays.mask.cpu()
        self._host_counts = self.arrays.counts.cpu().numpy()
        self.sampler = sampler or self._sample
        self.batch_orders = batch_orders or self._orders
        self.draws = draws or R.DeviceDraws(streams, self.device, high=high,
                                            p=p)
        self.counters: dict[str, float] = {}
        self.last_groups: list[tuple[int, int]] = []

    def _sample(self, round_idx, num_clients, clients_per_round):
        return R.sample_clients(R.generator(self.cfg.seed, round_idx),
                                num_clients, clients_per_round)

    def _orders(self, round_idx, client, phase: str = "local",
                epochs: int | None = None):
        salt = () if phase == "local" else (self.PHASES[phase],)
        gen = R.generator(self.cfg.seed, round_idx, client, *salt)
        return [R.padded_perm(gen, self._host_mask[client], self.max_n)
                for _ in range(epochs or self.cfg.train.epochs)]

    def _ids(self, host_ids: Sequence[int]) -> torch.Tensor:
        return to_device(torch.as_tensor(np.asarray(host_ids, np.int64)),
                         self.device)

    def _cohort(self, round_idx: int) -> np.ndarray:
        return np.asarray(torch.as_tensor(self.sampler(
            round_idx, self.arrays.num_clients,
            self.cfg.fed.clients_per_round)).tolist(), np.int64)

    def _rows(self, ids_g: torch.Tensor):
        a = self.arrays
        return a.idx.index_select(0, ids_g), a.mask.index_select(0, ids_g)

    def _site_masks(self, stream: str, round_idx: int, slots,
                    sites: Mapping[str, tuple], lead: tuple) -> dict | None:
        """``stream``'s dropout masks for ``slots`` (host ids) at
        ``sites``, ``{site: [len(slots), *lead, B, *site_shape]}``; None
        without sites."""
        if not sites:
            return None
        return self.draws(stream, round_idx, [int(c) for c in slots],
                          R.mask_shapes(sites, lead, self.batch_size))
