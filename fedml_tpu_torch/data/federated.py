"""Federated dataset containers.

The whole federated dataset lives on the device as flat tensors plus a
padded per-client index matrix, as in the JAX package:

- ``x``/``y``: the global training tensors, shape ``[N, ...]``.
- ``idx``: ``[num_clients, max_n]`` int32 indices into ``x``, padded with
  the client's own first sample; ``mask`` marks real samples; ``counts``
  are the true ``n_k`` used as FedAvg weights.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from fedml_tpu_torch.core.device import resolve_device


@dataclasses.dataclass
class FederatedArrays:
    """Device-resident federated dataset (all tensors on one device)."""

    x: torch.Tensor  # [N, ...] global train inputs
    y: torch.Tensor  # [N, ...] global train targets
    idx: torch.Tensor  # [num_clients, max_n] int32 into x/y
    mask: torch.Tensor  # [num_clients, max_n] float32 {0,1}
    counts: torch.Tensor  # [num_clients] int32 true n_k
    test_x: torch.Tensor  # [M, ...] global test inputs
    test_y: torch.Tensor  # [M, ...]
    test_idx: torch.Tensor  # [num_clients, max_test_n] int32 into test_x
    test_mask: torch.Tensor  # [num_clients, max_test_n] float32
    num_classes: int

    @property
    def num_clients(self) -> int:
        return self.idx.shape[0]

    @property
    def max_client_samples(self) -> int:
        return self.idx.shape[1]


def _round_up(n: int, multiple: int) -> int:
    n = max(1, n)
    if multiple > 1:
        n = ((n + multiple - 1) // multiple) * multiple
    return n


def _pad_index_map(
    idx_map: dict[int, np.ndarray], num_clients: int, pad_multiple: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    counts = np.array([len(idx_map[i]) for i in range(num_clients)], np.int32)
    max_n = _round_up(int(counts.max()), pad_multiple)
    idx = np.zeros((num_clients, max_n), np.int32)
    mask = np.zeros((num_clients, max_n), np.float32)
    for i in range(num_clients):
        n = counts[i]
        idx[i, :n] = idx_map[i]
        # pad with the client's own first sample: masked rows carry zero
        # weight, and self-padding keeps their content the same in every
        # data layout
        if n:
            idx[i, n:] = idx_map[i][0]
        mask[i, :n] = 1.0
    return idx, mask, counts


@dataclasses.dataclass
class FederatedData:
    """Host-side federated dataset: global numpy arrays + per-client index
    maps, converted to :class:`FederatedArrays` for the simulator."""

    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    train_idx_map: dict[int, np.ndarray]
    test_idx_map: dict[int, np.ndarray]
    num_classes: int
    task: str = "classification"  # "classification" | "nwp"

    @property
    def num_clients(self) -> int:
        return len(self.train_idx_map)

    def to_arrays(
        self, pad_multiple: int = 1, device: str | torch.device = "cuda"
    ) -> FederatedArrays:
        dev = resolve_device(device)
        idx, mask, counts = _pad_index_map(
            self.train_idx_map, self.num_clients, pad_multiple
        )
        tidx, tmask, _ = _pad_index_map(
            self.test_idx_map, self.num_clients, pad_multiple
        )
        # token inputs stay int32 (embedding ids); dense features go to
        # float32, as in the JAX package
        x_dtype = (
            torch.int32 if np.issubdtype(self.x_train.dtype, np.integer)
            else torch.float32
        )

        def conv(a, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=dev, dtype=dtype
            )

        return FederatedArrays(
            x=conv(self.x_train, x_dtype),
            y=conv(self.y_train),
            idx=conv(idx),
            mask=conv(mask),
            counts=conv(counts),
            test_x=conv(self.x_test, x_dtype),
            test_y=conv(self.y_test),
            test_idx=conv(tidx),
            test_mask=conv(tmask),
            num_classes=self.num_classes,
        )


def arrays_and_batch(
    data: FederatedData, dcfg, device: str | torch.device = "cuda"
) -> tuple[FederatedArrays, int]:
    """Resolve the (arrays, client batch size) pair from a DataConfig,
    honoring full-batch mode (one batch per client)."""
    pad = 1 if dcfg.full_batch else dcfg.batch_size
    arrays = data.to_arrays(pad_multiple=pad, device=device)
    max_n = arrays.max_client_samples
    batch = max_n if dcfg.full_batch else min(dcfg.batch_size, max_n)
    return arrays, batch
