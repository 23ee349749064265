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
from fedml_tpu_torch.data import partition as P


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


def _infer_input_dtype(x: np.ndarray) -> torch.dtype:
    """Token datasets (NLP) stay integer for the embedding; dense features
    (images included, NHWC) go to float32, as in the JAX package."""
    return (
        torch.int32 if np.issubdtype(np.asarray(x).dtype, np.integer)
        else torch.float32
    )


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
    # "classification" | "nwp" | "tag_prediction" | "segmentation"
    task: str = "classification"

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
        x_dtype = _infer_input_dtype(self.x_train)

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


def build_federated_data(
    x_train: np.ndarray,
    y_train: np.ndarray,
    x_test: np.ndarray,
    y_test: np.ndarray,
    num_classes: int,
    num_clients: int,
    partition_method: str = "homo",
    alpha: float = 0.5,
    r: float = 1.0,
    seed: int = 0,
    task: str = "classification",
) -> FederatedData:
    """Partition global arrays into a :class:`FederatedData` (the loader
    core shared by the image datasets): the train split by
    ``partition_method`` from ``default_rng(seed)``, the test split per
    label, both as in the JAX package."""
    rng = np.random.default_rng(seed)
    if partition_method == "natural":
        raise ValueError("natural partitions are built by dataset loaders")
    label_y = y_train if y_train.ndim == 1 else y_train.argmax(-1)
    train_map = P.partition_indices_train(
        label_y, num_classes, partition_method, num_clients, alpha, r, rng
    )
    label_yt = y_test if y_test.ndim == 1 else y_test.argmax(-1)
    test_map = P.partition_indices_test(label_yt, num_classes, num_clients)
    return FederatedData(
        x_train, y_train, x_test, y_test, train_map, test_map, num_classes, task
    )
