"""Partition engine: IID ("homo") and Dirichlet-LDA ("hetero") splits.

Re-implements the semantics of the reference's single partition engine
(``fedml_api/data_preprocessing/utils/partition.py:16-95``) and the core
LDA partitioner (``fedml_core/non_iid_partition/noniid_partition.py:6-92``):

- ``homo``: random permutation, near-equal contiguous splits.
- ``hetero``: per-class Dirichlet(alpha) proportions with the reference's
  balancing rule (a client already holding >= N/num_clients samples gets
  proportion 0 for further classes) and the min-size-10 retry loop.
- ``r`` subsample fraction (the fork's ``dataset_r``).
- test split: per-label equal division across clients
  (``partition.py:78-95``).

Runs host-side in numpy once at startup; the output index map is then frozen
into device tensors by :mod:`fedml_tpu_torch.data.federated`. A
copy of ``fedml_tpu.data.partition``, so that partitions are bitwise equal
without importing the JAX package.
"""

from __future__ import annotations

import numpy as np

MIN_PARTITION_SIZE = 10  # reference retry threshold (partition.py:49)


def partition_indices_train(
    y: np.ndarray,
    num_classes: int,
    partition: str,
    num_clients: int,
    alpha: float = 0.5,
    r: float = 1.0,
    rng: np.random.Generator | None = None,
    min_size: int = MIN_PARTITION_SIZE,
) -> dict[int, np.ndarray]:
    """Return {client_id: array of indices into y} (reference
    ``get_partition_indices_train``, ``partition.py:16-75``)."""
    rng = rng or np.random.default_rng(0)
    n_total = y.shape[0]
    n_use = int(n_total * r)
    indices_to_use = rng.choice(n_total, size=(n_use,), replace=False)

    if partition == "homo":
        splits = np.array_split(indices_to_use, num_clients)
        return {i: splits[i] for i in range(num_clients)}

    if partition != "hetero":
        raise ValueError(f"unknown partition method: {partition}")

    y_use = y[indices_to_use]
    target = n_use / num_clients
    while True:
        idx_batch: list[list[int]] = [[] for _ in range(num_clients)]
        for k in range(num_classes):
            idx_k = np.where(y_use == k)[0]
            if idx_k.size == 0:
                continue
            rng.shuffle(idx_k)
            props = rng.dirichlet(np.repeat(alpha, num_clients))
            # balancing rule: zero out clients that already reached the
            # IID-equal share (partition.py:57)
            props = np.array(
                [p * (len(b) < target) for p, b in zip(props, idx_batch)]
            )
            props = props / props.sum()
            cuts = (np.cumsum(props) * len(idx_k)).astype(int)[:-1]
            for b, part in zip(idx_batch, np.split(idx_k, cuts)):
                b.extend(part.tolist())
        if min(len(b) for b in idx_batch) >= min_size:
            break

    out = {}
    for j in range(num_clients):
        local = np.asarray(idx_batch[j], dtype=np.int64)
        rng.shuffle(local)
        out[j] = indices_to_use[local]
    return out


def partition_indices_test(
    y_test: np.ndarray, num_classes: int, num_clients: int
) -> dict[int, np.ndarray]:
    """Per-label equal split of the test set across clients (reference
    ``get_partition_indices_test``, ``partition.py:78-95``)."""
    label_indices = {
        k: np.where(y_test == k)[0] for k in range(num_classes)
    }
    out: dict[int, list[int]] = {i: [] for i in range(num_clients)}
    cursor = {k: 0 for k in range(num_classes)}
    for user in range(num_clients):
        for label in range(num_classes):
            per = len(label_indices[label]) // num_clients
            out[user].extend(
                label_indices[label][cursor[label] : cursor[label] + per].tolist()
            )
            cursor[label] += per
    return {u: np.asarray(v, dtype=np.int64) for u, v in out.items()}


def record_class_counts(
    y: np.ndarray, dataidx_map: dict[int, np.ndarray]
) -> dict[int, dict[int, int]]:
    """Per-client label histogram (reference ``record_net_data_stats``,
    ``partition.py:113-121``)."""
    out = {}
    for cid, idx in dataidx_map.items():
        unq, cnt = np.unique(y[idx], return_counts=True)
        out[cid] = {int(u): int(c) for u, c in zip(unq, cnt)}
    return out
