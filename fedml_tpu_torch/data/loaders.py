"""Offline federated dataset loaders.

The procedural datasets (``fake_<image>`` with the shapes and class
counts of ``IMAGE_SPECS``, the fake text sets, and LEAF's
``synthetic(alpha, beta)``) draw from numpy ``default_rng`` in the same
order as the JAX package's loaders, so the arrays and the partitions are
bitwise equal.
"""

from __future__ import annotations

import numpy as np

from fedml_tpu_torch.config import DataConfig
from fedml_tpu_torch.data.federated import (
    FederatedData,
    build_federated_data,
)

# name -> (input_shape, num_classes) for image datasets (NHWC)
IMAGE_SPECS: dict[str, tuple[tuple[int, ...], int]] = {
    "mnist": ((28, 28, 1), 10),
    "emnist": ((28, 28, 1), 62),
    "femnist": ((28, 28, 1), 62),
    "cifar10": ((32, 32, 3), 10),
    "cifar100": ((32, 32, 3), 100),
    "cinic10": ((32, 32, 3), 10),
    "fed_cifar100": ((32, 32, 3), 100),
}
SHAKESPEARE_SEQ_LEN = 80  # char-LM window of the Shakespeare task
SHAKESPEARE_VOCAB = 90
STACKOVERFLOW_SEQ_LEN = 20


def make_synthetic(
    num_clients: int,
    alpha: float = 1.0,
    beta: float = 1.0,
    dim: int = 60,
    num_classes: int = 10,
    samples_low: int = 50,
    samples_high: int = 500,
    seed: int = 0,
) -> FederatedData:
    """LEAF/FedProx ``synthetic(alpha, beta)``: per client a logistic
    model ``y = argmax(W_k x + b_k)``, ``W_k ~ N(u_k, 1)``, ``u_k ~ N(0,
    alpha)``, ``x ~ N(v_k, Sigma)``, ``v_k ~ N(B_k, 1)``, ``B_k ~ N(0,
    beta)``: non-IID in model and features. Each client keeps 90% of its
    samples for training and the rest for test."""
    rng = np.random.default_rng(seed)
    sizes = np.minimum(
        rng.lognormal(4.0, 2.0, num_clients).astype(int) + samples_low,
        samples_high,
    )
    sigma = np.diag(np.arange(1, dim + 1, dtype=np.float64) ** -1.2)
    xs, ys, train_map, test_map = [], [], {}, {}
    off = 0
    for k in range(num_clients):
        u_k = rng.normal(0, alpha)
        b_center = rng.normal(0, beta)
        w = rng.normal(u_k, 1.0, (dim, num_classes))
        b = rng.normal(u_k, 1.0, num_classes)
        v_k = rng.normal(b_center, 1.0, dim)
        n = int(sizes[k])
        x = rng.multivariate_normal(v_k, sigma, n).astype(np.float32)
        xs.append(x)
        ys.append((x @ w + b).argmax(-1).astype(np.int32))
        n_train = max(1, int(0.9 * n))
        train_map[k] = np.arange(off, off + n_train)
        test_map[k] = np.arange(off + n_train, off + n)
        off += n
    x_all = np.concatenate(xs)
    y_all = np.concatenate(ys)
    # train and test share the flat arrays; the test maps are re-based
    # onto the test arrays
    test_idx = np.concatenate([test_map[k] for k in range(num_clients)])
    remap = {int(g): i for i, g in enumerate(test_idx)}
    test_map = {k: np.array([remap[int(g)] for g in v], np.int64)
                for k, v in test_map.items()}
    return FederatedData(x_all, y_all, x_all[test_idx], y_all[test_idx],
                         train_map, test_map, num_classes)


def _fake_image_arrays(
    name: str, n_train: int, n_test: int, seed: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Gaussian class prototypes plus noise: a learnable stand-in with the
    named dataset's shape and class count."""
    shape, num_classes = IMAGE_SPECS[name]
    rng = np.random.default_rng(seed)
    protos = rng.normal(0.0, 1.0, (num_classes,) + shape).astype(np.float32)

    def gen(n):
        y = rng.integers(0, num_classes, n).astype(np.int32)
        x = protos[y] * 0.5 + rng.normal(0, 1.0, (n,) + shape).astype(np.float32)
        return x.astype(np.float32), y

    x_tr, y_tr = gen(n_train)
    x_te, y_te = gen(n_test)
    return x_tr, y_tr, x_te, y_te, num_classes


def make_fake_image_dataset(
    name: str, cfg: DataConfig, n_train: int = 6000, n_test: int = 1000
) -> FederatedData:
    x_tr, y_tr, x_te, y_te, num_classes = _fake_image_arrays(
        name, n_train, n_test, cfg.seed
    )
    return build_federated_data(
        x_tr, y_tr, x_te, y_te, num_classes, cfg.num_clients,
        cfg.partition_method, cfg.partition_alpha, cfg.dataset_r, cfg.seed,
    )


def make_fake_text_dataset(
    cfg: DataConfig,
    seq_len: int = SHAKESPEARE_SEQ_LEN,
    vocab: int = SHAKESPEARE_VOCAB,
    n_train: int = 4000,
    n_test: int = 500,
) -> FederatedData:
    """Markov-chain token sequences for next-word/char prediction (a
    learnable stand-in for shakespeare / stackoverflow_nwp)."""
    rng = np.random.default_rng(cfg.seed)
    # sparse markov transition: each token has 8 likely successors
    succ = rng.integers(0, vocab, (vocab, 8))

    def gen(n):
        seq = np.zeros((n, seq_len + 1), np.int32)
        seq[:, 0] = rng.integers(0, vocab, n)
        for t in range(seq_len):
            choice = succ[seq[:, t], rng.integers(0, 8, n)]
            noise = rng.integers(0, vocab, n)
            take_noise = rng.random(n) < 0.1
            seq[:, t + 1] = np.where(take_noise, noise, choice)
        return seq[:, :-1], seq[:, 1:]

    x_tr, y_tr = gen(n_train)
    x_te, y_te = gen(n_test)
    # homogeneous split over sequence index (labels are sequences)
    rng2 = np.random.default_rng(cfg.seed + 1)
    perm = rng2.permutation(n_train)
    train_map = {
        i: s for i, s in enumerate(np.array_split(perm, cfg.num_clients))
    }
    test_map = {
        i: s
        for i, s in enumerate(
            np.array_split(np.arange(n_test), cfg.num_clients)
        )
    }
    return FederatedData(
        x_tr, y_tr, x_te, y_te, train_map, test_map, vocab, task="nwp"
    )


def load_dataset(cfg: DataConfig) -> FederatedData:
    """Dataset dispatch. Only the offline datasets are ported:
    ``synthetic``, ``synthetic_<alpha>_<beta>`` and the ``fake_<name>``
    sets of the image (``IMAGE_SPECS``) and text paths; any other name
    raises."""
    name = cfg.dataset.lower()
    if name.startswith("synthetic") and name != "synthetic_stackoverflow_nwp":
        # "synthetic", "synthetic_1_1", "synthetic_0.5_0.5", ...
        parts = name.split("_")
        a = float(parts[1]) if len(parts) > 1 else 1.0
        b = float(parts[2]) if len(parts) > 2 else 1.0
        return make_synthetic(cfg.num_clients, a, b, seed=cfg.seed)
    base = name[len("fake_"):] if name.startswith("fake_") else None
    if base in IMAGE_SPECS:
        return make_fake_image_dataset(base, cfg)
    if base in ("shakespeare", "fed_shakespeare"):
        return make_fake_text_dataset(cfg)
    if base == "stackoverflow_nwp":
        return make_fake_text_dataset(
            cfg, seq_len=STACKOVERFLOW_SEQ_LEN, vocab=2000
        )
    raise ValueError(
        f"dataset {cfg.dataset!r} is not ported to fedml_tpu_torch yet "
        f"(available: synthetic[_<alpha>_<beta>], "
        f"fake_<{'|'.join(IMAGE_SPECS)}>, fake_shakespeare, "
        "fake_stackoverflow_nwp)"
    )
