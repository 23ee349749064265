"""Offline federated dataset loaders.

The procedural text datasets draw from numpy ``default_rng`` in the same
order as the JAX package's loaders, so the arrays are bitwise equal.
"""

from __future__ import annotations

import numpy as np

from fedml_tpu_torch.config import DataConfig
from fedml_tpu_torch.data.federated import FederatedData

SHAKESPEARE_SEQ_LEN = 80  # char-LM window of the Shakespeare task
SHAKESPEARE_VOCAB = 90
STACKOVERFLOW_SEQ_LEN = 20


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
    """Dataset dispatch. Only the offline text datasets of the transformer
    FedAvg path are ported; any other name raises."""
    name = cfg.dataset.lower()
    if name in ("fake_shakespeare", "fake_fed_shakespeare"):
        return make_fake_text_dataset(cfg)
    if name == "fake_stackoverflow_nwp":
        return make_fake_text_dataset(
            cfg, seq_len=STACKOVERFLOW_SEQ_LEN, vocab=2000
        )
    raise ValueError(
        f"dataset {cfg.dataset!r} is not ported to fedml_tpu_torch yet "
        "(available: fake_shakespeare, fake_stackoverflow_nwp)"
    )
