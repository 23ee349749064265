"""Seeded stand-ins for the natural federated datasets (the JAX package's
``fedml_tpu/data/natural.py``, its offline part). Numpy only, drawn in
the JAX package's order, so the arrays and the client maps are bit for
bit the JAX package's."""

from __future__ import annotations

import numpy as np

from fedml_tpu_torch.data.federated import FederatedData


def _natural_maps(client_arrays):
    """Per-client ``(x, y)`` arrays concatenated into global arrays, with
    each client's index map into them."""
    xs, ys, idx_map = [], [], {}
    offset = 0
    for i, (x, y) in enumerate(client_arrays):
        xs.append(x)
        ys.append(y)
        idx_map[i] = np.arange(offset, offset + len(x))
        offset += len(x)
    return np.concatenate(xs), np.concatenate(ys), idx_map


def synthetic_stackoverflow_nwp(
    num_clients: int = 64,
    vocab_size: int = 10000,
    seq_len: int = 20,
    seed: int = 0,
    sentences_low: int = 16,
    sentences_high: int = 96,
) -> FederatedData:
    """A seeded StackOverflow-shaped next-word-prediction set: the
    ``[B, T]`` int32 contract of the TFF StackOverflow split without its
    download. Ids: 0 pad, 1..V words, V+1 bos, V+2 eos, V+3 oov; every
    sequence starts at bos, a short sentence closes with eos then pad;
    ``x = tokens[:, :-1]``, ``y = tokens[:, 1:]``.

    The text is a sparse Markov chain over a Zipf-weighted vocabulary
    with a successor bias of each client's own, so the stream is
    learnable and non-IID across clients; client sizes are seeded and
    uneven. Each client keeps ``max(2, n // 10)`` more sentences as its
    test split."""
    rng = np.random.default_rng(seed)
    V = vocab_size
    bos, eos, oov = V + 1, V + 2, V + 3
    # a Zipf-like unigram table and a sparse successor table: each word
    # has 8 likely successors, and a client draws a quarter of its
    # continuations from its own 32-word pool
    ranks = np.arange(1, V + 1, dtype=np.float64)
    unigram = (ranks ** -1.1) / np.sum(ranks ** -1.1)
    succ = rng.integers(1, V + 1, (V, 8))

    def client_sentences(crng, n):
        bias = crng.integers(1, V + 1, 32)
        out = np.zeros((n, seq_len + 1), np.int32)
        out[:, 0] = bos
        lengths = crng.integers(seq_len // 2, seq_len + 1, n)
        word = crng.choice(V, size=n, p=unigram).astype(np.int64) + 1
        for t in range(seq_len):
            live = t < lengths
            nxt = succ[word - 1, crng.integers(0, 8, n)]
            take_bias = crng.random(n) < 0.25
            nxt = np.where(take_bias, bias[crng.integers(0, 32, n)], nxt)
            nxt = np.where(crng.random(n) < 0.02, oov, nxt)
            out[:, t + 1] = np.where(live, nxt, 0)
            # the chain walks words only: an oov leaves it at the last word
            word = np.where(live & (nxt <= V), nxt, word)
        short = lengths < seq_len
        out[np.arange(n)[short], lengths[short] + 1] = eos
        return out

    train, test = [], []
    for c in range(num_clients):
        crng = np.random.default_rng((seed, c))
        n = int(crng.integers(sentences_low, sentences_high + 1))
        seqs = client_sentences(crng, n + max(2, n // 10))
        tr, te = seqs[:n], seqs[n:]
        train.append((tr[:, :-1], tr[:, 1:]))
        test.append((te[:, :-1], te[:, 1:]))
    x_tr, y_tr, tr_map = _natural_maps(train)
    x_te, y_te, te_map = _natural_maps(test)
    return FederatedData(x_tr, y_tr, x_te, y_te, tr_map, te_map, V + 4,
                         "nwp")
