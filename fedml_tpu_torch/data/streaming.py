"""Streaming data for decentralized online learning (DOL)
(``fedml_tpu.data.streaming``, a numpy copy; the streams are bit for bit
the JAX package's).

Each client gets a stream of ``T`` (x, y) samples, one consumed an
iteration. A ``beta`` fraction of the stream is adversarial (samples
clustered by k-means and dealt out a cluster a client, so clients drift
apart); the rest is stochastic (a shared shuffled pool).
:func:`load_uci_stream` reads the UCI files (``SUSY.csv``, the room
occupancy ``datatraining.txt``) under a data directory;
:func:`make_susy_like_stream` is the procedural SUSY-shaped stream.
"""

from __future__ import annotations

import csv
import os

import numpy as np


def _kmeans(x: np.ndarray, k: int, iters: int = 20, seed: int = 0):
    """A small numpy k-means; the distances in row chunks, by the
    expansion ``|x - c|^2 = |x|^2 - 2 x.c + |c|^2`` (one product a
    chunk)."""
    rng = np.random.default_rng(seed)
    centers = x[rng.choice(len(x), k, replace=False)]
    assign = np.zeros(len(x), np.int64)
    chunk = max(1, 2_000_000 // max(k, 1))
    for _ in range(iters):
        c_sq = (centers**2).sum(-1)
        new_assign = np.empty(len(x), np.int64)
        for lo in range(0, len(x), chunk):
            xb = x[lo:lo + chunk]
            d = (xb**2).sum(-1, keepdims=True) - 2.0 * (xb @ centers.T)
            new_assign[lo:lo + chunk] = (d + c_sq).argmin(1)
        if (new_assign == assign).all():
            break
        assign = new_assign
        for c in range(k):
            pts = x[assign == c]
            if len(pts):
                centers[c] = pts.mean(0)
    return assign


def split_stream(
    x: np.ndarray,
    y: np.ndarray,
    n_clients: int,
    iterations: int,
    beta: float = 0.0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """A global sample stream dealt into per-client streams ``([N, T, d],
    [N, T])``: the first ``beta`` fraction adversarially (k-means cluster
    ``i`` to client ``i``), the rest from a shuffled pool; samples recycle
    if the stream is short."""
    rng = np.random.default_rng(seed)
    need = n_clients * iterations
    if len(x) < need:
        reps = -(-need // len(x))
        x, y = np.tile(x, (reps, 1))[:need], np.tile(y, reps)[:need]
    t_adv = int(beta * iterations)
    xs = np.zeros((n_clients, iterations) + x.shape[1:], np.float32)
    ys = np.zeros((n_clients, iterations), np.float32)
    if t_adv > 0:
        n_adv = n_clients * t_adv
        xa, ya = x[:n_adv], y[:n_adv]
        assign = _kmeans(xa, n_clients, seed=seed)
        for c in range(n_clients):
            rows = np.where(assign == c)[0]
            if len(rows) == 0:
                rows = rng.choice(n_adv, t_adv)
            take = np.resize(rows, t_adv)
            xs[c, :t_adv] = xa[take]
            ys[c, :t_adv] = ya[take]
    rest = rng.permutation(np.arange(n_clients * t_adv, len(x)))
    need_rest = n_clients * (iterations - t_adv)
    take = np.resize(rest, need_rest).reshape(n_clients, -1)
    for c in range(n_clients):
        xs[c, t_adv:] = x[take[c]]
        ys[c, t_adv:] = y[take[c]]
    return xs, ys


def load_susy_csv(path: str, limit: int | None = None):
    """``SUSY.csv``: the label first, then 18 features a row."""
    xs, ys = [], []
    with open(path) as f:
        for i, row in enumerate(csv.reader(f)):
            if limit is not None and i >= limit:
                break
            ys.append(float(row[0]))
            xs.append([float(v) for v in row[1:19]])
    return np.asarray(xs, np.float32), np.asarray(ys, np.float32)


def load_room_occupancy_txt(path: str, limit: int | None = None):
    """UCI room occupancy's ``datatraining.txt``: a header, then
    ``id,date,Temperature,Humidity,Light,CO2,HumidityRatio,Occupancy``
    rows; 5 features and the binary label last."""
    xs, ys = [], []
    with open(path) as f:
        reader = csv.reader(f)
        next(reader)  # header
        for i, row in enumerate(reader):
            if limit is not None and i >= limit:
                break
            vals = row[-6:]  # 5 features + label
            xs.append([float(v) for v in vals[:5]])
            ys.append(float(vals[5]))
    return np.asarray(xs, np.float32), np.asarray(ys, np.float32)


def load_uci_stream(name: str, data_dir: str, n_clients: int,
                    iterations: int, beta: float = 0.0, seed: int = 0):
    """Per-client streams from the UCI files under ``data_dir``
    (``SUSY/SUSY.csv`` or ``SUSY.csv``; ``room_occupancy/datatraining.
    txt`` or ``datatraining.txt``), the first ``max(4 N T, 10000)`` rows,
    the features standardized; a missing file raises
    ``FileNotFoundError``."""
    name = name.upper()
    limit = max(4 * n_clients * iterations, 10000)
    if name == "SUSY":
        path = os.path.join(data_dir, "SUSY", "SUSY.csv")
        if not os.path.exists(path):
            path = os.path.join(data_dir, "SUSY.csv")
        x, y = load_susy_csv(path, limit)
    elif name == "RO":
        path = os.path.join(data_dir, "room_occupancy", "datatraining.txt")
        if not os.path.exists(path):
            path = os.path.join(data_dir, "datatraining.txt")
        x, y = load_room_occupancy_txt(path, limit)
    else:
        raise ValueError(f"unknown UCI stream: {name} (SUSY | RO)")
    # standardized features keep the logistic stream well-conditioned
    x = (x - x.mean(0)) / (x.std(0) + 1e-8)
    return split_stream(x, y, n_clients, iterations, beta, seed)


def make_susy_like_stream(
    n_clients: int,
    iterations: int,
    input_dim: int = 18,
    beta: float = 0.0,
    drift: float = 0.3,
    seed: int = 0,
):
    """The procedural SUSY-shaped stream: a shared noisy linear concept
    with a drift of each client's features, so online learners see a
    falling regret and the beta clustering has structure."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(input_dim,))
    centers = rng.normal(size=(n_clients, input_dim)) * drift
    n = n_clients * iterations * 2
    x = rng.normal(size=(n, input_dim)).astype(np.float32)
    x += centers[rng.integers(0, n_clients, n)]
    logits = x @ w + rng.normal(scale=0.5, size=n)
    y = (logits > 0).astype(np.float32)
    return split_stream(x, y, n_clients, iterations, beta, seed)
