"""Topology managers for decentralized FL (``fedml_tpu.core.topology``,
a numpy copy; the matrices are bit for bit the JAX package's).

A ring with ``neighbor_num`` nearest neighbours and optional seeded extra
links, exported as a dense row-stochastic ``[N, N]`` mixing matrix: a
gossip round is one ``[N, N] x [N, P]`` product over the stacked client
models instead of one message a neighbour.
"""

from __future__ import annotations

import numpy as np


class SymmetricTopologyManager:
    """Undirected ring with ``neighbor_num`` nearest neighbours plus
    ``extra_links`` seeded random links; equal weights over a node's
    neighbours and itself (the rows of the symmetrized adjacency,
    normalized)."""

    def __init__(self, n: int, neighbor_num: int = 2, extra_links: int = 0,
                 seed: int = 0):
        self.n = n
        self.neighbor_num = min(neighbor_num, n - 1)
        self.extra_links = extra_links
        self.seed = seed
        self.topology = self._generate()

    def _generate(self) -> np.ndarray:
        n, k = self.n, self.neighbor_num
        adj = np.eye(n, dtype=np.float64)
        for i in range(n):
            for d in range(1, k // 2 + 1):
                adj[i, (i + d) % n] = 1.0
                adj[i, (i - d) % n] = 1.0
        rng = np.random.default_rng(self.seed)
        for _ in range(self.extra_links):
            i, j = rng.integers(0, n, 2)
            if i != j:
                adj[i, j] = adj[j, i] = 1.0
        adj = np.maximum(adj, adj.T)
        return adj / adj.sum(axis=1, keepdims=True)

    def get_in_neighbor_idx_list(self, node: int) -> list[int]:
        return [j for j in range(self.n)
                if self.topology[j, node] > 0 and j != node]

    def get_out_neighbor_idx_list(self, node: int) -> list[int]:
        return [j for j in range(self.n)
                if self.topology[node, j] > 0 and j != node]

    def get_in_neighbor_weights(self, node: int) -> np.ndarray:
        return self.topology[:, node]

    def get_out_neighbor_weights(self, node: int) -> np.ndarray:
        return self.topology[node]

    def mixing_matrix(self) -> np.ndarray:
        """The dense row-stochastic ``[N, N]`` matrix ``W``: a gossip round
        is ``stacked' = W @ stacked``."""
        return self.topology


class AsymmetricTopologyManager(SymmetricTopologyManager):
    """Directed variant: each node drops ``out_drop`` of its out-links,
    drawn from ``default_rng(seed + 1)``, so in- and out-neighbourhoods
    differ."""

    def __init__(self, n: int, neighbor_num: int = 4, out_drop: int = 1,
                 seed: int = 0):
        self.out_drop = out_drop
        super().__init__(n, neighbor_num, 0, seed)

    def _generate(self) -> np.ndarray:
        base = super()._generate()
        rng = np.random.default_rng(self.seed + 1)
        adj = (base > 0).astype(np.float64)
        for i in range(self.n):
            outs = [j for j in range(self.n) if adj[i, j] > 0 and j != i]
            rng.shuffle(outs)
            for j in outs[: self.out_drop]:
                adj[i, j] = 0.0
        return adj / adj.sum(axis=1, keepdims=True)
