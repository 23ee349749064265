"""Parameter-tree math for federated aggregation.

A tree here is a flat ``dict`` from parameter name to tensor (a
``state_dict``); a stacked tree has a leading client axis on every tensor.
"""

from __future__ import annotations

import torch

Tree = dict[str, torch.Tensor]


def tree_zeros_like(tree: Tree) -> Tree:
    return {k: torch.zeros_like(v) for k, v in tree.items()}


def tree_add(a: Tree, b: Tree) -> Tree:
    return {k: a[k] + b[k] for k in a}


def tree_sub(a: Tree, b: Tree) -> Tree:
    return {k: a[k] - b[k] for k in a}


def tree_scale(tree: Tree, s) -> Tree:
    return {k: v * s for k, v in tree.items()}


def tree_dot(a: Tree, b: Tree) -> torch.Tensor:
    return sum(torch.sum(a[k] * b[k]) for k in a)


def tree_stack(trees: list[Tree]) -> Tree:
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def tree_weighted_sum(stacked: Tree, weights: torch.Tensor) -> Tree:
    """Weighted sum over the leading (client) axis, in float32."""

    def leaf_sum(x):
        wb = weights.reshape((-1,) + (1,) * (x.ndim - 1)).float()
        return torch.sum(x.float() * wb, dim=0)

    return {k: leaf_sum(v) for k, v in stacked.items()}


def tree_weighted_mean(stacked: Tree, weights: torch.Tensor) -> Tree:
    """Weighted mean over the leading (client) axis: the FedAvg
    aggregation, with ``weights`` the clients' sample counts."""
    w = weights / torch.clamp(torch.sum(weights), min=1e-12)
    sums = tree_weighted_sum(stacked, w)
    return {k: sums[k].to(v.dtype) for k, v in stacked.items()}
