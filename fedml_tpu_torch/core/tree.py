"""Parameter-tree math for federated aggregation.

A tree here is a flat ``dict`` from parameter name to tensor (a
``state_dict``); a stacked tree has a leading client axis on every tensor.
:func:`tree_map` also walks nested dicts, tuples and lists (a local
step's carry, a cohort's lane arguments).
"""

from __future__ import annotations

import torch

Tree = dict[str, torch.Tensor]


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over ``tree`` and the trees ``rest`` of
    the same structure (nested dicts, tuples and lists of tensors)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *leaves)
                          for leaves in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a tree :func:`tree_map` walks, in its order."""
    out = []
    tree_map(out.append, tree)
    return out


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
