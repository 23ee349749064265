"""Parameter-tree math for federated aggregation.

A tree here is a flat ``dict`` from parameter name to tensor (a
``state_dict``); a stacked tree has a leading client axis on every tensor.
:func:`tree_map` also walks nested dicts, tuples and lists (a local
step's carry, a cohort's lane arguments).
"""

from __future__ import annotations

import math

import torch

Tree = dict[str, torch.Tensor]


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over ``tree`` and the trees ``rest`` of
    the same structure (nested dicts, tuples, NamedTuples and lists of
    tensors)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        mapped = [tree_map(fn, *leaves) for leaves in zip(tree, *rest)]
        # a NamedTuple takes its fields as arguments
        return (type(tree)(*mapped) if hasattr(tree, "_fields")
                else type(tree)(mapped))
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


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or in its own type where that is wider (float64:
    a reference computed in float64 stays float64)."""
    return x if x.dtype == torch.float64 else x.float()


def tree_l2_norm(tree: Tree) -> torch.Tensor:
    """The L2 norm over every leaf, in float32 (float64 leaves: float64)."""
    sq = [torch.sum(torch.square(wide(v))) for v in tree.values()]
    return torch.sqrt(sum(sq)) if sq else torch.zeros(())


def tree_vectorize(tree: Tree) -> torch.Tensor:
    """Every leaf flattened into one vector, in the tree's key order."""
    if not tree:
        return torch.zeros((0,))
    return torch.cat([v.reshape(-1) for v in tree.values()])


def tree_unvectorize(vec: torch.Tensor, like: Tree) -> Tree:
    """The inverse of :func:`tree_vectorize`, shaped and typed by
    ``like``."""
    out, off = {}, 0
    for k, v in like.items():
        out[k] = vec[off:off + v.numel()].reshape(v.shape).to(v.dtype)
        off += v.numel()
    return out


def bcast_rows(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-client ``[C]`` ``v`` shaped to broadcast over the stacked
    leaf ``x`` (``[C, ...]``)."""
    return v.reshape((-1,) + (1,) * (x.ndim - 1))


def rows(x: torch.Tensor) -> torch.Tensor:
    """A stacked leaf ``[C, ...]`` as ``[C, n]`` (also for ``n = 0``)."""
    return x.reshape(x.shape[0], math.prod(x.shape[1:]))


def tree_weighted_sum(stacked: Tree, weights: torch.Tensor) -> Tree:
    """Weighted sum over the leading (client) axis, in float32 (float64
    leaves: float64)."""

    def leaf_sum(x):
        wb = wide(weights.reshape((-1,) + (1,) * (x.ndim - 1)))
        return torch.sum(wide(x) * wb, dim=0)

    return {k: leaf_sum(v) for k, v in stacked.items()}


def tree_weighted_mean(stacked: Tree, weights: torch.Tensor) -> Tree:
    """Weighted mean over the leading (client) axis: the FedAvg
    aggregation, with ``weights`` the clients' sample counts."""
    w = weights / torch.clamp(torch.sum(weights), min=1e-12)
    sums = tree_weighted_sum(stacked, w)
    return {k: sums[k].to(v.dtype) for k, v in stacked.items()}
