"""Multi-tier aggregator topology: the spec and the partial payload
(``fedml_tpu.core.tier``).

A root aggregator serves ``L`` leaf aggregators (``--tier_spec
root:L``). Each leaf is rank 0 of its own deployment world, terminating
its clients' transports, and a member rank of the root world
``{0: root, 1..L: leaves}``. Each tier keeps its own membership ledger,
liveness monitor and reputation plane, so churn, crashes and quarantine
stay inside the tier.

A leaf forwards one typed partial upstream a flush: ``[sum, n, count]``,
the weighted delta sum over its included (screened, clipped,
non-quarantined) client results, their sample mass and how many results
it folds. ``sum / n`` is the leaf's weighted-mean delta, so a root that
folds one row a leaf with weight ``n`` through the unchanged
``server_update`` computes the flat world's weighted mean over every
client: the tree changes where reduction happens, not what is computed.

The root screens each partial at its receive edge
(:func:`validate_partial`) as the server screens compressed payloads
(structure, shapes, types, finiteness), so a malformed or poisoned
partial is counted and dropped, never folded. The error strings are the
JAX package's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from fedml_tpu_torch.core.message import to_host

#: payload keys of MSG_TYPE_L2R_PARTIAL (core/message.py)
KEY_TIER_SUM = "tier_sum"
KEY_TIER_COUNT = "tier_count"


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """A parsed ``--tier_spec``: ``root:<L>``, one root and ``L`` leaf
    aggregators."""

    n_leaves: int

    def __post_init__(self):
        if self.n_leaves < 1:
            raise ValueError(
                f"tier_spec needs >= 1 leaf, got {self.n_leaves}")

    @staticmethod
    def parse(spec: str) -> "TierSpec":
        head, sep, leaves = spec.partition(":")
        if head != "root" or not sep or not leaves.isdigit():
            raise ValueError(
                f"--tier_spec expects 'root:<n_leaves>' (e.g. root:2), "
                f"got {spec!r}")
        return TierSpec(n_leaves=int(leaves))

    @property
    def root_world_size(self) -> int:
        """The root world: rank 0 the root, ranks 1..L the leaves."""
        return self.n_leaves + 1

    def leaf_ranks(self) -> list[int]:
        return list(range(1, self.n_leaves + 1))

    def client_base(self, leaf_rank: int, leaf_clients: int) -> int:
        """The global client id of a leaf's slot 0 without
        ``--tier_client_base``: equal leaves take contiguous blocks, so
        sibling leaves never train the same shard."""
        if not 1 <= leaf_rank <= self.n_leaves:
            raise ValueError(
                f"leaf rank {leaf_rank} outside 1..{self.n_leaves}")
        return (leaf_rank - 1) * leaf_clients


def build_partial(sum_tree: dict, n_total: float, count: int) -> dict:
    """The leaf-to-root payload: the sum on the host (one pinned copy a
    dtype) and the count; the mass rides ``KEY_NUM_SAMPLES``."""
    return {KEY_TIER_SUM: to_host(dict(sum_tree)),
            KEY_TIER_COUNT: int(count)}


def _as_array(leaf):
    """A payload leaf as numpy, a bf16 tensor as it is."""
    if isinstance(leaf, torch.Tensor):
        return leaf if leaf.dtype == torch.bfloat16 else \
            leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def validate_partial(template_vars: dict, payload, n_total: float
                     ) -> str | None:
    """The root's receive-edge screen for one partial: an error string
    (the caller counts ``tier.partial_rejected`` and drops it) or None
    when it may be folded. One NaN leaf would poison the whole root
    aggregate, so every leaf is checked."""
    if not isinstance(payload, dict) or KEY_TIER_SUM not in payload:
        return "missing tier_sum"
    count = payload.get(KEY_TIER_COUNT)
    if not isinstance(count, int) or count < 1:
        return f"bad tier_count {count!r}"
    if not (isinstance(n_total, (int, float)) and math.isfinite(n_total)
            and n_total > 0):
        return f"bad sample mass {n_total!r}"
    psum = payload[KEY_TIER_SUM]
    try:
        keys = sorted(psum) if isinstance(psum, dict) else None
    except Exception as err:  # keys that do not order, from a hostile peer
        return f"unflattenable partial: {err}"
    if keys != sorted(template_vars) or any(
            v is None or isinstance(v, (dict, list, tuple))
            for v in psum.values()):
        return "partial tree structure != model template"
    for k in keys:
        a, want = _as_array(psum[k]), tuple(template_vars[k].shape)
        if tuple(a.shape) != want:
            return f"leaf shape {tuple(a.shape)} != template {want}"
        if isinstance(a, torch.Tensor):
            if not bool(torch.isfinite(a).all()):
                return "non-finite partial leaf"
            continue
        if not np.issubdtype(a.dtype, np.floating):
            return f"non-float partial leaf dtype {a.dtype}"
        if not np.all(np.isfinite(a)):
            return "non-finite partial leaf"
    return None
