"""Byzantine adversary injection: seeded malicious deltas, the JAX
package's ``core/adversary.py`` on flat ``{name: tensor}`` trees.

Attack modes (``d`` the honest delta ``new_params - global_params``):

- **sign_flip**: ``-scale * d``;
- **scale_boost**: ``scale * d``;
- **gauss**: ``d + noise_stddev * N(0, 1)``, drawn per (round, client id);
- **zero**: ``0``;
- **constant**: ``scale`` in every coordinate;
- **collude**: every adversary sends the same seeded gaussian delta of
  L2 norm ``scale``, drawn per round.

Which clients attack is :class:`~fedml_tpu_torch.config.AdversaryPolicy`
(``member_ids``). The functions are pure: the gaussian draws come from
the caller, through ``draw(stream, slots, shapes) -> {name: [len(slots),
*shape]}`` with the stream ``"gauss"`` keyed by client id and
``"collude"`` at slot 0 (a :data:`fedml_tpu_torch.core.random.Draws`
bound to the round).
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from fedml_tpu_torch.config import ADVERSARY_MODES as MODES
from fedml_tpu_torch.config import AdversaryPolicy
from fedml_tpu_torch.core import tree as T

Tree = dict[str, torch.Tensor]
Draw = Callable[[str, Sequence[int], Mapping[str, tuple]], Tree]

__all__ = ["MODES", "AdversaryPolicy", "cohort_mask", "collusion_delta",
           "corrupt_client_vars", "corrupt_stacked_deltas"]


def _shapes(tree: Tree, lead: int = 0) -> dict[str, tuple]:
    return {k: tuple(v.shape[lead:]) for k, v in tree.items()}


def collusion_delta(policy: AdversaryPolicy, like: Tree, raw: Tree) -> Tree:
    """The colluders' shared delta: the standard normal draws ``raw``
    (shaped like one client's delta ``like``) scaled to a global L2 norm
    of ``policy.scale``, in ``like``'s types."""
    s = policy.scale / torch.clamp(T.tree_l2_norm(raw), min=1e-12)
    return {k: (raw[k].float() * s).to(v.dtype) for k, v in like.items()}


def _attack_one(policy: AdversaryPolicy, delta: Tree,
                normals: Tree | None = None) -> Tree:
    """``policy.mode`` applied to ``delta`` (one client's, or a stack of
    them: every mode but collude is elementwise); ``normals`` are gauss's
    standard normal draws, shaped like ``delta``. Keeps the leaf
    types."""
    mode = policy.mode
    if mode == "sign_flip":
        return {k: d * torch.tensor(-policy.scale, dtype=d.dtype)
                for k, d in delta.items()}
    if mode == "scale_boost":
        return {k: d * torch.tensor(policy.scale, dtype=d.dtype)
                for k, d in delta.items()}
    if mode == "zero":
        return {k: torch.zeros_like(d) for k, d in delta.items()}
    if mode == "constant":
        return {k: torch.full_like(d, policy.scale) for k, d in delta.items()}
    if mode == "gauss":
        return {k: d + (policy.noise_stddev * normals[k].float()).to(d.dtype)
                for k, d in delta.items()}
    raise ValueError(f"adversary mode {mode!r} is not elementwise")


def corrupt_stacked_deltas(policy: AdversaryPolicy, stacked: Tree,
                           cohort: Sequence[int], draw: Draw) -> Tree:
    """The attacked version of every row of the stacked ``[C, ...]``
    deltas (the caller keeps the honest rows with :func:`cohort_mask`).
    ``cohort`` holds the rows' client ids: gauss draws per (round,
    client id), so a client's noise does not depend on its slot; collude
    broadcasts one shared delta."""
    if policy.mode == "collude":
        like = {k: v[0] for k, v in stacked.items()}
        raw = {k: v[0] for k, v in draw("collude", [0],
                                        _shapes(stacked, 1)).items()}
        base = collusion_delta(policy, like, raw)
        return {k: base[k][None].expand_as(v) for k, v in stacked.items()}
    normals = (draw("gauss", list(cohort), _shapes(stacked, 1))
               if policy.mode == "gauss" else None)
    return _attack_one(policy, stacked, normals)


def cohort_mask(policy: AdversaryPolicy, cohort: Sequence[int],
                num_clients: int) -> torch.Tensor:
    """``[C]`` bool on the host: which cohort slots hold an adversarial
    client id."""
    ids = policy.member_ids(num_clients)
    return torch.from_numpy(np.isin(np.asarray(cohort), ids))


def corrupt_client_vars(policy: AdversaryPolicy, global_vars: Tree,
                        new_vars: Tree, stat_names: Sequence[str],
                        member: int, draw: Draw) -> Tree:
    """One adversary's own result, as a deployed client sends it:
    ``params' = global + attack(params - global)``; batch statistics
    pass unchanged. ``member`` keys gauss's draw (collude ignores it)."""
    params = [k for k in new_vars if k not in stat_names]
    delta = {k: (new_vars[k] - global_vars[k])[None] for k in params}
    attacked = corrupt_stacked_deltas(policy, delta, [member], draw)
    return {**new_vars, **{k: (global_vars[k] + attacked[k][0]).to(
        global_vars[k].dtype) for k in params}}
