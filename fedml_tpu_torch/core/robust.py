"""The non-finite screen of the default aggregation path, and the rule
that keeps fednova apart from the reducing defenses."""

from __future__ import annotations

import torch


def finite_client_mask(
    stacked: dict[str, torch.Tensor], n_k: torch.Tensor
) -> torch.Tensor:
    """``[C]`` bool: True where every floating tensor of client ``c`` is
    finite and its sample count is finite."""
    ok = torch.isfinite(n_k.float())
    for x in stacked.values():
        if not torch.is_floating_point(x):
            continue
        ok = ok & torch.isfinite(x).reshape(x.shape[0], -1).all(dim=1)
    return ok


def check_fednova_compat(algorithm: str, method: str) -> None:
    """fednova's tau-normalized mean is the aggregation rule, so a
    reducing defense would be bypassed while the configuration says it is
    in force: raise ``ValueError`` for that pair, as the JAX package's
    ``check_fednova_compat`` does."""
    if algorithm == "fednova" and method not in ("mean", "", None):
        raise ValueError(
            f"robust_method={method!r} is incompatible with "
            "algorithm='fednova' (tau-normalized averaging is the "
            "aggregation rule); use fedavg/fedopt with a defense, or "
            "keep fednova with robust_norm_clip/robust_noise_stddev "
            "(which do compose)"
        )
