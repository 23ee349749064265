"""The non-finite screen of the default aggregation path."""

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
