"""Model wrapper: a functional interface over ``nn.Module``s.

The module defines the architecture only and holds no weights (see
:func:`weightless`); the weights are an explicit ``state_dict``
(a flat dict of tensors) that :meth:`FedModel.init` creates and that the
forward passes take as an argument through ``torch.func.functional_call``.
This keeps a client's model a value that can be copied, averaged and
compared, as the variables pytree is in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch import nn
from torch.func import functional_call

Params = dict[str, torch.Tensor]


def weightless(build: Callable[[], nn.Module]) -> nn.Module:
    """Build a module as an architecture only: its own weights go to the
    ``meta`` device, and the global RNG is left as it was (the weights
    come from :meth:`FedModel.init`)."""
    with torch.random.fork_rng(devices=[]):
        return build().to("meta")


def _init_tensor(mod: nn.Module, leaf: str, shape, gen: torch.Generator):
    """Flax's default initializers: Dense kernels lecun-normal (truncated
    normal), embeddings normal with std 1/sqrt(features), LayerNorm scale
    ones, every bias zeros."""
    if leaf == "bias":
        return torch.zeros(shape)
    if isinstance(mod, nn.LayerNorm):
        return torch.ones(shape)
    if isinstance(mod, nn.Embedding):
        return torch.empty(shape).normal_(0.0, shape[1] ** -0.5,
                                          generator=gen)
    if isinstance(mod, nn.Linear):
        # truncated to two standard deviations; the factor restores the
        # variance the truncation removes
        std = math.sqrt(1.0 / shape[1]) / 0.87962566103423978
        return nn.init.trunc_normal_(torch.empty(shape), 0.0, std, -2 * std,
                                     2 * std, generator=gen)
    raise TypeError(f"no initializer for {type(mod).__name__}")


@dataclasses.dataclass(frozen=True)
class FedModel:
    """Functional handle on one architecture on one device."""

    module: nn.Module
    input_shape: tuple[int, ...]
    device: torch.device
    # inputs may be int tokens (NLP) rather than floats
    input_dtype: torch.dtype = torch.float32

    def init(self, generator: torch.Generator) -> Params:
        """Fresh weights drawn on the CPU from ``generator`` (so a seed
        gives the same weights on every device), moved to the device."""
        params = {}
        for mod_name, mod in self.module.named_modules():
            for leaf, p in mod.named_parameters(recurse=False):
                name = f"{mod_name}.{leaf}" if mod_name else leaf
                params[name] = _init_tensor(mod, leaf, p.shape, generator)
        return {k: v.to(self.device) for k, v in params.items()}

    def apply_train(self, params: Params, x: torch.Tensor):
        """Forward in train mode; returns (logits, params). The slice's
        models have no batch statistics or dropout, so the variables come
        back unchanged."""
        return functional_call(self.module, params, (x,)), params

    def apply_eval(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return functional_call(self.module, params, (x,))
