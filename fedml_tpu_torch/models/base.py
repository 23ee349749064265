"""Model wrapper: a functional interface over ``nn.Module``s.

The module defines the architecture only and holds no weights (see
:func:`weightless`); the weights are an explicit ``state_dict``
(a flat dict of tensors) that :meth:`FedModel.init` creates and that the
forward passes take as an argument through ``torch.func.functional_call``.
This keeps a client's model a value that can be copied, averaged and
compared, as the variables pytree is in the JAX package.

The variables are one flat dict: the parameters, and for a model with
BatchNorm its running statistics (the buffers of :class:`BatchNorm`,
named by :attr:`FedModel.stat_names`; the JAX package's ``batch_stats``
collection). A train-mode forward returns the new statistics as values
and writes no buffer in place, so it stays a function of its inputs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch import nn
from torch.func import functional_call

from fedml_tpu_torch.core.tree import wide

Params = dict[str, torch.Tensor]


def weightless(build: Callable[[], nn.Module]) -> nn.Module:
    """Build a module as an architecture only: its own weights go to the
    ``meta`` device, and the global RNG is left as it was (the weights
    come from :meth:`FedModel.init`)."""
    with torch.random.fork_rng(devices=[]):
        return build().to("meta")


# flax's convention: the weight of the old running value. The vision
# models set 0.9; the generator's BatchNorm keeps flax's default, 0.99
BN_MOMENTUM = 0.9
FLAX_BN_MOMENTUM = 0.99
BN_EPS = 1e-5


def batch_norm_update(mean: torch.Tensor, var: torch.Tensor,
                      batch_mean: torch.Tensor, batch_var: torch.Tensor,
                      momentum: float = BN_MOMENTUM):
    """The running statistics after a batch, flax's way:
    ``momentum * running + (1 - momentum) * batch``."""
    return (momentum * mean + (1 - momentum) * batch_mean.detach(),
            momentum * var + (1 - momentum) * batch_var.detach())


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               mean: torch.Tensor, var: torch.Tensor, train: bool,
               momentum: float = BN_MOMENTUM):
    """Flax ``nn.BatchNorm`` over the channel dim 1 of ``x``; returns
    ``(y, new_mean, new_var)``.

    In train mode the statistics are taken over every other dim in
    float32 whatever ``x``'s type (float64 stays float64), the variance in
    the fast form E[x^2] - E[x]^2 clipped at 0 (biased), and the running
    values move as
    ``momentum * running + (1 - momentum) * batch`` with that biased
    variance (torch's BatchNorm would use the unbiased one, and its
    momentum is 1 - this one). In eval mode ``mean``/``var`` normalize and
    come back unchanged. The normalization (epsilon ``BN_EPS``) runs in
    float32 and the result takes ``x``'s type, as flax computes it."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    xf = wide(x)
    if train:
        dims = [0, *range(2, x.ndim)]
        use_mean = xf.mean(dims)
        use_var = torch.clamp(torch.mean(xf * xf, dims) - use_mean * use_mean,
                              min=0.0)
        new_mean, new_var = batch_norm_update(mean, var, use_mean, use_var,
                                              momentum)
    else:
        use_mean, use_var, new_mean, new_var = mean, var, mean, var
    mul = torch.rsqrt(use_var + BN_EPS) * wide(scale)
    y = (xf - use_mean.reshape(shape)) * mul.reshape(shape)
    return (y + wide(bias).reshape(shape)).to(x.dtype), new_mean, new_var


class BatchNorm(nn.Module):
    """:func:`batch_norm` with its scale and bias as parameters (``weight``
    and ``bias``) and its running statistics as buffers (``running_mean``
    and ``running_var``). Not ``nn.BatchNorm2d``: see :func:`batch_norm`.
    A train-mode call puts its new statistics into ``stats_out`` under the
    module and leaves the buffers as they are. ``momentum`` is flax's
    (the weight of the old running value)."""

    def __init__(self, num_features: int, momentum: float = BN_MOMENTUM):
        super().__init__()
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, train: bool = False,
                stats_out: dict | None = None) -> torch.Tensor:
        y, mean, var = batch_norm(x, self.weight, self.bias,
                                  self.running_mean, self.running_var, train,
                                  self.momentum)
        if train:
            stats_out[self] = (mean, var)
        return y


GN_EPS = 1e-6  # flax nn.GroupNorm's epsilon


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int) -> torch.Tensor:
    """Flax ``nn.GroupNorm`` over the channel dim 1 of ``x``: the channels
    split into ``num_groups`` contiguous groups, each normalized by its own
    mean and variance over its channels and the spatial dims, per sample.

    The statistics are float32 whatever ``x``'s type (flax's
    ``force_float32_reductions``), the variance in the fast form E[x^2] -
    E[x]^2 clipped at 0; the normalization (epsilon ``GN_EPS``) and the
    per-channel scale and bias run in float32, and the result takes the
    type ``x``, ``scale`` and ``bias`` promote to. No running statistics:
    train and eval are the same function. Not ``nn.GroupNorm``, whose
    epsilon and two-pass variance differ."""
    c = x.shape[1]
    xf = x.float().unflatten(1, (num_groups, c // num_groups))
    dims = tuple(range(2, xf.ndim))
    mean = xf.mean(dims, keepdim=True)
    var = torch.clamp(torch.mean(xf * xf, dims, keepdim=True) - mean * mean,
                      min=0.0)
    per_channel = (1,) + xf.shape[1:3] + (1,) * (xf.ndim - 3)
    mul = torch.rsqrt(var + GN_EPS) * scale.float().reshape(per_channel)
    y = ((xf - mean) * mul).flatten(1, 2)
    y = y + bias.float().reshape((1, -1) + (1,) * (x.ndim - 2))
    out = torch.promote_types(torch.promote_types(x.dtype, scale.dtype),
                              bias.dtype)
    return y.to(out)


class GroupNorm(nn.Module):
    """:func:`group_norm` with its scale and bias as parameters
    (``weight`` and ``bias``). It takes :class:`BatchNorm`'s ``train`` and
    ``stats_out`` arguments and ignores them, so a block can hold either
    norm."""

    def __init__(self, num_groups: int, num_features: int):
        super().__init__()
        if num_features % num_groups:
            raise ValueError(f"{num_groups} groups do not divide "
                             f"{num_features} channels")
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor, train: bool = False,
                stats_out: dict | None = None) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups)


def _lecun_normal(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """Flax's lecun_normal: a normal truncated to two standard deviations,
    with the factor that restores the variance the truncation removes."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(torch.empty(shape), 0.0, std, -2 * std,
                                 2 * std, generator=gen)


def _orthogonal_blocks(shape, gen: torch.Generator) -> torch.Tensor:
    """Flax's orthogonal initializer for each ``[H, H]`` block of a
    ``[k H, H]`` tensor (the LSTM's recurrent kernels, one per gate)."""
    h = shape[1]
    blocks = [torch.linalg.qr(torch.randn(h, h, generator=gen))
              for _ in range(shape[0] // h)]
    # signs of R's diagonal make the draw uniform over orthogonal matrices
    return torch.cat([q * torch.sign(torch.diagonal(r))[None]
                      for q, r in blocks])


# the LoRA adapter leaves (fedml_tpu_torch/peft/lora.py): drawn after
# every other leaf, so injecting adapters leaves the base draws unchanged
ADAPTER_LEAVES = ("lora_a", "lora_b")


def _init_tensor(mod: nn.Module, leaf: str, shape, gen: torch.Generator):
    """Flax's default initializers: Dense and Conv kernels and an LSTM's
    input kernels lecun-normal (fan_in = in features, or kh * kw * in
    channels per group for a conv; a transposed conv's ``[in, out, kh,
    kw]`` weight takes kh * kw * in), an LSTM's recurrent kernels orthogonal,
    embeddings normal with std 1/sqrt(features), LayerNorm, BatchNorm and
    GroupNorm scale ones, every bias zeros, BatchNorm running mean zeros
    and variance ones; a LoRA ``lora_a`` ``[rank, in]`` lecun-normal
    (fan_in = in features) and ``lora_b`` zeros."""
    if leaf in ("bias", "running_mean", "lora_b"):
        return torch.zeros(shape)
    if leaf == "lora_a":
        return _lecun_normal(shape, shape[1], gen)
    if leaf == "running_var" or isinstance(
            mod, (nn.LayerNorm, BatchNorm, GroupNorm)):
        return torch.ones(shape)
    if isinstance(mod, nn.Embedding):
        return torch.empty(shape).normal_(0.0, shape[1] ** -0.5,
                                          generator=gen)
    if leaf == "weight_hh":
        return _orthogonal_blocks(shape, gen)
    if isinstance(mod, nn.ConvTranspose2d):
        return _lecun_normal(shape, shape[0] * math.prod(shape[2:]), gen)
    if isinstance(mod, (nn.Linear, nn.Conv2d)) or leaf == "weight_ih":
        return _lecun_normal(shape, math.prod(shape[1:]), gen)
    raise TypeError(f"no initializer for {type(mod).__name__}.{leaf}")


@dataclasses.dataclass(frozen=True)
class FedModel:
    """Functional handle on one architecture on one device.

    ``stat_names`` are the keys of the variables that are batch
    statistics (every buffer of the module); the rest are parameters.
    A module with dropout (the JAX package's ``has_dropout``) names its
    sites: ``mask_sites`` (``{site: one sample's mask shape}``, from its
    ``mask_shapes()``) and ``mask_keep`` (``{site: keep probability}``,
    from its ``mask_rates()``); ``has_dropout`` is whether it has any. Its
    train-mode forward takes one bool keep mask a site, drawn outside the
    forward (``core/random.py``, stream ``"dropout"``), so a step is a
    function of its inputs and a CUDA graph replays it."""

    module: nn.Module
    input_shape: tuple[int, ...]
    device: torch.device
    # inputs may be int tokens (NLP) rather than floats
    input_dtype: torch.dtype = torch.float32
    stat_names: tuple[str, ...] = dataclasses.field(init=False)
    # derived from the module, so out of the equality and the hash
    mask_sites: dict = dataclasses.field(init=False, compare=False)
    mask_keep: dict = dataclasses.field(init=False, compare=False)
    has_dropout: bool = dataclasses.field(init=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "stat_names", tuple(
            name for name, _ in self.module.named_buffers()))
        shapes = getattr(self.module, "mask_shapes", None)
        sites = shapes() if shapes is not None else {}
        object.__setattr__(self, "mask_sites", sites)
        object.__setattr__(self, "mask_keep", {
            k: 1.0 - r for k, r in self.module.mask_rates().items()}
            if sites else {})
        object.__setattr__(self, "has_dropout", bool(sites))
        object.__setattr__(self, "_bn_names", {
            mod: name for name, mod in self.module.named_modules()
            if isinstance(mod, BatchNorm)})

    def init(self, generator: torch.Generator) -> Params:
        """Fresh variables drawn on the CPU from ``generator`` (so a seed
        gives the same weights on every device), moved to the device, in
        module order. The leaves are drawn in module order too, except
        LoRA adapter leaves, which are drawn after all the others: every
        other leaf is then drawn as for the model without adapters."""
        leaves = {}
        for mod_name, mod in self.module.named_modules():
            for leaf, p in [*mod.named_parameters(recurse=False),
                            *mod.named_buffers(recurse=False)]:
                name = f"{mod_name}.{leaf}" if mod_name else leaf
                leaves[name] = (mod, leaf, p.shape)
        drawn = {}
        for adapters in (False, True):
            for name, (mod, leaf, shape) in leaves.items():
                if (leaf in ADAPTER_LEAVES) == adapters:
                    drawn[name] = _init_tensor(mod, leaf, shape, generator)
        return {k: drawn[k].to(self.device) for k in leaves}

    def apply_train(self, variables: Params, *inputs: torch.Tensor,
                    masks: dict | None = None, **kwargs):
        """Forward of ``inputs`` (the model's input, or a generator's noise
        and labels) in train mode; returns (output, variables with the new
        batch statistics). A model without statistics gets its variables
        back unchanged. ``kwargs`` go to the module's forward (the ACGAN
        discriminator's ``validity``). A model with dropout needs
        ``masks`` (``{site: [B, *mask_sites[site]]}`` bool; the module's
        forward raises without them); a model without dropout ignores
        them."""
        if self.has_dropout and masks is not None:
            kwargs["masks"] = masks
        if not self.stat_names:
            if self.has_dropout:
                kwargs["train"] = True
            return functional_call(self.module, variables, inputs,
                                   kwargs), variables
        stats = {}
        logits = functional_call(self.module, variables, inputs,
                                 {**kwargs, "train": True,
                                  "stats_out": stats})
        new = dict(variables)
        for mod, (mean, var) in stats.items():
            name = self._bn_names[mod]
            new[f"{name}.running_mean"] = mean
            new[f"{name}.running_var"] = var
        return logits, new

    def apply_eval(self, variables: Params, *inputs: torch.Tensor,
                   **kwargs) -> torch.Tensor:
        """Forward in eval mode: BatchNorm normalizes with the running
        statistics (and dropout keeps every activation)."""
        return functional_call(self.module, variables, inputs, kwargs)
