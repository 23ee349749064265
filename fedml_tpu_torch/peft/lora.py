"""LoRA adapter injection for :class:`~fedml_tpu_torch.models.transformer.
TransformerLM` (the JAX package's ``fedml_tpu/peft/lora.py``).

Low-rank adaptation (Hu et al. 2021): each targeted projection ``y = x
Wᵀ + b`` gains a rank-``r`` branch

    y = x Wᵀ + (alpha / r) * (x Aᵀ) Bᵀ + b

with the base ``W`` frozen, ``A`` drawn at init and ``B`` zero at init,
so at round 0 the adapted model computes exactly what the base model
does. The port's layout is ``nn.Linear``'s: ``lora_a`` is ``[r, in]``
and ``lora_b`` ``[out, r]``, the transposes of the JAX package's ``[in,
r]`` and ``[r, out]`` (``fedml_tpu_torch/convert.py`` carries them
across). :meth:`FedModel.init <fedml_tpu_torch.models.base.FedModel.
init>` draws the base leaves exactly as for the un-injected model and the
adapter leaves after all of them, so injection leaves the base draws as
they were.

Injection is a dense factory: the transformer builds its projections
through ``dense_cls`` and :func:`dense_factory` gives the targeted names
a :class:`LoRALinear`. What trains and what aggregates is decided by
:mod:`fedml_tpu_torch.peft.partition`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

#: the injectable projection names of the TransformerLM block, in model
#: order
LORA_TARGETS = (
    "q_proj", "k_proj", "v_proj", "attn_out", "mlp_up", "mlp_down",
)

#: model names create_model resolves to a TransformerLM
LORA_MODELS = ("transformer", "transformer_lm")


@dataclasses.dataclass(frozen=True)
class LoRASpec:
    """The adapter configuration (``FedConfig.peft`` and ``lora_*``)."""

    rank: int = 4
    alpha: float = 8.0
    targets: tuple[str, ...] = ("q_proj", "v_proj")

    def __post_init__(self):
        if self.rank < 1:
            raise ValueError(f"lora_rank must be >= 1, got {self.rank}")
        if not self.alpha > 0:
            raise ValueError(f"lora_alpha must be > 0, got {self.alpha}")
        bad = [t for t in self.targets if t not in LORA_TARGETS]
        if bad or not self.targets:
            raise ValueError(
                f"unknown lora_targets {bad or '(empty)'}: the "
                f"TransformerLM's injectable projections are "
                f"{list(LORA_TARGETS)}")

    @staticmethod
    def from_fed(fed) -> "LoRASpec | None":
        """None when ``fed.peft`` is off; validated on construction."""
        method = getattr(fed, "peft", "none") or "none"
        if method == "none":
            return None
        if method != "lora":
            raise ValueError(f"peft must be 'none' or 'lora', got {method!r}")
        return LoRASpec(rank=fed.lora_rank, alpha=fed.lora_alpha,
                        targets=tuple(fed.lora_targets))


class LoRALinear(nn.Linear):
    """``nn.Linear`` (same ``weight`` and ``bias``, same init) plus the
    low-rank branch ``lora_a`` ``[rank, in]``, ``lora_b`` ``[out,
    rank]``. The sum runs in the JAX package's order: the base product,
    then the scaled branch, then the bias."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 rank: int, alpha: float):
        super().__init__(in_features, out_features, bias=bias)
        self.scale = alpha / rank
        self.lora_a = nn.Parameter(torch.zeros(rank, in_features))
        self.lora_b = nn.Parameter(torch.zeros(out_features, rank))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight)
        y = y + self.scale * F.linear(F.linear(x, self.lora_a), self.lora_b)
        if self.bias is not None:
            y = y + self.bias
        return y


def dense_factory(spec: LoRASpec):
    """The transformer's ``dense_cls`` hook: targeted names get a
    :class:`LoRALinear`, every other projection a stock ``nn.Linear``, so
    the module tree outside the targets is unchanged."""

    def make(in_features: int, out_features: int, bias: bool,
             name: str) -> nn.Module:
        if name in spec.targets:
            return LoRALinear(in_features, out_features, bias, spec.rank,
                              spec.alpha)
        return nn.Linear(in_features, out_features, bias=bias)

    return make


def apply_lora(model, spec: LoRASpec):
    """A transformer :class:`~fedml_tpu_torch.models.base.FedModel` with
    adapters injected: a new handle whose module builds the targeted
    projections as :class:`LoRALinear`. Raises for an architecture
    without the named projections: injection never does nothing
    silently."""
    from fedml_tpu_torch.models.base import FedModel, weightless
    from fedml_tpu_torch.models.transformer import TransformerLM

    lm = model.module
    if not isinstance(lm, TransformerLM):
        raise ValueError(
            f"peft='lora' targets the TransformerLM's named projections "
            f"({list(LORA_TARGETS)}); {type(lm).__name__} has no such "
            "contract: use --model transformer/transformer_lm")
    module = weightless(lambda: TransformerLM(
        **{**lm.config(), "dense_cls": dense_factory(spec)}))
    return FedModel(module, model.input_shape, model.device,
                    model.input_dtype)


def check_model_supported(model_name: str) -> None:
    """The parse-time twin of :func:`apply_lora`'s architecture check."""
    if model_name.lower() not in LORA_MODELS:
        raise ValueError(
            f"--peft lora requires a transformer model "
            f"({'/'.join(LORA_MODELS)}); got --model {model_name!r} (LoRA "
            f"injects into the TransformerLM's named projections "
            f"{list(LORA_TARGETS)})")
