"""Model factory: ``create_model(ModelConfig)`` returns a
:class:`~fedml_tpu_torch.models.base.FedModel`. Only the transformer LM is
ported; other names raise."""

from __future__ import annotations

import torch

from fedml_tpu_torch.config import ModelConfig
from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.models.base import FedModel, weightless
from fedml_tpu_torch.models.transformer import TransformerLM


def create_model(cfg: ModelConfig, device: str | torch.device = "cuda"
                 ) -> FedModel:
    dev = resolve_device(device)
    name = cfg.name.lower()
    extra = cfg.extra_dict()
    if name in ("transformer", "transformer_lm"):
        # vocab defaults to num_classes, so --num_classes alone sizes the
        # embedding table for a token dataset
        module = weightless(lambda: TransformerLM(
            vocab_size=extra.get("vocab_size", cfg.num_classes),
            num_layers=extra.get("num_layers", 2),
            num_heads=extra.get("num_heads", 4),
            embed_dim=extra.get("embed_dim", 128),
            max_len=extra.get("max_len", 512),
        ))
        return FedModel(module, tuple(cfg.input_shape), dev,
                        input_dtype=torch.int32)
    raise ValueError(f"model {cfg.name!r} is not ported to fedml_tpu_torch "
                     "yet (available: transformer_lm)")


__all__ = ["FedModel", "TransformerLM", "create_model"]
