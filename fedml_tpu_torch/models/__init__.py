"""Model factory: ``create_model(ModelConfig)`` returns a
:class:`~fedml_tpu_torch.models.base.FedModel`.

Ported names, with the JAX package's grammar: ``lr``, ``cnn_fedavg``,
``resnet<depth>`` (BatchNorm) and ``transformer_lm``. The ResNet variants
the port does not have yet (``_gn``, ``_s2d``, ``_s2d_exact``, a ``norm``
override) raise ``NotImplementedError`` naming their ROADMAP item; other
names raise ``ValueError``.
"""

from __future__ import annotations

import torch

from fedml_tpu_torch.config import ModelConfig
from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.models.base import FedModel, weightless
from fedml_tpu_torch.models.transformer import TransformerLM
from fedml_tpu_torch.models.vision import (
    CNNOriginalFedAvg,
    LogisticRegression,
    ResNetCIFAR,
)

# resnet name suffixes not ported yet -> their ROADMAP item
_RESNET_NOT_PORTED = (
    ("_s2d_exact", "resnet56_s2d"),
    ("_s2d", "resnet56_s2d"),
    ("_gn", "resnet GroupNorm"),
)


def _resnet(name: str, cfg: ModelConfig):
    extra = cfg.extra_dict()
    for suffix, item in _RESNET_NOT_PORTED:
        if name.endswith(suffix):
            raise NotImplementedError(
                f"model {cfg.name!r} is not ported to fedml_tpu_torch yet "
                f"(ROADMAP: {item})")
    if "norm" in extra:
        raise NotImplementedError(
            f"norm override {extra['norm']!r} is not ported to "
            "fedml_tpu_torch yet (ROADMAP: resnet GroupNorm, syncbn)")
    depth = int(name[len("resnet"):])
    return ResNetCIFAR(depth, cfg.num_classes,
                       in_channels=cfg.input_shape[-1])


def create_model(cfg: ModelConfig, device: str | torch.device = "cuda"
                 ) -> FedModel:
    dev = resolve_device(device)
    name = cfg.name.lower()
    extra = cfg.extra_dict()
    shape = tuple(cfg.input_shape)
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
        return FedModel(module, shape, dev, input_dtype=torch.int32)
    if name == "lr":
        module = weightless(lambda: LogisticRegression(cfg.num_classes,
                                                       shape))
    elif name == "cnn_fedavg":
        module = weightless(lambda: CNNOriginalFedAvg(cfg.num_classes, shape))
    elif name.startswith("resnet"):
        module = weightless(lambda: _resnet(name, cfg))
    else:
        raise ValueError(
            f"model {cfg.name!r} is not ported to fedml_tpu_torch yet "
            "(available: lr, cnn_fedavg, resnet<depth>, transformer_lm)")
    return FedModel(module, shape, dev)


__all__ = ["CNNOriginalFedAvg", "FedModel", "LogisticRegression",
           "ResNetCIFAR", "TransformerLM", "create_model"]
