"""Model factory: ``create_model(ModelConfig)`` returns a
:class:`~fedml_tpu_torch.models.base.FedModel`.

Ported names, with the JAX package's grammar: ``lr``, ``cnn_fedavg``,
``resnet<depth>[_gn][_s2d]`` (BatchNorm or GroupNorm, the "_s2d"
parameterization; the extra ``norm`` "bn" or "gn" overrides the suffix),
``resnet<depth>_s2d_exact`` (the standard BatchNorm ResNet with stage 1
in space-to-depth layout, ``models/s2d_exact.py``), ``resnet18_gn``,
``mobilenet`` (extra ``width_mult``), ``rnn``/``char_lstm`` and
``rnn_stackoverflow``/``nwp_lstm`` (extra ``vocab_size``) and
``transformer_lm``, and the parameterised CNNs ``cnn_small``,
``cnn_medium``, ``cnn_large`` and ``cnn_custom`` (extra ``convs``,
``denses``; an extra ``dropout`` above 0 raises ``NotImplementedError``).
The norm ``syncbn:<axis>`` raises
``NotImplementedError`` naming its ROADMAP item; other names raise
``ValueError``.
"""

from __future__ import annotations

import torch

from fedml_tpu_torch.config import ModelConfig
from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.models.base import FedModel, weightless
from fedml_tpu_torch.models.nlp import NWPLSTM, CharLSTM
from fedml_tpu_torch.models.s2d_exact import ResNetCIFARS2DExact
from fedml_tpu_torch.models.transformer import TransformerLM
from fedml_tpu_torch.models.vision import (
    CNNOriginalFedAvg,
    CNNParameterised,
    LogisticRegression,
    MobileNet,
    ResNet18GN,
    ResNetCIFAR,
)

PORTED = ("lr", "cnn_fedavg", "cnn_small", "cnn_medium", "cnn_large",
          "cnn_custom", "resnet<depth>[_gn][_s2d]",
          "resnet<depth>_s2d_exact",
          "resnet18_gn", "mobilenet", "rnn", "char_lstm",
          "rnn_stackoverflow", "nwp_lstm", "transformer_lm")


def _resnet(name: str, cfg: ModelConfig):
    extra = cfg.extra_dict()
    if name == "resnet18_gn":
        if "norm" in extra:
            raise ValueError(
                "resnet18_gn is the fixed GroupNorm ImageNet-style model; "
                "a norm override does not apply (use resnet<depth> with "
                "extra norm instead)")
        return ResNet18GN(cfg.num_classes, in_channels=cfg.input_shape[-1])
    # name grammar: resnet<depth>[_gn][_s2d] or resnet<depth>_s2d_exact
    base = name[len("resnet"):]
    if base.endswith("_s2d_exact"):
        return ResNetCIFARS2DExact(int(base[:-len("_s2d_exact")]),
                                   cfg.num_classes,
                                   in_channels=cfg.input_shape[-1])
    s2d = base.endswith("_s2d")
    if s2d:
        base = base[:-len("_s2d")]
    gn = base.endswith("_gn")
    norm = extra.get("norm", "gn" if gn else "bn")
    if norm.startswith("syncbn"):
        raise NotImplementedError(
            f"norm {norm!r} is not ported to fedml_tpu_torch yet "
            "(ROADMAP: Queue A item 15, syncbn)")
    depth = int(base[:-len("_gn")] if gn else base)
    return ResNetCIFAR(depth, cfg.num_classes,
                       in_channels=cfg.input_shape[-1], norm=norm,
                       space_to_depth=s2d)


# the fork's client CNNs: (conv widths, dense widths)
CNN_PLANS = {
    "cnn_small": ((16, 32), (64,)),
    "cnn_medium": ((32, 64), (128,)),
    "cnn_large": ((64, 128, 256), (256,)),
}


def _cnn(name: str, cfg: ModelConfig):
    extra = cfg.extra_dict()
    if name == "cnn_custom":
        convs = tuple(extra.get("convs", (16, 32)))
        denses = tuple(extra.get("denses", (128,)))
    else:
        convs, denses = CNN_PLANS[name]
    return CNNParameterised(cfg.num_classes, convs, denses,
                            tuple(cfg.input_shape), extra.get("dropout", 0.0))


_TOKEN_MODELS = ("transformer", "transformer_lm", "rnn", "char_lstm",
                 "rnn_stackoverflow", "nwp_lstm")


def _token_model(name: str, cfg: ModelConfig):
    extra = cfg.extra_dict()
    if name in ("rnn", "char_lstm"):  # shakespeare
        return CharLSTM(vocab_size=extra.get("vocab_size", 90))
    if name in ("rnn_stackoverflow", "nwp_lstm"):
        return NWPLSTM(vocab_size=extra.get("vocab_size", 10004))
    # vocab defaults to num_classes, so --num_classes alone sizes the
    # embedding table for a token dataset
    return TransformerLM(
        vocab_size=extra.get("vocab_size", cfg.num_classes),
        num_layers=extra.get("num_layers", 2),
        num_heads=extra.get("num_heads", 4),
        embed_dim=extra.get("embed_dim", 128),
        max_len=extra.get("max_len", 512),
    )


def create_model(cfg: ModelConfig, device: str | torch.device = "cuda"
                 ) -> FedModel:
    dev = resolve_device(device)
    name = cfg.name.lower()
    shape = tuple(cfg.input_shape)
    if name in _TOKEN_MODELS:
        return FedModel(weightless(lambda: _token_model(name, cfg)), shape,
                        dev, input_dtype=torch.int32)
    if name == "lr":
        module = weightless(lambda: LogisticRegression(cfg.num_classes,
                                                       shape))
    elif name == "cnn_fedavg":
        module = weightless(lambda: CNNOriginalFedAvg(cfg.num_classes, shape))
    elif name in CNN_PLANS or name == "cnn_custom":
        module = weightless(lambda: _cnn(name, cfg))
    elif name.startswith("resnet"):
        module = weightless(lambda: _resnet(name, cfg))
    elif name == "mobilenet":
        module = weightless(lambda: MobileNet(
            cfg.num_classes, cfg.extra_dict().get("width_mult", 1.0),
            in_channels=shape[-1]))
    else:
        raise ValueError(
            f"model {cfg.name!r} is not ported to fedml_tpu_torch yet "
            f"(available: {', '.join(PORTED)})")
    return FedModel(module, shape, dev)


__all__ = ["CNNOriginalFedAvg", "CNNParameterised", "CharLSTM", "FedModel", "LogisticRegression",
           "MobileNet", "NWPLSTM", "ResNet18GN", "ResNetCIFAR",
           "ResNetCIFARS2DExact", "TransformerLM", "create_model"]
