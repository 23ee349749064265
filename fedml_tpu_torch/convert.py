"""Weights carried across: flax variables of the JAX package's models to
this package's variables (a flat ``state_dict``).

The input is the flax variables as nested dicts of numpy arrays. Flax
``Dense`` kernels are ``[in, out]`` and become ``Linear.weight`` ``[out,
in]``; ``Conv`` kernels are HWIO and become OIHW; ``Embed.embedding``
becomes ``Embedding.weight``; ``LayerNorm`` and ``BatchNorm``
``scale``/``bias`` become ``weight``/``bias``, and ``batch_stats``
``mean``/``var`` become ``BatchNorm``'s ``running_mean``/``running_var``.
Flax's automatic module names are mapped explicitly.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

# flax automatic names -> port module names, by scope
_TOP = {"Embed_0": "embed", "LayerNorm_0": "ln_f"}
_BLOCK = {"LayerNorm_0": "ln_1", "LayerNorm_1": "ln_2"}
_LEAF = {"embedding": "weight", "scale": "weight", "kernel": "weight",
         "bias": "bias"}


def _module_name(path: tuple[str, ...]) -> str:
    parts = []
    for i, name in enumerate(path):
        if name.startswith("Block_"):
            parts.append(f"blocks.{int(name[len('Block_'):])}")
        elif i == 0:
            parts.append(_TOP.get(name, name))
        else:
            parts.append(_BLOCK.get(name, name))
    return ".".join(parts)


def transformer_state_dict(
    variables: Mapping[str, Any], device: str | torch.device = "cpu"
) -> dict[str, torch.Tensor]:
    """Flax ``TransformerLM`` variables (``{"params": {...}}``) to the
    port's ``TransformerLM`` state_dict."""
    out = {}

    def walk(tree, path):
        for key, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, path + (key,))
                continue
            arr = np.asarray(val)
            if key == "kernel":
                arr = arr.T
            name = f"{_module_name(path)}.{_LEAF[key]}"
            out[name] = torch.tensor(arr, device=device)  # a copy

    walk(variables["params"], ())
    return out


# flax automatic names -> port module names, by architecture (the port's
# class name); "fc1" and "head" are named alike on both sides
_VISION_TOP = {
    "LogisticRegression": {"Dense_0": "linear"},
    "CNNOriginalFedAvg": {"Conv2D_0": "conv1", "Conv2D_1": "conv2"},
    "ResNetCIFAR": {"Conv2D_0": "conv", "BatchNorm_0": "bn"},
}
# inside a BasicBlock: in a projecting block the third conv and BatchNorm
# are the shortcut's
_BASIC_BLOCK = {"Conv2D_0": "conv1", "BatchNorm_0": "bn1",
                "Conv2D_1": "conv2", "BatchNorm_1": "bn2",
                "Conv2D_2": "proj", "BatchNorm_2": "proj_bn"}
_VISION_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
                "mean": "running_mean", "var": "running_var"}


def vision_state_dict(variables: Mapping[str, Any], arch: str
                      ) -> dict[str, torch.Tensor]:
    """Flax variables (``{"params": ..., "batch_stats": ...}``) of a vision
    model to the port's variables; ``arch`` is the port's class name
    (``LogisticRegression``, ``CNNOriginalFedAvg`` or ``ResNetCIFAR``).
    ``BasicBlock_k`` is numbered across all three stages and becomes
    ``blocks.k``."""
    top = _VISION_TOP[arch]
    out = {}

    def module_name(path):
        parts = []
        for i, name in enumerate(path):
            if name.startswith("BasicBlock_"):
                parts.append(f"blocks.{int(name[len('BasicBlock_'):])}")
            elif i == 0:
                parts.append(top.get(name, name))
            else:
                parts.append(_BASIC_BLOCK[name])
        return ".".join(parts)

    def walk(tree, path):
        for key, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, path + (key,))
                continue
            arr = np.asarray(val)
            if key == "kernel":
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            name = f"{module_name(path)}.{_VISION_LEAF[key]}"
            out[name] = torch.tensor(arr)  # a copy, on the CPU

    for collection in ("params", "batch_stats"):
        walk(variables.get(collection, {}), ())
    return out
