"""Weights carried across: flax variables of the JAX package's models to
this package's variables (a flat ``state_dict``).

The input is the flax variables as nested dicts of numpy arrays. Flax
``Dense`` kernels are ``[in, out]`` and become ``Linear.weight`` ``[out,
in]``; ``Conv`` kernels are HWIO and become OIHW; ``Embed.embedding``
becomes ``Embedding.weight``; ``LayerNorm`` and ``BatchNorm``
``scale``/``bias`` (and ``GroupNorm``'s) become ``weight``/``bias``, and
``batch_stats`` ``mean``/``var`` become ``BatchNorm``'s
``running_mean``/``running_var``. An ``OptimizedLSTMCell``'s eight kernels
pack into the port's ``LSTM`` (gates i, f, g, o). Flax's automatic module
names are mapped explicitly.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

# flax automatic names -> port module names, by scope
_TOP = {"Embed_0": "embed", "LayerNorm_0": "ln_f"}
_BLOCK = {"LayerNorm_0": "ln_1", "LayerNorm_1": "ln_2"}
_LEAF = {"embedding": "weight", "scale": "weight", "kernel": "weight",
         "bias": "bias", "lora_a": "lora_a", "lora_b": "lora_b"}
# leaves stored transposed: flax [in, out] against the port's [out, in]
# (a LoRA branch's lora_a [in, r] and lora_b [r, out] become [r, in] and
# [out, r], nn.Linear's layout)
_TRANSPOSED = ("kernel", "lora_a", "lora_b")


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
    """Flax ``TransformerLM`` variables (``{"params": {...}}``, LoRA's
    ``lora_a``/``lora_b`` included) to the port's ``TransformerLM``
    state_dict. Only the last two axes of a matrix swap, so leaves with
    leading axes of rows (a stacked cohort, or a personal adapter bank
    ``[num_clients, ...]``) convert the same way."""
    out = {}

    def walk(tree, path):
        for key, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, path + (key,))
                continue
            arr = np.asarray(val)
            if key in _TRANSPOSED:
                arr = np.swapaxes(arr, -1, -2)
            name = f"{_module_name(path)}.{_LEAF[key]}"
            out[name] = torch.tensor(arr, device=device)  # a copy

    walk(variables["params"], ())
    return out


# flax automatic names -> port module names, by architecture (the port's
# class name); "fc1" and "head" are named alike on both sides. A norm is
# BatchNorm_k or GroupNorm_k, whichever the model has.
_RESNET_TOP = {"Conv2D_0": "conv", "BatchNorm_0": "bn", "GroupNorm_0": "bn",
               "PhasePooledBatchNorm_0": "bn"}
_VISION_TOP = {
    "LogisticRegression": {"Dense_0": "linear"},
    "CNNOriginalFedAvg": {"Conv2D_0": "conv1", "Conv2D_1": "conv2"},
    # CNN_DropOut's dense layers are flax's auto-named Dense_0 and Dense_1
    "CNNDropOut": {"Conv2D_0": "conv1", "Conv2D_1": "conv2",
                   "Dense_0": "fc1", "Dense_1": "head"},
    "ResNetCIFAR": _RESNET_TOP,
    "ResNetCIFARS2DExact": _RESNET_TOP,
    "ResNet18GN": _RESNET_TOP,
    "MobileNet": {"Conv2D_0": "conv", "BatchNorm_0": "bn",
                  "Dense_0": "head"},
    # fc<i> and head are named alike on both sides
    "CNNParameterised": {f"Conv2D_{k}": f"convs.{k}" for k in range(8)},
    # cls_hidden, cls_out, disc_hidden and disc_out are named alike
    "ACGANDiscriminator": {**{f"Conv2D_{k}": f"convs.{k}" for k in range(8)},
                           **{f"BatchNorm_{k}": f"bns.{k}"
                              for k in range(8)}},
}
# inside a block (BasicBlock_k or DepthwiseSeparable_k, numbered across
# the whole model as blocks.k; in the exact s2d ResNet _S2DBasicBlock_k,
# _TransitionBlock_0 and _BasicBlock_k, numbered in that order): in a
# projecting block the third conv and norm are the shortcut's
_RESNET_BLOCK = {"Conv2D_0": "conv1", "Conv2D_1": "conv2", "Conv2D_2": "proj",
                 **{f"{kind}_{i}": name
                    for kind in ("BatchNorm", "GroupNorm",
                                 "PhasePooledBatchNorm")
                    for i, name in enumerate(("bn1", "bn2", "proj_bn"))}}
_BLOCKS = {
    "BasicBlock": _RESNET_BLOCK,
    "_S2DBasicBlock": _RESNET_BLOCK,
    "_TransitionBlock": _RESNET_BLOCK,
    "_BasicBlock": _RESNET_BLOCK,
    "DepthwiseSeparable": {"Conv2D_0": "dw", "BatchNorm_0": "dw_bn",
                           "Conv2D_1": "pw", "BatchNorm_1": "pw_bn"},
}
_VISION_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
                "mean": "running_mean", "var": "running_var"}


def _kernel(arr: np.ndarray, lead: int) -> np.ndarray:
    """A flax kernel after ``lead`` leading axes of rows: a conv's HWIO
    to OIHW, a dense ``[in, out]`` to ``[out, in]``."""
    if arr.ndim - lead == 4:
        return np.moveaxis(arr, (-1, -2), (-4, -3))
    return np.swapaxes(arr, -1, -2)


def vision_state_dict(variables: Mapping[str, Any], arch: str,
                      lead: int = 0) -> dict[str, torch.Tensor]:
    """Flax variables (``{"params": ..., "batch_stats": ...}``) of a vision
    model to the port's variables; ``arch`` is the port's class name
    (``LogisticRegression``, ``CNNDropOut``, ``CNNOriginalFedAvg``,
    ``CNNParameterised``,
    ``ResNetCIFAR`` with or without ``space_to_depth``,
    ``ResNetCIFARS2DExact``, ``ResNet18GN`` or ``MobileNet``). Every leaf
    may carry ``lead`` leading axes of rows (a stacked ``[N, ...]`` bank of
    classifiers), which stay in front. ``BasicBlock_k`` (numbered across
    all stages) and ``DepthwiseSeparable_k`` become ``blocks.k``; in the
    exact s2d ResNet, with ``n`` blocks a stage, ``_S2DBasicBlock_k``
    becomes ``blocks.k``, ``_TransitionBlock_0`` ``blocks.n`` and
    ``_BasicBlock_k`` ``blocks.(n + 1 + k)``."""
    top = _VISION_TOP[arch]
    n = len({k for collection in ("params", "batch_stats")
             for k in variables.get(collection, {})
             if k.startswith("_S2DBasicBlock_")})
    offset = {"_TransitionBlock": n, "_BasicBlock": n + 1}
    out = {}

    def module_name(path):
        parts, block = [], None
        for i, name in enumerate(path):
            kind, _, k = name.rpartition("_")
            if kind in _BLOCKS:
                parts.append(f"blocks.{offset.get(kind, 0) + int(k)}")
                block = _BLOCKS[kind]
            elif i == 0:
                parts.append(top.get(name, name))
            else:
                parts.append(block[name])
        return ".".join(parts)

    def walk(tree, path):
        for key, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, path + (key,))
                continue
            arr = np.asarray(val)
            if key == "kernel":
                arr = _kernel(arr, lead)
            name = f"{module_name(path)}.{_VISION_LEAF[key]}"
            out[name] = torch.tensor(arr)  # a copy, on the CPU

    for collection in ("params", "batch_stats"):
        walk(variables.get(collection, {}), ())
    return out


# the gates of an OptimizedLSTMCell, in the port's packing order
_GATES = ("i", "f", "g", "o")
# flax automatic names of the LSTM models -> port module names
_NLP_TOP = {
    "CharLSTM": {"Embed_0": "embed", "OptimizedLSTMCell_0": "lstm1",
                 "OptimizedLSTMCell_1": "lstm2", "Dense_0": "head"},
    "NWPLSTM": {"Embed_0": "embed", "OptimizedLSTMCell_0": "lstm",
                "Dense_0": "fc", "Dense_1": "head"},
}


def nlp_state_dict(variables: Mapping[str, Any], arch: str
                   ) -> dict[str, torch.Tensor]:
    """Flax variables of ``fedml_tpu.models.nlp``'s ``CharLSTM`` or
    ``NWPLSTM`` (``arch``) to the port's. An ``OptimizedLSTMCell_k``'s
    input kernels ``ii, if, ig, io`` (``[in, H]``, no bias) become
    ``weight_ih`` ``[4H, in]``, its hidden kernels ``hi, hf, hg, ho``
    become ``weight_hh`` ``[4H, H]`` and their biases ``bias`` ``[4H]``,
    gates in that order."""
    out = {}
    for scope, tree in variables["params"].items():
        name = _NLP_TOP[arch][scope]
        if scope.startswith("OptimizedLSTMCell_"):
            packed = {
                "weight_ih": [tree[f"i{g}"]["kernel"] for g in _GATES],
                "weight_hh": [tree[f"h{g}"]["kernel"] for g in _GATES],
                "bias": [tree[f"h{g}"]["bias"] for g in _GATES],
            }
            for leaf, parts in packed.items():
                arr = np.concatenate([np.asarray(p) for p in parts], -1)
                out[f"{name}.{leaf}"] = torch.tensor(
                    arr.T if arr.ndim == 2 else arr)
            continue
        for key, val in tree.items():
            arr = np.asarray(val)
            out[f"{name}.{_LEAF[key]}"] = torch.tensor(
                arr.T if key == "kernel" else arr)
    return out


def generator_state_dict(variables: Mapping[str, Any], lead: int = 0
                         ) -> dict[str, torch.Tensor]:
    """Flax variables of ``fedml_tpu.models.gan``'s conditional or
    unconditional generator to the port's (``models/gan.py``):
    ``label_emb/embedding`` -> ``label_emb.weight``; ``pyramid/l1`` ->
    ``pyramid.l1`` (kernel transposed); ``ConvTranspose2D_k/kernel``
    ``[kh, kw, in, out]`` -> ``pyramid.deconvs.k.weight`` ``[in, out, kh,
    kw]``, flipped in both spatial dims (a flax transposed conv
    correlates with its kernel unflipped, ``F.conv_transpose2d`` with it
    flipped); ``BatchNorm_k`` scale, bias, mean and var -> ``pyramid.bns.k``
    weight, bias, running_mean and running_var. Every leaf may carry
    ``lead`` leading axes of rows (lanes of a cohort), kept in front."""
    out = {}

    def walk(tree, path):
        for key, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, path + (key,))
                continue
            arr = np.asarray(val)
            scope = path[-1]
            kind, _, k = scope.rpartition("_")
            if scope == "label_emb":
                name = "label_emb.weight"
            elif scope == "l1":
                name = f"pyramid.l1.{_LEAF[key]}"
                if key == "kernel":
                    arr = np.swapaxes(arr, -1, -2)
            elif kind == "ConvTranspose2D":
                name = f"pyramid.deconvs.{k}.{_LEAF[key]}"
                if key == "kernel":
                    arr = np.flip(np.moveaxis(arr, (-2, -1), (-4, -3)),
                                  (-2, -1))
            elif kind == "BatchNorm":
                name = f"pyramid.bns.{k}.{_VISION_LEAF[key]}"
            else:
                raise KeyError(f"unknown generator scope {'/'.join(path)}")
            out[name] = torch.tensor(np.ascontiguousarray(arr))

    for collection in ("params", "batch_stats"):
        walk(variables.get(collection, {}), ())
    return out


def acgan_state_dict(variables: Mapping[str, Any], lead: int = 0
                     ) -> dict[str, torch.Tensor]:
    """Flax variables of ``fedml_tpu.models.gan.ACGANDiscriminator``, with
    or without the validity head, to the port's (``models/gan.py``):
    ``Conv2D_k`` -> ``convs.k`` (HWIO to OIHW), ``BatchNorm_k`` ->
    ``bns.k``, the dense heads by their names (kernels transposed).
    ``lead`` leading axes of rows (a ``[N, ...]`` bank) stay in front."""
    return vision_state_dict(variables, "ACGANDiscriminator", lead)
