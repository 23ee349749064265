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

from typing import Any, Mapping, Sequence

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
    "TagLogisticRegression": {"Dense_0": "linear"},
    # the split models' auto-named layers (models/gkt.py)
    "SplitClientNet": {f"Conv2D_{k}": f"convs.{k}" for k in range(8)},
    "SplitServerNet": {"Dense_0": "hidden", "Dense_1": "head"},
    "VFLLocalModel": {"Dense_0": "hidden", "Dense_1": "out"},
    "VFLDenseModel": {"Dense_0": "out"},
    "VGG": {**{f"Conv2D_{k}": f"convs.{k}" for k in range(16)},
            "Dense_0": "fc1", "Dense_1": "head"},
    "LeNet": {"Conv2D_0": "conv1", "Conv2D_1": "conv2", "Dense_0": "fc1",
              "Dense_1": "head"},
    "MobileNetV3": {"Conv2D_0": "stem", "BatchNorm_0": "stem_bn",
                    "Conv2D_1": "last", "BatchNorm_1": "last_bn",
                    "Dense_0": "fc1", "Dense_1": "head"},
    "EfficientNet": {"Conv2D_0": "stem", "BatchNorm_0": "stem_bn",
                     "Conv2D_1": "last", "BatchNorm_1": "last_bn",
                     "Dense_0": "head"},
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
# an MBConv_k (blocks.k): with an expansion conv (expand above 1) its
# convs and norms are expansion, depthwise, projection; without, depthwise
# and projection. Its squeeze-excite's dense layers are fc1 and fc2.
_MBCONV = {"SqueezeExcite_0": "se", "Dense_0": "fc1", "Dense_1": "fc2"}
_MBCONV_PARTS = {True: (("expand_conv", "expand_bn"), ("dw", "dw_bn"),
                        ("project", "project_bn")),
                 False: (("dw", "dw_bn"), ("project", "project_bn"))}


def _mbconv_map(block: Mapping[str, Any]) -> dict[str, str]:
    """The names in one MBConv's params or batch_stats subtree: a third
    conv, or a third norm, is an expansion's."""
    expand = "Conv2D_2" in block or "BatchNorm_2" in block
    out = dict(_MBCONV)
    for i, (conv, norm) in enumerate(_MBCONV_PARTS[expand]):
        out[f"Conv2D_{i}"], out[f"BatchNorm_{i}"] = conv, norm
    return out


def _deeplab_top(tree: Mapping[str, Any], rates: int = 3
                 ) -> dict[str, str]:
    """DeepLab-lite's flax names: the encoder's convs and norms come
    first, then the ``rates`` ASPP branches', then the global pool's conv,
    the projection and its norm, and the head. Its BatchNorm count (in
    ``tree``, its params or its batch_stats) is encoder + rates + 1."""
    enc = sum(k.startswith("BatchNorm_") for k in tree) - rates - 1
    top = {}
    for i in range(enc):
        top[f"Conv2D_{i}"], top[f"BatchNorm_{i}"] = (f"encoder.{i}",
                                                     f"encoder_bn.{i}")
    for j in range(rates):
        top[f"Conv2D_{enc + j}"] = f"aspp.{j}"
        top[f"BatchNorm_{enc + j}"] = f"aspp_bn.{j}"
    top[f"Conv2D_{enc + rates}"] = "pool_conv"
    top[f"Conv2D_{enc + rates + 1}"] = "project"
    top[f"BatchNorm_{enc + rates}"] = "project_bn"
    top[f"Conv2D_{enc + rates + 2}"] = "head"
    return top


_VISION_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
                "mean": "running_mean", "var": "running_var"}


def _kernel(arr: np.ndarray, lead: int) -> np.ndarray:
    """A flax kernel after ``lead`` leading axes of rows: a conv's HWIO
    to OIHW, a dense ``[in, out]`` to ``[out, in]``."""
    if arr.ndim - lead == 4:
        return np.moveaxis(arr, (-1, -2), (-4, -3))
    return np.swapaxes(arr, -1, -2)


def _walk_leaves(variables: Mapping[str, Any], module_name, lead: int
                 ) -> dict[str, torch.Tensor]:
    """Every leaf of the ``params`` and ``batch_stats`` collections under
    the port's name ``module_name(path) + "." + leaf``, kernels moved to
    the port's layout after ``lead`` leading axes; copies, on the CPU."""
    out = {}

    def walk(tree, path):
        for key, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, path + (key,))
                continue
            arr = np.asarray(val)
            if key == "kernel":
                arr = _kernel(arr, lead)
            out[f"{module_name(path)}.{_VISION_LEAF[key]}"] = torch.tensor(
                arr)

    for collection in ("params", "batch_stats"):
        walk(variables.get(collection, {}), ())
    return out


def vision_state_dict(variables: Mapping[str, Any], arch: str,
                      lead: int = 0) -> dict[str, torch.Tensor]:
    """Flax variables (``{"params": ..., "batch_stats": ...}``) of a vision
    model to the port's variables; ``arch`` is the port's class name
    (``LogisticRegression``, ``CNNDropOut``, ``CNNOriginalFedAvg``,
    ``CNNParameterised``,
    ``ResNetCIFAR`` with or without ``space_to_depth``,
    ``ResNetCIFARS2DExact``, ``ResNet18GN``, ``MobileNet``, ``VGG``,
    ``LeNet``, ``MobileNetV3``, ``EfficientNet``, ``DeepLabLite``,
    ``TagLogisticRegression`` or a split model: ``SplitClientNet``,
    ``SplitServerNet``, ``VFLLocalModel``, ``VFLDenseModel``). Every leaf
    may carry ``lead`` leading axes of rows (a stacked ``[N, ...]`` bank of
    classifiers), which stay in front. ``BasicBlock_k`` (numbered across
    all stages), ``DepthwiseSeparable_k`` and ``MBConv_k`` become
    ``blocks.k``; in the
    exact s2d ResNet, with ``n`` blocks a stage, ``_S2DBasicBlock_k``
    becomes ``blocks.k``, ``_TransitionBlock_0`` ``blocks.n`` and
    ``_BasicBlock_k`` ``blocks.(n + 1 + k)``. An ``MBConv_k``'s names
    depend on whether it has an expansion conv, and DeepLab-lite's on its
    encoder's depth (``_deeplab_top``, three ASPP rates)."""
    top = (_deeplab_top(variables.get("params")
                        or variables.get("batch_stats", {}))
           if arch == "DeepLabLite" else _VISION_TOP[arch])
    mbconv = {k: _mbconv_map(v)
              for collection in ("batch_stats", "params")
              for k, v in variables.get(collection, {}).items()
              if k.startswith("MBConv_")}
    n = len({k for collection in ("params", "batch_stats")
             for k in variables.get(collection, {})
             if k.startswith("_S2DBasicBlock_")})
    offset = {"_TransitionBlock": n, "_BasicBlock": n + 1}

    def module_name(path):
        parts, block = [], None
        for i, name in enumerate(path):
            kind, _, k = name.rpartition("_")
            if i == 0 and kind == "MBConv":
                parts.append(f"blocks.{k}")
                block = mbconv[name]
            elif kind in _BLOCKS:
                parts.append(f"blocks.{offset.get(kind, 0) + int(k)}")
                block = _BLOCKS[kind]
            elif i == 0:
                parts.append(top.get(name, name))
            else:
                parts.append(block[name])
        return ".".join(parts)

    return _walk_leaves(variables, module_name, lead)


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


def bucket_state_dicts(stacks: Sequence[Mapping[str, Any]],
                       archs: Sequence[str]) -> list[dict[str, torch.Tensor]]:
    """The JAX package's ``HeteroFedGDKD`` bucket stacks (flax variables
    of each bucket's architecture, every leaf with a leading
    ``[len(client_ids)]`` axis of rows, as numpy) to the port's bucket
    stacks, bucket by bucket: ``archs`` are the port's class names
    (``type(bucket.model.module).__name__``). A vision architecture keeps
    its rows in front (:func:`vision_state_dict` with ``lead=1``); an LSTM
    (``CharLSTM``, ``NWPLSTM``) is converted row by row
    (:func:`nlp_state_dict`) and stacked."""
    out = []
    for stack, arch in zip(stacks, archs, strict=True):
        if arch in _VISION_TOP:
            out.append(vision_state_dict(stack, arch, lead=1))
            continue
        rows = len(next(iter(_leaves(stack))))
        per_row = [nlp_state_dict(_row(stack, i), arch) for i in range(rows)]
        out.append({k: torch.stack([r[k] for r in per_row])
                    for k in per_row[0]})
    return out


def _leaves(tree: Mapping[str, Any]):
    for val in tree.values():
        if isinstance(val, Mapping):
            yield from _leaves(val)
        else:
            yield np.asarray(val)


def _row(tree: Mapping[str, Any], i: int) -> dict:
    return {k: _row(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
            for k, v in tree.items()}


def gkt_state_dict(variables: Mapping[str, Any], lead: int = 0
                   ) -> dict[str, torch.Tensor]:
    """Flax variables of ``fedml_tpu.models.gkt``'s ``GKTClientResNet`` or
    ``GKTServerResNet`` to the port's (``models/gkt.py``): their modules
    are named alike on both sides (``conv1``, ``bn1``, ``layer{i}_{b}``
    with ``conv{j}``, ``bn{j}``, ``downsample_conv``, ``downsample_bn``,
    and ``fc``), so only the leaves are renamed. ``lead`` leading axes of
    rows (a ``[N, ...]`` stack of edge models) stay in front."""
    return _walk_leaves(variables, ".".join, lead)


# flax automatic names inside the DARTS network, by scope
_DARTS_TOP = {"Conv2D_0": "stem", "BatchNorm_0": "stem_bn",
              "Dense_0": "head"}
_DARTS_CELL = {"Conv2D_0": "pre0", "Conv2D_1": "pre1"}
_DARTS_SEP = {"SepConv_0": "sep", "SepConv_1": "dil", "Conv2D_0":
              "depthwise", "Conv2D_1": "pointwise", "BatchNorm_0": "bn"}


def darts_state_dict(variables: Mapping[str, Any], lead: int = 0
                     ) -> dict[str, torch.Tensor]:
    """Flax variables of ``fedml_tpu.models.darts.DARTSNetwork`` (the
    ``params``, ``batch_stats`` and ``arch`` collections) to the port's
    (``models/darts.py``): ``SearchCell_k`` -> ``cells.k``, its
    ``Conv2D_0``/``Conv2D_1`` -> ``pre0``/``pre1``, ``MixedOp_m`` ->
    ``mixed.m``, whose ``SepConv_0``/``SepConv_1`` -> ``sep``/``dil``
    (``Conv2D_0`` -> ``depthwise``, ``Conv2D_1`` -> ``pointwise``,
    ``BatchNorm_0`` -> ``bn``); the stem, its BatchNorm and the dense
    layer -> ``stem``, ``stem_bn``, ``head``; ``arch/alphas_*`` ->
    ``alphas_*``. ``lead`` leading axes of rows stay in front."""

    def module_name(path):
        parts = []
        for i, name in enumerate(path):
            kind, _, k = name.rpartition("_")
            if kind == "SearchCell":
                parts.append(f"cells.{k}")
            elif kind == "MixedOp":
                parts.append(f"mixed.{k}")
            elif i == 0:
                parts.append(_DARTS_TOP[name])
            elif len(path) == 2:
                parts.append(_DARTS_CELL[name])
            else:
                parts.append(_DARTS_SEP[name])
        return ".".join(parts)

    out = _walk_leaves(variables, module_name, lead)
    for key, val in variables.get("arch", {}).items():
        out[key] = torch.tensor(np.asarray(val))
    return out


_FID_EMBED = {"Conv_0": "conv1", "Conv_1": "conv2", "Dense_0": "feat",
              "feat": "feat", "cls": "cls"}


def fid_embed_state_dict(variables: Mapping[str, Any]
                         ) -> dict[str, torch.Tensor]:
    """Flax variables of ``fedml_tpu.metrics.fid``'s conv embeds (the
    random embed's ``Conv_0``, ``Conv_1``, ``Dense_0``; the trained one's
    ``feat`` and ``cls`` heads) to the port's ``metrics/fid.py``
    ``EmbedNet``."""
    return _walk_leaves(variables, lambda path: _FID_EMBED[path[0]], 0)
