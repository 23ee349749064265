"""Split models: FedGKT's edge and server ResNets, SplitNN's two stacks
and vertical FL's party models (``fedml_tpu.models.gkt``).

FedGKT cuts the reference's Bottleneck ResNet-56 at the stem: the edge
model (``resnet8_56``) is the stem, whose output is the exchanged feature
map, two Bottlenecks at planes 16 and a dense head; the server model is
the Bottleneck [6, 6, 6] trunk without the stem over those features.
Every BatchNorm is flax's default, momentum 0.99 (``FLAX_BN_MOMENTUM``),
and no GKT convolution has a bias. Inputs and the exchanged features are
NHWC (the features ``[B, H, W, width]``); the convolutions view them as
NCHW (``models/vision.py`` ``nchw``). Module names follow the JAX
package's explicit ones (``conv1``, ``bn1``, ``layer{i}_{b}``, ``fc``),
so the converter is a rename of leaves and
:func:`load_torch_gkt_state` reads the reference's checkpoints.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.base import FLAX_BN_MOMENTUM, BatchNorm, Params
from fedml_tpu_torch.models.vision import Conv2d, nchw


# the edge model's width: the exchanged features' channels
EDGE_WIDTH = 16


def _bn(channels: int) -> BatchNorm:
    return BatchNorm(channels, momentum=FLAX_BN_MOMENTUM)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """A logical NCHW activation as NHWC (the view back of ``nchw``)."""
    return x.permute(0, 2, 3, 1)


class Bottleneck(nn.Module):
    """The CIFAR Bottleneck: a 1x1 reduce to ``planes``, a 3x3 at
    ``stride`` (flax SAME: (0, 1) padding on even inputs at stride 2), a
    1x1 expand to ``planes * expansion``, BatchNorm after each; the
    shortcut is a 1x1 projection at ``stride`` with BatchNorm
    (``downsample_conv``, ``downsample_bn``) whenever the shape changes.
    NCHW in and out."""

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 expansion: int = 4):
        super().__init__()
        out = planes * expansion
        self.conv1 = Conv2d(in_channels, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = Conv2d(planes, out, 1, bias=False)
        self.bn3 = _bn(out)
        self.downsample_conv = self.downsample_bn = None
        if stride != 1 or in_channels != out:
            self.downsample_conv = Conv2d(in_channels, out, 1, stride,
                                          bias=False)
            self.downsample_bn = _bn(out)

    def forward(self, x: torch.Tensor, train: bool = False,
                stats_out: dict | None = None) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x), train, stats_out))
        h = F.relu(self.bn2(self.conv2(h), train, stats_out))
        h = self.bn3(self.conv3(h), train, stats_out)
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x), train,
                                          stats_out)
        return F.relu(h + identity)


class GKTClientResNet(nn.Module):
    """The edge model ``resnet8_56``: the stem (a 3x3 conv of ``width``,
    BatchNorm, ReLU), whose output is the exchanged features, then
    ``num_blocks`` Bottlenecks at planes ``width`` (``layer1_{b}``), the
    spatial mean and the dense ``fc``. ``forward(x)`` returns
    ``(features NHWC, logits)``."""

    def __init__(self, num_classes: int = 10, num_blocks: int = 2,
                 width: int = EDGE_WIDTH, in_channels: int = 3):
        super().__init__()
        self.num_blocks = num_blocks
        self.conv1 = Conv2d(in_channels, width, 3, bias=False)
        self.bn1 = _bn(width)
        cin = width
        for b in range(num_blocks):
            setattr(self, f"layer1_{b}", Bottleneck(cin, width))
            cin = width * 4
        self.fc = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                stats_out: dict | None = None):
        h = F.relu(self.bn1(self.conv1(nchw(x)), train, stats_out))
        features = nhwc(h)
        for b in range(self.num_blocks):
            h = getattr(self, f"layer1_{b}")(h, train, stats_out)
        return features, self.fc(h.mean(dim=(2, 3)))


class GKTServerResNet(nn.Module):
    """The server model ``resnet56_server``: Bottleneck stages at planes
    ``widths`` (``layer{stage}_{b}``; stride 2 into every stage but the
    first) over the edge's NHWC features of ``in_channels``, the spatial
    mean and the dense ``fc`` over ``widths[-1] * 4``."""

    def __init__(self, num_classes: int = 10,
                 blocks_per_stage: Sequence[int] = (6, 6, 6),
                 widths: Sequence[int] = (16, 32, 64),
                 in_channels: int = EDGE_WIDTH):
        super().__init__()
        self.names = []
        cin = in_channels
        for stage, (n, w) in enumerate(zip(blocks_per_stage, widths)):
            for b in range(n):
                stride = 2 if (stage > 0 and b == 0) else 1
                name = f"layer{stage + 1}_{b}"
                setattr(self, name, Bottleneck(cin, w, stride))
                self.names.append(name)
                cin = w * 4
        self.fc = nn.Linear(cin, num_classes)

    def forward(self, features: torch.Tensor, train: bool = False,
                stats_out: dict | None = None) -> torch.Tensor:
        h = nchw(features)
        for name in self.names:
            h = getattr(self, name)(h, train, stats_out)
        return self.fc(h.mean(dim=(2, 3)))


class SplitClientNet(nn.Module):
    """SplitNN's lower stack: per width in ``features`` a 3x3 conv at
    stride 2 (SAME, with bias; ``convs.k``) and ReLU. NHWC in, NHWC
    activations out (the tensor that crosses the cut)."""

    def __init__(self, features: Sequence[int] = (32, 64),
                 in_channels: int = 3):
        super().__init__()
        convs, cin = [], in_channels
        for f in features:
            convs.append(Conv2d(cin, f, 3, 2))
            cin = f
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = nchw(x)
        for conv in self.convs:
            h = F.relu(conv(h))
        return nhwc(h)


class SplitServerNet(nn.Module):
    """SplitNN's upper stack: the NHWC activations flattened in (H, W, C)
    order, a dense ``hidden`` with ReLU and the dense ``head``."""

    def __init__(self, in_features: int, num_classes: int = 10,
                 hidden: int = 128):
        super().__init__()
        self.hidden = nn.Linear(in_features, hidden)
        self.head = nn.Linear(hidden, num_classes)

    def forward(self, acts: torch.Tensor) -> torch.Tensor:
        h = acts.reshape(acts.shape[0], -1)
        return self.head(F.relu(self.hidden(h)))


class VFLLocalModel(nn.Module):
    """A party's feature extractor: a dense ``hidden`` with ReLU, then a
    dense ``out`` of ``out_dim``."""

    def __init__(self, in_features: int, out_dim: int = 32,
                 hidden: int = 64):
        super().__init__()
        self.hidden = nn.Linear(in_features, hidden)
        self.out = nn.Linear(hidden, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(F.relu(self.hidden(x)))


class VFLDenseModel(nn.Module):
    """A party's logit component: one dense layer ``out`` (the guest sums
    the parties' components)."""

    def __init__(self, in_features: int, out_dim: int = 1,
                 use_bias: bool = True):
        super().__init__()
        self.out = nn.Linear(in_features, out_dim, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(x)


def split_out_features(input_shape: Sequence[int],
                       features: Sequence[int] = (32, 64)) -> int:
    """The flattened width of :class:`SplitClientNet`'s activations on
    NHWC inputs of ``input_shape``: each SAME stride-2 conv takes
    ``ceil(size / 2)``."""
    h, w = input_shape[0], input_shape[1]
    for _ in features:
        h, w = math.ceil(h / 2), math.ceil(w / 2)
    return h * w * features[-1]


def load_torch_gkt_state(path: str, variables: Params,
                         side: str = "server") -> Params:
    """Warm start from the reference's torch checkpoint (``best.pth`` of
    ``resnet56``, a ``state_dict`` or ``{"state_dict": ...}``, names
    maybe prefixed ``module.``): ``conv1``, ``bn1`` (the edge's, with
    ``side="client"``), ``layer{i}.{b}.conv{j}``/``bn{j}``,
    ``layer{i}.{b}.downsample.{0,1}`` and ``fc`` onto the port's
    ``layer{i}_{b}`` modules. A key the checkpoint lacks keeps its
    current value. Returns new variables on the variables' devices."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k.replace("module.", ""): v for k, v in sd.items()}
    out = dict(variables)

    def put(dst: str, src: str) -> None:
        if dst in out and src in sd:
            like = out[dst]
            out[dst] = sd[src].to(device=like.device,
                                  dtype=like.dtype).reshape(like.shape)

    def put_bn(dst: str, src: str) -> None:
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            put(f"{dst}.{leaf}", f"{src}.{leaf}")

    if side == "client":
        put("conv1.weight", "conv1.weight")
        put_bn("bn1", "bn1")
    blocks = sorted({k.split(".")[0] for k in variables
                     if k.startswith("layer")})
    for name in blocks:
        i, b = name[len("layer"):].split("_")
        src = f"layer{i}.{b}"
        for j in (1, 2, 3):
            put(f"{name}.conv{j}.weight", f"{src}.conv{j}.weight")
            put_bn(f"{name}.bn{j}", f"{src}.bn{j}")
        put(f"{name}.downsample_conv.weight", f"{src}.downsample.0.weight")
        put_bn(f"{name}.downsample_bn", f"{src}.downsample.1")
    put("fc.weight", "fc.weight")
    put("fc.bias", "fc.bias")
    return out

