"""The rest of the model zoo: MobileNetV3, EfficientNet and LeNet.

Same architectures as ``fedml_tpu.models.vision_extra``: the mobile
inverted bottleneck (:class:`MBConv`, with squeeze-excite and h-swish),
MobileNetV3-small's block table, EfficientNet-B<k> by compound scaling of
the B0 stage table, and the mobile LeNet. Inputs are NHWC, viewed as
NCHW at the input (``models/vision.py`` ``nchw``). Every BatchNorm here is
flax's default, momentum 0.99 (``FLAX_BN_MOMENTUM``), not the 0.9 of the
CIFAR ResNets. A depthwise conv is ``groups = channels``; under the
cohort's ``torch.func.vmap`` cuDNN runs it as one conv of ``groups =
channels x lanes``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.base import FLAX_BN_MOMENTUM, BatchNorm
from fedml_tpu_torch.models.vision import Conv2d, nchw


def _sixth(x: torch.Tensor) -> torch.Tensor:
    """``x / 6``, divided by a tensor: torch's CUDA division by a Python
    scalar multiplies by the reciprocal, which rounds otherwise than the
    CPU."""
    return x / x.new_full((), 6.0)


def hswish(x: torch.Tensor) -> torch.Tensor:
    """``x * relu6(x + 3) / 6``, the JAX package's form (the plain
    reference; ``F.hardswish`` computes the same function)."""
    return _sixth(x * F.relu6(x + 3.0))


def hsigmoid(x: torch.Tensor) -> torch.Tensor:
    return _sixth(F.relu6(x + 3.0))


ACTIVATIONS = {"swish": F.silu, "hswish": hswish, "relu": F.relu}


def _bn(channels: int) -> BatchNorm:
    return BatchNorm(channels, momentum=FLAX_BN_MOMENTUM)


class SqueezeExcite(nn.Module):
    """The spatial mean, a dense layer of ``max(c // reduce, 8)`` with
    ReLU (``fc1``), a dense layer of ``c`` with h-sigmoid (``fc2``), and
    the input scaled by it channel by channel."""

    def __init__(self, channels: int, reduce: int = 4):
        super().__init__()
        hidden = max(channels // reduce, 8)
        self.fc1 = nn.Linear(channels, hidden)
        self.fc2 = nn.Linear(hidden, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.fc1(x.mean(dim=(2, 3))))
        s = hsigmoid(self.fc2(s))
        return x * s[:, :, None, None]


class MBConv(nn.Module):
    """Mobile inverted bottleneck: at ``expand`` above 1 a 1x1 expansion
    to ``in_channels * expand`` (``expand_conv``, ``expand_bn``, the
    activation); a depthwise ``kernel`` x ``kernel`` conv at ``stride``
    (``dw``, ``dw_bn``, the activation); optional squeeze-excite (``se``);
    a 1x1 projection (``project``, ``project_bn``, no activation); the
    input added back at stride 1 when the widths agree. No conv has a
    bias. ``act`` is "swish" (``F.silu``), "hswish" or "relu"."""

    def __init__(self, in_channels: int, out_channels: int, expand: int = 4,
                 kernel: int = 3, stride: int = 1, use_se: bool = True,
                 act: str = "swish"):
        super().__init__()
        self.act = ACTIVATIONS[act]
        mid = in_channels * expand
        self.expand_conv = self.expand_bn = None
        if expand != 1:
            self.expand_conv = Conv2d(in_channels, mid, 1, bias=False)
            self.expand_bn = _bn(mid)
        self.dw = Conv2d(mid, mid, kernel, stride, bias=False, groups=mid)
        self.dw_bn = _bn(mid)
        self.se = SqueezeExcite(mid) if use_se else None
        self.project = Conv2d(mid, out_channels, 1, bias=False)
        self.project_bn = _bn(out_channels)
        self.residual = stride == 1 and in_channels == out_channels

    def forward(self, x: torch.Tensor, train: bool = False,
                stats_out: dict | None = None) -> torch.Tensor:
        h = x
        if self.expand_conv is not None:
            h = self.act(self.expand_bn(self.expand_conv(h), train,
                                        stats_out))
        h = self.act(self.dw_bn(self.dw(h), train, stats_out))
        if self.se is not None:
            h = self.se(h)
        h = self.project_bn(self.project(h), train, stats_out)
        return h + x if self.residual else h


# MobileNetV3-small's bottlenecks: (out, expand, kernel, stride, SE, act)
MOBILENET_V3_BLOCKS = (
    (16, 1, 3, 2, True, "relu"),
    (24, 4, 3, 2, False, "relu"),
    (24, 3, 3, 1, False, "relu"),
    (40, 3, 5, 2, True, "hswish"),
    (40, 3, 5, 1, True, "hswish"),
    (48, 3, 5, 1, True, "hswish"),
    (96, 6, 5, 2, True, "hswish"),
)


class MobileNetV3(nn.Module):
    """MobileNetV3-small style (the model name ``mobilenet_v3``): a 3x3
    stem at stride 2 with BatchNorm and h-swish (``stem``, ``stem_bn``),
    the bottlenecks of ``MOBILENET_V3_BLOCKS`` (``blocks.k``), a 1x1 conv
    to 288 with BatchNorm and h-swish (``last``, ``last_bn``), the global
    mean, a dense 1024 with h-swish (``fc1``) and the dense ``head``.
    Every width ``ch`` becomes ``max(8, int(ch * width_mult))``."""

    def __init__(self, num_classes: int = 10, width_mult: float = 1.0,
                 in_channels: int = 3):
        super().__init__()

        def c(ch):
            return max(8, int(ch * width_mult))

        self.stem = Conv2d(in_channels, c(16), 3, 2, bias=False)
        self.stem_bn = _bn(c(16))
        blocks, cin = [], c(16)
        for out, expand, kernel, stride, se, act in MOBILENET_V3_BLOCKS:
            blocks.append(MBConv(cin, c(out), expand, kernel, stride, se,
                                 act))
            cin = c(out)
        self.blocks = nn.ModuleList(blocks)
        self.last = Conv2d(cin, c(288), 1, bias=False)
        self.last_bn = _bn(c(288))
        self.fc1 = nn.Linear(c(288), c(1024))
        self.head = nn.Linear(c(1024), num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                stats_out: dict | None = None) -> torch.Tensor:
        h = hswish(self.stem_bn(self.stem(nchw(x)), train, stats_out))
        for block in self.blocks:
            h = block(h, train, stats_out)
        h = hswish(self.last_bn(self.last(h), train, stats_out))
        h = hswish(self.fc1(h.mean(dim=(2, 3))))
        return self.head(h)


# EfficientNet-B0's stages: (out, expand, kernel, stride, repeats)
EFFICIENTNET_STAGES = (
    (16, 1, 3, 1, 1),
    (24, 6, 3, 2, 2),
    (40, 6, 5, 2, 2),
    (80, 6, 3, 2, 3),
    (112, 6, 5, 1, 3),
    (192, 6, 5, 2, 4),
    (320, 6, 3, 1, 1),
)
# efficientnet-b0 .. b7: (width, depth) coefficients
EFFICIENTNET_PARAMS = {
    "b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2), "b3": (1.2, 1.4),
    "b4": (1.4, 1.8), "b5": (1.6, 2.2), "b6": (1.8, 2.6), "b7": (2.0, 3.1),
}


class EfficientNet(nn.Module):
    """EfficientNet-B<k> by compound scaling (the model names
    ``efficientnet-b0`` .. ``b7``): a 3x3 stem at stride 2 with BatchNorm
    and swish (``stem``, ``stem_bn``), the stages of
    ``EFFICIENTNET_STAGES`` as swish bottlenecks with squeeze-excite
    (``blocks.k``; only a stage's first repeat takes its stride), a 1x1
    conv to 1280 with BatchNorm and swish (``last``, ``last_bn``), the
    global mean and the dense ``head``. A width ``ch`` becomes ``max(8,
    int(ch * w + 4) // 8 * 8)``, plus 8 where that is below ``0.9 * ch *
    w``; a stage's repeats ``r`` become ``ceil(r * d)``."""

    def __init__(self, num_classes: int = 10, width_coef: float = 1.0,
                 depth_coef: float = 1.0, in_channels: int = 3):
        super().__init__()

        def width(ch):
            ch = ch * width_coef
            new = max(8, int(ch + 4) // 8 * 8)
            if new < 0.9 * ch:
                new += 8
            return int(new)

        self.stem = Conv2d(in_channels, width(32), 3, 2, bias=False)
        self.stem_bn = _bn(width(32))
        blocks, cin = [], width(32)
        for out, expand, kernel, stride, repeats in EFFICIENTNET_STAGES:
            for r in range(int(math.ceil(repeats * depth_coef))):
                blocks.append(MBConv(cin, width(out), expand, kernel,
                                     stride if r == 0 else 1, True, "swish"))
                cin = width(out)
        self.blocks = nn.ModuleList(blocks)
        self.last = Conv2d(cin, width(1280), 1, bias=False)
        self.last_bn = _bn(width(1280))
        self.head = nn.Linear(width(1280), num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                stats_out: dict | None = None) -> torch.Tensor:
        h = F.silu(self.stem_bn(self.stem(nchw(x)), train, stats_out))
        for block in self.blocks:
            h = block(h, train, stats_out)
        h = F.silu(self.last_bn(self.last(h), train, stats_out))
        return self.head(h.mean(dim=(2, 3)))


class LeNet(nn.Module):
    """The mobile LeNet (the model name ``lenet``): two 5x5 SAME convs with
    bias of 20 and 50 channels (``conv1``, ``conv2``), each followed by a
    2x2 max-pool and then a ReLU; the (H, W, C) flatten (7 x 7 x 50 =
    2,450 at 28x28), a dense 500 with ReLU (``fc1``) and the dense
    ``head``."""

    def __init__(self, num_classes: int = 10,
                 input_shape: tuple[int, ...] = (28, 28, 1)):
        super().__init__()
        h, w, cin = input_shape
        self.conv1 = Conv2d(cin, 20, 5)
        self.conv2 = Conv2d(20, 50, 5)
        self.fc1 = nn.Linear((h // 4) * (w // 4) * 50, 500)
        self.head = nn.Linear(500, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(F.max_pool2d(self.conv1(nchw(x)), 2, 2))
        x = F.relu(F.max_pool2d(self.conv2(x), 2, 2))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.head(F.relu(self.fc1(x)))
