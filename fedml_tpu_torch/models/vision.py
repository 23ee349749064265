"""Vision models: logistic regression, the FedAvg-paper CNN, the fork's
parameterised CNNs, the CIFAR ResNets with BatchNorm or GroupNorm,
ResNet-18 with GroupNorm and MobileNet (V1).

Same architectures as ``fedml_tpu.models.vision`` at ``cohort=1``, the
CIFAR ResNets with and without ``space_to_depth``. Inputs are NHWC, as
the data layer stores them; the conv models view them as NCHW at their
input (:func:`nchw`), and conv weights are OIHW. Flax's "SAME" padding
is reproduced exactly: at stride 2 on an even input it pads (0, 1),
which no ``nn.Conv2d(padding=...)`` can express.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.base import BatchNorm, GroupNorm


def same_padding(in_spatial, kernel_spatial, strides
                 ) -> tuple[tuple[int, int], ...]:
    """Flax/XLA "SAME" padding as (lo, hi) pairs per spatial dim: the
    output has ceil(in / stride) positions, and the odd pixel of padding
    goes after (``fedml_tpu.ops.cohort_conv._resolve_padding``, no
    dilation)."""
    out = []
    for i, k, s in zip(in_spatial, kernel_spatial, strides):
        o = -(-i // s)
        total = max((o - 1) * s + k - i, 0)
        out.append((total // 2, total - total // 2))
    return tuple(out)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC batch as a logical NCHW tensor. On the card it is the view
    ``x.permute(0, 3, 1, 2)``, whose memory stays NHWC (torch's
    ``channels_last``): the layout cuDNN's NHWC convolutions read, which
    the activations then keep. On the CPU it is copied to contiguous NCHW:
    torch's oneDNN float32 convolution backward on ``channels_last``
    tensors aborts at random there when it runs on several threads
    (torch 2.13, CPU build)."""
    x = x.permute(0, 3, 1, 2)
    return x if x.is_cuda else x.contiguous()


def s2d_rearrange(x: torch.Tensor) -> torch.Tensor:
    """Space to depth: NHWC ``[B, H, W, c]`` to ``[B, H/2, W/2, 4c]``,
    the channels phase-major, ``(2u + v) c + ci`` for the pixel at
    offset ``(u, v)`` of its 2x2 patch (the JAX package's
    ``s2d_rearrange`` at ``cohort=1``). ``pixel_unshuffle`` orders them
    channel-major, ``4 ci + 2u + v``, which is another layout. The result
    is a contiguous NHWC tensor, so :func:`nchw` views it channels_last
    on the card."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax's ``padding="SAME"``, resolved from the
    input's size at every call. ``groups`` is flax's
    ``feature_group_count`` (``in_channels`` for a depthwise conv)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, bias: bool = True, groups: int = 1):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding=0, bias=bias, groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (top, bottom), (left, right) = same_padding(
            x.shape[2:], self.kernel_size, self.stride)
        if top == bottom and left == right:
            return F.conv2d(x, self.weight, self.bias, self.stride,
                            (top, left), groups=self.groups)
        x = F.pad(x, (left, right, top, bottom))  # keeps x's layout
        return F.conv2d(x, self.weight, self.bias, self.stride,
                        groups=self.groups)


def norm_layer(kind: str, channels: int) -> nn.Module:
    """The JAX package's ``_norm`` at ``cohort=1``: "bn" is flax
    BatchNorm (momentum 0.9), "gn" flax GroupNorm with 2 groups."""
    if kind == "bn":
        return BatchNorm(channels)
    if kind == "gn":
        return GroupNorm(2, channels)
    raise ValueError(f"unknown norm {kind!r} (the port has bn and gn)")


class LogisticRegression(nn.Module):
    """Flatten (in NHWC order) -> dense."""

    def __init__(self, num_classes: int = 10,
                 input_shape: tuple[int, ...] = (28, 28, 1)):
        super().__init__()
        self.linear = nn.Linear(math.prod(input_shape), num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x.reshape(x.shape[0], -1))


class CNNOriginalFedAvg(nn.Module):
    """2 x (conv5x5 + maxpool) + dense-512 CNN from the FedAvg paper."""

    def __init__(self, num_classes: int = 62,
                 input_shape: tuple[int, ...] = (28, 28, 1)):
        super().__init__()
        h, w, cin = input_shape
        self.conv1 = Conv2d(cin, 32, 5)
        self.conv2 = Conv2d(32, 64, 5)
        self.fc1 = nn.Linear((h // 4) * (w // 4) * 64, 512)
        self.head = nn.Linear(512, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.max_pool2d(F.relu(self.conv1(nchw(x))), 2, 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2, 2)
        # the dense layers read the reference's (H, W, C) flatten order
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.head(F.relu(self.fc1(x)))


class CNNParameterised(nn.Module):
    """The configurable conv stack of the fork's heterogeneous clients
    (``cnn_small``, ``cnn_medium``, ``cnn_large``, ``cnn_custom``): per
    width in ``conv_channels`` a 3x3 SAME conv with bias, ReLU and a VALID
    2x2 max-pool; the (H, W, C) flatten; per width in ``dense_sizes`` a
    dense layer ``fc<i>`` with ReLU; the dense ``head``. The convs are
    ``convs.k``, flax's ``Conv2D_k``."""

    def __init__(self, num_classes: int = 10,
                 conv_channels: tuple[int, ...] = (32, 64),
                 dense_sizes: tuple[int, ...] = (128,),
                 input_shape: tuple[int, ...] = (28, 28, 1),
                 dropout: float = 0.0):
        super().__init__()
        if dropout > 0:
            raise NotImplementedError(
                f"CNNParameterised dropout={dropout} is not ported to "
                "fedml_tpu_torch yet (ROADMAP: Queue A item 13b, dropout "
                "with a mask-replay hook)")
        h, w, cin = input_shape
        self.convs = nn.ModuleList()
        for ch in conv_channels:
            self.convs.append(Conv2d(cin, ch, 3))
            cin, h, w = ch, h // 2, w // 2
        width = h * w * cin
        self.n_dense = len(dense_sizes)
        for i, d in enumerate(dense_sizes):
            setattr(self, f"fc{i + 1}", nn.Linear(width, d))
            width = d
        self.head = nn.Linear(width, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nchw(x)
        for conv in self.convs:
            x = F.max_pool2d(F.relu(conv(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for i in range(self.n_dense):
            x = F.relu(getattr(self, f"fc{i + 1}")(x))
        return self.head(x)


class BasicBlock(nn.Module):
    """CIFAR ResNet basic block; a block that changes the shape projects
    its shortcut with a 1x1 conv and a norm. ``norm`` is "bn" or "gn"
    (:func:`norm_layer`); the norm layers are ``bn1``, ``bn2`` and
    ``proj_bn`` whichever it is."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1,
                 norm: str = "bn"):
        super().__init__()
        self.conv1 = Conv2d(in_channels, channels, 3, stride, bias=False)
        self.bn1 = norm_layer(norm, channels)
        self.conv2 = Conv2d(channels, channels, 3, bias=False)
        self.bn2 = norm_layer(norm, channels)
        self.proj = self.proj_bn = None
        if stride != 1 or in_channels != channels:
            self.proj = Conv2d(in_channels, channels, 1, stride, bias=False)
            self.proj_bn = norm_layer(norm, channels)

    def forward(self, x: torch.Tensor, train: bool = False,
                stats_out: dict | None = None) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train, stats_out))
        y = self.bn2(self.conv2(y), train, stats_out)
        if self.proj is not None:
            x = self.proj_bn(self.proj(x), train, stats_out)
        return F.relu(y + x)


class ResNetCIFAR(nn.Module):
    """3-stage CIFAR ResNet: depth = 6n + 2 (resnet56: n = 9), stage widths
    (width, 2 width, 4 width), strides (1, 2, 2), a global mean pool and a
    dense head; ``norm`` "bn" (BatchNorm) or "gn" (GroupNorm, 2 groups).

    ``space_to_depth`` is the JAX package's "_s2d" parameterization, a
    different network: the input goes through :func:`s2d_rearrange`
    (``[H, W, c]`` to ``[H/2, W/2, 4c]``), the stage widths are (4 width,
    2 width, 4 width) and the strides (1, 1, 2), so stages 2 and 3 keep
    their resolutions."""

    def __init__(self, depth: int = 56, num_classes: int = 10,
                 width: int = 16, in_channels: int = 3, norm: str = "bn",
                 space_to_depth: bool = False):
        super().__init__()
        n = (depth - 2) // 6
        self.space_to_depth = space_to_depth
        if space_to_depth:
            widths, strides = (4 * width, 2 * width, 4 * width), (1, 1, 2)
            in_channels *= 4
        else:
            widths, strides = (width, 2 * width, 4 * width), (1, 2, 2)
        self.conv = Conv2d(in_channels, widths[0], 3, bias=False)
        self.bn = norm_layer(norm, widths[0])
        blocks, cin = [], widths[0]
        for stage, (ch, st) in enumerate(zip(widths, strides)):
            for blk in range(n):
                stride = st if (stage > 0 and blk == 0) else 1
                blocks.append(BasicBlock(cin, ch, stride, norm))
                cin = ch
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                stats_out: dict | None = None) -> torch.Tensor:
        if self.space_to_depth:
            x = s2d_rearrange(x)
        x = F.relu(self.bn(self.conv(nchw(x)), train, stats_out))
        for block in self.blocks:
            x = block(x, train, stats_out)
        return self.head(x.mean(dim=(2, 3)))


class ResNet18GN(nn.Module):
    """ImageNet-style ResNet-18 with GroupNorm (2 groups), for fed_cifar100:
    a 3x3 stem of 64 channels at stride 1, four stages of two basic blocks
    at widths 64, 128, 256 and 512 (stride 2 into stages 2-4), a global
    mean pool and a dense head; about 11M parameters at 100 classes."""

    def __init__(self, num_classes: int = 100, in_channels: int = 3):
        super().__init__()
        self.conv = Conv2d(in_channels, 64, 3, bias=False)
        self.bn = GroupNorm(2, 64)
        blocks, cin = [], 64
        for stage, ch in enumerate((64, 128, 256, 512)):
            for blk in range(2):
                stride = 2 if (stage > 0 and blk == 0) else 1
                blocks.append(BasicBlock(cin, ch, stride, "gn"))
                cin = ch
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn(self.conv(nchw(x))))
        for block in self.blocks:
            x = block(x)
        return self.head(x.mean(dim=(2, 3)))


class DepthwiseSeparable(nn.Module):
    """A 3x3 depthwise conv (one filter per input channel, at ``stride``)
    and a 1x1 pointwise conv to ``channels``, each followed by BatchNorm
    and a ReLU; no conv has a bias."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1):
        super().__init__()
        self.dw = Conv2d(in_channels, in_channels, 3, stride, bias=False,
                         groups=in_channels)
        self.dw_bn = BatchNorm(in_channels)
        self.pw = Conv2d(in_channels, channels, 1, bias=False)
        self.pw_bn = BatchNorm(channels)

    def forward(self, x: torch.Tensor, train: bool = False,
                stats_out: dict | None = None) -> torch.Tensor:
        x = F.relu(self.dw_bn(self.dw(x), train, stats_out))
        return F.relu(self.pw_bn(self.pw(x), train, stats_out))


# MobileNet V1's depthwise-separable blocks: (channels, stride)
MOBILENET_PLAN = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
                  *((512, 1),) * 5, (1024, 2), (1024, 1))


class MobileNet(nn.Module):
    """MobileNet V1: a 3x3 stem of 32 channels at stride 1 with BatchNorm,
    the 13 blocks of ``MOBILENET_PLAN``, a global mean pool and a dense
    head. Every width ``ch`` becomes ``max(8, int(ch * width_mult))``."""

    def __init__(self, num_classes: int = 10, width_mult: float = 1.0,
                 in_channels: int = 3):
        super().__init__()

        def c(ch):
            return max(8, int(ch * width_mult))

        self.conv = Conv2d(in_channels, c(32), 3, bias=False)
        self.bn = BatchNorm(c(32))
        blocks, cin = [], c(32)
        for ch, stride in MOBILENET_PLAN:
            blocks.append(DepthwiseSeparable(cin, c(ch), stride))
            cin = c(ch)
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                stats_out: dict | None = None) -> torch.Tensor:
        x = F.relu(self.bn(self.conv(nchw(x)), train, stats_out))
        for block in self.blocks:
            x = block(x, train, stats_out)
        return self.head(x.mean(dim=(2, 3)))
