"""The exact space-to-depth layout of the standard CIFAR ResNet
(``fedml_tpu.models.s2d_exact`` at ``cohort=1``).

``resnet<depth>_s2d`` (:class:`~fedml_tpu_torch.models.vision.ResNetCIFAR`
with ``space_to_depth``) is another network. This module runs the SAME
function as the BatchNorm ``resnet<depth>``, with stage 1 in
space-to-depth space (4x the channels at half the resolution), its
weights computed from a standard model's by
:func:`convert_resnet_checkpoint_to_s2d`:

- the input goes through :func:`s2d_rearrange` (channels phase-major);
- a 3x3 stride-1 convolution on the original grid is a 3x3 convolution
  on the s2d grid whose kernel scatters each original tap to one (offset,
  phase) slot (:func:`convert_conv3x3_to_s2d`, 25% dense);
- stage 1's BatchNorm pools its statistics over the 4 phases of each
  original channel (:class:`PhasePooledBatchNorm`), the scale, bias and
  running statistics replicated 4x;
- the stage-2 entry (3x3 stride-2 convolution and 1x1 stride-2 shortcut)
  becomes a 2x2 (and a 1x1) convolution on the s2d grid that returns to
  the natural layout (:class:`TransitionBlock`); stages 2 and 3 and the
  head keep the original weights.

The converters work on HWIO numpy kernels, as the JAX package's do; the
model's weights are OIHW, and :func:`convert_resnet_checkpoint_to_s2d`
moves between the two.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.base import BN_EPS, BatchNorm, batch_norm_update
from fedml_tpu_torch.models.vision import (
    BasicBlock,
    Conv2d,
    nchw,
    s2d_rearrange,
)

PHASES = 4  # the 2x2 patch of a space-to-depth step


def convert_conv3x3_to_s2d(w: np.ndarray) -> np.ndarray:
    """``[3, 3, ci, co]`` stride-1 SAME to ``[3, 3, 4ci, 4co]`` on the s2d
    grid: output pixel ``(2i + a, 2j + b)`` reads original pixel ``(2i + a
    + s, 2j + b + t)``, at s2d offset ``floor((a + s) / 2)``, phase ``(a +
    s) mod 2``."""
    w = np.asarray(w)
    _, _, ci, co = w.shape
    out = np.zeros((3, 3, 4 * ci, 4 * co), w.dtype)
    for a in (0, 1):
        for b in (0, 1):
            for s in (-1, 0, 1):
                for t in (-1, 0, 1):
                    di, u = divmod(a + s, 2)
                    dj, v = divmod(b + t, 2)
                    out[di + 1, dj + 1,
                        (2 * u + v) * ci:(2 * u + v + 1) * ci,
                        (2 * a + b) * co:(2 * a + b + 1) * co] = w[s + 1,
                                                                   t + 1]
    return out


def convert_conv3x3_stride2_to_s2d(w: np.ndarray) -> np.ndarray:
    """``[3, 3, ci, co]`` stride-2 SAME to ``[2, 2, 4ci, co]`` on the s2d
    grid, stride 1, the output in the natural layout. SAME at stride 2 on
    an even extent pads the high edge only, so output pixel ``i`` reads
    original pixels ``2i .. 2i + 2``: offset ``s`` goes to s2d offset ``s
    // 2``, phase ``s % 2``."""
    w = np.asarray(w)
    _, _, ci, co = w.shape
    out = np.zeros((2, 2, 4 * ci, co), w.dtype)
    for s in (0, 1, 2):
        for t in (0, 1, 2):
            di, u = divmod(s, 2)
            dj, v = divmod(t, 2)
            out[di, dj, (2 * u + v) * ci:(2 * u + v + 1) * ci] += w[s, t]
    return out


def convert_conv1x1_stride2_to_s2d(w: np.ndarray) -> np.ndarray:
    """``[1, 1, ci, co]`` stride 2 to ``[1, 1, 4ci, co]`` stride 1 on the
    s2d grid: only phase (0, 0) contributes."""
    w = np.asarray(w)
    _, _, ci, co = w.shape
    out = np.zeros((1, 1, 4 * ci, co), w.dtype)
    out[0, 0, :ci] = w[0, 0]
    return out


def phase_pooled_batch_norm(x: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, mean: torch.Tensor,
                            var: torch.Tensor, train: bool,
                            phases: int = PHASES):
    """The JAX package's ``PhasePooledBatchNorm`` over the channel dim 1 of
    ``x`` (``phases * c`` channels, phase-major); returns ``(y, new_mean,
    new_var)``.

    In train mode the statistics of original channel ``ci`` are taken in
    float32 over the batch, the spatial dims and its ``phases`` phase
    channels, the variance as E[x^2] - E[x]^2 with no clip at 0 (unlike
    :func:`~fedml_tpu_torch.models.base.batch_norm`), and replicated to
    every phase; the running values move with flax's momentum. The
    normalization runs in ``x``'s type: mean, variance, epsilon, scale
    and bias are cast to it first."""
    cw = x.shape[1]
    shape = (1, -1) + (1,) * (x.ndim - 2)
    if train:
        xs = x.float().unflatten(1, (phases, cw // phases))
        dims = [0, 1, *range(3, xs.ndim)]
        mean_c = xs.mean(dims)
        var_c = torch.mean(xs * xs, dims) - mean_c * mean_c
        use_mean, use_var = mean_c.repeat(phases), var_c.repeat(phases)
        new_mean, new_var = batch_norm_update(mean, var, use_mean, use_var)
    else:
        use_mean, use_var, new_mean, new_var = mean, var, mean, var
    y = (x - use_mean.to(x.dtype).reshape(shape)) * torch.rsqrt(
        use_var.to(x.dtype).reshape(shape) + x.new_full((), BN_EPS))
    y = y * scale.to(x.dtype).reshape(shape)
    return y + bias.to(x.dtype).reshape(shape), new_mean, new_var


class PhasePooledBatchNorm(BatchNorm):
    """:func:`phase_pooled_batch_norm` with :class:`BatchNorm`'s
    parameters and buffers at the widened size, so the model's variables
    name it as a BatchNorm and a train-mode call reports its statistics
    through ``stats_out`` (FedAvg averages them, out of the server
    optimizer)."""

    def forward(self, x: torch.Tensor, train: bool = False,
                stats_out: dict | None = None) -> torch.Tensor:
        y, mean, var = phase_pooled_batch_norm(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            train)
        if train:
            stats_out[self] = (mean, var)
        return y


class S2DBasicBlock(nn.Module):
    """A stage-1 basic block in s2d space: ``widened`` channels in and
    out, stride 1, phase-pooled norms, the identity shortcut."""

    def __init__(self, widened: int):
        super().__init__()
        self.conv1 = Conv2d(widened, widened, 3, bias=False)
        self.bn1 = PhasePooledBatchNorm(widened)
        self.conv2 = Conv2d(widened, widened, 3, bias=False)
        self.bn2 = PhasePooledBatchNorm(widened)

    def forward(self, x: torch.Tensor, train: bool = False,
                stats_out: dict | None = None) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train, stats_out))
        y = self.bn2(self.conv2(y), train, stats_out)
        return F.relu(y + x)


class TransitionBlock(nn.Module):
    """The stage-2 entry: the s2d stage-1 output in, the natural stage-2
    activation out. ``conv1`` is the converted stride-2 3x3 kernel, a 2x2
    VALID convolution after an explicit (0, 1) pad of the s2d grid (the
    original SAME pads the high edge only); ``proj`` the converted 1x1
    shortcut, VALID."""

    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, channels, 2, bias=False)
        self.bn1 = BatchNorm(channels)
        self.conv2 = Conv2d(channels, channels, 3, bias=False)
        self.bn2 = BatchNorm(channels)
        self.proj = nn.Conv2d(in_channels, channels, 1, bias=False)
        self.proj_bn = BatchNorm(channels)

    def forward(self, x: torch.Tensor, train: bool = False,
                stats_out: dict | None = None) -> torch.Tensor:
        y = self.conv1(F.pad(x, (0, 1, 0, 1)))  # keeps x's layout
        y = F.relu(self.bn1(y, train, stats_out))
        y = self.bn2(self.conv2(y), train, stats_out)
        return F.relu(y + self.proj_bn(self.proj(x), train, stats_out))


class ResNetCIFARS2DExact(nn.Module):
    """The BatchNorm CIFAR ResNet with stage 1 run in s2d space: the same
    function as ``ResNetCIFAR(depth, norm="bn")`` under
    :func:`convert_resnet_checkpoint_to_s2d`. ``blocks`` holds stage 1's
    ``n`` :class:`S2DBasicBlock`, the :class:`TransitionBlock` and stages 2
    and 3's other blocks at the standard model's indices."""

    def __init__(self, depth: int = 56, num_classes: int = 10,
                 width: int = 16, in_channels: int = 3):
        super().__init__()
        n = (depth - 2) // 6
        w = width
        self.conv = Conv2d(PHASES * in_channels, 4 * w, 3, bias=False)
        self.bn = PhasePooledBatchNorm(4 * w)
        blocks = [S2DBasicBlock(4 * w) for _ in range(n)]
        blocks.append(TransitionBlock(4 * w, 2 * w))
        blocks += [BasicBlock(2 * w, 2 * w) for _ in range(n - 1)]
        blocks += [BasicBlock(2 * w if blk == 0 else 4 * w, 4 * w,
                              2 if blk == 0 else 1) for blk in range(n)]
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(4 * w, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                stats_out: dict | None = None) -> torch.Tensor:
        x = F.relu(self.bn(self.conv(nchw(s2d_rearrange(x))), train,
                           stats_out))
        for block in self.blocks:
            x = block(x, train, stats_out)
        return self.head(x.mean(dim=(2, 3)))


def _oihw_to_s2d(convert, w: torch.Tensor) -> torch.Tensor:
    """``convert`` (an HWIO converter) applied to an OIHW weight."""
    hwio = w.detach().cpu().permute(2, 3, 1, 0).numpy()
    return torch.from_numpy(
        np.ascontiguousarray(convert(hwio).transpose(3, 2, 0, 1)))


def convert_resnet_checkpoint_to_s2d(variables: dict[str, torch.Tensor],
                                     depth: int = 56
                                     ) -> dict[str, torch.Tensor]:
    """The variables of the port's ``ResNetCIFAR(depth, norm="bn")`` to
    :class:`ResNetCIFARS2DExact`'s, on the CPU: the stem and stage 1's
    convolutions converted (:func:`convert_conv3x3_to_s2d`), their norms'
    leaves tiled 4x; block ``n`` (the stage-2 entry) converted to the
    :class:`TransitionBlock`; every other block and the head copied."""
    n = (depth - 2) // 6
    stage1 = ("conv", *(f"blocks.{i}.conv{j}" for i in range(n)
                        for j in (1, 2)))
    pooled = ("bn", *(f"blocks.{i}.bn{j}" for i in range(n) for j in (1, 2)))
    out = {}
    for k, v in variables.items():
        module, _, leaf = k.rpartition(".")
        v = v.detach().cpu()
        if module in stage1:
            v = _oihw_to_s2d(convert_conv3x3_to_s2d, v)
        elif module in pooled:
            v = v.repeat(PHASES)
        elif module == f"blocks.{n}.conv1":
            v = _oihw_to_s2d(convert_conv3x3_stride2_to_s2d, v)
        elif module == f"blocks.{n}.proj":
            v = _oihw_to_s2d(convert_conv1x1_stride2_to_s2d, v)
        out[k] = v.clone()
    return out


__all__ = ["PhasePooledBatchNorm", "ResNetCIFARS2DExact", "S2DBasicBlock",
           "TransitionBlock", "convert_conv1x1_stride2_to_s2d",
           "convert_conv3x3_stride2_to_s2d", "convert_conv3x3_to_s2d",
           "convert_resnet_checkpoint_to_s2d", "phase_pooled_batch_norm",
           "s2d_rearrange"]
