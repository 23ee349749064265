"""The DARTS search space of FedNAS (``fedml_tpu.models.darts``).

A mixed op runs every candidate of :data:`PRIMITIVES` on its input,
stacks the outputs ``[P, B, C, H, W]`` and contracts them with
``softmax(alpha)`` of its edge. Every mixed op runs at stride 1: a cell
aligns its inputs and reduces by slicing ``[::2, ::2]``, never by a
strided convolution, as in the JAX package. The pools use flax's SAME
window: the average always divides by 9, the padding counted; the max
pads with ``-inf``. The separable and dilated convs are a depthwise 3x3
(dilation 1 or 2), a 1x1 and a BatchNorm at flax's momentum 0.99.

The architecture weights (``alphas_normal`` and ``alphas_reduce``,
``[num_edges, |PRIMITIVES|]``, drawn ``1e-3 * normal``) are parameters of
the network's top module, apart from the weights: :data:`ARCH` names
them, so the architect and the weight optimizer address them apart (the
JAX package's ``"arch"`` collection). Inputs are NHWC; the module names
follow flax's automatic ones (``cells.k.mixed.m.sep``/``dil``), mapped by
``convert.darts_state_dict``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.base import FLAX_BN_MOMENTUM, BatchNorm, Params
from fedml_tpu_torch.models.vision import Conv2d, nchw

PRIMITIVES = (
    "none",
    "skip_connect",
    "avg_pool_3x3",
    "max_pool_3x3",
    "sep_conv_3x3",
    "dil_conv_3x3",
)

# the architecture weights' names among the network's variables
ARCH = ("alphas_normal", "alphas_reduce")


class SepConv(nn.Module):
    """ReLU, a depthwise 3x3 at ``dilation`` (SAME, ``depthwise``), a 1x1
    (``pointwise``), BatchNorm (``bn``); no bias."""

    def __init__(self, channels: int, dilation: int = 1):
        super().__init__()
        self.depthwise = Conv2d(channels, channels, 3, bias=False,
                                groups=channels, dilation=dilation)
        self.pointwise = Conv2d(channels, channels, 1, bias=False)
        self.bn = BatchNorm(channels, momentum=FLAX_BN_MOMENTUM)

    def forward(self, x, train=False, stats_out=None):
        h = self.pointwise(self.depthwise(F.relu(x)))
        return self.bn(h, train, stats_out)


class MixedOp(nn.Module):
    """The ``softmax(alpha)``-weighted sum of every primitive at stride 1:
    zero, identity, the 3x3 average pool (always over 9), the 3x3 max pool
    (``-inf`` padding), ``sep`` (dilation 1) and ``dil`` (dilation 2)."""

    def __init__(self, channels: int):
        super().__init__()
        self.sep = SepConv(channels, 1)
        self.dil = SepConv(channels, 2)

    def forward(self, x, weights, train=False, stats_out=None):
        outs = [
            torch.zeros_like(x),
            x,
            F.avg_pool2d(x, 3, 1, 1, count_include_pad=True),
            F.max_pool2d(x, 3, 1, 1),
            self.sep(x, train, stats_out),
            self.dil(x, train, stats_out),
        ]
        return torch.einsum("p,pbchw->bchw", weights, torch.stack(outs))


def num_edges(steps: int) -> int:
    return sum(2 + i for i in range(steps))


def _halve(x: torch.Tensor) -> torch.Tensor:
    return x[:, :, ::2, ::2]


class SearchCell(nn.Module):
    """A DARTS cell of ``steps`` nodes, each the sum of mixed ops from
    every earlier state. ``s0`` (two cells back) is first sliced to
    ``s1``'s size when they differ; both go through a 1x1 to ``channels``
    (``pre0``, ``pre1``), and a reduction cell slices both. The output is
    the last ``steps`` states, concatenated on the channels."""

    def __init__(self, in0: int, in1: int, channels: int, steps: int = 4,
                 reduction: bool = False):
        super().__init__()
        self.steps, self.reduction = steps, reduction
        self.pre0 = Conv2d(in0, channels, 1, bias=False)
        self.pre1 = Conv2d(in1, channels, 1, bias=False)
        self.mixed = nn.ModuleList(MixedOp(channels)
                                   for _ in range(num_edges(steps)))

    def forward(self, s0, s1, weights, train=False, stats_out=None):
        if s0.shape[2] != s1.shape[2]:
            s0 = _halve(s0)
        s0, s1 = self.pre0(s0), self.pre1(s1)
        if self.reduction:
            s0, s1 = _halve(s0), _halve(s1)
        states, offset = [s0, s1], 0
        for _ in range(self.steps):
            acc = 0.0
            for j, h in enumerate(states):
                acc = acc + self.mixed[offset + j](h, weights[offset + j],
                                                   train, stats_out)
            offset += len(states)
            states.append(acc)
        return torch.cat(states[-self.steps:], dim=1)


class DARTSNetwork(nn.Module):
    """The searchable network: a 3x3 stem of ``init_channels`` with
    BatchNorm (``stem``, ``stem_bn``), ``layers`` cells (``cells.k``; the
    cells at ``layers // 3`` and ``2 * layers // 3`` reduce and double
    the channels), the spatial mean and the dense ``head``."""

    def __init__(self, num_classes: int = 10, init_channels: int = 16,
                 layers: int = 4, steps: int = 4, in_channels: int = 3):
        super().__init__()
        e = num_edges(steps)
        self.alphas_normal = nn.Parameter(torch.zeros(e, len(PRIMITIVES)))
        self.alphas_reduce = nn.Parameter(torch.zeros(e, len(PRIMITIVES)))
        c = init_channels
        self.stem = Conv2d(in_channels, c, 3, bias=False)
        self.stem_bn = BatchNorm(c, momentum=FLAX_BN_MOMENTUM)
        cells, in0, in1 = [], c, c
        self.reductions = []
        for layer in range(layers):
            reduction = layer in (layers // 3, 2 * layers // 3)
            if reduction:
                c *= 2
            cells.append(SearchCell(in0, in1, c, steps, reduction))
            self.reductions.append(reduction)
            in0, in1 = in1, steps * c
        self.cells = nn.ModuleList(cells)
        self.head = nn.Linear(in1, num_classes)

    def init_leaf(self, leaf: str, shape, gen: torch.Generator):
        """``1e-3 * normal``, the JAX package's draw of the alphas."""
        return 1e-3 * torch.randn(shape, generator=gen)

    def forward(self, x, train=False, stats_out=None):
        w_n = torch.softmax(self.alphas_normal, dim=-1)
        w_r = torch.softmax(self.alphas_reduce, dim=-1)
        h = self.stem_bn(self.stem(nchw(x)), train, stats_out)
        s0 = s1 = h
        for cell, reduction in zip(self.cells, self.reductions):
            out = cell(s0, s1, w_r if reduction else w_n, train, stats_out)
            s0, s1 = s1, out
        return self.head(s1.mean(dim=(2, 3)))


def derive_genotype(variables: Params) -> dict:
    """The discrete architecture by argmax: for each node the two
    strongest incoming edges (an edge's strength its best op other than
    ``none``), each with that op, in edge order; ``{"alphas_normal":
    [(op, edge), ...], "alphas_reduce": [...]}``."""
    out = {}
    none_idx = PRIMITIVES.index("none")
    for key in ARCH:
        alphas = torch.softmax(variables[key].detach().float(), dim=-1)
        alphas = alphas.cpu().numpy()
        gene, offset, steps = [], 0, 0
        while num_edges(steps) < alphas.shape[0]:
            steps += 1
        for i in range(steps):
            k = 2 + i
            best_op = alphas[offset:offset + k].copy()
            best_op[:, none_idx] = -1
            top2 = best_op.max(axis=-1).argsort()[-2:][::-1]
            for j in sorted(top2):
                gene.append((PRIMITIVES[int(best_op[j].argmax())], int(j)))
            offset += k
        out[key] = gene
    return out

