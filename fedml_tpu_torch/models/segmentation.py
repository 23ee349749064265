"""The segmentation model: DeepLab-lite, an encoder, atrous spatial
pyramid pooling and a bilinear decoder (``fedml_tpu.models.segmentation``).

The JAX package's stand-in for the reference's DeepLabV3+: strided 3x3
convs encode, dilated 3x3 branches and a global-pool branch see the
encoding at several scales, a 1x1 projection and a 1x1 head give class
logits, and a bilinear resize brings them back to the input's size.
Every BatchNorm is flax's default, momentum 0.99.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.base import FLAX_BN_MOMENTUM, BatchNorm
from fedml_tpu_torch.models.vision import Conv2d, nchw


class DeepLabLite(nn.Module):
    """DeepLab-lite (the model names ``deeplab`` and ``deeplab_lite``):

    - the encoder: per width of ``encoder_features`` a 3x3 conv at stride
      2, BatchNorm and ReLU (``encoder.k``, ``encoder_bn.k``);
    - ASPP: per rate of ``aspp_rates`` a 3x3 conv of that dilation,
      BatchNorm and ReLU (``aspp.k``, ``aspp_bn.k``), and the global pool:
      the spatial mean, a 1x1 conv (``pool_conv``) and a broadcast back
      over the encoding; the branches concatenated in that order;
    - a 1x1 projection with BatchNorm and ReLU (``project``,
      ``project_bn``) and the 1x1 ``head`` (the only conv with a bias);
    - a bilinear resize of the logits to the input's height and width
      (``jax.image.resize``'s "bilinear": half-pixel centres, no
      antialiasing when it enlarges).

    ``forward`` takes NHWC images and returns NHWC logits ``[B, H, W,
    num_classes]``."""

    def __init__(self, num_classes: int = 21,
                 encoder_features: Sequence[int] = (32, 64, 128),
                 aspp_rates: Sequence[int] = (1, 2, 4),
                 aspp_features: int = 128, in_channels: int = 3):
        super().__init__()

        def bn(channels):
            return BatchNorm(channels, momentum=FLAX_BN_MOMENTUM)

        cin = in_channels
        self.encoder, self.encoder_bn = nn.ModuleList(), nn.ModuleList()
        for f in encoder_features:
            self.encoder.append(Conv2d(cin, f, 3, 2, bias=False))
            self.encoder_bn.append(bn(f))
            cin = f
        self.aspp = nn.ModuleList(
            Conv2d(cin, aspp_features, 3, bias=False, dilation=r)
            for r in aspp_rates)
        self.aspp_bn = nn.ModuleList(bn(aspp_features) for _ in aspp_rates)
        self.pool_conv = Conv2d(cin, aspp_features, 1, bias=False)
        self.project = Conv2d(aspp_features * (len(aspp_rates) + 1),
                              aspp_features, 1, bias=False)
        self.project_bn = bn(aspp_features)
        self.head = Conv2d(aspp_features, num_classes, 1)

    def forward(self, x: torch.Tensor, train: bool = False,
                stats_out: dict | None = None) -> torch.Tensor:
        h = nchw(x)
        for conv, bn in zip(self.encoder, self.encoder_bn):
            h = F.relu(bn(conv(h), train, stats_out))
        branches = [F.relu(bn(conv(h), train, stats_out))
                    for conv, bn in zip(self.aspp, self.aspp_bn)]
        pooled = self.pool_conv(h.mean(dim=(2, 3), keepdim=True))
        branches.append(pooled.expand(-1, -1, *h.shape[2:]))
        h = torch.cat(branches, dim=1)
        h = F.relu(self.project_bn(self.project(h), train, stats_out))
        logits = F.interpolate(self.head(h), size=tuple(x.shape[1:3]),
                               mode="bilinear", align_corners=False)
        return logits.permute(0, 2, 3, 1)
