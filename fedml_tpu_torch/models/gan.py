"""The GAN family's models (``fedml_tpu.models.gan``): the conditional and
the unconditional DCGAN image generator, and the ACGAN discriminator.

A generator is a label embedding multiplied elementwise into the noise
(the conditional one), a dense projection ``l1`` to ``ff * init**2``
features laid out as an NHWC ``[B, init, init, ff]`` image, then stride-2
transposed convolutions, each but the last followed by BatchNorm (flax's
default momentum, 0.99) and ReLU, and a tanh. The images come out NHWC,
as the data layer stores real images, so fakes and real batches feed a
classifier alike.

A flax transposed convolution (``ConvTranspose2D``) is a fractionally
strided correlation with its kernel ``[kh, kw, in, out]`` unflipped; the
port stores the same weights as ``F.conv_transpose2d``'s ``[in, out, kh,
kw]``, flipped in both spatial dims (``convert.generator_state_dict``).

The ACGAN discriminator (:class:`ACGANDiscriminator`) is the port's first
model with dropout. Its masks are inputs of the forward pass, drawn
outside it (the simulation's ``"dropout"`` draws), so a train-mode
forward is a function of its inputs and no random op runs inside a
captured graph.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.models.base import (
    FLAX_BN_MOMENTUM,
    BatchNorm,
    FedModel,
    Params,
    weightless,
)
from fedml_tpu_torch.models.vision import Conv2d, nchw


def plan_upsampling(img_size: int, min_init: int = 4) -> tuple[int, int]:
    """The number of stride-2 upsamplings and the starting spatial size:
    the most halvings that keep the start at ``min_init`` or more (MNIST's
    28: two, from 7; CIFAR's 32: three, from 4)."""
    n_ups, size = 0, img_size
    while size % 2 == 0 and size // 2 >= min_init:
        size //= 2
        n_ups += 1
    if n_ups == 0:
        raise ValueError(f"img_size {img_size} too small for a conv pyramid")
    return n_ups, size


def transpose_padding(kernel: int, stride: int) -> tuple[int, int]:
    """``F.conv_transpose2d``'s ``(padding, output_padding)`` for flax's
    SAME transposed convolution: the fractionally strided correlation pads
    ``(lo, hi)`` with ``lo = kernel - 1`` where ``stride > kernel - 1``
    and ``ceil((kernel + stride - 2) / 2)`` otherwise, which torch writes
    as ``padding = kernel - 1 - lo`` and ``output_padding = hi - lo``."""
    total = kernel + stride - 2
    lo = kernel - 1 if stride > kernel - 1 else -(-total // 2)
    hi = total - lo
    if not (0 <= kernel - 1 - lo and 0 <= hi - lo < stride):
        raise ValueError(f"SAME padding ({lo}, {hi}) of kernel {kernel}, "
                         f"stride {stride} has no conv_transpose2d form")
    return kernel - 1 - lo, hi - lo


class ConvTranspose2d(nn.ConvTranspose2d):
    """Flax's SAME ``ConvTranspose2D`` without bias: output size ``in *
    stride``. The weight is ``[in, out, kh, kw]``, flax's kernel flipped
    in both spatial dims."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int):
        padding, output_padding = transpose_padding(kernel_size, stride)
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, bias=False)


class GeneratorPyramid(nn.Module):
    """The shared trunk (``_GeneratorPyramid``): ``l1``, then ``deconvs.k``
    with ``bns.k`` and ReLU, then the last ``deconvs`` entry and tanh."""

    def __init__(self, nz: int, img_size: int, channels: int, ngf: int):
        super().__init__()
        n_ups, self.init_size = plan_upsampling(img_size)
        n_blocks = n_ups - 1
        self.first = ngf * 2 ** n_blocks
        self.l1 = nn.Linear(nz, self.first * self.init_size ** 2)
        widths = [self.first] + [ngf * 2 ** (n_blocks - 1 - i)
                                 for i in range(n_blocks)] + [channels]
        self.deconvs = nn.ModuleList(
            ConvTranspose2d(cin, cout, 4, 2)
            for cin, cout in zip(widths[:-1], widths[1:]))
        self.bns = nn.ModuleList(BatchNorm(w, momentum=FLAX_BN_MOMENTUM)
                                 for w in widths[1:-1])

    def forward(self, h: torch.Tensor, train: bool = False,
                stats_out: dict | None = None) -> torch.Tensor:
        s = self.init_size
        # flax reshapes the projection to NHWC [B, s, s, ff]
        h = nchw(self.l1(h).reshape(h.shape[0], s, s, self.first))
        for deconv, bn in zip(self.deconvs, self.bns):
            h = F.relu(bn(deconv(h), train, stats_out))
        h = torch.tanh(self.deconvs[-1](h))
        # NHWC with the canonical strides of a real batch: with one
        # channel the permuted view counts as contiguous but keeps a
        # stride of H * W on its last dim, and the CPU's convolutions
        # then take another path than for the same values saved and
        # loaded (a checkpointed distillation set)
        return h.permute(0, 2, 3, 1).clone(
            memory_format=torch.contiguous_format)


class ConditionalImageGenerator(nn.Module):
    """``generator(z, labels)``: ``z`` ``[B, nz]``, ``labels`` ``[B]`` ->
    images ``[B, H, W, C]`` in (-1, 1); the input is ``z *
    label_emb(labels)``."""

    def __init__(self, num_classes: int, img_size: int = 32,
                 channels: int = 3, nz: int = 100, ngf: int = 64):
        super().__init__()
        self.label_emb = nn.Embedding(num_classes, nz)
        self.pyramid = GeneratorPyramid(nz, img_size, channels, ngf)

    def forward(self, z, labels, train: bool = False,
                stats_out: dict | None = None) -> torch.Tensor:
        return self.pyramid(z * self.label_emb(labels), train, stats_out)


class ImageGenerator(nn.Module):
    """The unconditional generator: ``generator(z)``."""

    def __init__(self, img_size: int = 32, channels: int = 3, nz: int = 100,
                 ngf: int = 64):
        super().__init__()
        self.pyramid = GeneratorPyramid(nz, img_size, channels, ngf)

    def forward(self, z, train: bool = False,
                stats_out: dict | None = None) -> torch.Tensor:
        return self.pyramid(z, train, stats_out)


def dropout(x: torch.Tensor, mask: torch.Tensor, rate: float
            ) -> torch.Tensor:
    """Flax ``nn.Dropout`` with its mask given: ``mask`` (bool, NHWC, the
    shape of ``x`` in NHWC order) keeps an activation of the logical NCHW
    ``x``, scaled by ``1 / (1 - rate)``, and zeroes the rest. The mask is
    viewed as ``x`` is laid out (:func:`~fedml_tpu_torch.models.vision.
    nchw`: channels_last on the card, contiguous NCHW on the CPU). The
    division is by a tensor: torch's CUDA division by a Python scalar
    multiplies by the reciprocal, which rounds otherwise than the CPU."""
    keep = x / x.new_full((), 1.0 - rate)
    return torch.where(nchw(mask), keep, 0.0)


class ACGANDiscriminator(nn.Module):
    """The ACGAN discriminator (``fedml_tpu.models.gan.ACGANDiscriminator``):
    per width in ``features`` a 3x3 stride-2 SAME convolution without bias
    (``convs.k``), ``leaky_relu(0.2)``, dropout at ``dropout`` and
    BatchNorm (``bns.k``, flax's default momentum 0.99; its batch
    statistics are those of the dropped activations); the (H, W, C)
    flatten; the class head ``cls_hidden`` (dense 128) -> ``cls_out``
    (dense K), no activation between them. With ``validity_head`` it also
    has ``disc_hidden`` (dense 128) -> ``disc_out`` (dense 1), the
    real/fake logit; without it (FedSSGAN's discriminator) those leaves do
    not exist.

    ``forward(x, masks=None, validity=False)``: ``x`` NHWC; ``masks`` one
    bool NHWC tensor per dropout site (:meth:`mask_shapes`), needed in
    train mode when ``dropout > 0`` and ignored in eval mode; returns the
    class logits, or with ``validity`` (class logits, validity ``[B,
    1]``)."""

    def __init__(self, num_classes: int, features: tuple[int, ...] = (
            32, 64, 128), dropout: float = 0.25,
            input_shape: tuple[int, ...] = (28, 28, 1),
            validity_head: bool = True):
        super().__init__()
        self.rate = float(dropout)
        self.validity_head = validity_head
        h, w, cin = input_shape
        self.sites = []
        self.convs, self.bns = nn.ModuleList(), nn.ModuleList()
        for f in features:
            self.convs.append(Conv2d(cin, f, 3, 2, bias=False))
            self.bns.append(BatchNorm(f, momentum=FLAX_BN_MOMENTUM))
            h, w, cin = -(-h // 2), -(-w // 2), f
            self.sites.append((h, w, f))
        width = h * w * cin
        self.cls_hidden = nn.Linear(width, 128)
        self.cls_out = nn.Linear(128, num_classes)
        if validity_head:
            self.disc_hidden = nn.Linear(width, 128)
            self.disc_out = nn.Linear(128, 1)

    def mask_shapes(self) -> dict[str, tuple[int, int, int]]:
        """The NHWC shape of one sample's mask at each dropout site, by
        name (``d0``, ``d1``, ...): at 28x28x1 and the default features
        (14, 14, 32), (7, 7, 64) and (4, 4, 128), 11,456 values."""
        if self.rate == 0.0:
            return {}
        return {f"d{i}": s for i, s in enumerate(self.sites)}

    def forward(self, x: torch.Tensor, masks: dict | None = None,
                validity: bool = False, train: bool = False,
                stats_out: dict | None = None):
        h = nchw(x)
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            h = F.leaky_relu(conv(h), 0.2)
            if train and self.rate > 0.0:
                h = dropout(h, masks[f"d{i}"], self.rate)
            h = bn(h, train, stats_out)
        trunk = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        cls = self.cls_out(self.cls_hidden(trunk))
        if not validity:
            return cls
        return cls, self.disc_out(self.disc_hidden(trunk))


def acgan_discriminator(num_classes: int,
                        input_shape: tuple[int, ...] = (28, 28, 1),
                        features: tuple[int, ...] = (32, 64, 128),
                        dropout: float = 0.25, validity_head: bool = True,
                        device: str | torch.device = "cuda") -> FedModel:
    """:class:`ACGANDiscriminator` as a
    :class:`~fedml_tpu_torch.models.base.FedModel` on ``device``."""
    module = weightless(lambda: ACGANDiscriminator(
        num_classes, tuple(features), dropout, tuple(input_shape),
        validity_head))
    return FedModel(module, tuple(input_shape), resolve_device(device))


@dataclasses.dataclass(frozen=True)
class GanModel:
    """A generator as a value (``fedml_tpu.models.gan.GanModel``): its
    variables come from :meth:`init` and go through :meth:`apply_train`
    (which returns the new BatchNorm statistics) and :meth:`apply_eval`.
    The draws of noise and fake labels are the simulation's (its
    ``draws`` hook), not the model's."""

    model: FedModel
    nz: int
    num_classes: int
    conditional: bool = True

    @property
    def stat_names(self) -> tuple[str, ...]:
        return self.model.stat_names

    def init(self, generator: torch.Generator) -> Params:
        return self.model.init(generator)

    def _inputs(self, z, labels):
        return (z, labels) if self.conditional else (z,)

    def apply_train(self, variables: Params, z, labels=None):
        """Train mode: BatchNorm on the batch's statistics; returns
        (images, variables with the new statistics)."""
        return self.model.apply_train(variables, *self._inputs(z, labels))

    def apply_eval(self, variables: Params, z, labels=None) -> torch.Tensor:
        return self.model.apply_eval(variables, *self._inputs(z, labels))

    def balanced_labels(self, n: int) -> torch.Tensor:
        """Class ``i % K`` for row ``i``: every class ceil or floor of
        ``n / K`` times."""
        return torch.arange(n, device=self.model.device) % self.num_classes


def generator_from_config(gan_cfg, num_classes: int, img_size: int,
                          channels: int, conditional: bool = True,
                          device: str | torch.device = "cuda") -> GanModel:
    """The generator of ``gan_cfg`` (its ``nz`` and ``ngf``) on
    ``device``."""
    dev = resolve_device(device)
    nz, ngf = gan_cfg.nz, gan_cfg.ngf
    if conditional:
        module = weightless(lambda: ConditionalImageGenerator(
            num_classes, img_size, channels, nz, ngf))
    else:
        module = weightless(lambda: ImageGenerator(img_size, channels, nz,
                                                   ngf))
    return GanModel(FedModel(module, (nz,), dev), nz,
                    num_classes if conditional else 0, conditional)
