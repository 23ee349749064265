"""FID scoring: activation statistics and the Frechet distance
(``fedml_tpu.metrics.fid``).

The reference scores FID with a pretrained InceptionV3, whose weights
are not in the repo, so the feature extractor is pluggable, in this
order (:func:`make_fid_scorer`): a TorchScript file
(:class:`TorchScriptEmbed`, FID comparable to published numbers), a
small CNN trained on labelled real data (:class:`TrainedCNNEmbed`,
class-aware features), else a fixed-seed random conv embedding
(:class:`RandomConvEmbed`), which keeps FID's ordering within a run.

Both conv embeds are flax's layout: a 3x3 stride-2 SAME conv of 32
channels, ReLU, one of 64, ReLU, a spatial mean, a dense layer. Their
weights come from a seeded ``torch.Generator`` with flax's initializers
(lecun-normal kernels, zero biases), not from flax's threefry draws, so
an FID of the default embed compares only with another of this package.
Both take a replay hook for their start (``start=``, the port's
variables), and ``fit`` one for its batch permutations (``perms=``),
with which a test replays the JAX package's.

The trace-sqrt term is taken eigenvalue-wise: for PSD S1, S2 the
eigenvalues of S1 S2 are real and non-negative, so
``tr(sqrt(S1 S2)) = sum(sqrt(eig(S1 S2)))``.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.algorithms.base import Optimizer, apply_updates
from fedml_tpu_torch.core import random as R
from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.models.base import FedModel, Params, weightless
from fedml_tpu_torch.models.vision import Conv2d, nchw


def activation_statistics(feats: np.ndarray
                          ) -> tuple[np.ndarray, np.ndarray]:
    """``(mu, sigma)`` of ``[N, D]`` features."""
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, np.atleast_2d(sigma)


def frechet_distance(mu1, s1, mu2, s2, eps: float = 1e-6) -> float:
    """``|mu1 - mu2|^2 + tr(S1 + S2 - 2 sqrt(S1 S2))``, at least 0."""
    diff = mu1 - mu2
    prod = s1 @ s2
    eig = np.linalg.eigvals(prod)
    # rounding can push tiny eigenvalues slightly negative or complex
    tr_sqrt = np.sum(np.sqrt(np.maximum(np.real(eig), 0.0)))
    fid = float(diff @ diff + np.trace(s1) + np.trace(s2) - 2.0 * tr_sqrt)
    return max(fid, 0.0)


class EmbedNet(nn.Module):
    """The conv embedding: NHWC ``x`` to ``feat`` ``[B, dim]``, and with
    ``num_classes`` also the logits of a dense head on ``relu(feat)``
    (``(feat, logits)``). flax's names: ``Conv_0`` ``conv1``, ``Conv_1``
    ``conv2``, ``Dense_0`` or ``feat`` ``feat``, ``cls`` ``cls``."""

    def __init__(self, channels: int, dim: int = 64,
                 num_classes: int | None = None):
        super().__init__()
        self.conv1 = Conv2d(channels, 32, 3, stride=2)
        self.conv2 = Conv2d(32, 64, 3, stride=2)
        self.feat = nn.Linear(64, dim)
        self.cls = nn.Linear(dim, num_classes) if num_classes else None

    def forward(self, x: torch.Tensor):
        h = F.relu(self.conv2(F.relu(self.conv1(nchw(x)))))
        feat = self.feat(h.mean(dim=(2, 3)))
        if self.cls is None:
            return feat
        return feat, self.cls(F.relu(feat))


def embed_model(channels: int, dim: int, num_classes: int | None,
                device) -> FedModel:
    return FedModel(weightless(lambda: EmbedNet(channels, dim, num_classes)),
                    (None, None, channels), resolve_device(device))


class RandomConvEmbed:
    """Deterministic random conv features, built at the first call from
    the images' channel count; ``start`` replaces the seeded draw."""

    def __init__(self, dim: int = 64, seed: int = 0,
                 device: str | torch.device = "cuda",
                 start: Params | None = None):
        self.dim = dim
        self.seed = seed
        self.device = resolve_device(device)
        self.start = start
        self.model = None
        self.variables = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.model is None:
            self.model = embed_model(x.shape[-1], self.dim, None,
                                     self.device)
            self.variables = (
                {k: v.to(self.device) for k, v in self.start.items()}
                if self.start is not None
                else self.model.init(torch.Generator().manual_seed(
                    self.seed)))
        with torch.no_grad():
            return self.model.apply_eval(self.variables, x)


class TrainedCNNEmbed:
    """A small CNN classifier trained deterministically (a fixed seed,
    fixed batch orders, a few epochs) on labelled real images; its
    features are the penultimate layer's. Two runs on the same data and
    device give the same features, so the same FID."""

    def __init__(self, model: FedModel, variables: Params):
        self.model = model
        self.variables = variables

    @classmethod
    def fit(cls, images, labels, num_classes: int | None = None,
            dim: int = 64, epochs: int = 3, batch_size: int = 128,
            lr: float = 1e-3, seed: int = 0,
            device: str | torch.device = "cuda",
            start: Params | None = None,
            perms: Callable[[int, int], torch.Tensor] | None = None
            ) -> "TrainedCNNEmbed":
        """Adam on the mean cross-entropy. ``start``: the first variables
        (default: the seeded draw); ``perms(epoch, n)``: an epoch's order
        (default: ``randperm`` seeded by ``(seed, epoch + 1)``)."""
        dev = resolve_device(device)
        images = torch.as_tensor(np.asarray(images, np.float32)).to(dev)
        labels = torch.as_tensor(np.asarray(labels)).long().to(dev)
        k = int(num_classes or int(labels.max()) + 1)
        model = embed_model(images.shape[-1], dim, k, dev)
        params = ({n: v.to(dev) for n, v in start.items()}
                  if start is not None
                  else model.init(torch.Generator().manual_seed(seed)))
        opt = Optimizer("adam", lr)
        opt_state = opt.init(params)

        def loss_fn(p, xb, yb):
            return F.cross_entropy(model.apply_eval(p, xb)[1], yb)

        grad = torch.func.grad(loss_fn)
        n = images.shape[0]
        # a small split must still train: an empty step range would return
        # the random start as a "trained" embed
        batch_size = max(1, min(batch_size, n))
        for e in range(epochs):
            perm = (perms(e, n) if perms is not None else torch.randperm(
                n, generator=R.generator(seed, e + 1))).to(dev)
            for s in range(0, n - batch_size + 1, batch_size):
                take = perm[s:s + batch_size]
                updates, opt_state = opt.update(
                    grad(params, images[take], labels[take]), opt_state,
                    params)
                params = apply_updates(params, updates)
        return cls(model, params)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.model.apply_eval(self.variables, x)[0]


def sample_grid(images, rows: int = 8, cols: int = 8) -> np.ndarray:
    """``[N, H, W, C]`` images tiled into one ``[rows*H, cols*W, C]`` grid,
    zero-padded to ``rows * cols``."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    need = rows * cols
    if n < need:
        pad = np.zeros((need - n, h, w, c), images.dtype)
        images = np.concatenate([images, pad])
    grid = images[:need].reshape(rows, cols, h, w, c)
    return grid.transpose(0, 2, 1, 3, 4).reshape(rows * h, cols * w, c)


class FIDScorer:
    """FID with a pluggable embed: ``embed_fn(x [B, H, W, C] on the
    scorer's device) -> [B, D]`` (a tensor or an array); the default is
    :class:`RandomConvEmbed`."""

    def __init__(self, embed_fn: Callable | None = None,
                 batch_size: int = 256,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.embed_fn = embed_fn or RandomConvEmbed(device=self.device)
        self.batch_size = batch_size

    def _features(self, images) -> np.ndarray:
        images = torch.as_tensor(np.asarray(images, np.float32))
        feats = []
        for s in range(0, images.shape[0], self.batch_size):
            out = self.embed_fn(images[s:s + self.batch_size].to(
                self.device))
            feats.append(out.cpu().numpy() if torch.is_tensor(out)
                         else np.asarray(out))
        return np.concatenate(feats)

    def calculate_fid(self, images_real, images_fake) -> float:
        mu1, s1 = activation_statistics(self._features(images_real))
        mu2, s2 = activation_statistics(self._features(images_fake))
        return frechet_distance(mu1, s1, mu2, s2)


class TorchScriptEmbed:
    """A feature extractor from a TorchScript file (a scripted
    InceptionV3, say), run on ``device``. Input: NHWC floats in [0, 1];
    grayscale goes to 3 channels, then NCHW, resized nearest to
    ``input_hw``."""

    def __init__(self, path: str, input_hw: int = 299,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.module = torch.jit.load(path, map_location=self.device).eval()
        self.input_hw = input_hw

    def __call__(self, x) -> np.ndarray:
        t = torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(
            x) else x.float()).to(self.device)
        if t.shape[-1] == 1:
            t = t.repeat_interleave(3, dim=-1)
        t = t.permute(0, 3, 1, 2)
        if t.shape[-1] != self.input_hw:
            t = F.interpolate(t, size=(self.input_hw, self.input_hw),
                              mode="nearest")
        with torch.no_grad():
            out = self.module(t)
        if isinstance(out, (tuple, list)):
            out = out[0]
        return out.reshape(out.shape[0], -1).cpu().numpy()


_DEFAULT_SCORERS: dict = {}


def _default_scorer(device: torch.device) -> FIDScorer:
    """One shared default scorer a device: a new one a round would load
    the TorchScript file (when configured) or draw the embed again."""
    if device not in _DEFAULT_SCORERS:
        _DEFAULT_SCORERS[device] = make_fid_scorer(device=device)
    return _DEFAULT_SCORERS[device]


def log_gan_round(sink, sim, state, round_idx: int, scorer=None,
                  n_samples: int = 64, out_dir: str | None = None,
                  extra: dict | None = None) -> dict:
    """A GAN round's record: FID(the real test split, fresh samples of the
    state's generator) and the samples' grid, saved as
    ``gan_samples_r<round>.npy`` beside the sink (or in ``out_dir``)."""
    fake = sim.sample_images(state, n_samples, seed=round_idx
                             ).float().cpu().numpy()
    real = sim.arrays.test_x[:max(n_samples, 256)].float().cpu().numpy()
    scorer = scorer or _default_scorer(sim.device)
    fid = scorer.calculate_fid(real, fake)
    record = {"round": round_idx, "fid": float(fid), **(extra or {})}
    base = out_dir or (
        (os.path.dirname(sink.path) or ".") if sink.path else None
    )
    if base:
        os.makedirs(base, exist_ok=True)
        grid_path = os.path.join(base, f"gan_samples_r{round_idx:05d}.npy")
        np.save(grid_path, sample_grid(fake))
        record["sample_grid"] = grid_path
    sink.log(record)
    return record


def make_fid_scorer(inception_path: str | None = None, batch_size: int = 64,
                    train_data: tuple | None = None,
                    num_classes: int | None = None, seed: int = 0,
                    device: str | torch.device = "cuda") -> FIDScorer:
    """The scorer, in this order of preference:

    1. a TorchScript embed, from ``inception_path`` or
       ``$FEDML_TPU_INCEPTION``; a named file that is missing raises
       ``FileNotFoundError`` (it must not degrade to an offline embed
       whose numbers look comparable to published FID);
    2. ``train_data=(images, labels)``: :class:`TrainedCNNEmbed`;
    3. the fixed-seed :class:`RandomConvEmbed`."""
    path = inception_path or os.environ.get("FEDML_TPU_INCEPTION")
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"Inception TorchScript file not found: {path}")
        return FIDScorer(TorchScriptEmbed(path, device=device), batch_size,
                         device)
    if train_data is not None:
        embed = TrainedCNNEmbed.fit(train_data[0], train_data[1],
                                    num_classes=num_classes, seed=seed,
                                    device=device)
        return FIDScorer(embed, batch_size, device)
    return FIDScorer(batch_size=batch_size, device=device)
