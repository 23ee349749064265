"""Segmentation metrics: the confusion-matrix evaluator
(``fedml_tpu.metrics.segmentation``).

Pixel accuracy, per-class accuracy, mean IoU and frequency-weighted IoU,
all from one ``[K, K]`` confusion matrix. The matrix accumulates on the
device, a ``torch.bincount`` a batch; the metrics are finished on the
host in numpy, as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch


def confusion_matrix_batch(gt: torch.Tensor, pred: torch.Tensor,
                           num_classes: int) -> torch.Tensor:
    """``[K, K]`` counts of one batch, rows the ground truth and columns
    the prediction; pixels whose label is outside ``[0, K)`` are not
    counted."""
    k = num_classes
    gt = gt.reshape(-1).long()
    pred = pred.reshape(-1).long()
    valid = (gt >= 0) & (gt < k)
    label = torch.where(valid, k * gt + pred, torch.full_like(gt, k * k))
    counts = torch.bincount(label, minlength=k * k + 1)
    return counts[:k * k].reshape(k, k)


class SegEvaluator:
    """The reference's accumulator: :meth:`add_batch`, the metric
    getters and :meth:`reset`. ``confusion`` is the running matrix as a
    float64 numpy array."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.reset()

    def reset(self) -> None:
        self._counts = None

    def add_batch(self, gt: torch.Tensor, pred: torch.Tensor) -> None:
        cm = confusion_matrix_batch(gt, pred, self.num_classes)
        self._counts = cm if self._counts is None else self._counts + cm

    @property
    def confusion(self) -> np.ndarray:
        if self._counts is None:
            return np.zeros((self.num_classes, self.num_classes))
        return self._counts.cpu().numpy().astype(np.float64)

    def pixel_accuracy(self) -> float:
        cm = self.confusion
        return float(np.diag(cm).sum() / cm.sum())

    def pixel_accuracy_class(self) -> float:
        cm = self.confusion
        with np.errstate(invalid="ignore", divide="ignore"):
            acc = np.diag(cm) / cm.sum(axis=1)
        return float(np.nanmean(acc))

    def _iou(self, cm: np.ndarray) -> np.ndarray:
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.diag(cm) / (cm.sum(axis=1) + cm.sum(axis=0)
                                  - np.diag(cm))

    def mean_iou(self) -> float:
        return float(np.nanmean(self._iou(self.confusion)))

    def fw_iou(self) -> float:
        cm = self.confusion
        freq = cm.sum(axis=1) / cm.sum()
        iou = self._iou(cm)
        return float((freq[freq > 0] * iou[freq > 0]).sum())

    @torch.no_grad()
    def add_model(self, model, variables, x: torch.Tensor, y: torch.Tensor,
                  eval_batch: int = 256) -> None:
        """Add ``model``'s eval-mode predictions (the argmax of its
        per-pixel logits) on ``x`` against ``y``, ``eval_batch`` images at
        a time."""
        for i in range(0, x.shape[0], eval_batch):
            logits = model.apply_eval(variables, x[i:i + eval_batch])
            self.add_batch(y[i:i + eval_batch], logits.argmax(-1))
