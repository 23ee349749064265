"""Knowledge-distillation losses (``fedml_tpu.algorithms.kd``): the
reference's ``SoftTarget`` (Hinton's KL with the ``T**2`` scale) and
``Logits`` (the MSE of raw logits)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _row_mean(per_row: torch.Tensor, w: torch.Tensor | None) -> torch.Tensor:
    """The mean over the rows, or with ``w`` the ``w``-weighted sum over
    ``max(sum w, 1)`` (the mean over the real rows of a padded batch)."""
    if w is None:
        return torch.mean(per_row)
    return torch.sum(per_row * w) / torch.clamp(torch.sum(w), min=1.0)


def soft_target(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                T: float = 4.0, w: torch.Tensor | None = None
                ) -> torch.Tensor:
    """``T**2`` times KL(softmax(t / T) || softmax(s / T)), summed over the
    classes and averaged over the batch (``F.kl_div(..., reduction=
    "batchmean") * T * T``); with ``w``, averaged over the real rows."""
    log_p_s = F.log_softmax(student_logits / T, dim=-1)
    log_p_t = F.log_softmax(teacher_logits / T, dim=-1)
    p_t = F.softmax(teacher_logits / T, dim=-1)
    per_row = torch.sum(p_t * (log_p_t - log_p_s), dim=-1)
    return _row_mean(per_row, w) * T * T


def logits_mse(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
               w: torch.Tensor | None = None) -> torch.Tensor:
    """The squared error of the logits, averaged over the classes and then
    the rows (the real rows, with ``w``)."""
    per_row = torch.mean(torch.square(student_logits - teacher_logits),
                         dim=-1)
    return _row_mean(per_row, w)
