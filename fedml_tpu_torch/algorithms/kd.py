"""Knowledge-distillation losses (``fedml_tpu.algorithms.kd``): the part
FedGDKD runs."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def soft_target(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                T: float = 4.0) -> torch.Tensor:
    """``T**2`` times KL(softmax(t / T) || softmax(s / T)), summed over the
    classes and averaged over the batch (``F.kl_div(..., reduction=
    "batchmean") * T * T``)."""
    log_p_s = F.log_softmax(student_logits / T, dim=-1)
    log_p_t = F.log_softmax(teacher_logits / T, dim=-1)
    p_t = F.softmax(teacher_logits / T, dim=-1)
    per_row = torch.sum(p_t * (log_p_t - log_p_s), dim=-1)
    return torch.mean(per_row) * T * T
