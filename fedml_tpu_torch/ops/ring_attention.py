"""Single-device attention. The ring (sequence-parallel) attention of the
JAX package waits for the port's multi-device slice."""

from __future__ import annotations

import math

import torch


def full_attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """Plain softmax attention over ``[B, T, H, D]`` inputs, scores and
    softmax in float32: the reference for the flash kernel and the
    attention the transformer trains with."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = torch.ones(tq, tk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype)
