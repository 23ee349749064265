"""Causal transformer LM with an injected attention function.

Same architecture, head layout ([B, T, H, D]) and projection names as
``fedml_tpu.models.transformer.TransformerLM``. Two flax defaults that
torch does not share are kept: LayerNorm's epsilon is 1e-6, and GELU is
the tanh approximation.

The projections (``q_proj``, ``k_proj``, ``v_proj``, ``attn_out``,
``mlp_up``, ``mlp_down`` and ``lm_head``) are built through a dense
factory, ``dense_cls(in_features, out_features, bias, name)``, by default
``nn.Linear``: the PEFT package (``fedml_tpu_torch.peft.lora``) swaps in
LoRA-wrapped projections for the targeted names, around the attention
call, without touching ``attn_fn``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.ops.ring_attention import full_attention

AttnFn = Callable[..., torch.Tensor]  # (q, k, v, causal=...) -> out
# (in_features, out_features, bias, name) -> the projection's module
DenseFactory = Callable[[int, int, bool, str], nn.Module]
LN_EPS = 1e-6  # flax nn.LayerNorm's default


def linear(in_features: int, out_features: int, bias: bool,
           name: str) -> nn.Module:
    """The default dense factory: a stock ``nn.Linear``."""
    del name
    return nn.Linear(in_features, out_features, bias=bias)


class Block(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: int = 4,
                 attn_fn: AttnFn = full_attention,
                 dense_cls: DenseFactory = linear):
        super().__init__()
        c = embed_dim
        self.num_heads = num_heads
        self.attn_fn = attn_fn
        self.ln_1 = nn.LayerNorm(c, eps=LN_EPS)
        self.q_proj = dense_cls(c, c, False, "q_proj")
        self.k_proj = dense_cls(c, c, False, "k_proj")
        self.v_proj = dense_cls(c, c, False, "v_proj")
        self.attn_out = dense_cls(c, c, False, "attn_out")
        self.ln_2 = nn.LayerNorm(c, eps=LN_EPS)
        self.mlp_up = dense_cls(c, mlp_ratio * c, True, "mlp_up")
        self.mlp_down = dense_cls(mlp_ratio * c, c, True, "mlp_down")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        h = self.ln_1(x)
        heads = (b, t, self.num_heads, c // self.num_heads)
        a = self.attn_fn(
            self.q_proj(h).reshape(heads),
            self.k_proj(h).reshape(heads),
            self.v_proj(h).reshape(heads),
            causal=True,
        )
        x = x + self.attn_out(a.reshape(b, t, c))
        h = F.gelu(self.mlp_up(self.ln_2(x)), approximate="tanh")
        return x + self.mlp_down(h)


class TransformerLM(nn.Module):
    def __init__(self, vocab_size: int, num_layers: int = 2,
                 num_heads: int = 4, embed_dim: int = 128,
                 max_len: int = 2048, attn_fn: AttnFn = full_attention,
                 dense_cls: DenseFactory = linear):
        super().__init__()
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.embed_dim = embed_dim
        self.max_len = max_len
        self.attn_fn = attn_fn
        self.dense_cls = dense_cls
        self.embed = nn.Embedding(vocab_size, embed_dim)
        self.pos_emb = nn.Embedding(max_len, embed_dim)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, attn_fn=attn_fn, dense_cls=dense_cls)
            for _ in range(num_layers)
        )
        self.ln_f = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.lm_head = dense_cls(embed_dim, vocab_size, False, "lm_head")

    def config(self) -> dict:
        """The constructor's arguments: ``TransformerLM(**{**lm.config(),
        "attn_fn": ...})`` builds the same architecture with one argument
        changed."""
        return dict(vocab_size=self.vocab_size, num_layers=self.num_layers,
                    num_heads=self.num_heads, embed_dim=self.embed_dim,
                    max_len=self.max_len, attn_fn=self.attn_fn,
                    dense_cls=self.dense_cls)

    def forward(self, tokens: torch.Tensor, positions=None) -> torch.Tensor:
        """``tokens`` [B, T] int; ``positions`` [B, T] (default 0..T-1).
        Returns logits [B, T, vocab]."""
        b, t = tokens.shape
        if positions is None:
            positions = torch.arange(t, device=tokens.device).expand(b, t)
        x = self.embed(tokens) + self.pos_emb(positions)
        for block in self.blocks:
            x = block(x)
        return self.lm_head(self.ln_f(x))
