"""NLP models: the reference's federated LSTM pair and the
StackOverflow tag model.

Same architectures as ``fedml_tpu.models.nlp``:

- :class:`CharLSTM`: the Shakespeare char LM, embed(8) -> 2 x LSTM(256)
  -> dense(vocab), logits at every position.
- :class:`NWPLSTM`: StackOverflow next-word prediction, embed(96) ->
  LSTM(670) -> dense(96) -> dense(vocab).
- :class:`TagLogisticRegression`: StackOverflow tag prediction from a
  bag of words, flatten -> dense(tags).

The LSTM is written out (:class:`LSTM`), not ``nn.LSTM``: cuDNN's RNN op
has no ``torch.func.vmap`` batching rule, and the local step is vmapped
over a cohort's clients. Written out, the recurrence is batched matmuls
and pointwise gates under vmap, and a CUDA graph captures it whole.

Types follow flax's ``promote_dtype``: an operation on two types runs in
the one they promote to. Under a bf16 compute type the parameters and the
embedded tokens are bf16, but the LSTM's carry starts as float32 zeros
(flax builds it in the parameters' own type), so the recurrent products,
the gates and everything after the first LSTM's input product run in
float32, as in the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _promoted(*tensors: torch.Tensor) -> list[torch.Tensor]:
    """``tensors`` cast to the type they promote to (flax's
    ``promote_dtype``)."""
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return [t.to(dtype) for t in tensors]


class Dense(nn.Linear):
    """``nn.Linear`` that promotes its input and parameters to one type
    first, as flax ``nn.Dense`` does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(*_promoted(x, self.weight, self.bias))


class LSTM(nn.Module):
    """One LSTM layer over ``[B, T, in]``, returning the hidden state at
    every step, ``[B, T, hidden]``: flax ``nn.RNN(nn.OptimizedLSTMCell)``.

    The gates are i, f, g, o, packed in that order: ``weight_ih`` ``[4
    hidden, in]`` (the input kernels ``ii, if, ig, io``, no bias),
    ``weight_hh`` ``[4 hidden, hidden]`` and ``bias`` ``[4 hidden]`` (the
    hidden kernels ``hi, hf, hg, ho`` and their biases). Sigmoid on i, f
    and o, tanh on g and on the cell; the carry starts at zeros in
    float32; no forget-gate offset. The input product of every step is
    one matmul before the loop; the loop over T takes the recurrent
    product and the gates."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, input_size))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias = nn.Parameter(torch.zeros(4 * hidden))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, steps = x.shape[:2]
        x_in, w_ih = _promoted(x, self.weight_ih)
        gates_in = x_in @ w_ih.T  # [B, T, 4H]
        c = torch.zeros(b, self.hidden, device=x.device)
        h = torch.zeros(b, self.hidden, device=x.device)
        h, w_hh, bias = _promoted(h, self.weight_hh, self.bias)
        c = c.to(h.dtype)
        out = []
        for t in range(steps):
            gates = (h @ w_hh.T + bias) + gates_in[:, t]
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        return torch.stack(out, dim=1)


class CharLSTM(nn.Module):
    """Shakespeare char LM: embed(``embed_dim``) -> 2 x
    LSTM(``hidden``) -> dense(vocab) at every position."""

    def __init__(self, vocab_size: int = 90, embed_dim: int = 8,
                 hidden: int = 256):
        super().__init__()
        self.vocab_size = vocab_size
        self.embed = nn.Embedding(vocab_size, embed_dim)
        self.lstm1 = LSTM(embed_dim, hidden)
        self.lstm2 = LSTM(hidden, hidden)
        self.head = Dense(hidden, vocab_size)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.head(self.lstm2(self.lstm1(self.embed(tokens))))


class NWPLSTM(nn.Module):
    """StackOverflow next-word predictor: embed(``embed_dim``) ->
    LSTM(``hidden``) -> dense(``embed_dim``) -> dense(vocab); the vocab is
    10k words and pad/bos/eos/oov by default."""

    def __init__(self, vocab_size: int = 10004, embed_dim: int = 96,
                 hidden: int = 670):
        super().__init__()
        self.vocab_size = vocab_size
        self.embed = nn.Embedding(vocab_size, embed_dim)
        self.lstm = LSTM(embed_dim, hidden)
        self.fc = Dense(hidden, embed_dim)
        self.head = Dense(embed_dim, vocab_size)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.head(self.fc(self.lstm(self.embed(tokens))))


class TagLogisticRegression(nn.Module):
    """Multi-label bag-of-words tagger (the model names ``tag_lr`` and
    ``stackoverflow_lr``): the input flattened, then one dense layer
    (``linear``) to a logit a tag; the sigmoid is the tag task's loss's."""

    def __init__(self, num_tags: int = 500,
                 input_shape: tuple[int, ...] = (1000,)):
        super().__init__()
        self.linear = nn.Linear(math.prod(input_shape), num_tags)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x.reshape(x.shape[0], -1))
