"""Flash attention: a hand-written CUDA kernel for Hopper and its plain
PyTorch version.

Replaces the Pallas kernel of ``fedml_tpu/ops/flash_attention.py``
(``flash_attention``, body ``_flash_kernel``): ``softmax(q kᵀ/√D) v`` over
``[B, T, H, D]`` inputs, causal or not, with the online softmax in float32
and the output cast to ``q``'s type. The kernel is
``fedml_tpu_torch/csrc/flash_attention.cu``, built for ``sm_90a`` at first
use (see :mod:`fedml_tpu_torch.ops.build`); its source says what bounds it
on the H100 and what its design does about that.

Unlike the Pallas kernel, T need not divide by the tile: the kernel masks
the ragged edge (the Shakespeare task runs at T = 80). Inputs may be
float32, bfloat16 or float16 with D in {32, 64, 128}. The library holds
two kernels behind one C function: float32 runs on the FP32 cores, and
bfloat16 and float16 run on the tensor cores, with the probabilities
rounded to the input type before the ``p v`` product.

Dispatch: a CPU tensor goes to :func:`flash_attention_reference`; a CUDA
tensor goes to the kernel, or the call raises. Like the Pallas kernel,
this is forward only: its gradient raises, so training uses
:func:`fedml_tpu_torch.ops.ring_attention.full_attention`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from fedml_tpu_torch.ops import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (32, 64, 128)


def flash_attention_reference(
    q, k, v, causal: bool = False, block_q: int = 64, block_k: int = 64
) -> torch.Tensor:
    """Blockwise attention with the online softmax, in float32 PyTorch
    ops: the same function as the kernel, for the CPU and for checking the
    kernel. Blocks need not divide T."""
    b, t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))  # [B,H,T,D]
    out = torch.empty_like(qf)
    for q0 in range(0, t, block_q):
        qb = qf[:, :, q0:q0 + block_q]
        nq = qb.shape[2]
        q_pos = torch.arange(q0, q0 + nq, device=q.device)
        m = torch.full(qb.shape[:3], float("-inf"), device=q.device)
        l = torch.zeros(qb.shape[:3], device=q.device)
        o = torch.zeros_like(qb)
        # causal: key blocks past this query block are skipped
        k_end = min(t, q0 + nq) if causal else t
        for k0 in range(0, k_end, block_k):
            kb = kf[:, :, k0:k0 + block_k]
            vb = vf[:, :, k0:k0 + block_k]
            s = torch.matmul(qb, kb.transpose(-1, -2)) * scale
            if causal:
                k_pos = torch.arange(k0, k0 + kb.shape[2], device=q.device)
                visible = q_pos[:, None] >= k_pos[None, :]
                s = s.masked_fill(~visible, float("-inf"))
            m_b = s.amax(dim=-1)
            p = torch.where(
                torch.isfinite(m_b)[..., None],
                torch.exp(s - m_b[..., None]),
                0.0,
            )
            new_m = torch.maximum(m, m_b)
            alpha = torch.where(torch.isfinite(m), torch.exp(m - new_m), 0.0)
            beta = torch.where(torch.isfinite(m_b), torch.exp(m_b - new_m), 0.0)
            o = o * alpha[..., None] + torch.matmul(p, vb) * beta[..., None]
            l = l * alpha + p.sum(dim=-1) * beta
            m = new_m
        out[:, :, q0:q0 + nq] = o / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library (built at first use) with its C signatures."""
    lib = build.library("flash_attention")
    lib.flash_attention_forward.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong),
                             ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.flash_attention_forward.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    """Checks what the kernel takes, launches it on the current stream and
    raises on a refused launch."""
    if not (q.shape == k.shape == v.shape and q.dim() == 4):
        raise ValueError(
            f"q, k, v must share one [B, T, H, D] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.device == k.device == v.device and q.device.type == "cuda"):
        raise ValueError("flash_attention's kernel needs q, k, v on one "
                         "CUDA device")
    if not (q.dtype == k.dtype == v.dtype and q.dtype in _DTYPE_CODES):
        raise ValueError(f"flash_attention takes float32, bfloat16 or "
                         f"float16 inputs of one type, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    b, t, h, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention's kernel takes head dim in "
                         f"{_HEAD_DIMS}, got {d}")
    if (t + 63) // 64 > 65535:
        raise ValueError(f"sequence length {t} exceeds the kernel's grid")
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _library()
    strides = (ctypes.c_longlong * 16)(
        *q.stride(), *k.stride(), *v.stride(), *out.stride()
    )
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], b, t, h, d, strides, 1.0 / math.sqrt(d),
            int(causal), stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg}")
    flash_attention.launches += 1
    if q.dtype != torch.float32:
        flash_attention.mma_launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.device.type == "cpu":
            return flash_attention_reference(q, k, v, causal)
        return _launch(q, k, v, causal)

    @staticmethod
    def backward(ctx, grad_out):
        raise RuntimeError(
            "flash_attention is forward only (as the Pallas kernel it "
            "replaces); train with full_attention"
        )


def flash_attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """``[B, T, H, D]`` attention through the flash kernel (CUDA tensors)
    or its plain version (CPU tensors). ``flash_attention.launches``
    counts the kernels' launches, ``flash_attention.mma_launches`` those
    of the tensor-core kernel (bfloat16 and float16 inputs) among them."""
    return _FlashAttention.apply(q, k, v, causal)


flash_attention.launches = 0
flash_attention.mma_launches = 0
