"""The port's flash attention against the JAX package's Pallas kernel
(interpret mode) and against full attention, plus the wrapper's dispatch
rules and, on a CUDA card, the hand-written kernel against its plain
version.

The JAX package is imported inside the parity test only, so that the
kernel test also runs where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_flash_attention.py``
"""

import numpy as np
import pytest
import torch

from chip_smoke import EDGE_CASES, edge_inputs
from fedml_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)
from fedml_tpu_torch.ops.ring_attention import full_attention

# float32 online softmax vs one-pass softmax: sums in another order; the
# band of the JAX package's own flash-vs-full test
F32 = dict(atol=2e-5, rtol=2e-5)


def _qkv(shape, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape,block", [((2, 64, 2, 8), 16),
                                         ((2, 80, 4, 32), 80),
                                         ((2, 80, 4, 32), 16)])
def test_plain_flash_matches_jax_kernel_and_full(shape, block, causal):
    import jax.numpy as jnp

    from fedml_tpu.ops.flash_attention import flash_attention as jax_flash
    from fedml_tpu.ops.ring_attention import full_attention as jax_full

    q, k, v = _qkv(shape)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    expect = np.asarray(jax_flash(jq, jk, jv, causal=causal, block_q=block,
                                  block_k=block, interpret=True))
    got = flash_attention_reference(tq, tk, tv, causal, block, block)
    np.testing.assert_allclose(got.numpy(), expect, **F32)
    # the CPU wrapper (the plain version's default tile of 64, ragged at
    # T = 80) and the port's full attention compute the same function
    np.testing.assert_allclose(
        flash_attention(tq, tk, tv, causal=causal).numpy(), expect, **F32)
    full = full_attention(tq, tk, tv, causal=causal).numpy()
    np.testing.assert_allclose(full, expect, **F32)
    np.testing.assert_allclose(
        full, np.asarray(jax_full(jq, jk, jv, causal=causal)), **F32)


# Both compute in float32 from the same 16-bit inputs and round once, at
# the end, to the input type, so they differ by at most about one output
# ulp of that type (bf16: 2^-7 = 7.8e-3 at 1; fp16: 2^-10 = 9.8e-4 at 1),
# where the float32 sums fall on two sides of a rounding boundary.
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 8e-3),
                                       (torch.float16, 1e-3)])
def test_plain_flash_16bit_matches_jax_kernel(dtype, tol, causal):
    import jax.numpy as jnp

    from fedml_tpu.ops.flash_attention import flash_attention as jax_flash

    jdtype = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}
    q, k, v = _qkv((2, 32, 2, 16), seed=3)
    jq, jk, jv = (jnp.asarray(a).astype(jdtype[dtype]) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    # both frameworks round the float32 draws to the same 16-bit inputs
    np.testing.assert_array_equal(
        np.asarray(jq.astype(jnp.float32)), tq.float().numpy())
    expect = jax_flash(jq, jk, jv, causal=causal, interpret=True)
    got = flash_attention_reference(tq, tk, tv, causal)
    assert got.dtype == dtype and expect.dtype == jdtype[dtype]
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(expect.astype(jnp.float32)),
        atol=tol, rtol=tol)


def test_cpu_path_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 16, 1, 32)))
    before = flash_attention.launches, flash_attention.mma_launches
    flash_attention(q, k, v, causal=True)
    flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), causal=True)
    assert (flash_attention.launches, flash_attention.mma_launches) == before


def test_backward_raises():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 16, 1, 32)))
    q.requires_grad_(True)
    out = flash_attention(q, k, v, causal=True)
    with pytest.raises(RuntimeError, match="forward only"):
        out.sum().backward()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,atol,layout", [
    ((2, 80, 4, 32), torch.float32, 2e-5, "k_strided"),
    ((2, 130, 2, 128), torch.float16, 2e-3, "k_strided"),
    *EDGE_CASES,  # ragged T, T past one block, packed and misaligned QKV
])
@pytest.mark.parametrize("causal", [False, True])
def test_kernel_matches_plain(cuda_device, shape, dtype, atol, layout,
                              causal):
    # the kernels read [B, T, H, D] through their strides: 16 bytes at a
    # time where the layout allows it, one element at a time elsewhere
    q, k, v = edge_inputs(shape, dtype, layout, device=cuda_device)
    before = flash_attention.launches, flash_attention.mma_launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    # float32 runs the FP32-core kernel, bf16 and fp16 the tensor-core one
    tensor_cores = int(dtype != torch.float32)
    assert (flash_attention.launches, flash_attention.mma_launches) == (
        before[0] + 1, before[1] + tensor_cores)
    assert got.dtype == dtype
    # the plain version in float32 from the same low-precision inputs
    want = flash_attention_reference(q.float(), k.float(), v.float(), causal)
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=atol)
