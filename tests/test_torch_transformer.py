"""The port's TransformerLM against the flax one on weights carried
across by ``fedml_tpu_torch.convert``: forward with full and with flash
attention, and the gradient of the next-token loss."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.base import make_task as jax_make_task
from fedml_tpu.models.transformer import TransformerLM as JaxLM
from fedml_tpu.ops.flash_attention import flash_attention as jax_flash
from fedml_tpu_torch.algorithms.base import make_task
from fedml_tpu_torch.convert import transformer_state_dict
from fedml_tpu_torch.models.base import FedModel, weightless
from fedml_tpu_torch.models.transformer import TransformerLM
from fedml_tpu_torch.ops.flash_attention import flash_attention

VOCAB, LAYERS, HEADS, EMBED, T, B = 37, 2, 2, 32, 16, 2


def _flax_and_port(jax_attn=None, port_attn=None):
    kw = dict(vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS,
              embed_dim=EMBED, max_len=T)
    flax_lm = JaxLM(**kw, **({"attn_fn": jax_attn} if jax_attn else {}))
    tokens = np.random.default_rng(0).integers(0, VOCAB, (B, T)).astype(
        np.int32)
    variables = jax.jit(flax_lm.init)(jax.random.key(1), jnp.asarray(tokens))
    module = weightless(lambda: TransformerLM(
        **kw, **({"attn_fn": port_attn} if port_attn else {})))
    model = FedModel(module, (T,), torch.device("cpu"), torch.int32)
    params = transformer_state_dict(jax.device_get(variables))
    assert set(params) == {k for k, _ in module.named_parameters()}
    return flax_lm, variables, model, params, tokens


@pytest.mark.parametrize("attn,atol", [("full", 1e-5), ("flash", 2e-5)])
def test_forward_matches_flax(attn, atol):
    jax_attn = port_attn = None
    if attn == "flash":
        jax_attn = functools.partial(jax_flash, interpret=True)
        port_attn = flash_attention
    flax_lm, variables, model, params, tokens = _flax_and_port(
        jax_attn, port_attn)
    expect = np.asarray(jax.jit(flax_lm.apply)(variables, jnp.asarray(tokens)))
    got = model.apply_eval(params, torch.from_numpy(tokens))
    assert got.shape == (B, T, VOCAB)
    np.testing.assert_allclose(got.detach().numpy(), expect, atol=atol,
                               rtol=atol)


def test_nwp_loss_gradient_matches_flax():
    flax_lm, variables, model, params, tokens = _flax_and_port()
    targets = np.roll(tokens, -1, axis=1)
    w = np.array([1.0, 0.0], np.float32)  # the second row is padding

    def jax_loss(v):
        s = jax_make_task("nwp").metric_sums(
            flax_lm.apply(v, jnp.asarray(tokens)), jnp.asarray(targets),
            jnp.asarray(w))
        return s["loss_sum"] / jnp.maximum(s["w_sum"], 1.0)

    jax_loss = jax.jit(jax_loss)
    expect = transformer_state_dict(
        jax.device_get(jax.jit(jax.grad(jax_loss))(variables)))
    live = {k: v.requires_grad_(True) for k, v in params.items()}
    s = make_task("nwp").metric_sums(
        model.apply_eval(live, torch.from_numpy(tokens)),
        torch.from_numpy(targets), torch.from_numpy(w))
    loss = s["loss_sum"] / torch.clamp(s["w_sum"], min=1.0)
    np.testing.assert_allclose(loss.item(), float(jax_loss(variables)),
                               rtol=1e-5)
    grads = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
    for name, g in grads.items():
        # float32 backward through 2 blocks: sums reassociate
        np.testing.assert_allclose(g.numpy(), expect[name].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=name)
