"""The port's vision models against the flax ones, on weights carried
across by ``fedml_tpu_torch.convert``: ResNet-8 (one identity block, two
projecting blocks) forward in eval mode and in train mode with its new
batch statistics, the flax "SAME" padding at stride 2, flax BatchNorm's
biased running variance and 0.9 momentum, float32 statistics under bf16
compute, the FedAvg CNN and logistic regression, the initializers and the
model factory."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models.vision import CNNOriginalFedAvg as JaxCNN
from fedml_tpu.models.vision import LogisticRegression as JaxLR
from fedml_tpu.models.vision import ResNetCIFAR as JaxResNet
from fedml_tpu.ops.cohort_conv import Conv2D as JaxConv2D
from fedml_tpu.ops.cohort_conv import _resolve_padding
from fedml_tpu_torch.config import ModelConfig
from fedml_tpu_torch.convert import vision_state_dict
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.base import BatchNorm, FedModel, weightless
from fedml_tpu_torch.models.vision import (
    CNNOriginalFedAvg,
    Conv2d,
    LogisticRegression,
    ResNetCIFAR,
    same_padding,
)

RES_SHAPE = (16, 16, 3)  # stride 2 on 16 still pads (0, 1)
TOL = dict(atol=1e-5, rtol=1e-5)


def flax_variables(module, input_shape, seed=0):
    """Random flax variables for ``module`` from numpy: the tree comes from
    ``jax.eval_shape`` of the module's init (no compile), every leaf from
    ``default_rng(seed)``: kernels with std 1/sqrt(fan_in), running
    variances in [0.5, 1.5], the rest with std 0.3."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.key(0), jnp.zeros((1,) + input_shape), train=False))
    rng = np.random.default_rng(seed)

    def leaf(k, shape):
        if k == "var":
            return rng.uniform(0.5, 1.5, shape)
        std = np.prod(shape[:-1]) ** -0.5 if k == "kernel" else 0.3
        return std * rng.standard_normal(shape)

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict)
                else leaf(k, v.shape).astype(np.float32)
                for k, v in tree.items()}

    return fill({k: dict(v) for k, v in shapes.items()})


def flax_resnet8(seed=0):
    """Flax ResNet-8 at width 4, its random variables, and the port's
    model with the same variables converted."""
    flax_net = JaxResNet(depth=8, num_classes=10, width=4)
    variables = flax_variables(flax_net, RES_SHAPE, seed)
    model = FedModel(weightless(lambda: ResNetCIFAR(8, 10, width=4)),
                     RES_SHAPE, torch.device("cpu"))
    return flax_net, variables, model, vision_state_dict(variables,
                                                         "ResNetCIFAR")


def _images(n, shape=RES_SHAPE, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n,) + shape).astype(np.float32)


@pytest.mark.parametrize("size", [16, 15, 32, 7])
def test_stride2_same_padding_at_even_and_odd_sizes(size):
    """Flax's SAME at stride 2 pads the odd pixel after: (0, 1) for a 3x3
    conv on an even input, (1, 1) on an odd one, (0, 0) for the 1x1
    projection. The port's conv computes the same values as flax's."""
    for k, s in ((3, 2), (1, 2), (3, 1), (5, 1)):
        want = _resolve_padding("SAME", (size, size), (k, k), (s, s),
                                (1, 1))
        assert same_padding((size, size), (k, k), (s, s)) == want
    assert same_padding((size, size), (3, 3), (2, 2))[0] == (
        (0, 1) if size % 2 == 0 else (1, 1))
    assert same_padding((size, size), (1, 1), (2, 2))[0] == (0, 0)

    x = _images(2, (size, size, 4))
    for k in (3, 1):
        flax_conv = JaxConv2D(8, (k, k), (2, 2), use_bias=False)
        kernel = np.random.default_rng(k).standard_normal(
            (k, k, 4, 8)).astype(np.float32)
        want = flax_conv.apply({"params": {"kernel": kernel}},
                               jnp.asarray(x))
        conv = Conv2d(4, 8, k, 2, bias=False)
        conv.weight.data = torch.from_numpy(kernel.transpose(3, 2, 0, 1))
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                                   np.asarray(want), **TOL)


def test_resnet_converted_variables_cover_the_model():
    """Every variable of the port's ResNet-8 comes across, with its shape:
    BasicBlock_k numbered over the three stages, the third conv and
    BatchNorm of a projecting block as its shortcut."""
    _, variables, model, converted = flax_resnet8()
    init = model.init(torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in converted.items()} == {
        k: v.shape for k, v in init.items()}
    assert model.stat_names == tuple(k for k in init if "running" in k)
    assert len(model.stat_names) == 2 * 9  # stem + 2 x 3 blocks + 2 proj
    np.testing.assert_array_equal(
        converted["blocks.1.proj.weight"].numpy(),
        variables["params"]["BasicBlock_1"]["Conv2D_2"]["kernel"].transpose(
            3, 2, 0, 1))
    assert "blocks.0.proj.weight" not in converted  # the identity block


@pytest.mark.parametrize("train", [False, True])
def test_resnet_forward_matches_flax(train):
    """Eval mode on the running statistics; train mode on the batch's,
    with the new running statistics compared too."""
    flax_net, variables, model, params = flax_resnet8()
    x = _images(6)
    if train:
        want, mutated = flax_net.apply(variables, jnp.asarray(x), train=True,
                                       mutable=["batch_stats"])
        got, new_vars = model.apply_train(params, torch.from_numpy(x))
        stats = vision_state_dict(jax.device_get(mutated), "ResNetCIFAR")
        assert set(stats) == set(model.stat_names)
        for k in stats:
            np.testing.assert_allclose(new_vars[k].numpy(),
                                       stats[k].numpy(), **TOL, err_msg=k)
        # no buffer was written in place
        assert all(torch.equal(params[k], v) for k, v in
                   vision_state_dict(variables, "ResNetCIFAR").items())
    else:
        want = flax_net.apply(variables, jnp.asarray(x), train=False)
        got = model.apply_eval(params, torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_batch_norm_biased_variance_and_flax_momentum():
    """One train step of BatchNorm: the running variance moves toward the
    biased batch variance with weight 0.1 (flax momentum 0.9); torch's
    BatchNorm2d, at the matching momentum 0.1, stores the unbiased one
    and so differs."""
    import flax.linen as nn

    rng = np.random.default_rng(3)
    x = (2.0 + 3.0 * rng.standard_normal((4, 3, 3, 5))).astype(np.float32)
    mean0 = rng.standard_normal(5).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    scale = rng.standard_normal(5).astype(np.float32)
    bias = rng.standard_normal(5).astype(np.float32)
    flax_bn = nn.BatchNorm(use_running_average=False, momentum=0.9)
    want, mutated = flax_bn.apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}},
        jnp.asarray(x), mutable=["batch_stats"])

    bn = BatchNorm(5)
    variables = {"weight": torch.from_numpy(scale),
                 "bias": torch.from_numpy(bias),
                 "running_mean": torch.from_numpy(mean0),
                 "running_var": torch.from_numpy(var0)}
    stats = {}
    got = torch.func.functional_call(
        bn, variables, (torch.from_numpy(x).permute(0, 3, 1, 2),),
        {"train": True, "stats_out": stats})
    new_mean, new_var = stats[bn]
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **TOL)
    biased = x.reshape(-1, 5).var(axis=0)
    np.testing.assert_allclose(new_var.numpy(), 0.9 * var0 + 0.1 * biased,
                               rtol=1e-5)
    np.testing.assert_allclose(new_var.numpy(),
                               np.asarray(mutated["batch_stats"]["var"]),
                               rtol=1e-5)
    np.testing.assert_allclose(new_mean.numpy(),
                               np.asarray(mutated["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(variables["running_var"], torch.from_numpy(var0))

    torch_bn = torch.nn.BatchNorm2d(5, momentum=0.1)
    torch_bn.running_mean.copy_(torch.from_numpy(mean0))
    torch_bn.running_var.copy_(torch.from_numpy(var0))
    torch_bn.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert not torch.allclose(torch_bn.running_var, new_var, rtol=1e-3)


def test_bf16_forward_keeps_float32_statistics():
    """Under bf16 compute (parameters and input cast, statistics left
    float32) the new running statistics stay float32 and carry more than
    bf16's precision; logits and statistics agree with flax's bf16
    forward at the band of the reference's bf16 test."""
    flax_net, variables, model, params = flax_resnet8()
    x = _images(6)

    def cast(tree, path=()):
        return {k: cast(v, path + (k,)) if isinstance(v, dict) else (
            v if path[0] == "batch_stats" else jnp.asarray(v, jnp.bfloat16))
            for k, v in tree.items()}

    want, mutated = flax_net.apply(cast(variables),
                                   jnp.asarray(x, jnp.bfloat16), train=True,
                                   mutable=["batch_stats"])
    compute = {k: v if k in model.stat_names else v.to(torch.bfloat16)
               for k, v in params.items()}
    got, new_vars = model.apply_train(
        compute, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32), atol=0.05,
                               rtol=0.1)
    stats = vision_state_dict(jax.device_get(mutated), "ResNetCIFAR")
    for k in model.stat_names:
        assert new_vars[k].dtype == torch.float32, k
        np.testing.assert_allclose(new_vars[k].numpy(), stats[k].numpy(),
                                   atol=0.05, rtol=0.1, err_msg=k)
    var = new_vars["blocks.2.bn2.running_var"]
    assert not torch.equal(var, var.bfloat16().float())


def test_cnn_fedavg_and_lr_forward_match_flax():
    """The FedAvg CNN flattens in flax's (H, W, C) order before its dense
    layers; logistic regression flattens NHWC."""
    shape = (28, 28, 1)
    x = _images(3, shape)
    for flax_net, port, arch in (
            (JaxCNN(num_classes=10), CNNOriginalFedAvg(10, shape),
             "CNNOriginalFedAvg"),
            (JaxLR(num_classes=10), LogisticRegression(10, shape),
             "LogisticRegression")):
        variables = flax_variables(flax_net, shape)
        model = FedModel(weightless(lambda: port), shape, torch.device("cpu"))
        params = vision_state_dict(variables, arch)
        init = model.init(torch.Generator().manual_seed(0))
        assert {k: v.shape for k, v in params.items()} == {
            k: v.shape for k, v in init.items()}
        want = flax_net.apply(variables, jnp.asarray(x))
        got = model.apply_eval(params, torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL, err_msg=arch)


def test_init_follows_flax_initializers():
    """Conv kernels lecun-normal over fan_in = kh * kw * cin (truncated at
    two standard deviations), BatchNorm scale 1, bias 0, mean 0, var 1,
    the head's bias 0; ResNet-56 at full width has about 0.85M
    parameters."""
    model = create_model(ModelConfig(name="resnet56", num_classes=10,
                                     input_shape=(32, 32, 3)), "cpu")
    v = model.init(torch.Generator().manual_seed(0))
    n_params = sum(t.numel() for k, t in v.items()
                   if k not in model.stat_names)
    assert 0.84e6 < n_params < 0.86e6, n_params
    assert len(model.module.blocks) == 27
    w = v["blocks.26.conv2.weight"]  # 64 -> 64, 3 x 3
    std = (1.0 / (64 * 9)) ** 0.5
    assert w.shape == (64, 64, 3, 3)
    assert abs(float(w.std()) - std) < 0.05 * std
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7
    for k, t in v.items():
        if k.endswith("running_var") or (".bn" in k and k.endswith("weight")):
            assert torch.equal(t, torch.ones_like(t)), k
        elif k.endswith(("running_mean", "bias")):
            assert torch.equal(t, torch.zeros_like(t)), k


@pytest.mark.parametrize("name,extra,item", [
    ("resnet56_gn_s2d", (), "resnet56_s2d"),
    ("resnet56_s2d", (), "resnet56_s2d"),
    ("resnet56_s2d_exact", (), "resnet56_s2d"),
    ("resnet56", (("norm", "syncbn:data"),), "syncbn"),
])
def test_unported_resnet_variants_raise(name, extra, item):
    """Of the JAX package's ResNet variants only the norm syncbn is left
    unported, and raises naming its ROADMAP item. The s2d names (ROADMAP
    item "resnet56_s2d", ported) build: the JAX package's variables of
    the same name, converted, cover the port's model shape for shape and
    give its eval logits (TOL)."""
    cfg = ModelConfig(name=name, input_shape=(32, 32, 3), extra=extra)
    if item == "syncbn":
        with pytest.raises(NotImplementedError, match=f"ROADMAP: .*{item}"):
            create_model(cfg, "cpu")
        return
    from fedml_tpu.config import ModelConfig as JaxModelConfig
    from fedml_tpu.models import create_model as jax_create_model

    flax_net = jax_create_model(JaxModelConfig(
        name=name, input_shape=(32, 32, 3))).module
    variables = flax_variables(flax_net, (32, 32, 3))
    params = vision_state_dict(variables, "ResNetCIFARS2DExact"
                               if name.endswith("_exact") else "ResNetCIFAR")
    model = create_model(cfg, "cpu")
    init = model.init(torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in params.items()} == {
        k: v.shape for k, v in init.items()}
    x = _images(2, (32, 32, 3))
    np.testing.assert_allclose(
        model.apply_eval(params, torch.from_numpy(x)).detach().numpy(),
        np.asarray(flax_net.apply(variables, jnp.asarray(x), train=False)),
        **TOL)
