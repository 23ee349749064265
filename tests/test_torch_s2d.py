"""The space-to-depth ResNets of the port against the JAX package's: the
"_s2d" parameterization (``ResNetCIFAR(space_to_depth=True)``, BatchNorm
and GroupNorm) and the exact s2d layout of the standard BatchNorm ResNet
(``models/s2d_exact.py``): the rearrangement and its channel order, the
three kernel converters bit for bit, the phase-pooled BatchNorm, ResNet-8
forwards through the weight converter, the exact model against the
port's own standard ResNet through the port's checkpoint converter, and
two FedAvg rounds of the exact model against the JAX package's.

Bands: forwards at atol = rtol = 1e-4 (the JAX package's own band for
the exact layout, ``tests/test_models.py``); the exact model against the
standard one in JAX's bands (eval 1e-4, train-mode logits 2e-4, batch
statistics rtol 1e-4 / atol 1e-5); FedAvg rounds at the ResNet FedAvg
tests' ``TOL`` (1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import fedml_tpu.config as jc
from fedml_tpu.algorithms import fedavg as jfed
from fedml_tpu.algorithms.base import _padded_perm
from fedml_tpu.core import random as JR
from fedml_tpu.models import s2d_exact as JS
from fedml_tpu.models.base import FedModel as JaxFedModel
from fedml_tpu.models.vision import ResNetCIFAR as JaxResNet
import fedml_tpu_torch.config as tc
from fedml_tpu_torch.algorithms import fedavg as tfed
from fedml_tpu_torch.convert import vision_state_dict
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models import s2d_exact as S
from fedml_tpu_torch.models.base import FedModel, weightless
from fedml_tpu_torch.models.vision import ResNetCIFAR, s2d_rearrange
from tests.test_torch_resnet_fedavg import TOL as ROUND_TOL
from tests.test_torch_resnet_fedavg import _data
from tests.test_torch_vision import RES_SHAPE, _images, flax_variables
from tests.torch_threads import one_torch_thread  # noqa: F401

FWD_TOL = dict(atol=1e-4, rtol=1e-4)
TRAIN_TOL = dict(atol=2e-4, rtol=2e-4)
STAT_TOL = dict(atol=1e-5, rtol=1e-4)


def _rng_array(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_s2d_rearrange_matches_jax_bitwise():
    x = _rng_array((2, 8, 6, 3))
    got = s2d_rearrange(torch.from_numpy(x))
    want = np.asarray(JS.s2d_rearrange(jnp.asarray(x)))
    assert got.shape == (2, 4, 3, 12) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def test_channel_order_is_phase_major_not_pixel_unshuffle():
    """``pixel_unshuffle`` puts pixel (u, v) of channel ci at 4 ci + 2u +
    v; the JAX package's layout at (2u + v) c + ci. The two hold the same
    values in another order: a transpose of the (c, 4) channel grid."""
    c = 3
    x = torch.from_numpy(_rng_array((2, 8, 8, c), seed=1))
    ours = s2d_rearrange(x).permute(0, 3, 1, 2)
    unshuffled = F.pixel_unshuffle(x.permute(0, 3, 1, 2), 2)
    assert not torch.equal(ours, unshuffled)
    b, _, h, w = unshuffled.shape
    assert torch.equal(ours, unshuffled.reshape(b, c, 4, h, w).transpose(
        1, 2).reshape(b, 4 * c, h, w))
    # one value pinned: pixel (0, 1) of channel 2 at phase 2u + v = 1
    assert ours[0, 1 * c + 2, 0, 0] == x[0, 0, 1, 2]


@pytest.mark.parametrize("name,shape", [
    ("convert_conv3x3_to_s2d", (3, 3, 2, 5)),
    ("convert_conv3x3_stride2_to_s2d", (3, 3, 2, 5)),
    ("convert_conv1x1_stride2_to_s2d", (1, 1, 3, 4)),
])
def test_converters_match_jax_bitwise(name, shape):
    w = _rng_array(shape, seed=2)
    got = getattr(S, name)(w)
    want = getattr(JS, name)(w)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("train", [True, False])
def test_phase_pooled_batch_norm_matches_jax(train):
    """Statistics pooled over the 4 phases of each channel, the variance
    unclipped, the running values at momentum 0.9; eval normalizes with
    the running values."""
    c = 3
    x = _rng_array((4, 5, 5, 4 * c), seed=3) * 2 + 0.5
    rng = np.random.default_rng(4)
    leaves = {k: rng.uniform(0.5, 1.5, 4 * c).astype(np.float32)
              for k in ("scale", "bias", "mean", "var")}
    flax_bn = JS.PhasePooledBatchNorm(use_running_average=not train)
    variables = {"params": {k: leaves[k] for k in ("scale", "bias")},
                 "batch_stats": {k: leaves[k] for k in ("mean", "var")}}
    if train:
        want, mutated = flax_bn.apply(variables, jnp.asarray(x),
                                      mutable=["batch_stats"])
    else:
        want = flax_bn.apply(variables, jnp.asarray(x))
    y, mean, var = S.phase_pooled_batch_norm(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        *(torch.from_numpy(leaves[k]) for k in ("scale", "bias", "mean",
                                                  "var")), train)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **FWD_TOL)
    if train:
        for k, got in (("mean", mean), ("var", var)):
            np.testing.assert_allclose(
                got.numpy(), np.asarray(mutated["batch_stats"][k]),
                **STAT_TOL, err_msg=k)
            # the batch's statistic is one value for every phase of a
            # channel
            batch = (got - 0.9 * torch.from_numpy(leaves[k])) / 0.1
            torch.testing.assert_close(batch.reshape(4, c),
                                       batch[:c].repeat(4, 1), atol=1e-5,
                                       rtol=0)
    else:
        assert mean is not None and torch.equal(
            mean, torch.from_numpy(leaves["mean"]))


def _s2d_pair(name):
    """The flax module, the port's module and the port's class name of a
    width-4 ResNet-8 ``name``."""
    if name == "resnet8_s2d_exact":
        return (JS.ResNetCIFARS2DExact(depth=8, num_classes=10, width=4),
                S.ResNetCIFARS2DExact(8, 10, width=4),
                "ResNetCIFARS2DExact")
    norm = "gn" if "_gn" in name else "bn"
    return (JaxResNet(depth=8, num_classes=10, width=4, norm=norm,
                      space_to_depth=True),
            ResNetCIFAR(8, 10, width=4, norm=norm, space_to_depth=True),
            "ResNetCIFAR")


@pytest.mark.parametrize("name", ["resnet8_s2d", "resnet8_gn_s2d",
                                  "resnet8_s2d_exact"])
def test_forward_matches_jax_through_the_converter(name):
    """Random flax variables converted with ``vision_state_dict``: the
    variables cover the port's model, shape for shape; eval logits, and
    train-mode logits with the new batch statistics, agree."""
    flax_net, module, arch = _s2d_pair(name)
    variables = flax_variables(flax_net, RES_SHAPE, seed=5)
    model = FedModel(weightless(lambda: module), RES_SHAPE,
                     torch.device("cpu"))
    params = vision_state_dict(variables, arch)
    init = model.init(torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in params.items()} == {
        k: v.shape for k, v in init.items()}
    x = _images(6)
    want = flax_net.apply(variables, jnp.asarray(x), train=False)
    got = model.apply_eval(params, torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    want, mutated = flax_net.apply(variables, jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
    got, new_vars = model.apply_train(params, torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    stats = vision_state_dict(jax.device_get(mutated), arch)
    assert set(stats) == set(model.stat_names)
    assert (len(stats) == 0) == ("_gn" in name)
    for k in stats:
        np.testing.assert_allclose(new_vars[k].detach().numpy(),
                                   stats[k].numpy(), **FWD_TOL, err_msg=k)


def test_exact_model_matches_the_standard_one_through_the_port_converter():
    """A standard port ResNet-8 (width 4, a random init) and the exact
    model with its variables converted by the port's
    ``convert_resnet_checkpoint_to_s2d``: the same function in eval and
    in train mode, and the converted stem statistics of the train step
    the standard ones tiled 4x. The port's converter gives the JAX
    converter's variables bit for bit."""
    std = FedModel(weightless(lambda: ResNetCIFAR(8, 10, width=4)),
                   RES_SHAPE, torch.device("cpu"))
    exact = FedModel(weightless(lambda: S.ResNetCIFARS2DExact(8, 10,
                                                             width=4)),
                     RES_SHAPE, torch.device("cpu"))
    v_std = std.init(torch.Generator().manual_seed(6))
    v_exact = S.convert_resnet_checkpoint_to_s2d(v_std, depth=8)
    init = exact.init(torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in v_exact.items()} == {
        k: v.shape for k, v in init.items()}
    x = torch.from_numpy(_images(6))
    np.testing.assert_allclose(exact.apply_eval(v_exact, x).detach().numpy(),
                               std.apply_eval(v_std, x).detach().numpy(),
                               **FWD_TOL)
    got, g_vars = exact.apply_train(v_exact, x)
    want, w_vars = std.apply_train(v_std, x)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               **TRAIN_TOL)
    for k in ("bn.running_mean", "bn.running_var"):
        np.testing.assert_allclose(g_vars[k].detach().numpy(),
                                   w_vars[k].detach().repeat(4).numpy(),
                                   **STAT_TOL, err_msg=k)

    # the JAX converter on the same weights (as flax variables)
    flax_std = JaxResNet(depth=8, num_classes=10, width=4)
    flax_vars = flax_variables(flax_std, RES_SHAPE, seed=7)
    want = vision_state_dict(JS.convert_resnet_checkpoint_to_s2d(
        flax_vars, depth=8), "ResNetCIFARS2DExact")
    got = S.convert_resnet_checkpoint_to_s2d(
        vision_state_dict(flax_vars, "ResNetCIFAR"), depth=8)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_two_fedavg_rounds_of_the_exact_model_match_jax():
    """Two rounds of 4 of 4 clients of ``resnet8_s2d_exact`` (width 4)
    in 2 size-sorted groups, the JAX package's cohorts and batch orders
    replayed, server_lr 0.7 and gmf 0.5: parameters, batch statistics
    (phase-pooled ones through the stats path, averaged outside the
    server optimizer) and train metrics in ``ROUND_TOL``."""
    flax_net, module, arch = _s2d_pair("resnet8_s2d_exact")
    variables = flax_variables(flax_net, RES_SHAPE, seed=8)
    model = FedModel(weightless(lambda: module), RES_SHAPE,
                     torch.device("cpu"))
    jdata, tdata = _data()
    common = dict(data=dict(num_clients=4, batch_size=4),
                  train=dict(lr=0.1, momentum=0.5, epochs=1,
                             cohort_groups=2),
                  fed=dict(num_rounds=2, clients_per_round=4, server_lr=0.7,
                           gmf=0.5))

    def cfg(m):
        return m.ExperimentConfig(
            data=m.DataConfig(**common["data"]),
            model=m.ModelConfig(name="resnet8_s2d_exact",
                                input_shape=RES_SHAPE),
            train=m.TrainConfig(**common["train"]),
            fed=m.FedConfig(**common["fed"]), seed=3)

    jsim = jfed.FedAvgSim(JaxFedModel(flax_net, RES_SHAPE,
                                      has_batch_stats=True), jdata, cfg(jc))
    max_n = jsim.arrays.max_client_samples

    def sampler(r, n, k):
        key = jax.random.fold_in(JR.round_key(jsim.root_key, r), 0)
        return torch.tensor(np.asarray(JR.sample_clients(key, n, k)))

    def batch_orders(r, c):
        ckey = JR.client_key(JR.round_key(jsim.root_key, r), c)
        return [torch.tensor(np.asarray(_padded_perm(
            jax.random.fold_in(ckey, 0), jsim.arrays.mask[c], max_n)))]

    tsim = tfed.FedAvgSim(model, tdata, cfg(tc), device="cpu",
                          sampler=sampler, batch_orders=batch_orders)
    assert len(tsim.model.stat_names) > 0
    jopt = jfed.make_server_optimizer("sgd", 0.7, 0.0)
    jvars = jax.tree.map(jnp.asarray, variables)
    jstate = jfed.ServerState(
        jvars, jopt.init(jvars["params"]),
        jax.tree.map(jnp.zeros_like, jvars["params"]),
        jnp.asarray(0, jnp.int32))
    tstate = tsim.init()._replace(variables=vision_state_dict(variables,
                                                              arch))
    for _ in range(2):
        jstate, jm = jsim.run_round(jstate)
        tstate, tm = tsim.run_round(tstate)
        for k in ("train_loss", "train_acc"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       **ROUND_TOL)
    want = vision_state_dict(jax.device_get(jstate.variables), arch)
    assert set(tstate.variables) == set(want)
    for k in want:
        np.testing.assert_allclose(tstate.variables[k].numpy(),
                                   want[k].numpy(), **ROUND_TOL, err_msg=k)


def test_factory_builds_the_s2d_names():
    """``create_model`` parses the JAX package's grammar: the widths of
    resnet20_s2d (stage widths 64, 32, 64 at width 16 over 12 input
    channels), resnet20_gn_s2d (GroupNorm, no statistics) and
    resnet20_s2d_exact (12-channel stem of 64, phase-pooled stage 1)."""
    def model(name):
        return create_model(tc.ModelConfig(name=name, num_classes=10,
                                           input_shape=(32, 32, 3)), "cpu")

    s2d = model("resnet20_s2d")
    assert s2d.module.space_to_depth
    v = s2d.init(torch.Generator().manual_seed(0))
    assert v["conv.weight"].shape == (64, 12, 3, 3)
    assert v["blocks.3.conv1.weight"].shape == (32, 64, 3, 3)
    assert v["blocks.3.proj.weight"].shape == (32, 64, 1, 1)
    assert v["blocks.6.conv1.weight"].shape == (64, 32, 3, 3)
    assert model("resnet20_gn_s2d").stat_names == ()
    exact = model("resnet20_s2d_exact")
    assert isinstance(exact.module, S.ResNetCIFARS2DExact)
    assert isinstance(exact.module.bn, S.PhasePooledBatchNorm)
    v = exact.init(torch.Generator().manual_seed(0))
    assert v["conv.weight"].shape == (64, 12, 3, 3)
    assert v["blocks.3.conv1.weight"].shape == (32, 64, 2, 2)
    assert v["bn.running_var"].shape == (64,)
    x = torch.zeros(2, 32, 32, 3)
    assert exact.apply_eval(v, x).shape == (2, 10)
