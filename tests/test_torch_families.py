"""The reference's FedAvg benchmark families on the port, against the JAX
package with weights carried across by ``fedml_tpu_torch.convert``:
GroupNorm, the GroupNorm ResNets (``resnet<d>_gn``, ``ResNet18GN``),
MobileNet and the federated LSTMs forward; one FedAvg round of ResNet-8-GN
under server adam, of MobileNet and of the char LSTM under FedNova with the
JAX package's cohorts and batch orders replayed, in float32 and bf16
(MobileNet's round in float64 on both sides); the
batched cohort against the per-client loop on a GroupNorm and an LSTM
model; the model factory and the command line."""

import contextlib
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu.config as jc
from fedml_tpu.algorithms import fedavg as jfed
from fedml_tpu.algorithms.base import _padded_perm
from fedml_tpu.algorithms.base import build_local_update as jax_local_update
from fedml_tpu.algorithms.base import make_task as jax_make_task
from fedml_tpu.core import random as JR
from fedml_tpu.data.federated import FederatedData as JaxFederatedData
from fedml_tpu.models.base import FedModel as JaxFedModel
from fedml_tpu.models.nlp import CharLSTM as JaxCharLSTM
from fedml_tpu.models.nlp import NWPLSTM as JaxNWPLSTM
from fedml_tpu.models.vision import MobileNet as JaxMobileNet
from fedml_tpu.models.vision import ResNet18GN as JaxResNet18GN
from fedml_tpu.models.vision import ResNetCIFAR as JaxResNet
import fedml_tpu_torch.config as tc
from fedml_tpu_torch.algorithms import fedavg as tfed
from fedml_tpu_torch.algorithms.base import build_local_update, make_task
from fedml_tpu_torch.convert import nlp_state_dict, vision_state_dict
from fedml_tpu_torch.data.federated import FederatedData
from fedml_tpu_torch.experiments import run as cli
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.base import FedModel, group_norm, weightless
from fedml_tpu_torch.models.nlp import NWPLSTM, CharLSTM
from fedml_tpu_torch.models.vision import MobileNet, ResNet18GN, ResNetCIFAR
from tests.torch_threads import one_torch_thread  # noqa: F401

IMG = (16, 16, 3)
# CIFAR's size: at 16 x 16 MobileNet's last blocks are 1 x 1, and their
# BatchNorm statistics over a batch of 4 are degenerate
MOBILENET_IMG = (32, 32, 3)
T, VOCAB, HIDDEN = 12, 23, 16
B = 4
COUNTS = (10, 3, 7, 5)  # samples per client: full, partial, padded batches
# forward in float32, the same weights on both sides: only the order of
# the sums differs (measured: at most 2.4e-6 on these models)
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
# one FedAvg round in float32: the reference's band for reassociated
# float32 reductions (tests/test_bulk.py)
ROUND_TOL = dict(rtol=2e-5, atol=2e-6)
# the ResNet-8 bf16 band (tests/test_torch_resnet_fedavg.py)
BF16_TOL = dict(atol=0.05, rtol=0.1)
# MobileNet's float32 BatchNorm is ill-conditioned at a random init: its
# depthwise convolutions of ReLU outputs have a mean far above their
# spread, so the fast variance E[x^2] - E[x]^2 cancels, and the gradient
# reaches hundreds. Its round runs in float64 in both packages and is held
# at ROUND_TOL: measured, 1.4e-7 at most at 1, 2, 4 and 8 torch threads
# (the port's float32 round was 0.0128-0.0403 from the JAX float64 one,
# the JAX package's own float32 round 0.167)
# its train-mode forward (batch statistics) against flax in float64:
# measured at most 1.1e-5 over three inputs
MOBILENET_FWD_TOL = dict(atol=5e-5, rtol=1e-5)
# the reference's band for a grouped cohort against one group
GROUP_TOL = dict(rtol=2e-5, atol=2e-6)


def flax_variables(module, x, seed=0):
    """Random flax variables for ``module`` on input ``x`` from numpy,
    without compiling: kernels with std 1/sqrt(fan_in), running variances
    in [0.5, 1.5], the rest with std 0.3."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), x,
                                                train=False))
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


# name -> (flax module, port module, convert, input shape, input dtype)
def _archs():
    return {
        "resnet8_gn": (JaxResNet(8, 10, norm="gn", width=4),
                       lambda: ResNetCIFAR(8, 10, width=4, norm="gn"),
                       lambda v: vision_state_dict(v, "ResNetCIFAR"), IMG,
                       np.float32),
        "resnet18_gn": (JaxResNet18GN(10), lambda: ResNet18GN(10),
                        lambda v: vision_state_dict(v, "ResNet18GN"), IMG,
                        np.float32),
        "mobilenet": (JaxMobileNet(10, 0.25), lambda: MobileNet(10, 0.25),
                      lambda v: vision_state_dict(v, "MobileNet"),
                      MOBILENET_IMG, np.float32),
        "char_lstm": (JaxCharLSTM(VOCAB, hidden=HIDDEN),
                      lambda: CharLSTM(VOCAB, hidden=HIDDEN),
                      lambda v: nlp_state_dict(v, "CharLSTM"), (T,),
                      np.int32),
        "nwp_lstm": (JaxNWPLSTM(VOCAB, embed_dim=8, hidden=HIDDEN),
                     lambda: NWPLSTM(VOCAB, embed_dim=8, hidden=HIDDEN),
                     lambda v: nlp_state_dict(v, "NWPLSTM"), (T,),
                     np.int32),
    }


def _pair(name, seed=0):
    """(flax module, its random variables, the port's model, the same
    variables converted, the input shape)."""
    flax_net, build, convert, shape, dtype = _archs()[name]
    variables = flax_variables(flax_net, jnp.zeros((1,) + shape, dtype), seed)
    model = FedModel(weightless(build), shape, torch.device("cpu"),
                     input_dtype=torch.int32 if dtype == np.int32
                     else torch.float32)
    port = convert(variables)
    assert set(port) == set(model.module.state_dict()), name
    return flax_net, variables, model, port, shape


def _inputs(n, shape, dtype, seed=1):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        return rng.integers(0, VOCAB, (n,) + shape).astype(np.int32)
    return rng.standard_normal((n,) + shape).astype(np.float32)


# -- GroupNorm ----------------------------------------------------------------


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_group_norm_matches_flax(groups):
    """Per-sample statistics over each group of channels and the spatial
    dims, epsilon 1e-6, the fast variance, per-channel scale and bias, in
    float32; under bf16 the statistics stay float32 and the result is
    bf16, as flax's."""
    rng = np.random.default_rng(groups)
    # sample 0 off centre; sample 1 with a variance of 1e-4, where the
    # epsilon shows
    x = (rng.standard_normal((2, 5, 6, 8))
         * np.array([2.0, 0.01])[:, None, None, None]
         + np.array([3.0, 0.0])[:, None, None, None]).astype(np.float32)
    scale = rng.standard_normal(8).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    gn = fnn.GroupNorm(num_groups=groups)
    variables = {"params": {"scale": scale, "bias": bias}}
    for dtype, tol in ((jnp.float32, FWD_TOL), (jnp.bfloat16, BF16_TOL)):
        cast = jax.tree.map(lambda a: jnp.asarray(a, dtype), variables)
        want = gn.apply(cast, jnp.asarray(x, dtype))
        tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
        got = group_norm(torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2),
                         torch.from_numpy(scale).to(tdt),
                         torch.from_numpy(bias).to(tdt), groups)
        assert got.dtype == tdt and want.dtype == dtype
        np.testing.assert_allclose(
            got.float().permute(0, 2, 3, 1).numpy(),
            np.asarray(want.astype(jnp.float32)), **tol)


# -- forward parity -----------------------------------------------------------


@pytest.mark.parametrize("name", ["resnet8_gn", "resnet18_gn", "mobilenet",
                                  "char_lstm", "nwp_lstm"])
def test_forward_matches_flax(name):
    """Eval-mode logits at batch 2 (ResNet-18-GN at its full widths);
    for MobileNet also the train-mode logits and new BatchNorm statistics,
    against flax in float64 (MOBILENET_FWD_TOL). A GroupNorm or LSTM
    model has no statistics."""
    flax_net, variables, model, port, shape = _pair(name)
    dtype = _archs()[name][4]
    x = _inputs(2, shape, dtype)
    want = flax_net.apply(variables, jnp.asarray(x), train=False)
    got = model.apply_eval(port, torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    if name != "mobilenet":
        assert model.stat_names == ()
        return
    with jax.enable_x64(True):
        want, mutated = jax.jit(lambda v, x: flax_net.apply(
            v, x, train=True, mutable=["batch_stats"]))(
            jax.tree.map(lambda a: a.astype(np.float64), variables),
            jnp.asarray(x, jnp.float64))
        want = np.asarray(want, np.float32)
        stats = vision_state_dict(jax.tree.map(
            lambda a: np.asarray(a, np.float32),
            {"batch_stats": jax.device_get(mutated["batch_stats"])}),
            "MobileNet")
    got, new_vars = model.apply_train(port, torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want,
                               **MOBILENET_FWD_TOL)
    assert set(stats) == set(model.stat_names)
    for k, v in stats.items():
        np.testing.assert_allclose(new_vars[k].numpy(), v.numpy(),
                                   **MOBILENET_FWD_TOL, err_msg=k)


def test_resnet18_gn_one_step_matches_jax():
    """ResNet-18-GN at its full widths: one SGD step of a client of 2
    samples at batch 2, in float32, on both sides."""
    flax_net, variables, model, port, shape = _pair("resnet18_gn", seed=3)
    x = _inputs(2, shape, np.float32)
    y = np.array([1, 7], np.int32)
    train = dict(optimizer="sgd", lr=0.05, epochs=1)
    jlu = jax.jit(jax_local_update(JaxFedModel(flax_net, shape),
                                   jax_make_task("classification"),
                                   jc.TrainConfig(**train), 2, 2))
    idx, mask = np.arange(2, dtype=np.int32), np.ones(2, np.float32)
    want, _, msums = jlu(variables, jnp.asarray(idx), jnp.asarray(mask),
                         jnp.asarray(x), jnp.asarray(y), jax.random.key(0))
    tlu = build_local_update(model, make_task("classification"),
                             tc.TrainConfig(**train), 2, 2)
    got, _, sums = tlu(port, torch.from_numpy(idx), torch.from_numpy(mask),
                       torch.from_numpy(x), torch.from_numpy(y),
                       [torch.arange(2)])
    want = vision_state_dict(jax.device_get(want), "ResNet18GN")
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   **FWD_TOL, err_msg=k)
    np.testing.assert_allclose(float(sums["loss_sum"]),
                               float(msums["loss_sum"]), rtol=1e-5)


# -- one FedAvg round ---------------------------------------------------------


def _data(shape, dtype):
    n = sum(COUNTS)
    rng = np.random.default_rng(0)
    if dtype == np.int32:
        seq = rng.integers(0, VOCAB, (n + 8, T + 1)).astype(np.int32)
        x, y, classes, task = seq[:, :-1], seq[:, 1:], VOCAB, "nwp"
    else:
        x = rng.standard_normal((n + 8,) + shape).astype(np.float32)
        y = rng.integers(0, 10, n + 8).astype(np.int32)
        classes, task = 10, "classification"
    starts = np.cumsum((0,) + COUNTS)
    train = {i: np.arange(starts[i], starts[i + 1])
             for i in range(len(COUNTS))}
    test = {i: np.arange(2 * i, 2 * i + 2) for i in range(len(COUNTS))}
    args = (x[:n], y[:n], x[n:], y[n:], train, test, classes)
    return JaxFederatedData(*args, task=task), FederatedData(*args, task=task)


ROUNDS = {
    # name -> (algorithm, server optimizer, server lr, lr, batch, epochs)
    "resnet8_gn": ("fedopt", "adam", 1e-3, 0.05, B, 2),
    "mobilenet": ("fedavg", "sgd", 1.0, 1e-3, B, 1),
    "char_lstm": ("fednova", "sgd", 1.0, 0.5, B, 2),
}


@pytest.mark.parametrize("name,compute_dtype", [
    ("resnet8_gn", "float32"), ("mobilenet", "float32"),
    ("char_lstm", "float32"), ("resnet8_gn", "bfloat16"),
    ("char_lstm", "bfloat16")])
def test_fedavg_round_matches_jax(name, compute_dtype):
    """One round of 3 of 4 clients (10, 3, 7 and 5 samples, 2 epochs,
    batch 4), with the JAX package's cohort and batch orders replayed:
    parameters, statistics and train metrics agree in ROUND_TOL in
    float32, at the ResNet-8 bf16 band under bf16."""
    flax_net, variables, model, port, shape = _pair(name, seed=2)
    dtype = _archs()[name][4]
    jdata, tdata = _data(shape, dtype)
    algorithm, server_opt, server_lr, lr, batch, epochs = ROUNDS[name]
    tol = ROUND_TOL if compute_dtype == "float32" else BF16_TOL

    # MobileNet's BatchNorm is ill-conditioned in float32 (see ROUND_TOL):
    # both packages run its round in float64, the port through a float64
    # compute type and float64 variables
    x64 = name == "mobilenet"

    def cfg(m, dtype=compute_dtype):
        return m.ExperimentConfig(
            data=m.DataConfig(num_clients=len(COUNTS), batch_size=batch),
            model=m.ModelConfig(name=name, input_shape=shape),
            train=m.TrainConfig(lr=lr, epochs=epochs, cohort_groups=1,
                                compute_dtype=dtype),
            fed=m.FedConfig(algorithm=algorithm, num_rounds=1,
                            clients_per_round=3, server_optimizer=server_opt,
                            server_lr=server_lr, gmf=0.5),
            seed=3)

    with jax.enable_x64(True) if x64 else contextlib.nullcontext():
        jsim = jfed.FedAvgSim(JaxFedModel(
            flax_net, shape, has_batch_stats=bool(model.stat_names),
            input_dtype=jnp.int32 if dtype == np.int32 else jnp.float32),
            jdata, cfg(jc))
        max_n = jsim.arrays.max_client_samples

        def sampler(r, n, k):  # the JAX package's cohort draw for round r
            key = jax.random.fold_in(JR.round_key(jsim.root_key, r), 0)
            return torch.tensor(np.asarray(JR.sample_clients(key, n, k)))

        def batch_orders(r, c):  # and its batch orders for client c
            ckey = JR.client_key(JR.round_key(jsim.root_key, r), c)
            return [torch.tensor(np.asarray(_padded_perm(
                jax.random.fold_in(ckey, e), jsim.arrays.mask[c], max_n)))
                for e in range(epochs)]

        jopt = jfed.make_server_optimizer(server_opt, server_lr, 0.0)
        jvars = jax.tree.map(
            lambda a: jnp.asarray(a, jnp.float64 if x64 else jnp.float32),
            variables)
        jstate = jfed.ServerState(
            jvars, jopt.init(jvars["params"]),
            jax.tree.map(jnp.zeros_like, jvars["params"]),
            jnp.asarray(0, jnp.int32))
        jstate, jm = jsim.run_round(jstate)
        cohort = [sampler(0, len(COUNTS), 3)] + [
            batch_orders(0, c) for c in range(len(COUNTS))]
        jstate = jax.tree.map(
            lambda a: np.asarray(a, np.float64 if x64 else np.float32),
            jax.device_get(jstate.variables))
        jm = {k: float(v) for k, v in jm.items()}
    dtype = torch.float64 if x64 else torch.float32
    tsim = tfed.FedAvgSim(model, tdata,
                          cfg(tc, "float64") if x64 else cfg(tc),
                          device="cpu",
                          sampler=lambda r, n, k: cohort[0],
                          batch_orders=lambda r, c: cohort[1 + c])
    tstate = tsim.init()._replace(
        variables={k: v.to(dtype) for k, v in port.items()})
    tstate, tm = tsim.run_round(tstate)
    for k in ("train_loss", "train_acc"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **tol)
    want = _archs()[name][2](jstate)
    assert set(tstate.variables) == set(want)
    for k in want:
        assert tstate.variables[k].dtype == dtype, k
        np.testing.assert_allclose(tstate.variables[k].numpy(),
                                   want[k].numpy(), **tol, err_msg=k)


# -- the batched cohort -------------------------------------------------------


@pytest.mark.parametrize("name", ["resnet8_gn", "char_lstm"])
def test_cohort_matches_per_client_loop(name):
    """The batched cohort (vmapped, 2 size-sorted groups, each stepping
    as often as its largest client) gives each client of a GroupNorm and
    an LSTM model the parameters, n_k and metric sums of its own
    per-client update (test_torch_cohort.py's test of the same name on
    ResNet-8 with BatchNorm)."""
    _, _, _, _, shape = _pair(name)
    dtype = _archs()[name][4]
    _, tdata = _data(shape, dtype)
    extra = (("vocab_size", VOCAB),) if dtype == np.int32 else ()
    cfg = tc.ExperimentConfig(
        data=tc.DataConfig(num_clients=len(COUNTS), batch_size=B),
        model=tc.ModelConfig(name=name, num_classes=VOCAB if extra else 10,
                             input_shape=shape, extra=extra),
        train=tc.TrainConfig(lr=0.1, momentum=0.5, epochs=2,
                             cohort_groups=2),
        fed=tc.FedConfig(clients_per_round=len(COUNTS)), seed=1)
    sim = tfed.FedAvgSim(create_model(cfg.model, "cpu"), tdata, cfg, "cpu")
    state = sim.init()
    stacked, n_k, sums = sim._locals(state)
    assert [s for _, s in sim.last_groups] == [3, 2]
    a = sim.arrays
    cohort = sim.sampler(0, a.num_clients, len(COUNTS)).tolist()
    for i, c in enumerate(cohort):
        want, want_n, want_sums = sim.local_update(
            state.variables, a.idx[c], a.mask[c], a.x, a.y,
            sim.batch_orders(0, c))
        assert float(n_k[i]) == float(want_n) == COUNTS[c]
        for k in want:
            torch.testing.assert_close(stacked[k][i], want[k], **GROUP_TOL,
                                       msg=f"client {c} {k}")
        for k in want_sums:
            torch.testing.assert_close(sums[k][i], want_sums[k],
                                       **GROUP_TOL)


# -- the factory, the initializers, the command line --------------------------


@pytest.mark.parametrize("name,extra,kind,n_params", [
    ("resnet20_gn", (), "GroupNorm", 272474),
    ("resnet20", (("norm", "gn"),), "GroupNorm", 272474),
    ("resnet20_gn", (("norm", "bn"),), "BatchNorm", 272474),
    ("resnet18_gn", (), "GroupNorm", 11173962),
    ("mobilenet", (), "BatchNorm", 3217226),
    ("mobilenet", (("width_mult", 0.5),), "BatchNorm", 823722),
])
def test_factory_builds_the_families(name, extra, kind, n_params):
    """The names and extras of the JAX package's factory; the parameter
    counts are the flax models' (ResNet-18-GN about 11M)."""
    model = create_model(tc.ModelConfig(name=name, input_shape=(32, 32, 3),
                                        extra=extra), "meta")
    kinds = {type(m).__name__ for m in model.module.modules()}
    assert kind in kinds and ({"GroupNorm", "BatchNorm"} - {kind}) & kinds \
        == set()
    assert sum(p.numel() for p in model.module.parameters()) == n_params
    assert bool(model.stat_names) == (kind == "BatchNorm")


def test_factory_builds_the_lstms_and_refuses_the_rest():
    for name, cls, vocab in (("rnn", CharLSTM, 90),
                             ("char_lstm", CharLSTM, 90),
                             ("rnn_stackoverflow", NWPLSTM, 10004),
                             ("nwp_lstm", NWPLSTM, 10004)):
        model = create_model(tc.ModelConfig(name=name, input_shape=(20,)),
                             "meta")
        assert isinstance(model.module, cls) and model.module.vocab_size == \
            vocab and model.input_dtype == torch.int32
    model = create_model(tc.ModelConfig(name="nwp_lstm", input_shape=(20,),
                                        extra=(("vocab_size", 2000),)),
                         "meta")
    assert model.module.head.weight.shape == (2000, 96)
    with pytest.raises(ValueError, match="norm override"):
        create_model(tc.ModelConfig(name="resnet18_gn",
                                    extra=(("norm", "bn"),)), "meta")
    with pytest.raises(ValueError, match="unknown norm"):
        create_model(tc.ModelConfig(name="resnet20",
                                    extra=(("norm", "ln"),)), "meta")
    with pytest.raises(ValueError, match="not ported"):
        create_model(tc.ModelConfig(name="darts"), "meta")


def test_initializers_of_the_new_leaves():
    """GroupNorm scale ones and bias zeros; an LSTM's recurrent kernels
    orthogonal gate by gate, its input kernels lecun-normal, its bias
    zeros."""
    model = create_model(tc.ModelConfig(name="resnet8_gn",
                                        input_shape=IMG), "cpu")
    v = model.init(torch.Generator().manual_seed(0))
    assert torch.equal(v["blocks.1.proj_bn.weight"], torch.ones(32))
    assert torch.equal(v["bn.bias"], torch.zeros(16))
    model = create_model(tc.ModelConfig(name="nwp_lstm", input_shape=(T,),
                                        extra=(("vocab_size", 50),)), "cpu")
    v = model.init(torch.Generator().manual_seed(0))
    w_hh = v["lstm.weight_hh"]
    assert w_hh.shape == (4 * 670, 670)
    for gate in w_hh.split(670):
        torch.testing.assert_close(gate @ gate.T, torch.eye(670), atol=1e-4,
                                   rtol=0)
    std = 96 ** -0.5
    assert abs(float(v["lstm.weight_ih"].std()) - std) < 0.05 * std
    assert torch.equal(v["lstm.bias"], torch.zeros(4 * 670))


@pytest.mark.parametrize("argv", [
    ["--algorithm", "fedopt", "--server_optimizer", "yogi",
     "--server_lr", "0.01", "--model", "resnet8_gn", "--dataset",
     "fake_cifar10", "--num_classes", "10", "--input_shape", "16", "16",
     "3"],
    ["--algorithm", "fednova", "--model", "rnn", "--dataset",
     "fake_shakespeare", "--num_classes", "90", "--input_shape", "80"],
    ["--algorithm", "fedprox", "--model", "mobilenet", "--dataset",
     "fake_cifar10", "--num_classes", "10", "--input_shape", "32", "32",
     "3"],
])
def test_cli_runs_the_families(argv, capsys, tmp_path):
    """The CLI runs fedopt (server yogi), fednova and fedprox (prox_mu from
    --config) on the CPU at a tiny size and prints its summary."""
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"train": {"prox_mu": 0.01},
                                "model": {"extra": {"width_mult": 0.25}}}
                               if "fedprox" in argv else {}))
    common = ["--config", str(path), "--client_num_in_total", "100",
              "--client_num_per_round", "2", "--comm_round", "1",
              "--batch_size", "16", "--frequency_of_the_test", "1",
              "--device", "cpu", "--out_dir", str(tmp_path)]
    cfg, _ = cli.parse_args(argv + common)
    assert cfg.fed.algorithm == argv[1]
    assert cli.main(argv + common) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["round"] == 0
    assert all(np.isfinite(summary[k]) for k in
               ("train_loss", "test_loss", "test_acc"))
