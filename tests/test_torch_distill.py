"""The distillation family and the dropout classifier in the port against
the JAX package: CNN_DropOut's and ``cnn_custom``'s forwards with
dropout, ``logits_mse``, ``build_public_set`` bit for bit, two FedAvg
rounds over ``cnn``, FedMD's pretraining and two rounds, two FD+FAug
rounds (models, teachers, flags) and its leave-one-out algebra, two
FedArjun rounds (adapter and local stack), and a CLI run of each
algorithm.

Every sim runs at ``tests/test_distill_sgan.py``'s tiny configuration
(fake_mnist, 96 samples, 4 clients, 2 a round, batch 8, a public set of
32), hetero 0.3, so groups run gated padding steps. The port replays the
JAX sims' cohorts, batch orders and dropout masks through its hooks
(``sampler``, ``batch_orders``, ``draws``). The masks are captured from
the flax module under ``flax.linen.intercept_methods``, as
``tests/test_torch_gan_family.py`` captures the discriminator's: each
``nn.Dropout`` draws its key by ``make_rng("dropout")``, the interceptor
records ``bernoulli(key, 1 - rate, shape)`` and calls on with that key,
and each step's dropout key is derived as the JAX package derives it
(``fold_in(fold_in(phase key, epoch), step)``). Weights cross with
``fedml_tpu_torch/convert.py``. Float32 at rtol 1e-4, atol 1e-5, except
FedMD's rounds and FD's rounds, ill-conditioned in float32 at this
configuration (ROADMAP Queue C, C5): both packages run them in float64
(``jax.enable_x64``; the port's data and variables float64), held at the
same band."""

import dataclasses
import json
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu.config as jc
import fedml_tpu_torch.config as tc
from fedml_tpu.algorithms import distill as JD
from fedml_tpu.algorithms import fedavg as jfed
from fedml_tpu.algorithms import kd as JKD
from fedml_tpu.core import random as JR
from fedml_tpu.data.loaders import make_fake_image_dataset as jax_fake_images
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu_torch.algorithms import distill as TD
from fedml_tpu_torch.algorithms import fedavg as tfed
from fedml_tpu_torch.algorithms.kd import logits_mse, soft_target
from fedml_tpu_torch.convert import vision_state_dict
from fedml_tpu_torch.data.loaders import make_fake_image_dataset
from fedml_tpu_torch.models import create_model
from tests.test_torch_gan import close, close_vars, flax_vars, lane_orders
from tests.torch_threads import one_torch_thread  # noqa: F401

FWD = dict(rtol=1e-5, atol=1e-6)  # float32 forwards
MATH = dict(rtol=1e-6, atol=1e-6)
ROUND = dict(rtol=1e-4, atol=1e-5)
B, K = 8, 10
SHAPE = (28, 28, 1)
PRETRAIN = 0xBEEF  # the JAX FedMD's pretraining key salt
# keys a capture call takes: each call is padded to a multiple, so the
# capture compiles once per mode (float32, float64), not once a shape
CAPTURE_KEYS = 256


def tiny_cfg(m, algo="fedavg", model="cnn", **gan):
    """tests/test_distill_sgan.py's tiny_cfg (hetero 0.3 here)."""
    gan = {**dict(nz=16, ngf=8, distillation_size=16, kd_epochs=1,
                  public_size=32, digest_epochs=1, revisit_epochs=1,
                  pretrain_epochs_public=1, pretrain_epochs_private=1),
           **gan}
    return m.ExperimentConfig(
        data=m.DataConfig(dataset="fake_mnist", num_clients=4,
                          partition_method="hetero", partition_alpha=0.3,
                          batch_size=B, seed=0),
        model=m.ModelConfig(name=model, num_classes=K, input_shape=SHAPE),
        train=m.TrainConfig(lr=0.05, epochs=1),
        fed=m.FedConfig(algorithm=algo, num_rounds=2, clients_per_round=2,
                        eval_every=1),
        gan=m.GanConfig(**gan), seed=0)


def datasets(jcfg, tcfg):
    return (jax_fake_images("mnist", jcfg.data, n_train=96, n_test=32),
            make_fake_image_dataset("mnist", tcfg.data, n_train=96,
                                    n_test=32))


def port_vars(variables, arch="CNNDropOut", lead=0):
    return vision_state_dict(jax.device_get(variables), arch, lead=lead)


# ---------------------------------------------------------------------------
# the JAX package's dropout masks
# ---------------------------------------------------------------------------


def mask_capture(module, batch=B):
    """``capture(keys [n]) -> [site masks [n, batch, ...]]``: the masks of
    one train-mode call of ``module`` a key (the call's ``rngs={"dropout":
    key}``), jitted and vmapped."""
    variables = jax.tree.map(jnp.asarray,
                             flax_vars(module, jnp.zeros((1,) + SHAPE)))

    def one(rng):
        recorded = []

        def interceptor(next_fun, args, kwargs, context):
            mod = context.module
            if (isinstance(mod, nn.Dropout) and context.method_name
                    == "__call__" and not mod.deterministic):
                key = mod.make_rng("dropout")
                recorded.append(jax.random.bernoulli(key, 1.0 - mod.rate,
                                                     args[0].shape))
                return next_fun(*args, rng=key, **kwargs)
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(interceptor):
            module.apply(variables, jnp.zeros((batch,) + SHAPE), train=True,
                         rngs={"dropout": rng})
        return recorded

    run = jax.jit(jax.vmap(one))

    def capture(keys):
        n = keys.shape[0]
        pad = -n % CAPTURE_KEYS
        keys = jnp.concatenate([keys, jnp.repeat(keys[:1], pad)])
        return [m[:n] for m in run(keys)]

    return capture


@jax.jit
def _step_keys(base, es, ss):
    """Epoch e, step s under a phase key: fold_in(fold_in(base, e), s)."""
    return jax.vmap(lambda e: jax.vmap(lambda s: jax.random.fold_in(
        jax.random.fold_in(base, e), s))(ss))(es)


def to_port_masks(site_masks, lead):
    return {f"d{i}": torch.tensor(np.asarray(m).reshape(
        tuple(lead) + m.shape[1:])) for i, m in enumerate(site_masks)}


class Replay:
    """The port's hooks replaying a JAX sim: its cohorts, each phase's
    batch orders (``orders[phase](r, c)``: the phase's key, whose epoch
    ``e`` order is ``permutation(fold_in(key, e))``, real samples first)
    and each stream's dropout masks (``masks[stream](r, c)``: the phase's
    key, whose step keys are ``fold_in(fold_in(key, e), s)``)."""

    def __init__(self, jsim, capture, orders, masks):
        self.jsim, self.capture = jsim, capture
        self.orders, self.masks = orders, masks
        self.max_n = jsim.arrays.max_client_samples

    def rkey(self, r):
        return JR.round_key(self.jsim.root_key, r)

    def ckey(self, r, c):
        return JR.client_key(self.rkey(r), c)

    def sampler(self, r, n, k):
        return torch.tensor(np.asarray(JR.sample_clients(
            jax.random.fold_in(self.rkey(r), 0), n, k)))

    def batch_orders(self, r, c, phase="local", epochs=None):
        epochs = epochs or self.jsim.cfg.train.epochs
        return list(torch.tensor(lane_orders(
            self.orders[phase](r, c), self.jsim.arrays.mask[c], epochs,
            self.max_n)))

    def draws(self, stream, r, slots, shapes):
        lead = next(iter(shapes.values()))[:2]
        keys = jnp.stack([_step_keys(self.masks[stream](r, c),
                                     jnp.arange(lead[0]),
                                     jnp.arange(lead[1])).reshape(-1)
                          for c in slots]).reshape(-1)
        return to_port_masks(self.capture(keys), (len(slots), *lead))

    def hooks(self):
        return dict(sampler=self.sampler, batch_orders=self.batch_orders,
                    draws=self.draws)


def f64(tree):
    """A JAX tree's floating leaves as float64 (under ``enable_x64``)."""
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)
                        if jnp.issubdtype(a.dtype, jnp.floating) else a,
                        tree)


def to_float64(tsim, names=("x", "test_x")):
    """A port sim's float inputs as float64: its rounds then run in
    float64 from float64 variables (the updates compute in the
    variables' type)."""
    for name in names:
        setattr(tsim.arrays, name, getattr(tsim.arrays, name).double())
    if hasattr(tsim, "pub_x"):
        tsim.pub_x = tsim.pub_x.double()
    return tsim


def double(tree):
    return {k: v.double() if v.is_floating_point() else v
            for k, v in tree.items()}


def stacked_vars(module, n, seed=0):
    """``n`` clients' random flax variables of ``module``, stacked (numpy,
    no compile; ``tests/test_torch_gan.py`` ``flax_vars``, seeds ``seed +
    i``)."""
    trees = [flax_vars(module, jnp.zeros((1,) + SHAPE), seed=seed + i)
             for i in range(n)]
    return jax.tree.map(lambda *a: np.stack(a), *trees)


def fold(key, *salts):
    for s in salts:
        key = jax.random.fold_in(key, s)
    return key


# ---------------------------------------------------------------------------
# forwards and losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["cnn", "cnn_custom"])
def test_dropout_classifier_matches_flax(name):
    """Train mode with the flax module's own masks replayed, and eval
    mode, from the same weights; ``cnn_custom`` at dropout 0.3 after
    each of two dense layers."""
    extra = ((("convs", (4, 6)), ("denses", (12, 7)), ("dropout", 0.3))
             if name == "cnn_custom" else ())
    jmodel = jax_create_model(jc.ModelConfig(name=name, num_classes=K,
                                             input_shape=SHAPE, extra=extra))
    tmodel = create_model(tc.ModelConfig(name=name, num_classes=K,
                                         input_shape=SHAPE, extra=extra),
                          "cpu")
    assert jmodel.has_dropout and tmodel.has_dropout
    variables = flax_vars(jmodel.module, jnp.zeros((1,) + SHAPE))
    arch = "CNNDropOut" if name == "cnn" else "CNNParameterised"
    ours = port_vars(variables, arch)
    assert set(ours) == set(tmodel.init(torch.Generator()))
    x = np.random.default_rng(1).standard_normal((B,) + SHAPE).astype(
        np.float32)
    keys = jax.random.split(jax.random.key(3), 2)
    masks = mask_capture(jmodel.module)(keys)
    for i, key in enumerate(keys):
        want, _ = jmodel.apply_train(variables, jnp.asarray(x), key)
        got, _ = tmodel.apply_train(
            ours, torch.tensor(x),
            masks={k: v[i] for k, v in to_port_masks(masks, (2,)).items()})
        close(got, want, FWD, f"train {i}")
    close(tmodel.apply_eval(ours, torch.tensor(x)),
          jmodel.apply_eval(variables, jnp.asarray(x)), FWD, "eval")
    if name == "cnn":
        sites = tmodel.mask_sites
        assert sites == {"d0": (12, 12, 64), "d1": (128,)}
        assert sum(int(np.prod(s)) for s in sites.values()) == 9344
        assert tmodel.mask_keep == {"d0": 0.75, "d1": 0.5}
        wide = create_model(tc.ModelConfig(name="cnn", num_classes=62,
                                           input_shape=SHAPE), "cpu")
        n = sum(v.numel() for v in wide.init(torch.Generator()).values())
        assert 1.2e6 < n < 1.21e6, n


def test_train_forward_without_masks_raises():
    """A dropout model's train-mode forward draws no mask of its own:
    without masks it raises, never keeping every activation."""
    model = create_model(tc.ModelConfig(name="cnn", num_classes=K,
                                        input_shape=SHAPE), "cpu")
    variables = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="keep masks"):
        model.apply_train(variables, torch.zeros((2,) + SHAPE))
    # eval mode keeps every activation, as flax's deterministic dropout
    assert model.apply_eval(variables, torch.zeros((2,) + SHAPE)).shape \
        == (2, K)


def test_kd_losses_match_jax():
    rng = np.random.default_rng(0)
    s, t = (rng.standard_normal((6, K)).astype(np.float32) * 3
            for _ in range(2))
    w = np.array([1, 1, 0, 1, 0, 1], np.float32)
    close(logits_mse(torch.tensor(s), torch.tensor(t)),
          JKD.logits_mse(s, t), MATH)
    close(logits_mse(torch.tensor(s), torch.tensor(t), torch.tensor(w)),
          JKD.logits_mse(s, t, w), MATH)
    close(soft_target(torch.tensor(s), torch.tensor(t), 4.0,
                      torch.tensor(w)),
          JKD.soft_target(s, t, 4.0, w), MATH)


def test_build_public_set_is_bitwise():
    for size, n_clients in ((32, 4), (40, 3), (96, 4)):
        jcfg, tcfg = tiny_cfg(jc), tiny_cfg(tc)
        jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(
            jcfg.data, num_clients=n_clients))
        tcfg = dataclasses.replace(tcfg, data=dataclasses.replace(
            tcfg.data, num_clients=n_clients))
        jdata, tdata = datasets(jcfg, tcfg)
        jx, jy = JD.build_public_set(jdata, size, B, 0)
        tx, ty = TD.build_public_set(tdata, size, B, 0)
        assert tx.shape[0] == size // B * B
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)


def test_leave_one_out_label_algebra():
    """tests/test_distill_sgan.py's two-client case, and a label only one
    member saw: its teacher row stays, its flag stays off."""
    lab_avg = torch.tensor([[[1.0, 0.0], [2.0, 0.0]],
                            [[3.0, 0.0], [5.0, 0.0]]])
    loo, have = TD.leave_one_out_labels(lab_avg, torch.ones(2, 2))
    assert torch.equal(loo[0, 0], torch.tensor([3.0, 0.0]))
    assert torch.equal(loo[1, 1], torch.tensor([2.0, 0.0]))
    assert bool(have.all())
    rng = np.random.default_rng(2)
    avg = rng.standard_normal((3, K, K)).astype(np.float32)
    cnt = rng.integers(0, 3, (3, K)).astype(np.float32)
    cnt[:, 4] = [2, 0, 0]
    loo, have = TD.leave_one_out_labels(torch.tensor(avg),
                                        torch.tensor(cnt))
    seen = (cnt > 0).astype(np.float32)
    tot = (avg * seen[..., None]).sum(0)
    m = np.maximum(seen.sum(0)[None] - seen, 1.0)
    want = (tot[None] - avg * seen[..., None]) / m[..., None]
    close(loo, want, MATH)
    np.testing.assert_array_equal(have.numpy(),
                                  (seen.sum(0)[None] - seen) > 0)
    assert not bool(have[0, 4]) and bool(have[1, 4])


# ---------------------------------------------------------------------------
# rounds against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def capture():
    return mask_capture(jax_create_model(jc.ModelConfig(
        name="cnn", num_classes=K, input_shape=SHAPE)).module)


def two_rounds(sim, state):
    """The (state, metrics) after each of two rounds; a JAX sim's on the
    host, since its next round donates the state."""
    out = []
    for _ in range(2):
        state, m = sim.run_round(state)
        out.append(jax.device_get((state, m)) if hasattr(sim, "root_key")
                   else (state, m))
    return out


def test_fedavg_cnn_two_rounds_match_jax(capture):
    jcfg, tcfg = tiny_cfg(jc), tiny_cfg(tc)
    jdata, tdata = datasets(jcfg, tcfg)
    jsim = jfed.FedAvgSim(jax_create_model(jcfg.model), jdata, jcfg)
    replay = Replay(jsim, capture, {"local": replay_ckey(jsim)},
                    {"dropout": replay_ckey(jsim)})
    tsim = tfed.FedAvgSim(create_model(tcfg.model, "cpu"), tdata, tcfg,
                          "cpu", sampler=replay.sampler,
                          batch_orders=lambda r, c: replay.batch_orders(
                              r, c),
                          draws=replay.draws)
    jstate = jsim.init()
    tstate = tsim.init()._replace(variables=port_vars(jstate.variables))
    for (ts, tm), (js, jm) in zip(two_rounds(tsim, tstate),
                                  two_rounds(jsim, jstate)):
        close_vars(ts.variables, port_vars(js.variables), ROUND, "global")
        close(tm["train_loss"], jm["train_loss"], ROUND, "train_loss")


def replay_ckey(jsim, *salts):
    return lambda r, c: fold(JR.client_key(JR.round_key(jsim.root_key, r),
                                           c), *salts)


@pytest.fixture(scope="module")
def fedmd(capture):
    """The JAX FedMD's pretraining and two rounds, and a port FedMDSim
    replaying it."""
    jcfg, tcfg = tiny_cfg(jc, "fedmd"), tiny_cfg(tc, "fedmd")
    jdata, tdata = datasets(jcfg, tcfg)
    jsim = JD.FedMDSim(jax_create_model(jcfg.model), jdata, jcfg)
    pre = lambda r, c: jax.random.fold_in(jsim.root_key, PRETRAIN + c)
    replay = Replay(
        jsim, capture, {"local": replay_ckey(jsim, 2), "pretrain": pre},
        {"dropout": replay_ckey(jsim, 2), "dropout_public":
         replay_ckey(jsim, 1), "dropout_pretrain": pre,
         "dropout_pretrain_private": pre})
    tsim = TD.FedMDSim(create_model(tcfg.model, "cpu"), tdata, tcfg, "cpu",
                       **replay.hooks())
    start = JD.FedMDState(stacked_vars(jsim.model.module, 4),
                          jnp.asarray(0, jnp.int32))
    jstate = start._replace(
        model_stack=jsim._pretrain_fn(start.model_stack, jsim.arrays))
    host = jax.device_get((start, jstate))  # the rounds donate the state
    with jax.enable_x64(True):
        want = two_rounds(jsim, f64(jstate))
    return (jsim, tsim, *host, want)


def test_fedmd_pretraining_matches_jax(fedmd):
    jsim, tsim, start, jstate, _ = fedmd
    got = tsim.pretrain(port_vars(start.model_stack, lead=1))
    close_vars(got, port_vars(jstate.model_stack, lead=1), ROUND,
               "pretrained")
    assert tsim.last_steps["dropout_pretrain"] == 32 // B


def test_fedmd_two_rounds_match_jax(fedmd):
    """The consensus, digest and revisit of two rounds from the JAX
    package's pretrained stack, in float64 (Queue C, C5); the unsampled
    clients' models unchanged bit for bit."""
    jsim, tsim, _, jstate, want = fedmd
    state = TD.FedMDState(double(port_vars(jstate.model_stack, lead=1)), 0)
    with jax.enable_x64(True):
        got = two_rounds(to_float64(tsim), state)
    for r, ((ts, tm), (js, jm)) in enumerate(zip(got, want)):
        close_vars(ts.model_stack, port_vars(js.model_stack, lead=1),
                   ROUND, f"round {r}")
        close(tm["train_loss"], jm["train_loss"], ROUND, "train_loss")
        idle = np.setdiff1d(np.arange(4), tsim._cohort(r))
        for k, v in ts.model_stack.items():
            assert torch.equal(v[idle], state.model_stack[k][idle]), k
        state = ts
    with jax.enable_x64(True):
        jev = jsim.evaluate_clients(want[-1][0])
    tev = tsim.evaluate_clients(state)
    np.testing.assert_allclose(tev["per_client_acc"],
                               jev["per_client_acc"], atol=1e-6)


def test_fd_two_rounds_match_jax(capture):
    """Two FD+FAug rounds in float64 (Queue C, C5: a teacher entry is a
    mean of logits that cancels): the models, the teachers and the flags;
    the unsampled clients' rows unchanged bit for bit."""
    jcfg, tcfg = tiny_cfg(jc, "fd_faug", kd_gamma=0.3), tiny_cfg(
        tc, "fd_faug", kd_gamma=0.3)
    jdata, tdata = datasets(jcfg, tcfg)
    jsim = JD.FDSim(jax_create_model(jcfg.model), jdata, jcfg)
    replay = Replay(jsim, capture, {"local": replay_ckey(jsim)},
                    {"dropout": replay_ckey(jsim)})
    tsim = TD.FDSim(create_model(tcfg.model, "cpu"), tdata, tcfg, "cpu",
                    **replay.hooks())
    with jax.enable_x64(True):
        jstate = f64(JD.FDState(
            stacked_vars(jsim.model.module, 4), jnp.zeros((4, K, K)),
            jnp.zeros((4, K), bool), jnp.asarray(0, jnp.int32)))
        state = to_float64(tsim).init()._replace(
            model_stack=double(port_vars(jstate.model_stack, lead=1)))
        state = state._replace(teacher=state.teacher.double())
        rounds = zip(two_rounds(tsim, state), two_rounds(jsim, jstate))
        rounds = list(rounds)
    for r, ((ts, tm), (js, _)) in enumerate(rounds):
        assert tm == {}
        close_vars(ts.model_stack, port_vars(js.model_stack, lead=1),
                   ROUND, f"round {r}")
        close(ts.teacher, js.teacher, ROUND, "teacher")
        np.testing.assert_array_equal(ts.has_teacher.numpy(),
                                      np.asarray(js.has_teacher))
        cohort = tsim._cohort(r)
        idle = np.setdiff1d(np.arange(4), cohort)
        for k, v in ts.model_stack.items():
            assert torch.equal(v[idle], state.model_stack[k][idle]), k
        assert torch.equal(ts.teacher[idle], state.teacher[idle])
        state = ts
    assert bool(state.has_teacher.any())


def test_fedarjun_two_rounds_match_jax(capture):
    """Two FedArjun rounds: the adapter (CNN_DropOut, its masks in the
    local -> adapter transfer) and the local stack (lr)."""
    jcfg, tcfg = (tiny_cfg(m, "fedarjun", kd_lambda=0.5) for m in (jc, tc))
    jdata, tdata = datasets(jcfg, tcfg)
    local = dict(name="lr", num_classes=K, input_shape=SHAPE)
    jsim = JD.FedArjunSim(jax_create_model(jcfg.model),
                          jax_create_model(jc.ModelConfig(**local)), jdata,
                          jcfg)
    replay = Replay(
        jsim, capture, {"a2l": replay_ckey(jsim),
                        "local": replay_ckey(jsim, 1),
                        "l2a": replay_ckey(jsim, 2)},
        {"dropout_l2a": replay_ckey(jsim, 2)})
    tsim = TD.FedArjunSim(create_model(tcfg.model, "cpu"),
                          create_model(tc.ModelConfig(**local), "cpu"),
                          tdata, tcfg, "cpu", **replay.hooks())
    jstate = JD.FedArjunState(
        flax_vars(jsim.adapter.module, jnp.zeros((1,) + SHAPE)),
        stacked_vars(jsim.local.module, 4, seed=10),
        jnp.asarray(0, jnp.int32))
    state = TD.FedArjunState(
        port_vars(jstate.adapter_vars),
        port_vars(jstate.local_stack, "LogisticRegression", lead=1), 0)
    for r, ((ts, _), (js, _)) in enumerate(zip(two_rounds(tsim, state),
                                               two_rounds(jsim, jstate))):
        close_vars(ts.adapter_vars, port_vars(js.adapter_vars), ROUND,
                   f"adapter {r}")
        close_vars(ts.local_stack, port_vars(
            js.local_stack, "LogisticRegression", lead=1), ROUND,
            f"local {r}")
    assert set(tsim.last_steps) == {"dropout_a2l", "dropout",
                                    "dropout_l2a"}


@pytest.mark.parametrize("algo", ["fedmd", "fd_faug", "fedarjun"])
def test_cli_runs_the_distillation_family(algo, tmp_path, capsys):
    """``python -m fedml_tpu_torch.experiments.run --algorithm <algo>
    --model cnn --dataset fake_mnist --device cpu``, 2 rounds (the data
    cut by ``dataset_r`` through ``--config``): the harness's rows."""
    from fedml_tpu_torch.experiments.run import main

    cfg = {"data": {"dataset_r": 0.02, "partition_method": "homo"},
           "gan": {"public_size": 32, "kd_epochs": 1}}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    assert main(["--config", str(path), "--algorithm", algo, "--model",
                 "cnn", "--dataset", "fake_mnist", "--num_classes", "10",
                 "--input_shape", "28", "28", "1", "--client_num_in_total",
                 "4", "--client_num_per_round", "2", "--comm_round", "2",
                 "--batch_size", "8", "--device", "cpu", "--out_dir",
                 str(tmp_path), "--run_name", algo]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["run_name"] == f"{algo}_rep0"
    rows = [json.loads(line) for line in open(os.path.join(
        tmp_path, f"{algo}_rep0", "metrics.jsonl"))]
    rounds = [row for row in rows if "round" in row]
    assert [row["round"] for row in rounds] == [0, 1]
    assert 0.0 <= rounds[-1]["test_acc"] <= 1.0
    assert np.isfinite(rounds[-1]["test_loss"])
    if algo == "fedmd":
        assert all(np.isfinite(row["train_loss"]) for row in rounds)
