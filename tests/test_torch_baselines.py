"""The local baselines in the port against the JAX package: one and two
rounds of the local-only baseline (every client its own logistic model,
3 clients of uneven size, 16x16x3 inputs, SGD with momentum) and of the
centralized trainer on the pooled set (2 epochs a round), each with the
JAX sim's batch orders replayed (a round's key ``fold_in(root, round)``,
a baseline client's ``fold_in(round key, client)``), their train metrics
and evaluations; and ``pooled_data`` against the JAX package's. Float32 at
rtol 1e-4, atol 1e-5."""

import jax
import numpy as np
import pytest
import torch

import fedml_tpu.config as jc
import fedml_tpu_torch.config as tc
from fedml_tpu.algorithms import local_baselines as JB
from fedml_tpu.data import federated as jfd
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu_torch.algorithms import local_baselines as TB
from fedml_tpu_torch.convert import vision_state_dict
from fedml_tpu_torch.data import federated as tfd
from fedml_tpu_torch.models import create_model
from tests.test_torch_gan import close, lane_orders
from tests.test_torch_split import BAND, host, image_data, tiny_cfg
from tests.torch_threads import one_torch_thread  # noqa: F401


def lr_vars(variables, lead=0):
    return vision_state_dict(variables, "LogisticRegression", lead)


def replayed_orders(jsim, epochs, pooled=False):
    """The port's ``batch_orders(round, client)``: the JAX local update's
    epoch orders under ``fold_in(fold_in(root, round), client)``, or the
    centralized trainer's ``fold_in(root, round)``."""
    mask = np.asarray(jsim.arrays.mask)
    max_n = jsim.arrays.max_client_samples

    def batch_orders(r, c):
        key = jax.random.fold_in(jsim.root_key, r)
        if not pooled:
            key = jax.random.fold_in(key, c)
        return [torch.from_numpy(o)
                for o in lane_orders(key, mask[c], epochs, max_n)]

    return batch_orders


@pytest.fixture(scope="module")
def baseline_runs():
    jcfg, tcfg = tiny_cfg(jc), tiny_cfg(tc)
    jsim = JB.BaselineSim(jax_create_model(jcfg.model), image_data(jfd),
                          jcfg)
    tsim = TB.BaselineSim(create_model(tcfg.model, "cpu"), image_data(tfd),
                          tcfg, "cpu", batch_orders=replayed_orders(jsim, 1))
    jstate = jsim.init()
    tstate = TB.BaselineState(lr_vars(host(jstate.model_stack), lead=1), 0)
    out = []
    for _ in range(2):
        jstate, jm = jsim.run_round(jstate)
        tstate, tm = tsim.run_round(tstate)
        out.append((host(jstate), host(jm), tstate, tm))
    return out, jsim.evaluate_clients(jstate), tsim.evaluate_clients(tstate)


@pytest.mark.parametrize("rounds", [1, 2])
def test_baseline_rounds_match_jax(baseline_runs, rounds):
    jstate, jm, tstate, tm = baseline_runs[0][rounds - 1]
    assert tstate.round == rounds
    for k in ("train_loss", "train_acc"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **BAND)
    for k, v in lr_vars(jstate.model_stack, lead=1).items():
        close(tstate.model_stack[k], v.numpy(), BAND, k)


def test_baseline_evaluation_matches_jax(baseline_runs):
    _, jev, tev = baseline_runs
    for k in ("test_acc", "test_loss"):
        np.testing.assert_allclose(tev[k], float(jev[k]), **BAND)
    np.testing.assert_allclose(tev["per_client_acc"],
                               np.asarray(jev["per_client_acc"]), **BAND)


@pytest.fixture(scope="module")
def centralized_runs():
    jcfg, tcfg = tiny_cfg(jc, epochs=2), tiny_cfg(tc, epochs=2)
    jtr = JB.CentralizedTrainer(jax_create_model(jcfg.model),
                                image_data(jfd), jcfg)
    ttr = TB.CentralizedTrainer(
        create_model(tcfg.model, "cpu"), image_data(tfd), tcfg, "cpu",
        batch_orders=replayed_orders(jtr, 2, pooled=True))
    jv = jtr.init()
    tv = lr_vars(host(jv))
    out = []
    for r in range(2):
        jv, jm = jtr.run_round(jv, r)
        tv, tm = ttr.run_round(tv, r)
        out.append((host(jv), jm, tv, tm))
    return out, (jtr.evaluate(jv), ttr.evaluate(tv),
                 jtr.evaluate_train(jv), ttr.evaluate_train(tv))


@pytest.mark.parametrize("rounds", [1, 2])
def test_centralized_rounds_match_jax(centralized_runs, rounds):
    jv, jm, tv, tm = centralized_runs[0][rounds - 1]
    assert set(tm) == set(jm) and all(isinstance(v, float)
                                      for v in tm.values())
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], **BAND)
    for k, v in lr_vars(jv).items():
        close(tv[k], v.numpy(), BAND, k)


def test_centralized_evaluation_matches_jax(centralized_runs):
    jev, tev, jtrain, ttrain = centralized_runs[1]
    for want, got in ((jev, tev), (jtrain, ttrain)):
        for k in ("loss", "acc"):
            np.testing.assert_allclose(got[k], want[k], **BAND)


def test_pooled_data_matches_jax():
    want = JB.pooled_data(image_data(jfd))
    got = TB.pooled_data(image_data(tfd))
    assert got.num_clients == want.num_clients == 1
    for m in ("train_idx_map", "test_idx_map"):
        assert np.array_equal(getattr(got, m)[0], getattr(want, m)[0])
