"""FedNAS in the port against the JAX package: the DARTS network's
forwards (train mode with its new batch statistics, and eval mode) on
flax weights and alphas carried across by ``convert.darts_state_dict``,
``derive_genotype`` on the same alphas, and one and two FedNAS rounds
(``DARTSNetwork(init_channels=4, layers=3, steps=2)`` on 16x16x3
inputs, 3 clients of uneven size, 2 a round) with the JAX sim's cohorts
and batch orders replayed through the hooks, then the test accuracy at
batch 64. Float32: the rounds at rtol 1e-4, atol 1e-5, the forwards at
rtol 1e-5, atol 1e-6. The JAX runs are module-scoped."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu.config as jc
import fedml_tpu_torch.config as tc
from fedml_tpu.algorithms import fednas as JN
from fedml_tpu.core import random as JR
from fedml_tpu.data import federated as jfd
from fedml_tpu.models import darts as JD
from fedml_tpu_torch.algorithms import fednas as TN
from fedml_tpu_torch.convert import darts_state_dict
from fedml_tpu_torch.data import federated as tfd
from fedml_tpu_torch.models import darts as TD
from tests.test_torch_gan import close, lane_orders
from tests.test_torch_split import (
    BAND,
    FWD,
    SHAPE,
    fed_model,
    host,
    image_data,
    tiny_cfg,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

K = 10
NET = dict(init_channels=4, layers=3, steps=2)


def jax_net():
    return JD.DARTSNetwork(num_classes=K, **NET)


def port_net():
    return fed_model(lambda: TD.DARTSNetwork(K, **NET), SHAPE)


def test_darts_forwards_match_jax():
    x = np.random.default_rng(1).normal(size=(4,) + SHAPE).astype(np.float32)
    v = jax_net().init({"params": jax.random.key(2)}, jnp.asarray(x),
                       train=False)
    model = port_net()
    tv = darts_state_dict(host(v))
    fresh = model.init(torch.Generator().manual_seed(0))
    assert {k: t.shape for k, t in fresh.items()} == {
        k: t.shape for k, t in tv.items()}
    close(model.apply_eval(tv, torch.tensor(x)),
          jax_net().apply(v, jnp.asarray(x), train=False), FWD, "eval")
    jt, mut = jax_net().apply(v, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
    tt, new = model.apply_train(tv, torch.tensor(x))
    close(tt, jt, FWD, "train")
    for k, want in darts_state_dict(host(mut)).items():
        close(new[k], want.numpy(), FWD, k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_derive_genotype_matches_jax(seed):
    rng = np.random.default_rng(seed)
    e = TD.num_edges(3)
    arch = {k: rng.normal(size=(e, len(TD.PRIMITIVES))).astype(np.float32)
            for k in TD.ARCH}
    want = JD.derive_genotype({"arch": {k: jnp.asarray(v)
                                        for k, v in arch.items()}})
    got = TD.derive_genotype({k: torch.tensor(v) for k, v in arch.items()})
    assert got == want
    assert all(op != "none" for gene in got.values() for op, _ in gene)


@pytest.fixture(scope="module")
def fednas_runs():
    """Two rounds of the JAX FedNASSim and of the port's from the same
    start, the cohorts and batch orders replayed."""
    jcfg = tiny_cfg(jc)
    jcfg = jcfg.__class__(**{**jcfg.__dict__, "fed": jc.FedConfig(
        num_rounds=2, clients_per_round=2)})
    jsim = JN.FedNASSim(jax_net(), image_data(jfd), jcfg)
    mask = np.asarray(jsim.arrays.mask)
    root = jsim.root_key

    def sampler(r, n, cpr):
        key = jax.random.fold_in(JR.round_key(root, r), 0)
        return torch.from_numpy(np.array(JR.sample_clients(key, n, cpr)))

    def batch_orders(r, c):
        ckey = JR.client_key(JR.round_key(root, r), c)
        return [torch.from_numpy(o) for o in lane_orders(
            ckey, mask[c], jcfg.train.epochs, jsim.max_n)]

    tcfg = tiny_cfg(tc)
    tcfg = tcfg.__class__(**{**tcfg.__dict__, "fed": tc.FedConfig(
        num_rounds=2, clients_per_round=2)})
    tsim = TN.FedNASSim(port_net(), image_data(tfd), tcfg, "cpu",
                        sampler=sampler, batch_orders=batch_orders)
    assert tsim.batch_size == jsim.batch_size
    start = host(jsim.init())
    tstate = TN.FedNASState(darts_state_dict(start.variables), 0)
    jstate = jax.tree.map(jnp.asarray, start)
    out = []
    for _ in range(2):
        jstate, _ = jsim.run_round(jstate)
        tstate, _ = tsim.run_round(tstate)
        out.append((host(jstate), tstate, tsim.last_steps))
    return start, out, jsim.evaluate(jstate), tsim.evaluate(tstate)


@pytest.mark.parametrize("rounds", [1, 2])
def test_fednas_rounds_match_jax(fednas_runs, rounds):
    start, out, _, _ = fednas_runs
    jstate, tstate, steps = out[rounds - 1]
    assert tstate.round == rounds
    want = darts_state_dict(jstate.variables)
    assert set(want) == set(tstate.variables)
    for k, v in want.items():
        close(tstate.variables[k], v.numpy(), BAND, k)
    # the architect and the weights both stepped and were averaged
    for k in TD.ARCH + ("stem.weight",):
        assert not np.allclose(tstate.variables[k].numpy(),
                               darts_state_dict(start.variables)[k].numpy())
    # half of the padded 40 samples is 20: 2 steps of 8 an epoch, which
    # every cohort's largest client fills
    assert steps == 2


def test_fednas_evaluate_matches_jax(fednas_runs):
    _, _, jev, tev = fednas_runs
    assert abs(tev["test_acc"] - jev["test_acc"]) <= 1 / 32
