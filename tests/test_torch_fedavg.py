"""The port's local update, server update and FedAvg rounds against the
JAX package's, with weights carried across and the JAX package's random
draws (cohorts, batch orders) replayed through the port's hooks."""

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
from fedml_tpu.models import create_model as jax_create_model
import fedml_tpu_torch.config as tc
from fedml_tpu_torch.algorithms import fedavg as tfed
from fedml_tpu_torch.algorithms.base import build_local_update, make_task
from fedml_tpu_torch.convert import transformer_state_dict
from fedml_tpu_torch.data.federated import FederatedData
from fedml_tpu_torch.models import create_model

VOCAB, T, B = 37, 16, 4
COUNTS = (10, 3, 7, 5)  # samples per client: full, partial, padded batches
MODEL = dict(name="transformer_lm", num_classes=VOCAB, input_shape=(T,),
             extra=(("num_layers", 1), ("num_heads", 2), ("embed_dim", 32),
                    ("max_len", T)))
# float32 training over several steps on both sides: sums reassociate
# and the differences compound step to step
TOL = dict(atol=1e-4, rtol=1e-4)


def _data():
    rng = np.random.default_rng(0)
    seq = rng.integers(0, VOCAB, (sum(COUNTS) + 8, T + 1)).astype(np.int32)
    x, y = seq[:, :-1], seq[:, 1:]
    n = sum(COUNTS)
    starts = np.cumsum((0,) + COUNTS)
    train = {i: np.arange(starts[i], starts[i + 1])
             for i in range(len(COUNTS))}
    test = {i: np.arange(2 * i, 2 * i + 2) for i in range(len(COUNTS))}
    args = (x[:n], y[:n], x[n:], y[n:], train, test, VOCAB)
    return JaxFederatedData(*args, task="nwp"), FederatedData(*args, task="nwp")


def _port(variables):
    return transformer_state_dict(jax.device_get(variables))


def _assert_params_close(got, variables):
    want = _port(variables)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("train", [
    dict(optimizer="sgd", lr=0.1, momentum=0.9, weight_decay=1e-3,
         clip_norm=1.0, prox_mu=0.1, epochs=2),
    # adam's step is ~lr * sign(g) where |g| is near its eps, so rounding-
    # level gradient differences move a weight by up to ~lr: lr 1e-3 keeps
    # that inside the band
    dict(optimizer="adam", lr=1e-3, weight_decay=1e-2, clip_norm=0.5,
         epochs=1),
])
def test_local_update_matches_jax(train):
    jdata, tdata = _data()
    ja = jdata.to_arrays(pad_multiple=B)
    ta = tdata.to_arrays(pad_multiple=B, device="cpu")
    max_n = ja.max_client_samples
    jmodel = jax_create_model(jc.ModelConfig(**MODEL))
    variables = jax.jit(jmodel.init)(jax.random.key(0))
    jlu = jax.jit(jax_local_update(jmodel, jax_make_task("nwp"),
                                   jc.TrainConfig(**train), B, max_n))
    tlu = build_local_update(create_model(tc.ModelConfig(**MODEL), "cpu"),
                             make_task("nwp"), tc.TrainConfig(**train), B,
                             max_n)
    rng = jax.random.key(5)
    # client 1 (3 samples) trains one real step per epoch, then padding;
    # an all-padding row must leave the model exactly as it was
    empty = jnp.zeros_like(ja.mask[1])
    for idx_row, mask_row, tmask in ((ja.idx[1], ja.mask[1], ta.mask[1]),
                                     (ja.idx[1], empty,
                                      torch.zeros_like(ta.mask[1]))):
        want, n_k, msums = jlu(variables, idx_row, mask_row, ja.x, ja.y,
                               rng)
        orders = [torch.tensor(np.asarray(
            _padded_perm(jax.random.fold_in(rng, e), mask_row, max_n)))
            for e in range(train["epochs"])]
        got, t_n_k, t_sums = tlu(_port(variables), ta.idx[1], tmask, ta.x,
                                 ta.y, orders=orders)
        assert float(t_n_k) == float(n_k)
        _assert_params_close(got, want)
        for k in msums:
            np.testing.assert_allclose(float(t_sums[k]), float(msums[k]),
                                       **TOL)
    # the padded row: bitwise no-op on both sides
    start = _port(variables)
    assert all(torch.equal(got[k], start[k]) for k in start)
    _assert_params_close(start, want)


def test_server_update_matches_jax():
    rng = np.random.default_rng(1)
    shapes = {"a": (3, 4), "b": (5,)}
    glob = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    fed_kw = dict(server_lr=0.7, server_momentum=0.9, gmf=0.5)
    jfc, tfc = jc.FedConfig(**fed_kw), tc.FedConfig(**fed_kw)
    jopt = jfed.make_server_optimizer("sgd", 0.7, 0.9)
    jparams = {k: jnp.asarray(v) for k, v in glob.items()}
    jstate = jfed.ServerState({"params": jparams}, jopt.init(jparams),
                              jax.tree.map(jnp.zeros_like, jparams),
                              jnp.asarray(0, jnp.int32))
    tparams = {k: torch.from_numpy(v) for k, v in glob.items()}
    topt = tfed.make_server_optimizer("sgd", 0.7, 0.9)
    tstate = tfed.ServerState(tparams, topt.init(tparams),
                              {k: torch.zeros_like(v)
                               for k, v in tparams.items()}, 0)
    for step in range(2):  # the second step exercises both momenta
        stacked = {k: rng.standard_normal((4,) + s).astype(np.float32)
                   for k, s in shapes.items()}
        n_k = np.array([3.0, 0.0, 7.0, 5.0], np.float32)
        jstate = jfed.server_update(
            jfc, jc.TrainConfig(), 1, B, jstate,
            {"params": {k: jnp.asarray(v) for k, v in stacked.items()}},
            jnp.asarray(n_k), jax.random.key(step), jfed.local_reducer())
        tstate = tfed.server_update(
            tfc, tstate, {k: torch.from_numpy(v) for k, v in stacked.items()},
            torch.from_numpy(n_k), tfed.local_reducer())
        assert tstate.round == int(jstate.round)
        for k in shapes:
            np.testing.assert_allclose(
                tstate.variables[k].numpy(),
                np.asarray(jstate.variables["params"][k]),
                atol=1e-6, rtol=1e-6)


def test_two_fedavg_rounds_match_jax():
    jdata, tdata = _data()
    common = dict(
        data=dict(num_clients=len(COUNTS), batch_size=B),
        train=dict(lr=0.1, momentum=0.5, epochs=1),
        fed=dict(num_rounds=2, clients_per_round=len(COUNTS),
                 server_lr=1.0, server_momentum=0.5),
    )

    def cfg(m):
        return m.ExperimentConfig(
            data=m.DataConfig(**common["data"]),
            model=m.ModelConfig(**MODEL),
            train=m.TrainConfig(**common["train"]),
            fed=m.FedConfig(**common["fed"]), seed=3)

    jsim = jfed.FedAvgSim(jax_create_model(jc.ModelConfig(**MODEL)), jdata,
                          cfg(jc))
    max_n = jsim.arrays.max_client_samples

    def sampler(r, n, k):  # the JAX package's cohort draw for round r
        key = jax.random.fold_in(JR.round_key(jsim.root_key, r), 0)
        return torch.tensor(np.asarray(JR.sample_clients(key, n, k)))

    def batch_orders(r, c):  # and its batch orders for client c
        ckey = JR.client_key(JR.round_key(jsim.root_key, r), c)
        return [torch.tensor(np.asarray(_padded_perm(
            jax.random.fold_in(ckey, e), jsim.arrays.mask[c], max_n)))
            for e in range(common["train"]["epochs"])]

    tsim = tfed.FedAvgSim(create_model(tc.ModelConfig(**MODEL), "cpu"),
                          tdata, cfg(tc), device="cpu", sampler=sampler,
                          batch_orders=batch_orders)
    # FedAvgSim.init's state, with the model's init jitted (op-by-op flax
    # init costs seconds on one core)
    variables = jax.jit(jsim.model.init)(
        jax.random.fold_in(jsim.root_key, 0x7FFFFFFF))
    jopt = jfed.make_server_optimizer("sgd", 1.0, 0.5)
    jstate = jfed.ServerState(
        variables, jopt.init(variables["params"]),
        jax.tree.map(jnp.zeros_like, variables["params"]),
        jnp.asarray(0, jnp.int32))
    tstate = tsim.init()._replace(variables=_port(jstate.variables))
    for _ in range(2):
        jstate, jm = jsim.run_round(jstate)
        tstate, tm = tsim.run_round(tstate)
        for k in ("train_loss", "train_acc"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)
        assert float(tm["nonfinite_rejected"]) == 0.0
    _assert_params_close(tstate.variables, jstate.variables)
    jev, tev = jsim.evaluate_global(jstate), tsim.evaluate_global(tstate)
    assert tev["count"] == jev["count"]
    for k in ("loss", "acc"):
        np.testing.assert_allclose(tev[k], jev[k], **TOL)


def test_unported_settings_raise():
    _, tdata = _data()
    model = create_model(tc.ModelConfig(**MODEL), "cpu")
    for bad in (dict(fed=tc.FedConfig(fuse_rounds=2)),
                dict(fed=tc.FedConfig(peft="lora"))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tfed.FedAvgSim(model, tdata, tc.ExperimentConfig(**bad),
                           device="cpu")
    # the bulk engine's personalized round waits for PEFT
    with pytest.raises(NotImplementedError, match="item 12"):
        tfed.FedAvgSim(model, tdata, tc.ExperimentConfig(fed=tc.FedConfig(
            client_block_size=4, peft="lora")), device="cpu")
    assert [p for p, _, _ in tfed._NOT_PORTED] == ["fed.fuse_rounds",
                                                   "fed.peft"]
    # the defenses, the codecs, the adversaries, elastic buckets and the
    # bulk engine are ported
    for good in (dict(fed=tc.FedConfig(elastic_buckets=True)),
                 dict(fed=tc.FedConfig(client_block_size=4)),
                 dict(fed=tc.FedConfig(robust_method="median",
                                       robust_norm_clip=1.0,
                                       robust_noise_stddev=0.1)),
                 dict(fed=tc.FedConfig(compress="topk_int8")),
                 dict(adversary=tc.AdversaryPolicy(mode="sign_flip",
                                                   ranks=(1,)))):
        tfed.FedAvgSim(model, tdata, tc.ExperimentConfig(**good),
                       device="cpu")


def test_nonfinite_screen_matches_jax_and_drops_the_client():
    from fedml_tpu.core.robust import finite_client_mask as jax_mask
    from fedml_tpu_torch.core.robust import finite_client_mask

    rng = np.random.default_rng(2)
    stacked = {"a": rng.standard_normal((4, 3)).astype(np.float32),
               "b": rng.standard_normal((4, 2, 2)).astype(np.float32)}
    stacked["a"][1, 2] = np.nan
    stacked["b"][3, 0, 1] = np.inf
    n_k = np.array([2.0, 3.0, 4.0, 5.0], np.float32)
    want = np.asarray(jax_mask({k: jnp.asarray(v) for k, v in
                                stacked.items()}, jnp.asarray(n_k)))
    got = finite_client_mask({k: torch.from_numpy(v) for k, v in
                              stacked.items()}, torch.from_numpy(n_k))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [True, False, True, False])

    # a round in which one client returns NaN: it is screened out, and
    # the aggregate is the weighted mean of the others
    _, tdata = _data()
    cfg = tc.ExperimentConfig(
        data=tc.DataConfig(num_clients=len(COUNTS), batch_size=B),
        fed=tc.FedConfig(clients_per_round=len(COUNTS)))
    tsim = tfed.FedAvgSim(create_model(tc.ModelConfig(**MODEL), "cpu"),
                          tdata, cfg, device="cpu")
    state = tsim.init()

    def cohort_update(params, idx_rows, mask_rows, x, y, orders, steps):
        # the round's batched update; client 1 is the one with COUNTS[1]
        # samples
        n_k = mask_rows.sum(1)
        shift = torch.where(n_k == COUNTS[1], float("nan"), 1.0)
        out = {k: v[None] + shift.reshape((-1,) + (1,) * v.ndim)
               for k, v in params.items()}
        return out, n_k, {
            k: torch.zeros(len(n_k)) for k in ("loss_sum", "correct",
                                               "count", "w_sum")}

    tsim.cohort_update = cohort_update
    new_state, metrics = tsim.run_round(state)
    assert float(metrics["nonfinite_rejected"]) == 1.0
    for k, v in state.variables.items():
        torch.testing.assert_close(new_state.variables[k], v + 1.0)
