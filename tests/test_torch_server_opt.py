"""The port's server step against the JAX package's: the server
optimizers adam, adagrad and yogi (optax's semantics) over three rounds,
with and without global momentum, and FedNova's tau-normalized mean with
unequal sample counts and a zero-weight row; the rule that keeps fednova
apart from the reducing defenses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu.config as jc
from fedml_tpu.algorithms import fedavg as jfed
from fedml_tpu.core.robust import check_fednova_compat as jax_check
import fedml_tpu_torch.config as tc
from fedml_tpu_torch.algorithms import fedavg as tfed
from fedml_tpu_torch.core.robust import check_fednova_compat
from fedml_tpu_torch.data.federated import FederatedData
from fedml_tpu_torch.models import create_model

# the reference's band for reassociated float32 reductions
# (tests/test_bulk.py)
TOL = dict(rtol=2e-5, atol=2e-6)
PARAMS = {"w": (3, 4), "b": (5,)}
STATS = {"mean": (5,)}
# sample counts, unequal, with a zero-weight (padded or screened) row
N_K = np.array([3.0, 0.0, 7.0, 12.0], np.float32)
B, STEPS_PER_EPOCH, EPOCHS = 4, 3, 2


def _states(name, server_lr, gmf, rng):
    glob = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in {**PARAMS, **STATS}.items()}
    jopt = jfed.make_server_optimizer(name, server_lr, 0.0)
    jp = {k: jnp.asarray(glob[k]) for k in PARAMS}
    jstate = jfed.ServerState(
        {"params": jp, "batch_stats": {k: jnp.asarray(glob[k])
                                       for k in STATS}},
        jopt.init(jp), jax.tree.map(jnp.zeros_like, jp),
        jnp.asarray(0, jnp.int32))
    topt = tfed.make_server_optimizer(name, server_lr, 0.0)
    tp = {k: torch.from_numpy(glob[k]) for k in PARAMS}
    tstate = tfed.ServerState({k: torch.from_numpy(v)
                               for k, v in glob.items()}, topt.init(tp),
                              {k: torch.zeros_like(v) for k, v in tp.items()},
                              0)
    return jstate, tstate


def _rounds(algorithm, name, server_lr, gmf, rounds=3):
    """``rounds`` server steps on both sides from the same stacked client
    results; the parameters must agree after each, and the statistics be
    the plain weighted mean."""
    rng = np.random.default_rng(7)
    jstate, tstate = _states(name, server_lr, gmf, rng)
    kw = dict(algorithm=algorithm, server_optimizer=name,
              server_lr=server_lr, gmf=gmf)
    jfc, tfc = jc.FedConfig(**kw), tc.FedConfig(**kw)
    jtrain = jc.TrainConfig(epochs=EPOCHS)
    steps = tfed.LocalSteps(B, STEPS_PER_EPOCH, EPOCHS)
    for r in range(rounds):
        stacked = {k: rng.standard_normal((len(N_K),) + s).astype(np.float32)
                   for k, s in {**PARAMS, **STATS}.items()}
        jstate = jfed.server_update(
            jfc, jtrain, STEPS_PER_EPOCH, B, jstate,
            {"params": {k: jnp.asarray(stacked[k]) for k in PARAMS},
             "batch_stats": {k: jnp.asarray(stacked[k]) for k in STATS}},
            jnp.asarray(N_K), jax.random.key(r), jfed.local_reducer())
        tstate = tfed.server_update(
            tfc, tstate, {k: torch.from_numpy(v) for k, v in stacked.items()},
            torch.from_numpy(N_K), tfed.local_reducer(), tuple(STATS), steps)
        for k in PARAMS:
            np.testing.assert_allclose(
                tstate.variables[k].numpy(),
                np.asarray(jstate.variables["params"][k]), **TOL,
                err_msg=f"round {r} {k}")
        plain = (N_K[:, None] * stacked["mean"]).sum(0) / N_K.sum()
        np.testing.assert_allclose(tstate.variables["mean"].numpy(), plain,
                                   rtol=1e-6)
    return jstate, tstate


@pytest.mark.parametrize("gmf", [0.0, 0.9])
@pytest.mark.parametrize("name,server_lr", [("adam", 1e-3),
                                            ("adagrad", 0.1),
                                            ("yogi", 1e-2)])
def test_server_optimizer_matches_optax(name, server_lr, gmf):
    """Three rounds of each adaptive server optimizer: parameters within
    the band of optax's after every round, the statistics outside the
    optimizer, and the optimizer's own state (moments, count, sums of
    squares) alike."""
    jstate, tstate = _rounds("fedavg", name, server_lr, gmf)
    jopt = jstate.opt_state[0]
    if name == "adagrad":
        want = {"sum_of_squares": jopt.sum_of_squares}
    else:
        want = {"mu": jopt.mu, "nu": jopt.nu}
        assert float(tstate.opt_state["count"]) == int(jopt.count) == 3
    for part, tree in want.items():
        assert set(tstate.opt_state[part]) == set(PARAMS)
        for k in PARAMS:
            np.testing.assert_allclose(tstate.opt_state[part][k].numpy(),
                                       np.asarray(tree[k]), **TOL,
                                       err_msg=f"{part} {k}")


def test_adagrad_leaves_a_zero_sum_unmoved():
    """optax.adagrad's update is 0 where the sum of squares is 0 (rsqrt
    would be inf there): a parameter with no accumulated square and a
    zero gradient stays where it is."""
    opt = tfed.make_server_optimizer("adagrad", 1.0, 0.0)
    p = {"w": torch.tensor([1.0, 2.0])}
    state = {"sum_of_squares": {"w": torch.tensor([0.0, 0.1])}}
    updates, new = opt.update({"w": torch.tensor([0.0, 1.0])}, state, p)
    assert updates["w"][0].item() == 0.0
    assert new["sum_of_squares"]["w"].tolist() == pytest.approx([0.0, 1.1])
    assert updates["w"][1].item() == pytest.approx(-(1.1 + 1e-7) ** -0.5)


@pytest.mark.parametrize("name,server_lr,gmf", [("sgd", 1.0, 0.0),
                                                ("sgd", 0.7, 0.5),
                                                ("adam", 1e-3, 0.0)])
def test_fednova_server_update_matches_jax(name, server_lr, gmf):
    """FedNova's tau-normalized mean over clients of 3, 0, 7 and 12
    samples (tau 1, 1 clipped up from 0, 2 and 3 clipped down, times 2
    epochs), through the server optimizer, against the JAX package; the
    zero-weight row adds nothing."""
    _rounds("fednova", name, server_lr, gmf)
    steps = tfed.LocalSteps(B, STEPS_PER_EPOCH, EPOCHS)
    assert steps.tau(torch.from_numpy(N_K)).tolist() == [2.0, 2.0, 4.0, 6.0]


def test_fednova_zero_weight_row_adds_nothing():
    """A row of weight 0 may hold anything finite: the aggregate is the
    same as without the row."""
    rng = np.random.default_rng(3)
    fed = tc.FedConfig(algorithm="fednova")
    steps = tfed.LocalSteps(B, STEPS_PER_EPOCH, EPOCHS)
    glob = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in PARAMS.items()}
    stacked = {k: torch.from_numpy(rng.standard_normal(
        (len(N_K),) + s).astype(np.float32)) for k, s in PARAMS.items()}
    state = tfed.ServerState(glob, {}, {k: torch.zeros_like(v)
                                        for k, v in glob.items()}, 0)
    live = N_K > 0
    full = tfed.server_update(fed, state, stacked, torch.from_numpy(N_K),
                              tfed.local_reducer(), steps=steps)
    kept = tfed.server_update(
        fed, state, {k: v[torch.from_numpy(live)] for k, v in
                     stacked.items()}, torch.from_numpy(N_K[live]),
        tfed.local_reducer(), steps=steps)
    for k in PARAMS:
        torch.testing.assert_close(full.variables[k], kept.variables[k],
                                   rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="LocalSteps"):
        tfed.server_update(fed, state, stacked, torch.from_numpy(N_K),
                           tfed.local_reducer())


@pytest.mark.parametrize("method", ["krum", "median", "mean"])
def test_fednova_with_a_reducing_defense_raises(method):
    """fednova with a reducing defense raises ValueError with the JAX
    package's message, from the rule itself and from FedAvgSim's
    constructor, before the defense's own not-ported refusal; fednova
    with the plain mean runs."""
    for algorithm in ("fednova", "fedavg"):
        if algorithm == "fednova" and method != "mean":
            with pytest.raises(ValueError) as want:
                jax_check(algorithm, method)
            with pytest.raises(ValueError) as got:
                check_fednova_compat(algorithm, method)
            assert str(got.value) == str(want.value)
        else:
            check_fednova_compat(algorithm, method)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((12, 4)).astype(np.float32)
    y = rng.integers(0, 3, 12).astype(np.int32)
    data = FederatedData(x[:8], y[:8], x[8:], y[8:],
                         {0: np.arange(5), 1: np.arange(5, 8)},
                         {0: np.arange(2), 1: np.arange(2, 4)}, 3)
    cfg = tc.ExperimentConfig(
        data=tc.DataConfig(num_clients=2, batch_size=4),
        model=tc.ModelConfig(name="lr", num_classes=3, input_shape=(4,)),
        fed=tc.FedConfig(algorithm="fednova", robust_method=method,
                         clients_per_round=2))
    model = create_model(cfg.model, "cpu")
    if method == "mean":
        sim = tfed.FedAvgSim(model, data, cfg, device="cpu")
        state, m = sim.run_round(sim.init())
        assert np.isfinite(float(m["train_loss"]))
    else:
        with pytest.raises(ValueError, match="incompatible"):
            tfed.FedAvgSim(model, data, cfg, device="cpu")


def test_unknown_server_optimizer_raises_as_jax_does():
    with pytest.raises(ValueError, match="unknown server optimizer"):
        jfed.make_server_optimizer("lamb", 1.0, 0.0)
    with pytest.raises(ValueError, match="unknown server optimizer"):
        tfed.make_server_optimizer("lamb", 1.0, 0.0)
