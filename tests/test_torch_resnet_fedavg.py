"""FedAvg with BatchNorm on the port against the JAX package: ResNet-8
(width 4, 16x16x3 images) local updates over padded batches in float32
and bf16, the server step that keeps batch statistics out of the server
optimizer, two FedAvg rounds with the JAX package's cohorts and batch
orders replayed; then the reference's anchor tests on ``lr``/``fake_mnist``
ported, and the command line."""

import json

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
import fedml_tpu_torch.config as tc
from fedml_tpu_torch.algorithms import fedavg as tfed
from fedml_tpu_torch.algorithms.base import build_local_update, make_task
from fedml_tpu_torch.convert import vision_state_dict
from fedml_tpu_torch.data import load_dataset
from fedml_tpu_torch.data.federated import FederatedData
from fedml_tpu_torch.experiments import run as cli
from fedml_tpu_torch.models import create_model
from tests.test_torch_vision import RES_SHAPE, flax_resnet8

B = 4
COUNTS = (10, 3, 7, 5)  # samples per client: full, partial, padded batches
# float32 training over several steps on both sides: sums reassociate
# and the differences compound step to step
TOL = dict(atol=1e-4, rtol=1e-4)
# the reference's own bf16-vs-f32 band (tests/test_fedavg.py)
BF16_TOL = dict(atol=0.05, rtol=0.1)


def _data():
    rng = np.random.default_rng(0)
    n = sum(COUNTS)
    x = rng.standard_normal((n + 8,) + RES_SHAPE).astype(np.float32)
    y = rng.integers(0, 10, n + 8).astype(np.int32)
    starts = np.cumsum((0,) + COUNTS)
    train = {i: np.arange(starts[i], starts[i + 1])
             for i in range(len(COUNTS))}
    test = {i: np.arange(2 * i, 2 * i + 2) for i in range(len(COUNTS))}
    args = (x[:n], y[:n], x[n:], y[n:], train, test, 10)
    return JaxFederatedData(*args), FederatedData(*args)


def _assert_vars_close(got, want_flax, tol):
    want = vision_state_dict(jax.device_get(want_flax), "ResNetCIFAR")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **tol,
                                   err_msg=k)


@pytest.mark.parametrize("compute_dtype,tol", [("float32", TOL),
                                               ("bfloat16", BF16_TOL)])
def test_local_update_matches_jax(compute_dtype, tol):
    """Client 0 (10 samples: two full batches and one of 2 real and 2
    padded rows) and client 1 (3 real rows and 1 padded in its one
    batch), 2 epochs of SGD with momentum and weight decay. The padded
    rows enter BatchNorm's statistics on both sides. Under bf16 the
    returned parameters and statistics are float32."""
    flax_net, variables, model, params = flax_resnet8()
    jdata, tdata = _data()
    ja = jdata.to_arrays(pad_multiple=B)
    ta = tdata.to_arrays(pad_multiple=B, device="cpu")
    max_n = ja.max_client_samples
    train = dict(optimizer="sgd", lr=0.1, momentum=0.5, weight_decay=1e-3,
                 epochs=2, compute_dtype=compute_dtype)
    jlu = jax.jit(jax_local_update(
        JaxFedModel(flax_net, RES_SHAPE, has_batch_stats=True),
        jax_make_task("classification"), jc.TrainConfig(**train), B, max_n))
    tlu = build_local_update(model, make_task("classification"),
                             tc.TrainConfig(**train), B, max_n)
    rng = jax.random.key(5)
    for c in (0, 1):
        want, n_k, msums = jlu(variables, ja.idx[c], ja.mask[c], ja.x, ja.y,
                               rng)
        orders = [torch.tensor(np.asarray(_padded_perm(
            jax.random.fold_in(rng, e), ja.mask[c], max_n)))
            for e in range(train["epochs"])]
        got, t_n_k, t_sums = tlu(params, ta.idx[c], ta.mask[c], ta.x, ta.y,
                                 orders=orders)
        assert float(t_n_k) == float(n_k) == COUNTS[c]
        _assert_vars_close(got, want, tol)
        for k in msums:
            np.testing.assert_allclose(float(t_sums[k]), float(msums[k]),
                                       **tol, err_msg=k)


def test_server_update_keeps_stats_out_of_the_optimizer():
    """Batch statistics are the plain weighted mean of the clients'
    values, even at server_lr != 1 with server momentum and gmf > 0; the
    parameters take the server optimizer's step. Two steps, so both
    momenta act."""
    rng = np.random.default_rng(1)
    params = {"w": (3, 4), "b": (5,)}
    stats = {"mean": (5,), "var": (5,)}
    glob = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in {**params, **stats}.items()}
    fed_kw = dict(server_lr=0.7, server_momentum=0.9, gmf=0.5)
    jfc, tfc = jc.FedConfig(**fed_kw), tc.FedConfig(**fed_kw)
    jopt = jfed.make_server_optimizer("sgd", 0.7, 0.9)
    jp = {k: jnp.asarray(glob[k]) for k in params}
    jstate = jfed.ServerState(
        {"params": jp, "batch_stats": {k: jnp.asarray(glob[k])
                                       for k in stats}},
        jopt.init(jp), jax.tree.map(jnp.zeros_like, jp),
        jnp.asarray(0, jnp.int32))
    tp = {k: torch.from_numpy(glob[k]) for k in params}
    topt = tfed.make_server_optimizer("sgd", 0.7, 0.9)
    tstate = tfed.ServerState({k: torch.from_numpy(v) for k, v in
                               glob.items()}, topt.init(tp),
                              {k: torch.zeros_like(v) for k, v in tp.items()},
                              0)
    n_k = np.array([3.0, 0.0, 7.0, 5.0], np.float32)
    for step in range(2):
        stacked = {k: rng.standard_normal((4,) + s).astype(np.float32)
                   for k, s in {**params, **stats}.items()}
        jstate = jfed.server_update(
            jfc, jc.TrainConfig(), 1, B, jstate,
            {"params": {k: jnp.asarray(stacked[k]) for k in params},
             "batch_stats": {k: jnp.asarray(stacked[k]) for k in stats}},
            jnp.asarray(n_k), jax.random.key(step), jfed.local_reducer())
        tstate = tfed.server_update(
            tfc, tstate, {k: torch.from_numpy(v) for k, v in stacked.items()},
            torch.from_numpy(n_k), tfed.local_reducer(), tuple(stats))
        assert set(tstate.opt_state["trace"]) == set(tstate.momentum) == set(
            params)
        for k in params:
            np.testing.assert_allclose(
                tstate.variables[k].numpy(),
                np.asarray(jstate.variables["params"][k]), atol=1e-6,
                rtol=1e-6)
        for k in stats:
            plain = (n_k[:, None] * stacked[k]).sum(0) / n_k.sum()
            np.testing.assert_allclose(tstate.variables[k].numpy(), plain,
                                       rtol=1e-6)
            np.testing.assert_allclose(
                tstate.variables[k].numpy(),
                np.asarray(jstate.variables["batch_stats"][k]), rtol=1e-6)


@pytest.mark.parametrize("clients,groups", [(3, 0), (4, 2)])
def test_two_fedavg_rounds_match_jax(clients, groups):
    """Two rounds of 3 of 4 clients (one group) and of 4 of 4 clients in
    2 size-sorted groups, with the JAX package's cohorts and batch orders
    replayed, server_lr 0.7 and gmf 0.5: parameters, batch statistics,
    train metrics and the global evaluation (on the running statistics)
    agree."""
    flax_net, variables, model, params = flax_resnet8(seed=2)
    jdata, tdata = _data()
    common = dict(
        data=dict(num_clients=len(COUNTS), batch_size=B),
        train=dict(lr=0.1, momentum=0.5, epochs=1, cohort_groups=groups),
        fed=dict(num_rounds=2, clients_per_round=clients, server_lr=0.7,
                 gmf=0.5),
    )

    def cfg(m):
        return m.ExperimentConfig(
            data=m.DataConfig(**common["data"]),
            model=m.ModelConfig(name="resnet8", input_shape=RES_SHAPE),
            train=m.TrainConfig(**common["train"]),
            fed=m.FedConfig(**common["fed"]), seed=3)

    jsim = jfed.FedAvgSim(JaxFedModel(flax_net, RES_SHAPE,
                                      has_batch_stats=True), jdata, cfg(jc))
    max_n = jsim.arrays.max_client_samples

    def sampler(r, n, k):  # the JAX package's cohort draw for round r
        key = jax.random.fold_in(JR.round_key(jsim.root_key, r), 0)
        return torch.tensor(np.asarray(JR.sample_clients(key, n, k)))

    def batch_orders(r, c):  # and its batch orders for client c
        ckey = JR.client_key(JR.round_key(jsim.root_key, r), c)
        return [torch.tensor(np.asarray(_padded_perm(
            jax.random.fold_in(ckey, e), jsim.arrays.mask[c], max_n)))
            for e in range(common["train"]["epochs"])]

    tsim = tfed.FedAvgSim(model, tdata, cfg(tc), device="cpu",
                          sampler=sampler, batch_orders=batch_orders)
    jopt = jfed.make_server_optimizer("sgd", 0.7, 0.0)
    jvars = jax.tree.map(jnp.asarray, variables)
    jstate = jfed.ServerState(
        jvars, jopt.init(jvars["params"]),
        jax.tree.map(jnp.zeros_like, jvars["params"]),
        jnp.asarray(0, jnp.int32))
    tstate = tsim.init()._replace(variables=params)
    for _ in range(2):
        jstate, jm = jsim.run_round(jstate)
        tstate, tm = tsim.run_round(tstate)
        for k in ("train_loss", "train_acc"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)
    _assert_vars_close(tstate.variables, jstate.variables, TOL)
    jev, tev = jsim.evaluate_global(jstate), tsim.evaluate_global(tstate)
    assert tev["count"] == jev["count"]
    for k in ("loss", "acc"):
        np.testing.assert_allclose(tev[k], jev[k], **TOL)


# -- the reference's anchor tests, on the port -------------------------------


def _mnist_cfg(data, fed=None, train=None):
    return tc.ExperimentConfig(
        data=tc.DataConfig(dataset="fake_mnist", **data),
        model=tc.ModelConfig(name="lr", num_classes=10,
                             input_shape=(28, 28, 1)),
        train=tc.TrainConfig(**(train or dict(lr=0.1, epochs=1))),
        fed=tc.FedConfig(**(fed or dict(num_rounds=1, clients_per_round=4,
                                        eval_every=1))),
        seed=0)


def test_fedavg_learns_fake_mnist():
    """Ten rounds of logistic regression on fake_mnist raise the test
    accuracy by more than 0.2 (the reference's test of the same name)."""
    cfg = _mnist_cfg(dict(num_clients=8, batch_size=32, seed=0),
                     train=dict(lr=0.1, epochs=2),
                     fed=dict(num_rounds=10, clients_per_round=8,
                              eval_every=10))
    sim = tfed.FedAvgSim(create_model(cfg.model, "cpu"),
                         load_dataset(cfg.data), cfg, device="cpu")
    state = sim.init()
    acc0 = sim.evaluate_global(state)["acc"]
    for _ in range(cfg.fed.num_rounds):
        state, _ = sim.run_round(state)
    acc1 = sim.evaluate_global(state)["acc"]
    assert acc1 > acc0 + 0.2, (acc0, acc1)


def test_equivalence_oracle_fullbatch():
    """Full batch, one epoch, every client: the FedAvg step equals one
    centralized gradient step on the pooled data (the reference's
    tests/test_fedavg.py test of the same name, atol 1e-4)."""
    cfg = _mnist_cfg(dict(num_clients=4, partition_method="homo",
                          full_batch=True, seed=1),
                     train=dict(lr=0.05, epochs=1))
    sim = tfed.FedAvgSim(create_model(cfg.model, "cpu"),
                         load_dataset(cfg.data), cfg, device="cpu")
    state = sim.init()
    new_state, _ = sim.run_round(state)

    a = sim.arrays
    live = {k: v.clone().requires_grad_(True)
            for k, v in state.variables.items()}
    total, wsum = 0.0, 0.0
    for c in range(a.num_clients):
        logits = sim.model.apply_eval(live, a.x[a.idx[c].long()])
        ce = torch.nn.functional.cross_entropy(
            logits, a.y[a.idx[c].long()].long(), reduction="none")
        total = total + torch.sum(ce * a.mask[c])
        wsum = wsum + torch.sum(a.mask[c])
    grads = torch.autograd.grad(total / wsum, list(live.values()))
    for (k, p), g in zip(state.variables.items(), grads):
        np.testing.assert_allclose(new_state.variables[k].numpy(),
                                   (p - cfg.train.lr * g).numpy(), atol=1e-4,
                                   err_msg=k)


def test_padded_clients_noop():
    """Clients of very different sizes (hetero alpha 0.2): padding does
    not distort the aggregate, which is the mean of the clients' results
    weighted by their true n_k."""
    cfg = _mnist_cfg(dict(num_clients=8, partition_method="hetero",
                          partition_alpha=0.2, batch_size=16, seed=3),
                     fed=dict(num_rounds=2, clients_per_round=8,
                              eval_every=2))
    sim = tfed.FedAvgSim(create_model(cfg.model, "cpu"),
                         load_dataset(cfg.data), cfg, device="cpu")
    a = sim.arrays
    assert a.counts.min() < sim.max_n // 2  # sizes differ
    state = sim.init()
    new_state, m = sim.run_round(state)
    assert np.isfinite(float(m["train_loss"]))
    results = [sim.local_update(state.variables, a.idx[c], a.mask[c], a.x,
                                a.y, sim.batch_orders(0, c))[0]
               for c in range(a.num_clients)]
    w = a.counts.float() / a.counts.sum()
    for k in state.variables:
        want = sum(w[c] * results[c][k] for c in range(a.num_clients))
        np.testing.assert_allclose(new_state.variables[k].numpy(),
                                   want.numpy(), atol=1e-6, err_msg=k)


def test_small_client_matches_serial_sgd():
    """A client with 5 samples at batch 8 takes exactly one full-batch step
    per epoch over its real data: 3 epochs equal 3 serial SGD steps (the
    reference's tests/test_local_update_semantics.py test)."""
    model = create_model(tc.ModelConfig(name="lr", num_classes=3,
                                        input_shape=(4,)), "cpu")
    cfg = tc.TrainConfig(lr=0.1, epochs=3, optimizer="sgd")
    batch_size, max_n = 8, 32
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(40, 4)), dtype=torch.float32)
    y = torch.tensor(rng.integers(0, 3, 40), dtype=torch.int32)
    idx_row = torch.tensor(np.r_[np.arange(5), np.zeros(27)],
                           dtype=torch.int32)
    mask_row = torch.tensor(np.r_[np.ones(5), np.zeros(27)],
                            dtype=torch.float32)
    lu = build_local_update(model, make_task("classification"), cfg,
                            batch_size, max_n)
    variables = model.init(torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    from fedml_tpu_torch.core.random import padded_perm
    orders = [padded_perm(gen, mask_row, max_n) for _ in range(cfg.epochs)]
    out, n_k, _ = lu(variables, idx_row, mask_row, x, y, orders)
    assert float(n_k) == 5.0

    params = {k: v.clone() for k, v in variables.items()}
    for _ in range(cfg.epochs):
        live = {k: v.requires_grad_(True) for k, v in params.items()}
        loss = torch.nn.functional.cross_entropy(
            model.apply_eval(live, x[:5]), y[:5].long())
        grads = torch.autograd.grad(loss, list(live.values()))
        params = {k: (v - cfg.lr * g).detach()
                  for (k, v), g in zip(live.items(), grads)}
    for k in params:
        np.testing.assert_allclose(out[k].numpy(), params[k].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


def test_cli_prints_its_summary(capsys, tmp_path):
    """``main`` on a tiny config, with momentum from --config, prints one
    JSON summary line; an unported algorithm raises by ROADMAP item."""
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"train": {"momentum": 0.9}}))
    argv = ["--config", str(path), "--algorithm", "fedavg",
            "--dataset", "fake_mnist", "--model", "lr", "--num_classes",
            "10", "--input_shape", "28", "28", "1",
            "--client_num_in_total", "4", "--client_num_per_round", "2",
            "--comm_round", "2", "--batch_size", "32", "--lr", "0.05",
            "--partition_method", "hetero", "--partition_alpha", "0.5",
            "--compute_dtype", "bfloat16", "--frequency_of_the_test", "1",
            "--device", "cpu"]
    cfg, _ = cli.parse_args(argv)
    assert cfg.train.momentum == 0.9 and cfg.data.num_clients == 4
    assert cfg.train.compute_dtype == "bfloat16" and cfg.fed.num_rounds == 2
    assert cli.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(lines[-1])
    assert summary["round"] == 1 and summary["run_name"] == "run"
    assert all(np.isfinite(summary[k]) for k in
               ("train_loss", "test_loss", "test_acc"))
    for algorithm, item in (("fedprox", "slice 4"), ("fednova", "FedNova")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP: .*{item}"):
            cli.main(argv[:2] + ["--algorithm", algorithm] + argv[4:])
