"""The port's buffered asynchronous aggregation (core/async_agg.py)
against the JAX package's: the config's errors, the fold and the emit on
the same deltas and lags (float32, rtol 1e-6), checkpoint blobs that cross
between the packages, the open-loop world model (exactly equal), the
simulators ignoring the setting (bitwise) and the CLI's check and
warning."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu.core.async_agg as JA
import fedml_tpu_torch.config as tc
import fedml_tpu_torch.core.async_agg as TA
from fedml_tpu.experiments import run as jax_run
from fedml_tpu_torch.algorithms import fedavg as tfed
from fedml_tpu_torch.data import load_dataset
from fedml_tpu_torch.experiments import run as cli
from fedml_tpu_torch.models import create_model
from tests.torch_threads import one_torch_thread  # noqa: F401

FOLD = dict(rtol=1e-6, atol=0)
SHAPES = {"conv.weight": (4, 3, 3, 3), "conv.bias": (4,), "head": (7, 5),
          "bn.running_mean": (4,)}


def _deltas(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{k: rng.standard_normal(s).astype(np.float32)
             for k, s in SHAPES.items()} for _ in range(n)]


def _pair(cfg_kw):
    """A JAX and a port buffer over the same zero template."""
    jcfg, tcfg = JA.AsyncConfig(**cfg_kw), TA.AsyncConfig(**cfg_kw)
    jbuf = JA.AsyncBuffer(jcfg, {k: jnp.zeros(s, jnp.float32)
                                 for k, s in SHAPES.items()})
    tbuf = TA.AsyncBuffer(tcfg, {k: torch.zeros(s) for k, s in
                                 SHAPES.items()})
    return jbuf, tbuf


def _assert_tree_close(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if torch.is_tensor(got[k]) else np.asarray(got[k])
        np.testing.assert_allclose(g, np.asarray(want[k]), err_msg=k, **tol)


@pytest.mark.parametrize("kw", [dict(buffer_k=-1), dict(staleness_fn="exp"),
                                dict(staleness_alpha=-0.5)])
def test_config_errors_are_the_jax_ones(kw):
    with pytest.raises(ValueError) as jerr:
        JA.AsyncConfig(**kw)
    with pytest.raises(ValueError) as terr:
        TA.AsyncConfig(**kw)
    assert str(terr.value) == str(jerr.value)


def test_config_from_fed_and_weights_match_jax():
    fed = tc.FedConfig(async_buffer_k=8, staleness_fn="poly",
                       staleness_alpha=0.7)
    cfg = TA.AsyncConfig.from_fed(fed)
    assert cfg == TA.AsyncConfig(8, "poly", 0.7) and cfg.enabled()
    assert not TA.AsyncConfig.from_fed(tc.FedConfig()).enabled()
    for fn in TA.STALENESS_FNS:
        jcfg, tcfg = JA.AsyncConfig(4, fn, 0.7), TA.AsyncConfig(4, fn, 0.7)
        for lag in (0, 1, 2.5, 7, 100):
            assert tcfg.weight(lag) == jcfg.weight(lag)
        for c in (jcfg, tcfg):
            with pytest.raises(ValueError, match="version lag"):
                c.weight(-1)
    assert TA.STALENESS_FNS == JA.STALENESS_FNS


@pytest.mark.parametrize("fn", ["poly", "const"])
def test_fold_and_emit_match_jax(fn):
    """Two emissions of K = 5 folds at lags 0-7 and uneven n_k."""
    jbuf, tbuf = _pair(dict(buffer_k=5, staleness_fn=fn,
                            staleness_alpha=0.5))
    deltas = _deltas(10)
    rng = np.random.default_rng(1)
    for i, d in enumerate(deltas):
        n_k, lag = float(rng.integers(1, 50)), int(rng.integers(0, 8))
        wj = jbuf.fold({k: jnp.asarray(v) for k, v in d.items()}, n_k, lag)
        wt = tbuf.fold({k: torch.from_numpy(v) for k, v in d.items()}, n_k,
                       lag)
        assert wt == wj and tbuf.mass == jbuf.mass
        assert tbuf.count == jbuf.count and tbuf.ready() == jbuf.ready()
        _assert_tree_close(tbuf.sum, jbuf.sum, **FOLD)
        if tbuf.ready():
            (tm, tmass), (jm, jmass) = tbuf.emit(), jbuf.emit()
            assert tmass == jmass and tbuf.version == jbuf.version == \
                (i + 1) // 5
            _assert_tree_close(tm, jm, **FOLD)
            assert all(torch.equal(v, torch.zeros_like(v))
                       for v in tbuf.sum.values())
            assert (tbuf.mass, tbuf.count) == (0.0, 0)
    for b in (tbuf, jbuf):
        with pytest.raises(RuntimeError, match="empty async buffer"):
            b.emit()


def test_checkpoint_blobs_cross_between_packages():
    """Fold 3, save in one package, load in the other, fold 2 more and
    emit: both ways equal to the buffer that never stopped."""
    deltas, lags = _deltas(5, seed=2), (0, 3, 1, 0, 6)
    cfg = dict(buffer_k=5, staleness_fn="poly", staleness_alpha=0.5)

    def fold(buf, ds, ls, jax_side):
        for d, lag in zip(ds, ls):
            buf.fold({k: jnp.asarray(v) if jax_side else torch.from_numpy(v)
                      for k, v in d.items()}, 10.0, lag)

    jstraight, tstraight = _pair(cfg)
    fold(jstraight, deltas, lags, True)
    fold(tstraight, deltas, lags, False)
    want = jstraight.emit()
    for writer_is_jax in (True, False):
        jbuf, tbuf = _pair(cfg)
        src, dst = (jbuf, tbuf) if writer_is_jax else (tbuf, jbuf)
        fold(src, deltas[:3], lags[:3], writer_is_jax)
        blob = src.state_arrays()
        assert blob["sum"]["head"].dtype == np.float32
        assert {k: blob[k].dtype for k in ("mass", "count", "version")} == {
            "mass": np.float64, "count": np.int64, "version": np.int64}
        dst.load_arrays(blob)
        fold(dst, deltas[3:], lags[3:], not writer_is_jax)
        got = dst.emit()
        assert got[1] == want[1]
        _assert_tree_close(got[0], want[0], **FOLD)
    # the port's own round trip is bitwise
    _, a = _pair(cfg)
    _, b = _pair(cfg)
    fold(a, deltas[:3], lags[:3], False)
    b.load_arrays(a.state_arrays())
    assert all(torch.equal(a.sum[k], b.sum[k]) for k in SHAPES)
    assert (a.mass, a.count, a.version) == (b.mass, b.count, b.version)


def test_emit_through_server_update_is_the_weighted_mean():
    """K fresh arrivals at full weight, emitted through ``server_update``
    (the JAX async actor's row of one client of weight ``mass``), give
    the synchronous round's FedAvg step over the same K results."""
    rng = np.random.default_rng(3)
    glob = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in SHAPES.items()}
    stat_names = ("bn.running_mean",)
    clients = [{k: v + torch.from_numpy(d[k]) for k, v in glob.items()}
               for d in _deltas(4, seed=4)]
    n_k = torch.tensor([3.0, 9.0, 5.0, 1.0])
    fed = tc.FedConfig()
    params = {k: v for k, v in glob.items() if k not in stat_names}
    state = tfed.ServerState(
        glob, tfed.make_server_optimizer("sgd", 1.0, 0.0).init(params),
        {k: torch.zeros_like(v) for k, v in params.items()}, 0)
    sync = tfed.server_update(
        fed, state, {k: torch.stack([c[k] for c in clients]) for k in glob},
        n_k, tfed.local_reducer(), stat_names)
    buf = TA.AsyncBuffer(TA.AsyncConfig(4, "const"), glob)
    for c, n in zip(clients, n_k):
        buf.fold({k: c[k] - glob[k] for k in glob}, float(n), 0)
    assert buf.ready()
    mean_delta, mass = buf.emit()
    row = {k: (glob[k] + mean_delta[k])[None] for k in glob}
    emitted = tfed.server_update(fed, state, row, torch.tensor([mass]),
                                 tfed.local_reducer(), stat_names)
    _assert_tree_close(emitted.variables, sync.variables, rtol=1e-6,
                       atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(n_clients=40, n_leaves=1, buffer_k=4, horizon_s=3.0, seed=1),
    dict(n_clients=57, n_leaves=3, buffer_k=2, flush_every=3,
         horizon_s=2.0, seed=5, sigma=1.2),
    dict(n_clients=40, n_leaves=2, horizon_s=1.0, seed=2, sync=True),
])
def test_simulate_open_loop_equals_jax(kw):
    assert TA.simulate_open_loop(**kw) == JA.simulate_open_loop(**kw)
    arrivals = np.sort(np.random.default_rng(0).random(9))
    got, want = (m._serial_completion(arrivals, 0.2, 0.05) for m in (TA, JA))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_simulators_ignore_the_async_settings():
    """FedAvg with async_buffer_k 2 runs the same rounds bit for bit as
    with 0, as the JAX simulators do."""
    dcfg = tc.DataConfig(dataset="synthetic_1_1", num_clients=6,
                         batch_size=8)
    data = load_dataset(dcfg)
    mcfg = tc.ModelConfig(name="lr", num_classes=10, input_shape=(60,))
    states = []
    for fed in (tc.FedConfig(num_rounds=2, clients_per_round=3),
                tc.FedConfig(num_rounds=2, clients_per_round=3,
                             async_buffer_k=2, staleness_fn="const")):
        cfg = tc.ExperimentConfig(data=dcfg, model=mcfg, fed=fed, seed=1)
        sim = tfed.FedAvgSim(create_model(mcfg, "cpu"), data, cfg, "cpu")
        state = sim.init()
        for _ in range(2):
            state, _ = sim.run_round(state)
        states.append(state.variables)
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])


def test_cli_checks_and_warns_as_the_jax_cli(capsys, tmp_path):
    with pytest.raises(SystemExit) as err:
        cli.parse_args(["--async_buffer_k", "-2"])
    with pytest.raises(ValueError) as jerr:
        JA.AsyncConfig(buffer_k=-2)
    assert str(err.value) == str(jerr.value)
    with pytest.raises(SystemExit):
        cli.parse_args(["--staleness_fn", "exp"])  # argparse's choices
    cfg, _ = cli.parse_args(["--async_buffer_k", "4", "--staleness_fn",
                             "const", "--staleness_alpha", "0.9"])
    assert (cfg.fed.async_buffer_k, cfg.fed.staleness_fn,
            cfg.fed.staleness_alpha) == (4, "const", 0.9)
    argv = ["--algorithm", "fedavg", "--dataset", "synthetic_1_1",
            "--model", "lr", "--num_classes", "10", "--input_shape", "60",
            "--client_num_in_total", "4", "--client_num_per_round", "2",
            "--comm_round", "1", "--batch_size", "8", "--device", "cpu",
            "--out_dir", str(tmp_path), "--async_buffer_k", "4"]
    assert cli.main(argv) == 0
    first = ("warning: --async_buffer_k is a deployment flag and is "
             "ignored by the simulator")
    assert first in capsys.readouterr().err
    # the same sentence the JAX CLI prints
    assert '"warning: --async_buffer_k is a deployment flag and is "\n' \
        in inspect.getsource(jax_run.main)
