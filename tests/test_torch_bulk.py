"""The bulk engine (fedml_tpu_torch/core/bulk.py and the block-streamed
round of algorithms/fedavg.py) against the JAX package's bulk round, and
against the port's own stacked round.

Rounds against the JAX FedAvgSim (its ``_round``, the program its
``run_round`` compiles) replay every draw: the cohort, the batch orders,
the aggregate's noise, the adversaries' gaussians, the quantizer's
uniforms (keyed by client id) and the projections. Most of them replace
both sides' local training with one table of per-client deltas
(``_fake_locals``), so both rounds start each block from the same bits:
a streamed quantile rule reads a histogram, and an ulp of local-training
difference can move a value across a bin edge; a compressed round an
int8 code. One case trains for real.

Bands: against the JAX bulk round rtol 2e-5 / atol 2e-6 (the port's
sim-level band, ``SIM_TOL``: float32 sums reassociate), the same
selections, the error-feedback bank bit for bit; against the port's
stacked round the reference's rtol 2e-5 / atol 1e-7
(``tests/test_bulk.py``); ResNet-8's batch statistics in the band this
file measures and states (``BN_BAND``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu.config as jc
from fedml_tpu.algorithms import fedavg as jfed
from fedml_tpu.core import compress as JC
from fedml_tpu.core import random as JR
from fedml_tpu.core import streamdef as JSD
from fedml_tpu.models import create_model as jax_create_model
import fedml_tpu_torch.config as tc
from fedml_tpu_torch.algorithms import fedavg as tfed
from fedml_tpu_torch.core import bulk as BK
from fedml_tpu_torch.core import tree as T
from fedml_tpu_torch.experiments import run as cli
from fedml_tpu_torch.models import create_model
from tests.test_torch_byzantine import (
    SIM_TOL,
    _cfg,
    _datasets,
    _replay,
    _to_port,
    _to_port_stacked,
    _unoptimized,
)

# the reference's bulk-vs-stacked band (tests/test_bulk.py RTOL, ATOL)
STACKED_TOL = dict(rtol=2e-5, atol=1e-7)


def _proj_draws(jsim):
    """The JAX package's projection blocks (streamdef.project_rows) for
    the lr model, as the port's ``"proj"`` stream: leaf 0 the bias, leaf
    1 the kernel, whose rows run (in, out) where the port's weight runs
    (out, in)."""

    def draw(r, shapes):
        rkey = JR.round_key(jsim.root_key, r)
        base = jax.random.fold_in(rkey, JSD._PROJ_SALT)
        p = JSD.PROJ_DIM
        bias = np.asarray(jax.random.normal(jax.random.fold_in(base, 0),
                                            (10, p)))
        kernel = np.asarray(jax.random.normal(jax.random.fold_in(base, 1),
                                              (7840, p)))
        kernel = kernel.reshape(784, 10, p).transpose(1, 0, 2)
        out = {"linear.weight": kernel.reshape(7840, p),
               "linear.bias": bias}
        assert {k: v.shape for k, v in out.items()} == shapes
        return {k: torch.from_numpy(np.ascontiguousarray(v))[None]
                for k, v in out.items()}

    return draw


def _fake_locals(jdata, num_clients, scale=0.05, seed=5):
    """The same local results on both sides: each client's parameters are
    the global ones plus its own row of a seeded delta table, its n_k its
    sample count, its loss a seeded constant. A client is known by the
    first sample of its index row. Returns ``(jax local_update, port
    cohort_update)``."""
    rng = np.random.default_rng(seed)
    kernel = (scale * rng.standard_normal((num_clients, 784, 10))
              ).astype(np.float32)
    bias = (scale * rng.standard_normal((num_clients, 10))).astype(
        np.float32)
    loss = rng.random(num_clients).astype(np.float32)
    owner = np.zeros(len(jdata.x_train), np.int64)
    for c, idx in jdata.train_idx_map.items():
        owner[idx] = c
    jk, jb, jl, jo = (jnp.asarray(a) for a in (kernel, bias, loss, owner))
    tk = torch.from_numpy(np.ascontiguousarray(kernel.transpose(0, 2, 1)))
    tb, tl, to = (torch.from_numpy(a) for a in (bias, loss, owner))

    def sums(n, lv):
        return {"loss_sum": n * lv, "correct": n * 0.5, "count": n,
                "w_sum": n}

    def jax_local(variables, idx_row, mask_row, x, y, key):
        c = jo[idx_row[0]]
        d = variables["params"]["Dense_0"]
        n = jnp.sum(mask_row)
        return {"params": {"Dense_0": {"bias": d["bias"] + jb[c],
                                       "kernel": d["kernel"] + jk[c]}}}, \
            n, sums(n, jl[c])

    def port_cohort(global_vars, idx_rows, mask_rows, x, y, orders, steps):
        c = to[idx_rows[:, 0].long()]
        n = mask_rows.sum(1)
        return {"linear.weight": global_vars["linear.weight"][None] + tk[c],
                "linear.bias": global_vars["linear.bias"][None] + tb[c]}, \
            n, sums(n, tl[c])

    return jax_local, port_cohort


def _sims(fake=True, **kw):
    """A JAX and a port FedAvgSim of ``_cfg(**kw)`` (lr on 8-client
    fake_mnist), the port replaying the JAX one's draws, both from the
    JAX sim's initial state."""
    jcfg, tcfg = _cfg(jc, **kw), _cfg(tc, **kw)
    jdata, tdata = _datasets()
    jsim = jfed.FedAvgSim(jax_create_model(jcfg.model), jdata, jcfg)
    sampler, batch_orders, draws = _replay(
        jsim, JC.CompressionSpec.from_fed(jcfg.fed, seed=jcfg.seed))
    proj = _proj_draws(jsim)

    def all_draws(stream, r, slots, shapes):
        return proj(r, shapes) if stream == "proj" else draws(
            stream, r, slots, shapes)

    tsim = tfed.FedAvgSim(create_model(tcfg.model, "cpu"), tdata, tcfg,
                          device="cpu", sampler=sampler,
                          batch_orders=batch_orders, draws=all_draws)
    if fake:
        jsim.local_update, tsim.cohort_update = _fake_locals(jdata, 8)
    jstate = jsim.init()
    return jsim, tsim, jstate, tsim.init()._replace(
        variables=_to_port(jstate.variables))


def _assert_close(tstate, jstate, tol=SIM_TOL, err=""):
    want = _to_port(jstate.variables)
    for k in want:
        np.testing.assert_allclose(tstate.variables[k].numpy(),
                                   want[k].numpy(), **tol,
                                   err_msg=f"{err} {k}")


def _against_jax(rounds=2, fake=True, on_round=None, **kw):
    jsim, tsim, jstate, tstate = _sims(fake=fake, **kw)
    jround = _unoptimized(jsim._round)
    jbank = None
    if tsim.cspec.enabled():
        jsim._ensure_ef_bank(jstate)
        jbank = jsim._ef_bank
    for r in range(rounds):
        if jbank is None:
            jstate, jm = jround(jstate, jsim.arrays)
        else:
            jstate, jm, jbank = jround(jstate, jsim.arrays, None, jbank)
        tstate, tm = tsim.run_round(tstate)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       **SIM_TOL, err_msg=k)
        _assert_close(tstate, jstate, err=f"round {r}")
        if on_round is not None:
            on_round(r, tsim, jbank)
    return tsim, jbank


# (name, FedConfig and adversary settings): cohort 6 of 8 and blocks of 4
# leave a partial final block; blocks of 8 make one block
BULK_CASES = {
    "mean_even_blocks": dict(cohort=8, client_block_size=4),
    "mean_partial_block": dict(client_block_size=4),
    "mean_single_block": dict(client_block_size=8),
    "fednova": dict(client_block_size=4, algorithm="fednova"),
    "clip_noise": dict(client_block_size=4, robust_norm_clip=0.3,
                       robust_noise_stddev=1e-3),
    "gauss_adversary": dict(client_block_size=4, mode="gauss"),
}


@pytest.mark.parametrize("name", sorted(BULK_CASES))
def test_bulk_round_matches_jax(name):
    """2 rounds of the port's bulk round against the JAX package's, on the
    shared table of local results."""
    _against_jax(**BULK_CASES[name])


def test_bulk_round_with_real_training_matches_jax():
    """2 rounds with the local updates trained on both sides: 8 clients in
    blocks of 3 (the last one partial), each client's 24 steps of SGD."""
    _against_jax(fake=False, cohort=8, client_block_size=3)


@pytest.mark.parametrize("compress", ["int8", "topk_int8"])
def test_bulk_error_feedback_bank_matches_jax(compress):
    """3 rounds of 6 of 8 clients in blocks of 2, under a streamed median,
    compressed with error feedback in a client-keyed bank (the quantizer's
    draws keyed by client id): every client's residual row, sampled or
    not, bit for bit after round 1, which starts from the same state; in
    SIM_TOL after rounds 2 and 3, which start from states an ulp apart."""

    def check(r, tsim, jbank):
        want = _to_port_stacked({"params": jbank.rows["params"]})
        for k in want:
            got, exp = tsim.ef_bank.rows[k].numpy(), want[k].numpy()
            if r == 0:
                np.testing.assert_array_equal(got, exp, err_msg=k)
            else:
                np.testing.assert_allclose(got, exp, **SIM_TOL, err_msg=k)

    tsim, _ = _against_jax(rounds=3, client_block_size=2, compress=compress,
                           method="median", on_round=check)
    assert set(tsim.bank_state()) == {"ef_residual"}
    assert tsim.counters["bank.gathers"] == 2 * 3 * 3  # 2 passes, 3 blocks
    assert tsim.counters["bank.scatters"] == 3 * 3


@pytest.mark.parametrize("method", ["median", "trimmed_mean", "krum",
                                    "multikrum", "fltrust"])
def test_streamed_defense_matches_jax(method):
    """Each streamed rule, 2 rounds of 8 clients in blocks of 2 with 2
    sign-flipping adversaries: the port's two passes against the JAX
    package's, the same selection and the aggregate in SIM_TOL."""
    _against_jax(cohort=8, client_block_size=2, method=method,
                 mode="sign_flip", robust_noise_stddev=1e-3)


def _port_run(rounds=2, **kw):
    cfg = _cfg(tc, **kw)
    sim = tfed.FedAvgSim(create_model(cfg.model, "cpu"), _datasets()[1],
                         cfg, device="cpu")
    state = sim.init()
    ms = []
    for _ in range(rounds):
        state, m = sim.run_round(state)
        ms.append(float(m["train_loss"]))
    return sim, state, ms


@pytest.mark.parametrize("name", ["mean_even_blocks", "mean_partial_block",
                                  "fednova", "clip_noise"])
def test_bulk_tracks_the_port_stacked_round(name):
    """The port's bulk round against its own stacked round, real training,
    2 rounds: the reference's band."""
    kw = dict(BULK_CASES[name])
    _, s_bulk, m_bulk = _port_run(**kw)
    kw.pop("client_block_size")
    _, s_stk, m_stk = _port_run(**kw)
    for k in s_stk.variables:
        np.testing.assert_allclose(s_bulk.variables[k].numpy(),
                                   s_stk.variables[k].numpy(), **STACKED_TOL,
                                   err_msg=k)
    np.testing.assert_allclose(m_bulk, m_stk, rtol=1e-5)


def test_skipping_dead_blocks_changes_no_bit():
    """An elastic bulk grid of 4 blocks of 2 with 3 live clients: the two
    wholly dead blocks are not run. Running them instead (they add exact
    zeros) gives the same state, metrics and residual bank bit for
    bit."""
    out = []
    for skip in (True, False):
        cfg = _cfg(tc, cohort=6, client_block_size=2, elastic_buckets=True,
                   compress="int8", method="median")
        sim = tfed.FedAvgSim(create_model(cfg.model, "cpu"), _datasets()[1],
                             cfg, device="cpu")
        sim._skip_dead_blocks = skip
        sim.set_cohort_size(3)
        state = sim.init()
        for _ in range(2):
            state, m = sim.run_round(state)
        out.append((state, m, sim.ef_bank.rows, sim.counters))
    (a, ma, ba, ca), (b, mb, bb, cb) = out
    for k in a.variables:
        assert torch.equal(a.variables[k], b.variables[k]), k
        assert torch.equal(ba[k], bb[k]), k
    assert {k: float(v) for k, v in ma.items()} == {
        k: float(v) for k, v in mb.items()}
    assert ca["bank.gathers"] == 2 * 2 * 2 and cb["bank.gathers"] == 2 * 2 * 4


def test_fold_partials_match_server_update():
    """Random stacked results with batch statistics, folded in blocks of
    3, 3 and 1 through fold_block_partials, then
    server_update_from_partials, against server_update on the whole
    stack: the reference's band, under clip and FedNova alike."""
    rng = np.random.default_rng(0)
    shapes = {"w": (4, 3), "b": (3,), "mean": (3,)}
    glob = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in shapes.items()}
    stacked = {k: glob[k][None] + torch.from_numpy(
        rng.standard_normal((7,) + s).astype(np.float32))
        for k, s in shapes.items()}
    n_k = torch.tensor([3.0, 0.0, 7.0, 5.0, 2.0, 9.0, 4.0])
    sums = {"loss_sum": n_k * 0.5, "correct": n_k, "count": n_k,
            "w_sum": n_k}
    steps = tfed.LocalSteps(2, 5, 1)
    for fed in (tc.FedConfig(robust_norm_clip=1.5),
                tc.FedConfig(algorithm="fednova")):
        state = tfed.ServerState(glob, {}, {k: torch.zeros_like(glob[k])
                                            for k in ("w", "b")}, 0)
        want = tfed.server_update(fed, state, stacked, n_k,
                                  tfed.local_reducer(), ("mean",), steps)
        parts = [tfed.fold_block_partials(
            fed, steps, state, {k: v[sl] for k, v in stacked.items()},
            n_k[sl], {k: v[sl] for k, v in sums.items()}, torch.zeros(()),
            ("mean",)) for sl in (slice(0, 3), slice(3, 6), slice(6, 7))]
        total = functools.reduce(
            lambda a, b: T.tree_map(torch.add, a, b), parts)
        assert float(total.n_sum) == 30.0
        got = tfed.server_update_from_partials(fed, state, total, ("mean",))
        for k in shapes:
            np.testing.assert_allclose(got.variables[k].numpy(),
                                       want.variables[k].numpy(),
                                       **STACKED_TOL, err_msg=k)
    with pytest.raises(ValueError, match="agg_delta"):
        tfed.server_update_from_partials(
            tc.FedConfig(robust_method="median"), state, total, ("mean",))


def test_bulk_spec_plan_and_stream_blocks():
    from fedml_tpu.core import bulk as JBK

    with pytest.raises(ValueError, match="client_block_size"):
        BK.BulkSpec(block_size=-1)
    assert not BK.BulkSpec(0).enabled() and BK.BulkSpec(4).enabled()
    for c in (1, 8, 9, 33, 100):
        for b in (1, 4, 32):
            for el in (False, True):
                assert BK.plan_blocks(c, b, el) == JBK.plan_blocks(c, b, el)
    with pytest.raises(ValueError):
        BK.plan_blocks(0, 4, False)
    seen = []

    def fold(block_ids, block_live, block_pos, bank):
        seen.append((block_ids.tolist(), list(block_pos)))
        return {"s": torch.tensor(float(block_ids.sum()))}, bank + 1

    ids = np.arange(6)
    out, bank = BK.stream_blocks(fold, ids, None, 2, banks=0, positions=True)
    assert float(out["s"]) == 15.0 and bank == 3
    assert seen == [([0, 1], [0, 1]), ([2, 3], [2, 3]), ([4, 5], [4, 5])]
    with pytest.raises(ValueError, match="multiple"):
        BK.stream_blocks(fold, np.arange(5), None, 2)
    counters = {}
    BK.note_round(counters, 32, 313, 16)
    BK.note_round(counters, 32, 313, 16)
    assert counters == {"bulk.block_size": 32.0,
                        "bulk.blocks_per_round": 313.0,
                        "bulk.padded_slots": 16.0, "bulk.rounds": 2.0}


def test_cli_bulk_and_elastic_flags(capsys):
    argv = ["--dataset", "fake_mnist", "--model", "lr",
            "--client_num_in_total", "8", "--client_num_per_round", "6"]
    cfg, _ = cli.parse_args(argv)
    assert (cfg.fed.client_block_size, cfg.fed.elastic_buckets) == (0, False)
    cfg, _ = cli.parse_args(argv + ["--client_block_size", "4", "--elastic"])
    assert (cfg.fed.client_block_size, cfg.fed.elastic_buckets) == (4, True)
    assert "warning" not in capsys.readouterr().err
    cli.parse_args(argv + ["--client_block_size", "6"])
    assert "whole cohort fits one block" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="client_block_size must be >= 0"):
        cli.parse_args(argv + ["--client_block_size", "-1"])


# ResNet-8's batch statistics, bulk against stacked: the reference's own
# test (tests/test_bulk.py::test_bulk_batch_stats_parity, its ResNet-8 at
# 32x32) holds them at rtol 5e-5 / atol 1e-6 and misses on every tree of
# this round. Measured here by scripts/bulk_bn_band.py (this test's
# round): the port's bulk round differs from its stacked round and from
# the JAX package's stacked round by at most 1.2e-7 absolute in any
# parameter or statistic (relative 1.9e-5 and 2.8e-5, on weights near 0;
# the port's stacked round from JAX's: 2.4e-7); held at 1e-6 absolute,
# the reference's atol
BN_BAND = dict(rtol=0, atol=1e-6)


def test_resnet8_batch_stats_bulk_against_stacked():
    """One round of all 4 clients of ResNet-8 (width 4, 16x16x3, SGD with
    momentum), the JAX package's cohort and batch orders replayed: the
    port's bulk round in blocks of 2 against its stacked round and
    against the JAX package's stacked round, every parameter and
    statistic in BN_BAND."""
    from fedml_tpu.models.base import FedModel as JaxFedModel
    from fedml_tpu_torch.convert import vision_state_dict
    from tests.test_torch_resnet_fedavg import B, COUNTS, _data
    from tests.test_torch_vision import RES_SHAPE, flax_resnet8

    flax_net, variables, model, params = flax_resnet8(seed=2)
    jdata, tdata = _data()

    def cfg(m, **fed):
        return m.ExperimentConfig(
            data=m.DataConfig(num_clients=len(COUNTS), batch_size=B),
            model=m.ModelConfig(name="resnet8", input_shape=RES_SHAPE),
            train=m.TrainConfig(lr=0.1, momentum=0.5, epochs=1),
            fed=m.FedConfig(num_rounds=1, clients_per_round=len(COUNTS),
                            **fed), seed=3)

    jsim = jfed.FedAvgSim(JaxFedModel(flax_net, RES_SHAPE,
                                      has_batch_stats=True), jdata, cfg(jc))
    sampler, batch_orders, _ = _replay(jsim, JC.CompressionSpec())
    jvars = jax.tree.map(jnp.asarray, variables)
    jstate = jsim.init()._replace(variables=jvars)
    jnew, _ = jsim.run_round(jstate)
    want = vision_state_dict(jax.device_get(jnew.variables), "ResNetCIFAR")
    got = {}
    for block in (0, 2):
        tsim = tfed.FedAvgSim(model, tdata, cfg(tc, client_block_size=block),
                              device="cpu", sampler=sampler,
                              batch_orders=batch_orders)
        state = tsim.init()._replace(variables=params)
        got[block] = tsim.run_round(state)[0].variables
    assert any(k.endswith("mean") for k in want)
    for k in want:
        np.testing.assert_allclose(got[2][k].numpy(), got[0][k].numpy(),
                                   **BN_BAND, err_msg=f"bulk vs stacked {k}")
        np.testing.assert_allclose(got[2][k].numpy(), want[k].numpy(),
                                   **BN_BAND, err_msg=f"bulk vs JAX {k}")
