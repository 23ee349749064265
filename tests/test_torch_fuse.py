"""Fused blocks (fedml_tpu_torch/core/fuse.py and ``FedAvgSim.run_block``)
against the port's per-round loop and against the JAX package's fused
block.

A port block enqueues the same rounds as the per-round loop, from the
same state, so a fused run equals the unfused one bit for bit: the
records, the final variables, the carried error-feedback residual (the
stacked ``[C, ...]`` one and the bulk engine's bank), under adversaries
and defenses, and under elastic churn between blocks. Against the JAX
package's fused block (a ``lax.scan`` of its round), its cohorts and
batch orders replayed: the port's sim-level band ``SIM_TOL`` (rtol 2e-5,
atol 2e-6). ``plan_blocks`` gives the JAX package's schedule exactly."""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core import fuse as JF
import fedml_tpu_torch.config as tc
from fedml_tpu_torch.algorithms import fedavg as tfed
from fedml_tpu_torch.core import fuse as F
from fedml_tpu_torch.metrics import MetricsSink
from fedml_tpu_torch.models import create_model
from tests.test_torch_byzantine import (
    SIM_TOL,
    _cfg,
    _datasets,
    _sims,
    _to_port,
)
from tests.torch_threads import one_torch_thread  # noqa: F401


def _sim(fuse=1, eval_every=None, **kw):
    cfg = _cfg(tc, fuse_rounds=fuse, **kw)
    if eval_every is not None:
        cfg = dataclasses.replace(cfg, fed=dataclasses.replace(
            cfg.fed, eval_every=eval_every))
    return tfed.FedAvgSim(create_model(cfg.model, "cpu"), _datasets()[1],
                          cfg, device="cpu")


def _same(a, b, where="") -> None:
    """Trees of tensors and scalars equal bit for bit."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, tuple):
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert a == b, where


def _records(sink):
    return [{k: v for k, v in r.items() if k != "_ts"} for r in sink.history]


def _run(sim):
    sink = MetricsSink()
    state = sim.run(metrics_sink=sink)
    return state, _records(sink)


PLANS = [(0, 7, 2, 3, 0), (0, 3, 1, 2, 0), (0, 8, 3, 3, 0), (5, 8, 4, 100, 0),
         (0, 8, 8, 8, 0), (0, 6, 4, 100, 2), (3, 10, 3, 4, 3),
         (0, 16, 8, 8, 2), (2, 9, 5, 1, 0), (0, 1, 4, 1, 1)]


@pytest.mark.parametrize("start,total,fuse,eval_every,ckpt", PLANS)
def test_plan_blocks_matches_jax(start, total, fuse, eval_every, ckpt):
    got = list(F.plan_blocks(start, total, fuse, eval_every, ckpt))
    assert got == list(JF.plan_blocks(start, total, fuse, eval_every, ckpt))
    assert sum(n for _, n, _ in got) == total - start
    assert got[-1][2]  # the final round is a boundary
    with pytest.raises(ValueError):
        next(F.plan_blocks(0, 4, 0, 1))


def test_block_pipeline_is_one_deep():
    pl = F.BlockPipeline()
    assert pl.flush() is None
    t0 = time.perf_counter()
    assert pl.push(0, 2, {"a": torch.arange(2.0)}, t0, compiled=True) is None
    prev = pl.push(2, 2, {"a": torch.arange(2.0) + 2}, t0)
    assert (prev.start, prev.length, prev.compiled) == (0, 2, True)
    assert prev.rows == [{"a": 0.0}, {"a": 1.0}]
    assert prev.wall_s > 0 and 0 <= prev.get_wait_s <= prev.wall_s
    last = pl.flush()
    assert (last.start, last.length, last.compiled) == (2, 2, False)
    assert [r["a"] for r in last.rows] == [2.0, 3.0]
    assert pl.flush() is None
    # a float32 value comes back as float() of it, exactly
    x = torch.tensor([0.1, 1 / 3], dtype=torch.float32)
    pl.push(0, 2, {"x": x}, t0)
    assert [r["x"] for r in pl.flush().rows] == [float(v) for v in x]


def test_construction_validates_fuse_rounds():
    with pytest.raises(ValueError, match="fuse_rounds"):
        _sim(fuse=0)
    with pytest.raises(ValueError, match="run_block"):
        _sim(fuse=1).run_block(None, 2)
    # the elastic round draws its own slots: a custom sampler is refused
    # with fusion as without (the JAX package's tests/test_fuse.py)
    cfg = _cfg(tc, fuse_rounds=2, elastic_buckets=True)
    with pytest.raises(ValueError, match="sampler"):
        tfed.FedAvgSim(create_model(cfg.model, "cpu"), _datasets()[1], cfg,
                       device="cpu", sampler=lambda r, n, k: torch.arange(k))


@pytest.mark.parametrize("fuse,rounds", [(1, 4), (2, 4), (3, 4), (3, 5)])
def test_fused_run_equals_unfused_bitwise(fuse, rounds):
    """``run`` in blocks of 2 and 3 (4 rounds with a partial tail block;
    5 rounds at K 3, evaluating after round 2): the records and the final
    variables, optimizer state and momentum equal the per-round loop's
    bit for bit; at K 1 ``run`` is the per-round loop."""
    kw = dict(rounds=rounds, eval_every=3, server_optimizer="adam",
              server_lr=0.01)
    ref_state, ref = _run(_sim(**kw))
    state, got = _run(_sim(fuse=fuse, **kw))
    assert got == ref
    assert [r["round"] for r in got] == list(range(rounds))
    _same(state._asdict(), ref_state._asdict())


@pytest.mark.parametrize("compress", ["int8", "topk_int8"])
def test_fused_carries_the_residual(compress):
    """The stacked ``[C, ...]`` error-feedback residual is carried from
    round to round inside a block: the records (the residual's norm
    among them), the state and the final residual equal the unfused
    run's bit for bit."""
    ref_sim, sim = (_sim(fuse=f, rounds=4, compress=compress)
                    for f in (1, 2))
    ref_state, ref = _run(ref_sim)
    state, got = _run(sim)
    assert got == ref
    assert all("compress_residual_norm" not in r for r in got)
    assert sim.counters == ref_sim.counters
    assert "compress.residual_norm" in sim.counters
    _same(state.variables, ref_state.variables)
    _same(sim.ef_residual, ref_sim.ef_residual)


def test_fused_adversary_under_a_defense_bitwise():
    """Seeded sign-flip adversaries under krum with clipping and noise:
    fused equals unfused bit for bit, the screen's counter too."""
    kw = dict(rounds=4, method="krum", mode="sign_flip",
              robust_norm_clip=2.0, robust_noise_stddev=1e-3)
    ref_sim, sim = _sim(**kw), _sim(fuse=2, **kw)
    ref_state, ref = _run(ref_sim)
    state, got = _run(sim)
    assert got == ref and sim.counters == ref_sim.counters
    _same(state.variables, ref_state.variables)


def test_fused_bulk_engine_bitwise():
    """The bulk engine (blocks of 4 clients, int8 with the client-keyed
    residual bank, the streamed median): fused equals unfused bit for
    bit, the bank's rows included, and the bank's gathers count per
    round."""
    kw = dict(rounds=4, compress="int8", method="median",
              client_block_size=4)
    ref_sim, sim = _sim(**kw), _sim(fuse=3, **kw)
    ref_state, ref = _run(ref_sim)
    state, got = _run(sim)
    assert got == ref
    assert sim.counters == ref_sim.counters and sim.counters[
        "bank.gathers"] > 0
    _same(state.variables, ref_state.variables)
    _same(sim.ef_bank.rows, ref_sim.ef_bank.rows)


def test_elastic_churn_lands_at_the_block_boundary():
    """A block counts once in the program cache (the JAX package's block
    program): the first block a miss, the next, after a churn inside the
    bucket, a hit. The churn takes effect at that block, as the unfused
    run churned at the same round shows bit for bit."""
    sim = _sim(fuse=2, rounds=4, elastic_buckets=True)

    def counts():
        c = sim.counters
        return (c.get("elastic.compile_cache_misses", 0),
                c.get("elastic.compile_cache_hits", 0))

    state = sim.init()
    state, _ = sim.run_block(state, 2)
    assert counts() == (1, 0)
    sim.set_cohort_size(2)
    state, block = sim.run_block(state, 2)
    assert counts() == (1, 1)
    assert block["train_loss"].shape == (2,)

    ref = _sim(rounds=4, elastic_buckets=True)
    rs = ref.init()
    for _ in range(2):
        rs, _ = ref.run_round(rs)
    ref.set_cohort_size(2)
    rows = []
    for _ in range(2):
        rs, m = ref.run_round(rs)
        rows.append(m["train_loss"])
    assert torch.equal(block["train_loss"], torch.stack(rows))
    _same(state.variables, rs.variables)
    assert ref.counters["elastic.compile_cache_hits"] == 3


def test_run_logs_every_round_and_evaluates_on_the_boundary():
    """7 rounds, K 2, eval every 3: blocks (0, 2), (2, 1), (3, 2), (5, 1),
    (6, 1); every round logged once in order, the evaluation on rounds
    2, 5 and 6 only, each record as the per-round loop's. Only the first
    block built a program (``compiled``): later lengths reuse it."""
    sim = _sim(fuse=2, rounds=7, eval_every=3)
    _, got = _run(sim)
    assert [r["round"] for r in got] == list(range(7))
    assert [r["round"] for r in got if "test_acc" in r] == [2, 5, 6]
    _, ref = _run(_sim(rounds=7, eval_every=3))
    assert got == ref
    assert [(b.start, b.length) for b in sim.last_blocks] == [
        (0, 2), (2, 1), (3, 2), (5, 1), (6, 1)]
    assert [b.compiled for b in sim.last_blocks] == [True] + [False] * 4
    assert sim.cohort_update.programs.stats["misses"] == 1


def test_fused_block_matches_the_jax_fused_block():
    """Two blocks of 2 rounds of lr on fake_mnist (6 of 8 clients a
    round), the JAX package's ``run_block`` (one ``lax.scan`` program a
    block) against the port's, the JAX cohorts and batch orders
    replayed: train metrics and parameters in SIM_TOL."""
    jsim, tsim, jstate, tstate = _sims(rounds=4, fuse_rounds=2)
    for _ in range(2):
        jstate, jm = jsim.run_block(jstate, 2)
        tstate, tm = tsim.run_block(tstate, 2)
        jm = jax.device_get(jm)
        assert set(tm) == set(jm)
        for k in jm:
            assert tm[k].shape == (2,)
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                       **SIM_TOL, err_msg=k)
    want = _to_port(jstate.variables)
    for k in want:
        np.testing.assert_allclose(tstate.variables[k].numpy(),
                                   want[k].numpy(), **SIM_TOL, err_msg=k)
    assert tstate.round == int(jnp.asarray(jstate.round)) == 4
