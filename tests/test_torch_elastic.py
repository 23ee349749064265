"""Elastic buckets (fedml_tpu_torch/core/elastic.py and the elastic round
of algorithms/fedavg.py) against the JAX package's.

Bands: the bucket arithmetic, the padding and the masks equal; the
padded aggregate bit for bit equal to the unpadded one for the
selection rules and within rtol 1e-5 / atol 1e-6 for the summing ones,
and bit for bit content-blind for every rule
(``tests/test_elastic.py``'s tiers, FLTrust among the summing rules);
an elastic round against the JAX
package's, its bucket draw replayed, in the port's sim-level band
``SIM_TOL`` (rtol 2e-5 / atol 2e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu.config as jc
from fedml_tpu.algorithms import fedavg as jfed
from fedml_tpu.core import elastic as JE
from fedml_tpu.core import random as JR
from fedml_tpu.models import create_model as jax_create_model
import fedml_tpu_torch.config as tc
from fedml_tpu_torch.algorithms import fedavg as tfed
from fedml_tpu_torch.core import elastic as E
from fedml_tpu_torch.core import robust
from fedml_tpu_torch.models import create_model
from tests.test_torch_byzantine import (
    SIM_TOL,
    _cfg,
    _datasets,
    _replay,
    _to_port,
    _unoptimized,
)
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_bucket_for_and_masks_match_jax():
    for n in (1, 2, 3, 4, 5, 8, 9, 33):
        assert E.bucket_for(n) == JE.bucket_for(n)
    assert E.bucket_for(3, min_bucket=8) == 8
    with pytest.raises(ValueError):
        E.bucket_for(0)
    np.testing.assert_array_equal(E.active_mask(8, 3).numpy(),
                                  np.asarray(JE.active_mask(8, 3)))
    rng = np.random.default_rng(0)
    stacked = {"a": rng.normal(size=(4, 3)).astype(np.float32)}
    glob = {"a": rng.normal(size=(3,)).astype(np.float32)}
    n_k = np.asarray([3.0, 2.0, 5.0, 1.0], np.float32)
    live = np.asarray([True, False, True, False])
    sums = {"loss_sum": n_k * 0.5}
    healed, n_out, sums_out = E.mask_padded(
        {k: torch.from_numpy(v) for k, v in stacked.items()},
        torch.from_numpy(n_k),
        {k: torch.from_numpy(v) for k, v in sums.items()},
        {k: torch.from_numpy(v) for k, v in glob.items()},
        torch.from_numpy(live))
    jhealed, jn, jsums = JE.mask_padded(stacked, jnp.asarray(n_k), sums,
                                        glob, jnp.asarray(live))
    np.testing.assert_array_equal(healed["a"].numpy(),
                                  np.asarray(jhealed["a"]))
    np.testing.assert_array_equal(n_out.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(sums_out["loss_sum"].numpy(),
                                  np.asarray(jsums["loss_sum"]))


def _delta_case(rng, c):
    deltas = {"a": torch.from_numpy(rng.normal(size=(c, 3, 2)).astype(
        np.float32)), "b": torch.from_numpy(rng.normal(size=(c, 5)).astype(
            np.float32))}
    weights = torch.from_numpy(rng.integers(1, 40, size=(c,)).astype(
        np.float32))
    zero = {"a": torch.zeros((3, 2)), "b": torch.zeros((5,))}
    return deltas, weights, zero


# the selection rules reproduce the unpadded aggregate bit for bit; the
# summing ones add exact zeros to a wider sum (tests/test_elastic.py).
# FLTrust is bitwise in the JAX package and an ulp off here: its trust-
# weighted sum over the client axis is a torch sum over the padded rows,
# which the CPU's vectorized reduction associates by the row count
EXACT_RULES = ("median", "krum")
ULP_RULES = ("mean", "trimmed_mean", "multikrum", "fltrust")


@pytest.mark.parametrize("rule", EXACT_RULES + ULP_RULES)
def test_padded_aggregation_matches_unpadded_every_cohort_size(rule):
    """Cohort sizes 1..8 padded to their buckets (1, 2, 4, 8): the padded
    reduce against the unpadded one, and the padding itself against the
    JAX package's."""
    red = tfed.local_reducer()
    pipe = robust.DefensePipeline(method=rule, num_adversaries=1)
    rng = np.random.default_rng(0)
    for c in range(1, 9):
        deltas, weights, zero = _delta_case(rng, c)
        pd, pw, valid = E.pad_stacked(deltas, weights, zero,
                                      E.bucket_for(c))
        jpd, jpw, jvalid = JE.pad_stacked(
            {k: v.numpy() for k, v in deltas.items()}, weights.numpy(),
            {k: v.numpy() for k, v in zero.items()}, JE.bucket_for(c))
        np.testing.assert_array_equal(pw.numpy(), np.asarray(jpw))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        un = pipe.reduce(deltas, weights, red)
        pa = pipe.reduce(pd, pw, red, valid)
        for k in un:
            np.testing.assert_array_equal(pd[k].numpy(), np.asarray(jpd[k]))
            if rule in EXACT_RULES:
                np.testing.assert_array_equal(pa[k].numpy(), un[k].numpy(),
                                              err_msg=f"{rule} c={c} {k}")
            else:
                np.testing.assert_allclose(pa[k].numpy(), un[k].numpy(),
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=f"{rule} c={c} {k}")
    with pytest.raises(ValueError, match="does not fit"):
        E.pad_stacked(deltas, weights, zero, 2)


@pytest.mark.parametrize("rule", EXACT_RULES + ULP_RULES)
def test_padding_rows_are_content_blind_bitwise(rule):
    """At a fixed bucket the masked rows cannot move the aggregate:
    garbage in the padding gives the same bits, for every rule."""
    red = tfed.local_reducer()
    pipe = robust.DefensePipeline(method=rule, num_adversaries=1)
    rng = np.random.default_rng(1)
    for c in (1, 3, 5, 7):
        deltas, weights, zero = _delta_case(rng, c)
        pd, pw, valid = E.pad_stacked(deltas, weights, zero, E.bucket_for(c))
        junk = {k: torch.where(valid.reshape((-1,) + (1,) * (x.ndim - 1)),
                               x, torch.from_numpy(rng.normal(
                                   size=tuple(x.shape)).astype(np.float32)
                                   * 1e3)) for k, x in pd.items()}
        a, b = pipe.reduce(pd, pw, red, valid), pipe.reduce(junk, pw, red,
                                                            valid)
        for k in a:
            assert torch.equal(a[k], b[k]), (rule, c, k)


def test_trimmed_mean_padded_trim_count_matches_static():
    """The padded rule's trim count comes from the static rule's Python
    float formula (float32 would trim 29 of 100 at 0.29, not 28)."""
    rng = np.random.default_rng(5)
    for frac in (0.1, 0.25, 0.29, 0.3, 0.49):
        for n in (3, 7, 10, 13, 100):
            x = torch.from_numpy(rng.normal(size=(n, 6)).astype(np.float32))
            want = robust.trimmed_mean({"w": x}, frac)["w"]
            bucket = E.bucket_for(n)
            padded = {"w": torch.cat([x, torch.full((bucket - n, 6), 7.75)])}
            valid = torch.arange(bucket) < n
            got = robust.trimmed_mean(padded, frac, valid)["w"]
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{frac} {n}")


def _sim(sampler=None, **kw):
    cfg = _cfg(tc, **kw)
    return tfed.FedAvgSim(create_model(cfg.model, "cpu"), _datasets()[1],
                          cfg, device="cpu", sampler=sampler)


def test_set_cohort_size_validation():
    sim = _sim(elastic_buckets=True)  # 6 of 8: bucket 8
    with pytest.raises(ValueError, match="does not fit"):
        sim.set_cohort_size(9)
    with pytest.raises(ValueError, match="does not fit"):
        sim.set_cohort_size(0)
    sim.set_cohort_size(8)
    with pytest.raises(ValueError, match="elastic_buckets"):
        _sim().set_cohort_size(3)
    with pytest.raises(ValueError, match="elastic_buckets"):
        _sim(client_block_size=4).set_cohort_size(4)
    bulk = _sim(cohort=5, client_block_size=2, elastic_buckets=True)
    assert (bulk._n_blocks, bulk._slots, bulk._max_live) == (4, 8, 8)
    with pytest.raises(ValueError, match="block grid"):
        bulk.set_cohort_size(9)


def test_elastic_rejects_a_custom_sampler():
    with pytest.raises(ValueError, match="custom cohort sampler"):
        _sim(sampler=lambda r, n, k: torch.arange(k), elastic_buckets=True)


def test_elastic_round_matches_jax():
    """3 rounds of the elastic round at live cohorts 6, 3 and 5 of a
    bucket of 8 (lr, fake_mnist, real training): the port against the
    JAX package's, its bucket permutation replayed through the port's
    slot sampler; the dead slots are healed on both sides."""
    jcfg, tcfg = (_cfg(m, elastic_buckets=True) for m in (jc, tc))
    jdata, tdata = _datasets()
    jsim = jfed.FedAvgSim(jax_create_model(jcfg.model), jdata, jcfg)
    _, batch_orders, draws = _replay(jsim, None)

    def slot_sampler(r, n, k):
        key = jax.random.fold_in(JR.round_key(jsim.root_key, r), 0)
        ids = np.asarray(jsim._sample_bucket(key, n))
        assert ids.shape == (k,)
        return torch.from_numpy(ids.astype(np.int64))

    tsim = tfed.FedAvgSim(create_model(tcfg.model, "cpu"), tdata, tcfg,
                          device="cpu", batch_orders=batch_orders,
                          draws=draws, slot_sampler=slot_sampler)
    jstate = jsim.init()
    tstate = tsim.init()._replace(variables=_to_port(jstate.variables))
    jround = _unoptimized(jsim._round)
    for r, live in enumerate((6, 3, 5)):
        tsim.set_cohort_size(live)
        jstate, jm = jround(jstate, jsim.arrays, jnp.asarray(live, jnp.int32))
        tstate, tm = tsim.run_round(tstate)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       **SIM_TOL, err_msg=f"{r} {k}")
        want = _to_port(jstate.variables)
        for k in want:
            np.testing.assert_allclose(tstate.variables[k].numpy(),
                                       want[k].numpy(), **SIM_TOL,
                                       err_msg=f"round {r} {k}")
    assert tsim.counters["elastic.compile_cache_misses"] == 1
    assert tsim.counters["elastic.compile_cache_hits"] == 2


@pytest.mark.parametrize("bulk", [0, 2])
def test_churn_costs_one_program(bulk):
    """A churn schedule of live cohorts in [2, 8] over 8 rounds (bench.py
    elastic_churn_record's, cut): one program built (on the card one
    graph capture), every other round a hit; stacked and bulk. The
    compressed stacked round zeroes the residual of its dead slots."""
    sim = _sim(cohort=8, client_block_size=bulk, elastic_buckets=True,
               compress="none" if bulk else "int8")
    state = sim.init()
    for n in (8, 3, 5, 2, 7, 4, 6, 3):
        sim.set_cohort_size(n)
        state, m = sim.run_round(state)
        assert np.isfinite(float(m["train_loss"]))
    assert sim.counters["elastic.compile_cache_misses"] == 1
    assert sim.counters["elastic.compile_cache_hits"] == 7
    assert len(sim.cohort_update.programs) == 1
    if not bulk:
        for r in sim.ef_residual.values():
            assert float(r[3:].abs().max()) == 0.0 < float(r[:3].abs().max())


def test_compiled_round_cache_is_an_lru():
    built = []
    cache = E.CompiledRoundCache(lambda k: built.append(k) or f"p{k}",
                                 max_entries=2)
    assert [cache(k) for k in (4, 4, 8, 16, 4)] == ["p4", "p4", "p8",
                                                     "p16", "p4"]
    assert built == [4, 8, 16, 4] and len(cache) == 2
    assert cache.stats == {"hits": 1, "misses": 4, "evictions": 2}
    counters = {}
    E.mirror_jit_cache(cache, lambda: cache(16), counters)
    E.mirror_jit_cache(cache, lambda: cache(32), counters)
    assert counters == {"elastic.compile_cache_hits": 1,
                        "elastic.compile_cache_misses": 1}
