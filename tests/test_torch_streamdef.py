"""The port's streamed defenses (fedml_tpu_torch/core/streamdef.py)
against the JAX package's, function by function on the same numpy
inputs, and the port's streamed bulk round against the port's stacked
round (tests/test_streamdef.py's tiers).

Bands: the moments, the histogram edges and the estimates within 1e-6
(float32 sums of 2-row blocks, the same order on both sides), the
histogram counts and the trim table equal, each estimate within one bin
width of the exact order statistic (the reference's own band); the
projection within rtol 1e-5 (float32 matmuls in another order), the
selection weights of Krum and multi-Krum equal and FLTrust's within
1e-6; a streamed round against the stacked one within
``tests/test_streamdef.py``'s ``_PARITY_BAND`` per rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core import streamdef as JSD
import fedml_tpu_torch.config as tc
from fedml_tpu_torch.algorithms import fedavg as tfed
from fedml_tpu_torch.core import streamdef as SD
from fedml_tpu_torch.data import load_dataset
from fedml_tpu_torch.models import create_model
from tests.torch_threads import one_torch_thread  # noqa: F401

CLOSE = dict(rtol=1e-6, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def _folded(mod, flat, live, as_array):
    """Moments then histogram over 2-row blocks, summed block by block
    (the bulk engine's fold), in ``mod``'s package."""
    d = flat.shape[1]
    mom = None
    for i in range(0, flat.shape[0], 2):
        b = mod.fold_moments(as_array(flat[i:i + 2]), as_array(live[i:i + 2]))
        mom = b if mom is None else mod.CoordMoments(*(
            x + y for x, y in zip(mom, b)))
    lo, width = mod.hist_edges(mom)
    hist = None
    for i in range(0, flat.shape[0], 2):
        h = mod.fold_hist(as_array(flat[i:i + 2]), as_array(live[i:i + 2]),
                          lo, width)
        hist = h if hist is None else hist + h
    assert hist.shape == (mod.HIST_BINS, d)
    return mom, lo, width, hist


@pytest.mark.parametrize("spread", ["normal", "zero"])
def test_quantile_sketch_matches_jax_and_the_order_statistics(spread):
    rng = np.random.default_rng(0)
    if spread == "normal":
        x = rng.normal(size=(16, 7)).astype(np.float32)
        x[0] *= 40.0  # an outlier row the trimmed mean drops
    else:
        x = np.full((16, 7), 2.5, np.float32)
    live = np.ones(16, np.float32)
    live[3] = 0.0  # a dead row votes nothing
    mom, lo, width, hist = _folded(SD, x, live, _t)
    jmom, jlo, jwidth, jhist = _folded(JSD, x, live, jnp.asarray)
    for a, b in zip(mom + (lo, width), jmom + (jlo, jwidth)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **CLOSE)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jhist))
    ks, jks = SD.trim_table(0.2, 16), JSD.trim_table(0.2, 16)
    np.testing.assert_array_equal(ks.numpy(), np.asarray(jks))
    med = SD.median_from_hist(hist, lo, width, mom.count)
    trim = SD.trimmed_mean_from_hist(hist, lo, width, mom.count, ks)
    jmed = JSD.median_from_hist(jhist, jlo, jwidth, jmom.count)
    jtrim = JSD.trimmed_mean_from_hist(jhist, jlo, jwidth, jmom.count, jks)
    np.testing.assert_allclose(med.numpy(), np.asarray(jmed), **CLOSE)
    np.testing.assert_allclose(trim.numpy(), np.asarray(jtrim), **CLOSE)
    # within one bin of the exact rules over the 15 live rows (an odd
    # count: the CDF's crossing lands in the median's own bin)
    rows = np.sort(x[live > 0], axis=0)
    bin_w = width.numpy() + 1e-6
    np.testing.assert_array_less(np.abs(med.numpy() - rows[7]), bin_w)
    np.testing.assert_array_less(np.abs(trim.numpy()
                                        - rows[3:-3].mean(0)), bin_w)
    if spread == "zero":
        np.testing.assert_allclose(med.numpy(), 2.5, rtol=0, atol=1e-6)


def test_trim_table_is_the_stacked_rule_in_python_floats():
    for frac in (0.1, 0.25, 0.29, 0.3, 0.49):
        np.testing.assert_array_equal(SD.trim_table(frac, 100).numpy(),
                                      np.asarray(JSD.trim_table(frac, 100)))
    # float32 would trim 29 of 100 at 0.29 (100 * 0.29 = 29.000000238)
    assert SD.trim_table(0.29, 100)[100] == 28


def _normals(rkey, shapes):
    """JAX's projection blocks for a tree of ``shapes`` (sorted keys: the
    JAX leaf index), as the port's ``"proj"`` draws give them."""
    base = jax.random.fold_in(rkey, JSD._PROJ_SALT)
    return {k: _t(jax.random.normal(jax.random.fold_in(base, i),
                                    (int(np.prod(shapes[k])), JSD.PROJ_DIM),
                                    jnp.float32))
            for i, k in enumerate(sorted(shapes))}


def test_projection_sketch_matches_jax():
    rng = np.random.default_rng(1)
    shapes = {"a": (3, 4), "b": (5,)}
    deltas = {k: rng.normal(size=(4,) + s).astype(np.float32)
              for k, s in shapes.items()}
    n_k = np.asarray([3.0, 0.0, 5.0, 2.0], np.float32)
    live = np.asarray([1.0, 1.0, 1.0, 0.0], np.float32)
    rkey = jax.random.key(7)
    normals = _normals(rkey, shapes)
    assert SD.proj_shapes({k: torch.zeros(s) for k, s in shapes.items()}
                          ) == {k: tuple(v.shape) for k, v in normals.items()}
    got = SD.fold_proj({k: _t(v) for k, v in deltas.items()}, _t(n_k),
                       _t(live), range(4, 8), 12, normals)
    want = jax.jit(JSD.fold_proj, static_argnums=4)(
        {k: jnp.asarray(v) for k, v in deltas.items()}, jnp.asarray(n_k),
        jnp.asarray(live), jnp.arange(4, 8), 12, rkey)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    assert float(got.proj[:4].abs().max()) == 0.0  # other blocks' slots


@pytest.mark.parametrize("method", ["krum", "multikrum", "fltrust"])
def test_selection_weights_match_jax(method):
    """One sketch of 10 slots (2 far outliers, a dead slot, a zero-weight
    slot) on both sides: the same weights."""
    rng = np.random.default_rng(2)
    proj = rng.normal(size=(10, SD.PROJ_DIM)).astype(np.float32)
    proj[[2, 7]] += 30.0
    norm = np.linalg.norm(proj, axis=1).astype(np.float32)
    weight = rng.integers(1, 9, 10).astype(np.float32)
    weight[4] = 0.0
    live = np.ones(10, np.float32)
    live[9] = 0.0
    got = SD.selection_weights(method, SD.ProjSketch(
        _t(proj), _t(norm), _t(weight), _t(live)), 2, 0)
    want = jax.jit(JSD.selection_weights, static_argnums=(0, 2, 3))(
        method, JSD.ProjSketch(jnp.asarray(proj), jnp.asarray(norm),
                               jnp.asarray(weight), jnp.asarray(live)),
        2, 0)
    if method == "fltrust":
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **CLOSE)
    else:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert float(got[0][2]) == float(got[0][7]) == 0.0
    if method == "fltrust":
        # no trust at all: a zero aggregate
        flip = SD.ProjSketch(_t(np.stack([proj[0], -proj[0]])),
                             torch.ones(2), torch.ones(2), torch.ones(2))
        assert float(SD.selection_weights(method, flip, 0, 0)[0].abs()
                     .max()) == 0.0
    with pytest.raises(ValueError, match="not a streaming"):
        SD.selection_weights("median", SD.ProjSketch(
            _t(proj), _t(norm), _t(weight), _t(live)), 2, 0)


def test_sketch_size_and_gauges_match_jax():
    for method in SD.STREAM_METHODS:
        assert SD.sketch_mb(method, 10**6, 1024) == JSD.sketch_mb(
            method, 10**6, 1024)
    counters = {}
    SD.note_defense(counters, "krum", 7850, 64)
    assert counters == {"defense.sketch_bins": 0.0,
                        "defense.sketch_proj_dim": 256.0,
                        "defense.sketch_mb": JSD.sketch_mb("krum", 7850, 64)}
    assert (SD.PROJ_DIM, SD.HIST_BINS, SD.HIST_SPAN) == (
        JSD.PROJ_DIM, JSD.HIST_BINS, JSD.HIST_SPAN)


# the reference's bands, tests/test_streamdef.py _PARITY_BAND (measured
# there on this configuration: median 1.2e-2, trimmed 2.6e-4, krum
# 5.6e-2, multikrum 6.9e-3, fltrust 3.4e-3)
_PARITY_BAND = {"median": 8e-2, "trimmed_mean": 5e-3, "krum": 2.5e-1,
                "multikrum": 5e-2, "fltrust": 5e-2}


def _run(**fed):
    cfg = tc.ExperimentConfig(
        data=tc.DataConfig(dataset="fake_mnist", num_clients=8,
                           batch_size=32, seed=0),
        model=tc.ModelConfig(name="lr", num_classes=10,
                             input_shape=(28, 28, 1)),
        train=tc.TrainConfig(lr=0.1, epochs=1),
        fed=tc.FedConfig(num_rounds=2, clients_per_round=8, **fed), seed=0)
    sim = tfed.FedAvgSim(create_model(cfg.model, "cpu"),
                         load_dataset(cfg.data), cfg, device="cpu")
    state = sim.init()
    for _ in range(2):
        state, m = sim.run_round(state)
    return state, float(m["train_loss"])


@pytest.mark.parametrize("method", sorted(_PARITY_BAND))
def test_streamed_defense_tracks_the_stacked_round(method):
    """2 rounds of 8 clients (lr, fake_mnist): the streamed rule in
    blocks of 2 against the port's stacked rule."""
    kw = dict(robust_method=method)
    if method in ("krum", "multikrum"):
        kw["robust_num_adversaries"] = 1
    s_bulk, loss = _run(client_block_size=2, **kw)
    s_stk, _ = _run(**kw)
    assert np.isfinite(loss)
    diff = max(float((s_bulk.variables[k] - s_stk.variables[k]).abs().max())
               for k in s_stk.variables)
    assert diff < _PARITY_BAND[method], (method, diff)
