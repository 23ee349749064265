"""The port's defenses (fedml_tpu_torch/core/robust.py) against the JAX
package's, on the same numpy inputs, and the JAX suite's edge cases of
tests/test_robust.py ported.

Bands: the median, order statistics and Krum's selections exact in
float32; the trimmed mean, clipping and the weighted means rtol 1e-6;
whatever goes through a matmul or a reassociated sum (FLTrust, the
anomaly scores) rtol 2e-5 / atol 2e-6."""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import fedavg as jfed
from fedml_tpu.core import robust as JR
import fedml_tpu_torch.config as tc
from fedml_tpu_torch.algorithms import fedavg as tfed
from fedml_tpu_torch.core import robust as R

EXACT = dict(rtol=0, atol=0)
CLOSE = dict(rtol=1e-6, atol=1e-7)
MATMUL = dict(rtol=2e-5, atol=2e-6)
EPS32 = float(np.finfo(np.float32).eps)
SHAPES = {"a": (3, 4), "b": (5,)}  # sorted keys: both packages' order


def _jx(fn, *args, **kwargs):
    """The JAX package's ``fn(*args, **kwargs)``, jitted (one compile,
    where op-by-op dispatch compiles every operation); arguments that
    are not arrays are static."""
    bound = inspect.signature(fn).bind(*args, **kwargs)
    static = [k for k, v in bound.arguments.items()
              if isinstance(v, (int, float, str, tuple))]
    return jax.jit(fn, static_argnames=static)(**bound.arguments)


def _pair(tree):
    """A numpy tree as (JAX tree, port tree)."""
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in tree.items()})


def _close(got, want, band):
    if isinstance(got, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], band)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **band)


def _clusters(c=9, seed=0):
    """``c`` clients: the honest ones around +1, two attackers far away
    (row c-2 sign-flipped and boosted, row c-1 a random colluder); the
    clusters are far apart, so no rounding can reorder a selection."""
    rng = np.random.default_rng(seed)
    tree = {}
    for k, s in SHAPES.items():
        x = 1.0 + 0.05 * rng.standard_normal((c,) + s)
        x[c - 2] = -20.0
        x[c - 1] = 5.0 * rng.standard_normal(s)
        tree[k] = x.astype(np.float32)
    return tree


def _stack(rows):
    return _pair({"w": np.asarray(rows, np.float32)})


def _dist_band(t):
    """``[C, C]``: the float32 error of ``|x|^2 + |y|^2 - 2 x.y`` for each
    pair, ``4 eps (|x|^2 + |y|^2)``: the cancellation, whatever order the
    sums take."""
    sq = (R.flatten_clients(t) ** 2).sum(1).numpy()
    return 4 * EPS32 * (sq[:, None] + sq[None, :])


def _close_within(got, want, atol):
    """``got`` within ``atol`` (elementwise) plus rtol 2e-5 of ``want``."""
    got, want = got.numpy(), np.asarray(want)
    with np.errstate(invalid="ignore"):  # inf - inf where both are inf
        near = np.abs(got - want) <= atol + 2e-5 * np.abs(want)
    assert np.all(near | (got == want)), (got, want)


# -- the coordinate rules ------------------------------------------------------


def test_coordinate_median_even_client_count():
    """torch.median takes the lower middle value; the port takes the
    midpoint, as jnp.median does, bit for bit."""
    j, t = _stack([[1.0, 10.0], [2.0, 20.0], [3.0, 30.0],
                   [100.0, -100.0]])
    got = R.coordinate_median(t)
    _close(got, _jx(JR.coordinate_median, j), EXACT)
    np.testing.assert_array_equal(got["w"].numpy(), [2.5, 15.0])
    assert torch.median(t["w"], dim=0).values.tolist() == [2.0, 10.0]


@pytest.mark.parametrize("c", [1, 7, 10])
def test_coordinate_median_matches_jax(c):
    j, t = _pair(_clusters(c) if c > 2 else {
        k: np.random.default_rng(c).standard_normal((c,) + s)
        .astype(np.float32) for k, s in SHAPES.items()})
    _close(R.coordinate_median(t), _jx(JR.coordinate_median, j), EXACT)
    valid = np.arange(c) % 3 != 1
    _close(R.coordinate_median(t, torch.from_numpy(valid)),
           _jx(JR.coordinate_median, j, jnp.asarray(valid)), EXACT)


@pytest.mark.parametrize("c,frac", [(10, 0.3), (4, 0.9), (1, 0.5)])
def test_trimmed_mean_matches_jax(c, frac):
    j, t = _pair({k: np.random.default_rng(c).standard_normal((c,) + s)
                  .astype(np.float32) for k, s in SHAPES.items()})
    _close(R.trimmed_mean(t, frac), _jx(JR.trimmed_mean, j, frac), CLOSE)
    # the valid form: every row valid, then the last row dropped
    for valid in (np.ones(c, bool), np.arange(c) < max(1, c - 1)):
        _close(R.trimmed_mean(t, frac, torch.from_numpy(valid)),
               _jx(JR.trimmed_mean, j, frac, jnp.asarray(valid)), CLOSE)


def test_trim_count_is_a_host_python_float():
    """The trim count is int(c * trim_frac) in Python floats: at c = 100,
    trim 0.29 that is 28 (28.999999999999996), where float32 makes it
    29; the valid form trims as many as the static one."""
    assert R.trim_count(100, 0.29) == 28
    assert int(np.float32(100) * np.float32(0.29)) == 29
    rows = np.arange(100, dtype=np.float32)[:, None] ** 2
    j, t = _pair({"w": rows})
    want = rows[28:72].mean(0)
    _close(R.trimmed_mean(t, 0.29), _jx(JR.trimmed_mean, j, 0.29), CLOSE)
    np.testing.assert_allclose(R.trimmed_mean(t, 0.29)["w"].numpy(), want)
    np.testing.assert_allclose(R.trimmed_mean(
        t, 0.29, torch.ones(100, dtype=torch.bool))["w"].numpy(), want,
        rtol=1e-6)


def test_trimmed_mean_edge_cases():
    """Over-trimming degrades to the middle rows; one client is its own
    mean; trim 0 is the mean."""
    _, t = _stack([[1.0], [2.0], [3.0], [1000.0]])
    np.testing.assert_allclose(R.trimmed_mean(t, 0.9)["w"].numpy(), [2.5])
    _, t = _stack([[5.0, -1.0]])
    for frac in (0.0, 0.1, 0.5, 0.99):
        np.testing.assert_allclose(R.trimmed_mean(t, frac)["w"].numpy(),
                                   [5.0, -1.0])
    _, t = _stack([[1.0], [3.0]])
    np.testing.assert_allclose(R.trimmed_mean(t, 0.0)["w"].numpy(), [2.0])


def test_norm_clip_matches_jax_and_its_edges():
    tree = _clusters(6)
    tree["a"][2] = 0.0  # client 2 has an all-zero delta...
    tree["b"][2] = 0.0
    j, t = _pair(tree)
    got = R.clip_deltas_by_norm(t, 1.5)
    _close(got, _jx(JR.clip_deltas_by_norm, j, 1.5), CLOSE)
    assert torch.all(got["a"][2] == 0) and torch.all(got["b"][2] == 0)
    # ...under the threshold a delta is left as it was
    _, t = _stack([[0.3, 0.4]])
    np.testing.assert_allclose(R.clip_deltas_by_norm(t, 1.0)["w"].numpy(),
                               [[0.3, 0.4]], rtol=1e-6)
    # each leaf keeps its type; the norm is over all leaves
    mixed = {"a": torch.full((3, 4), 2.0, dtype=torch.bfloat16),
             "b": torch.full((3, 2), 3.0)}
    out = R.clip_deltas_by_norm(mixed, 1.0)
    assert out["a"].dtype == torch.bfloat16 and out["b"].dtype == torch.float32
    total = torch.sqrt(torch.sum(out["a"].float() ** 2, 1)
                       + torch.sum(out["b"] ** 2, 1))
    assert torch.all(total <= 1.05)
    # zero-size leaves pass; an empty tree is returned as it is
    out = R.clip_deltas_by_norm({"w": torch.ones(2, 3),
                                 "empty": torch.zeros(2, 0)}, 1.0)
    assert out["empty"].shape == (2, 0) and torch.isfinite(out["w"]).all()
    assert R.clip_deltas_by_norm({}, 1.0) == {}


def test_gaussian_noise_with_replayed_draws():
    """The JAX package's noise (one key per leaf, split in sorted-key
    order), replayed as the port's draws."""
    j, t = _pair({k: np.ones(s, np.float32) for k, s in SHAPES.items()})
    key = jax.random.key(3)
    keys = jax.random.split(key, len(SHAPES))
    normals = {k: torch.from_numpy(np.asarray(
        jax.random.normal(kk, s, jnp.float32)))
        for (k, s), kk in zip(sorted(SHAPES.items()), keys)}
    _close(R.add_gaussian_noise(t, 0.7, normals),
           _jx(JR.add_gaussian_noise, j, 0.7, key), CLOSE)


# -- selection and scoring -----------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_krum_and_multikrum_select_as_jax(masked):
    tree = _clusters(9)
    j, t = _pair(tree)
    w = np.array([3, 5, 2, 0, 4, 6, 1, 7, 8], np.float32) if masked \
        else np.ones(9, np.float32)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    band = _dist_band(t)
    _close_within(R.pairwise_sq_dists(t), _jx(JR.pairwise_sq_dists, j), band)
    sel, scores, best = R.krum(t, 2, tw)
    jsel, jscores, jbest = _jx(JR.krum, j, 2, jw)
    assert int(best) == int(jbest) and int(best) < 7 and w[int(best)] > 0
    _close(sel, jsel, EXACT)
    # a score sums at most C - 1 distances of its row (or _FAR stand-ins)
    _close_within(scores, jscores, band.sum(1))
    for m in (0, 3):
        agg, _, mask = R.multi_krum(t, tw, 2, m)
        jagg, _, jmask = _jx(JR.multi_krum, j, jw, 2, m)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        assert not mask[7]
        _close(agg, jagg, CLOSE)


def test_krum_valid_forms_match_jax():
    """The padded-cohort form: rows past the valid count, with n_valid
    setting the neighbour and keep counts."""
    tree = _clusters(9)
    j, t = _pair(tree)
    valid = np.arange(9) != 4
    w = valid.astype(np.float32)
    n_valid = int(valid.sum())
    d2 = _jx(JR.pairwise_sq_dists, j)
    for nv in (None, n_valid):
        want = _jx(JR.krum_scores, d2, 2, jnp.asarray(valid),
                              None if nv is None else jnp.asarray(nv))
        got = R.krum_scores(R.pairwise_sq_dists(t), 2,
                            torch.from_numpy(valid),
                            None if nv is None else torch.tensor(nv))
        _close_within(got, want, _dist_band(t).sum(1))
    _, _, best = R.krum(t, 2, torch.from_numpy(w), torch.tensor(n_valid))
    _, _, jbest = _jx(JR.krum, j, 2, jnp.asarray(w), jnp.asarray(n_valid))
    assert int(best) == int(jbest)
    for m in (0, 4):
        _, _, mask = R.multi_krum(t, torch.from_numpy(w), 2, m,
                                  torch.tensor(n_valid))
        _, _, jmask = _jx(JR.multi_krum, j, jnp.asarray(w), 2, m,
                                    jnp.asarray(n_valid))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


def test_multikrum_ties_go_to_the_lower_index():
    """A tie at the m-th place: lax.top_k keeps the lower index, and so
    does the port (a stable sort), in both forms."""
    j, t = _stack(np.eye(5, dtype=np.float32))
    scores = np.array([3.0, 1.0, 2.0, 2.0, 2.0], np.float32)
    w = np.ones(5, np.float32)
    for nv in (None, 5):
        _, _, mask = R.multi_krum(t, torch.from_numpy(w), 1, 3,
                                  None if nv is None else torch.tensor(nv),
                                  scores=torch.from_numpy(scores))
        _, _, jmask = _jx(JR.multi_krum, j, jnp.asarray(w), 1, 3,
                                    None if nv is None else jnp.asarray(nv),
                                    scores=jnp.asarray(scores))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        np.testing.assert_array_equal(mask.numpy(), [0, 1, 1, 1, 0])


def test_zero_weight_rows_never_win_selection():
    rng = np.random.default_rng(1)
    rows = np.concatenate([1.0 + 0.05 * rng.standard_normal((2, 4)),
                           np.zeros((2, 4))]).astype(np.float32)
    _, t = _stack(rows)
    w = torch.tensor([32.0, 32.0, 0.0, 0.0])
    assert int(R.krum(t, 2, w)[2]) < 2
    agg, _, _ = R.multi_krum(t, w, 2)
    assert torch.all((agg["w"] - 1.0).abs() < 0.5)
    _, trust = R.fltrust(t, R.coordinate_median(t), weights=w)
    assert torch.all(trust[2:] == 0)


def test_fltrust_matches_jax_and_its_edges():
    j, t = _pair(_clusters(9))
    w = np.array([1, 1, 0, 1, 1, 1, 1, 1, 1], np.float32)
    agg, trust = R.fltrust(t, R.coordinate_median(t),
                           weights=torch.from_numpy(w))
    jagg, jtrust = _jx(JR.fltrust, j, _jx(JR.coordinate_median, j),
                              weights=jnp.asarray(w))
    _close(trust, jtrust, MATMUL)
    _close(agg, jagg, MATMUL)
    # an opposing delta gets no trust and cannot drag the aggregate
    _, t = _stack([[1.0, 1.0], [1.0, 0.9], [-10.0, -10.0]])
    agg, trust = R.fltrust(t, {"w": torch.tensor([1.0, 1.0])})
    assert trust[2] == 0 and trust[0] > 0 and trust[1] > 0
    assert torch.all(agg["w"] > 0)
    # no trust at all: the reference itself
    _, t = _stack([[-1.0, -1.0], [-2.0, -2.0]])
    agg, trust = R.fltrust(t, {"w": torch.tensor([1.0, 2.0])})
    assert torch.all(trust == 0)
    np.testing.assert_array_equal(agg["w"].numpy(), [1.0, 2.0])


@pytest.mark.parametrize("masked", [False, True])
def test_anomaly_scores_match_jax(masked):
    """ddof 0 in the z-score (torch.std's default is 1); with the
    colluder's twin appended, the duplicate signal fires for both.
    nearest_rel comes from a cancelling distance (about 4 eps |x|^2 =
    8e-6 at |x|^2 = 17, through a square root, over the norm): atol
    1e-5."""
    tree = _clusters(9)
    tree = {k: np.concatenate([v, v[8:9]]) for k, v in tree.items()}
    j, t = _pair(tree)
    valid = np.arange(10) != 3 if masked else None
    got = R.anomaly_scores(t, None if valid is None
                           else torch.from_numpy(valid))
    want = _jx(JR.anomaly_scores, j, None if valid is None
                             else jnp.asarray(valid))
    keep = np.ones(10, bool) if valid is None else valid
    for k in want:
        band = dict(MATMUL, atol=1e-5) if k == "nearest_rel" else MATMUL
        np.testing.assert_allclose(got[k].numpy()[keep],
                                   np.asarray(want[k])[keep], **band,
                                   err_msg=k)
    score = got["score"].numpy()
    assert score[7] > 1.0 and score[8] >= 2.0 and score[9] >= 2.0
    assert np.all(score[:7][keep[:7]] < 1.0)


# -- the pipeline --------------------------------------------------------------


@pytest.mark.parametrize("method", R.DefensePipeline.METHODS)
def test_pipeline_matches_jax(method):
    """preprocess (clip), reduce under each rule and postprocess (noise,
    the draws replayed), against the JAX pipeline; with and without a
    valid mask."""
    kw = dict(method=method, clip=3.0, noise_stddev=0.01,
              num_adversaries=2, trim_frac=0.2)
    pipe, jpipe = R.DefensePipeline(**kw), JR.DefensePipeline(**kw)
    j, t = _pair(_clusters(9))
    w = np.arange(1, 10, dtype=np.float32)
    band = MATMUL if method == "fltrust" else CLOSE
    for valid in (None, np.arange(9) != 5):
        got = pipe.reduce(pipe.preprocess(t), torch.from_numpy(w),
                          tfed.local_reducer(),
                          None if valid is None else torch.from_numpy(valid))
        want = _jx(jpipe.reduce, _jx(jpipe.preprocess, j), jnp.asarray(w),
                            jfed.local_reducer(),
                            None if valid is None else jnp.asarray(valid))
        _close(got, want, band)
    key = jax.random.key(5)
    keys = jax.random.split(key, len(SHAPES))

    def normals(shapes):
        assert shapes == {k: s for k, s in sorted(SHAPES.items())}
        return {k: torch.from_numpy(np.asarray(jax.random.normal(kk, s)))
                for (k, s), kk in zip(shapes.items(), keys)}

    _close(pipe.postprocess(got, normals), _jx(jpipe.postprocess, want, key),
           band)
    assert pipe.excluded_count(9) == jpipe.excluded_count(9)
    quiet = dataclasses.replace(pipe, noise_stddev=0.0)
    assert quiet.postprocess(got, None) is got


def test_pipeline_configuration_rules():
    fed = tc.FedConfig(robust_method="multikrum", robust_num_adversaries=2,
                       robust_multikrum_m=5, robust_trim_frac=0.3,
                       robust_norm_clip=1.5, robust_noise_stddev=0.1)
    assert R.DefensePipeline.from_fed(fed) == R.DefensePipeline(
        "multikrum", 1.5, 0.1, 2, 5, 0.3)
    with pytest.raises(ValueError, match="multikrum"):
        R.DefensePipeline(method="multikrum")
    R.DefensePipeline(method="multikrum", num_adversaries=1)
    R.DefensePipeline(method="multikrum", multikrum_m=3)
    with pytest.raises(ValueError, match="defense method"):
        R.DefensePipeline(method="bulyan")
    with pytest.raises(ValueError, match="noise draws"):
        R.DefensePipeline(noise_stddev=0.1).postprocess({}, None)
    for c in (1, 4, 10):
        for kw in (dict(method="krum"), dict(method="median"),
                   dict(method="multikrum", num_adversaries=2),
                   dict(method="multikrum", multikrum_m=3)):
            assert R.DefensePipeline(**kw).excluded_count(c) == \
                JR.DefensePipeline(**kw).excluded_count(c)
