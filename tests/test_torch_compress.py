"""The port's wire codec (fedml_tpu_torch/core/compress.py) against the
JAX package's, the quantizer's uniform draws replayed from JAX's keys.

Bands: payloads (int8 codes, scales, top-k indices and values) and the
decompressed deltas bit for bit, deterministic and with replayed draws;
the error-feedback identity within rtol = atol = 1e-4 after 12 rounds
(float32 sums of 12 terms), as the JAX suite states it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core import compress as JC
from fedml_tpu_torch.core import compress as C

SHAPES = {"a": (6, 5), "b": (7,), "e": (0,)}  # sorted: both packages' order
EXACT = dict(rtol=0, atol=0)


def _tree(seed, c=None):
    rng = np.random.default_rng(seed)
    lead = () if c is None else (c,)
    return {k: rng.standard_normal(lead + s).astype(np.float32)
            for k, s in SHAPES.items()}


def _pair(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in tree.items()})


def _eq(got, want):
    if isinstance(got, dict):
        assert set(got) == set(want), (sorted(got), sorted(want))
        for k in want:
            _eq(got[k], want[k])
        return
    want = np.asarray(want)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


def _uniforms(spec, key, template):
    """The JAX package's stochastic-rounding draws for one client under
    ``key`` (one key per leaf, zero-size leaves included in the split),
    for the leaves the port draws for."""
    keys = jax.random.split(key, len(template))
    shapes = C.CompressionSpec(spec.method, spec.topk_frac).draw_shapes(
        {k: torch.zeros(v.shape) for k, v in template.items()})
    return {k: torch.from_numpy(np.array(jax.random.uniform(
        kk, shapes[k], jnp.float32)))
        for k, kk in zip(sorted(template), keys) if k in shapes}


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("method", ["int8", "topk", "topk_int8"])
def test_payloads_match_jax_bit_for_bit(method, stochastic):
    kw = dict(method=method, topk_frac=0.2, stochastic=stochastic)
    spec, jspec = C.CompressionSpec(**kw), JC.CompressionSpec(**kw)
    j, t = _pair(_tree(0))
    key = jax.random.key(4)
    draws = _uniforms(spec, key, j) if stochastic else None
    payload = C.compress_tree(spec, t, draws)
    # op by op: under jit XLA may divide by the broadcast scale as a
    # product with its reciprocal, an ulp off IEEE division
    jpayload = JC.compress_tree(jspec, j, key)
    _eq(payload, jpayload)
    _eq(C.decompress_tree(spec, payload, t),
        JC.decompress_tree(jspec, jpayload, j))
    assert C.validate_payload(C.payload_template(spec, t), payload) is None


def test_topk_ties_go_to_the_lower_index():
    """+a and -a tie at the k-th place: lax.top_k keeps the lower index,
    and so does the port (a stable descending sort; torch.topk promises
    no order among ties)."""
    spec = C.CompressionSpec(method="topk", topk_frac=0.5)
    x = np.array([0.9, 0.5, -0.5, 0.2], np.float32)
    got = C.compress_leaf(spec, torch.from_numpy(x), None)
    want = JC.compress_leaf(JC.CompressionSpec(method="topk", topk_frac=0.5),
                            jnp.asarray(x), None)
    _eq(got, want)
    assert got["idx"].tolist() == [0, 1]


@pytest.mark.parametrize("method", ["int8", "topk", "topk_int8"])
def test_roundtrip_stacked_matches_jax(method):
    """The simulation's wire model over 3 slots, twice, the residual
    carried: the decompressed deltas and the residual bit for bit, the
    slot keys' draws replayed."""
    spec = C.CompressionSpec(method=method, topk_frac=0.2)
    jspec = JC.CompressionSpec(method=method, topk_frac=0.2)
    residual, jresidual = None, None
    for r in range(2):
        j, t = _pair(_tree(r, c=3))
        rkey = jax.random.key(10 + r)
        one = {k: v[0] for k, v in j.items()}
        per_slot = [_uniforms(spec, JC.slot_key(jspec, rkey, s), one)
                    for s in range(3)]
        draws = {k: torch.stack([d[k] for d in per_slot])
                 for k in per_slot[0]}
        deq, residual = C.roundtrip_stacked(spec, t, residual, draws)
        jdeq, jresidual = JC.roundtrip_stacked(jspec, j, jresidual, rkey)
        _eq(deq, jdeq)
        _eq(residual, jresidual)


@pytest.mark.parametrize("method", ["int8", "topk_int8"])
def test_decompress_stacked_matches_jax(method):
    spec = C.CompressionSpec(method=method, topk_frac=0.2, stochastic=False)
    jspec = JC.CompressionSpec(method=method, topk_frac=0.2,
                               stochastic=False)
    rows = [_tree(s) for s in range(3)]
    payloads = [C.compress_tree(spec, _pair(r)[1]) for r in rows]
    stacked = {k: {p: torch.stack([pl[k][p] for pl in payloads])
                   for p in payloads[0][k]} for k in SHAPES}
    template = _pair(rows[0])
    jstacked = jax.tree.map(lambda *x: jnp.stack(x), *[
        JC.compress_tree(jspec, _pair(r)[0], None) for r in rows])
    _eq(C.decompress_stacked(spec, stacked, template[1]),
        JC.decompress_stacked(jspec, jstacked, template[0]))


@pytest.mark.parametrize("method", ["int8", "topk", "topk_int8"])
def test_error_feedback_telescopes_exactly(method):
    """sum_t sent_t + r_T == sum_t d_t: with error feedback the codec's
    error is carried, never accumulated as bias."""
    spec = C.CompressionSpec(method=method, topk_frac=0.05)
    gen = torch.Generator().manual_seed(0)
    residual = None
    sent = torch.zeros(30, 4)
    total = torch.zeros(30, 4)
    for _ in range(12):
        d = {"w": torch.randn(30, 4, generator=gen)}
        u = {k: torch.rand(s, generator=gen)
             for k, s in spec.draw_shapes(d).items()}
        _, deq, residual = C.apply_with_feedback(spec, d, residual, u)
        sent += deq["w"]
        total += d["w"]
    torch.testing.assert_close(sent + residual["w"], total, rtol=1e-4,
                               atol=1e-4)


def test_nonfinite_round_resets_the_carry():
    """One NaN delta costs one round: the carry resets to 0 instead of
    keeping the NaN, so the next round is clean again."""
    spec = C.CompressionSpec(method="topk_int8", topk_frac=0.2,
                             stochastic=False)
    good = {"w": torch.ones(10)}
    bad = {"w": torch.tensor([float("nan")] + [1.0] * 9)}
    _, _, res = C.apply_with_feedback(spec, good, None)
    _, deq_bad, res = C.apply_with_feedback(spec, bad, res)
    assert not torch.isfinite(deq_bad["w"]).all()
    assert torch.equal(res["w"], torch.zeros(10))
    _, deq_next, _ = C.apply_with_feedback(spec, good, res)
    assert torch.isfinite(deq_next["w"]).all()
    # the stacked form resets only the poisoned slot's carry
    stacked = {"w": torch.stack([good["w"], bad["w"]])}
    _, res = C.roundtrip_stacked(spec, stacked, None)
    assert torch.equal(res["w"][1], torch.zeros(10))
    assert torch.isfinite(res["w"][0]).all() and res["w"][0].abs().sum() > 0


def test_without_error_feedback_topk_biases():
    """Without the carry a persistently small coordinate is never sent;
    with it the carry grows until the coordinate wins a slot."""
    x = torch.zeros(40)
    x[0], x[7] = 1.0, 0.05
    sent = {}
    for feedback in (False, True):
        spec = C.CompressionSpec(method="topk", topk_frac=0.025,
                                 error_feedback=feedback)
        residual, tx = None, torch.zeros(40)
        for _ in range(30):
            _, deq, residual = C.apply_with_feedback(spec, {"w": x},
                                                     residual)
            tx += deq["w"]
        sent[feedback] = tx
    assert sent[False][7] == 0.0
    assert sent[True][7] > 0.5


def test_payload_validation_catches_malformed():
    spec = C.CompressionSpec(method="topk_int8", topk_frac=0.1,
                             stochastic=False)
    _, x = _pair(_tree(1))
    tmpl = C.payload_template(spec, x)
    good = C.compress_tree(spec, x)
    assert C.validate_payload(tmpl, good) is None
    for bad, reason in (
            ({**good, "b": {**good["b"],
                            "idx": torch.tensor([1000], dtype=torch.int32)}},
             "out of range"),
            ({**good, "b": {"vals": torch.zeros(1)}}, "keys"),
            ({**good, "b": {**good["b"], "scale": torch.tensor(
                float("nan"))}}, "non-finite"),
            ({**good, "b": {**good["b"], "scale": torch.tensor(3e38)}},
             "out of f32 range"),
            ({**good, "b": {**good["b"], "scale": torch.tensor(-1.0)}},
             "out of f32 range"),
            ({**good, "b": {**good["b"], "q": good["b"]["q"].int()}},
             "dtype"),
            ({k: v for k, v in good.items() if k != "a"}, "tree mismatch")):
        assert reason in C.validate_payload(tmpl, bad)


def test_wire_ratio_and_spec_match_jax():
    j, t = _pair(_tree(2))
    for method in ("none", "int8", "topk", "topk_int8"):
        for frac in (0.01, 0.3):
            assert C.wire_ratio(C.CompressionSpec(method, frac), t) == \
                JC.wire_ratio(JC.CompressionSpec(method, frac), j)
    for bad in (dict(method="fp8"), dict(topk_frac=0.0),
                dict(topk_frac=1.5)):
        with pytest.raises(ValueError, match="compress"):
            C.CompressionSpec(**bad)
