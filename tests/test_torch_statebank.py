"""The port's client-state bank (fedml_tpu_torch/core/statebank.py) and
the bulk engine's wire codec forms (``compress.roundtrip_rows``,
``compress.pad_stacked_payload``) against the JAX package's, on the same
numpy inputs.

Bands: every bank operation bit for bit (the sentinel id's clamped
gather and dropped scatter, the ``keep`` mask, rows that follow their
client across rounds); the payloads and residual rows bit for bit, the
quantizer's draws replayed from JAX's keys by client id."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core import compress as JC
from fedml_tpu.core import statebank as JSB
from fedml_tpu_torch.core import compress as C
from fedml_tpu_torch.core import statebank as SB

SHAPES = {"a": (3, 4), "b": (5,)}  # sorted: both packages' leaf order
N = 7  # clients: the sentinel id is 7


def _rows(seed, lead):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((lead,) + s).astype(np.float32)
            for k, s in SHAPES.items()}


def _banks(seed=0):
    rows = _rows(seed, N)
    return (SB.ClientStateBank("ef", {k: torch.from_numpy(v.copy())
                                      for k, v in rows.items()}),
            JSB.ClientStateBank("ef", {k: jnp.asarray(v)
                                       for k, v in rows.items()}))


def _eq(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_bank_geometry_and_constructors_match_jax():
    template = {k: torch.zeros(s) for k, s in SHAPES.items()}
    jtemplate = {k: jnp.zeros(s) for k, s in SHAPES.items()}
    for ctor in ("zeros", "broadcast"):
        t = getattr(SB.ClientStateBank, ctor)("ef", {
            k: v + 1.5 for k, v in template.items()}, N)
        j = getattr(JSB.ClientStateBank, ctor)("ef", {
            k: v + 1.5 for k, v in jtemplate.items()}, N)
        _eq(t.rows, j.rows)
        assert (t.num_rows, t.sentinel, t.row_bytes(), t.resident_bytes()
                ) == (j.num_rows, j.sentinel, j.row_bytes(),
                      j.resident_bytes())
    counters = {}
    SB.note_bank(t, counters)
    assert counters == {"bank.rows": 7.0, "bank.row_bytes": 68.0,
                        "bank.resident_mb": 476 / 1e6}


def test_gather_clamps_the_sentinel_like_jax():
    bank, jbank = _banks()
    ids = [4, 0, N, 2]  # the sentinel reads the last row
    _eq(bank.gather(ids), jbank.gather(jnp.asarray(ids)))
    _eq(bank.gather(np.asarray([N, N])), jbank.gather(jnp.asarray([N, N])))


@pytest.mark.parametrize("use_keep", [False, True])
def test_put_drops_the_sentinel_and_keeps_masked_rows_like_jax(use_keep):
    bank, jbank = _banks()
    ids = [5, N, 1, 3]
    new = _rows(9, 4)
    keep = np.array([True, True, False, True])
    gathered = bank.gather(ids)
    kw = dict(keep=torch.from_numpy(keep), gathered=gathered) \
        if use_keep else {}
    jkw = dict(keep=jnp.asarray(keep)) if use_keep else {}
    got = bank.put(ids, {k: torch.from_numpy(v) for k, v in new.items()},
                   **kw)
    want = jbank.put(jnp.asarray(ids), {k: jnp.asarray(v)
                                        for k, v in new.items()}, **jkw)
    assert got is bank  # written in place
    _eq(got.rows, want.rows)


def test_rows_follow_their_client_across_rounds():
    """Three rounds of gather, update, put with the cohort in a new order
    each round, a sentinel pad and a screened slot: every row, sampled or
    not, bit for bit as the JAX bank's."""
    bank, jbank = _banks(1)
    rng = np.random.default_rng(3)
    for r in range(3):
        ids = np.concatenate([rng.permutation(N)[:4], [N]])
        keep = rng.random(5) > 0.2
        old, jold = bank.gather(ids), jbank.gather(jnp.asarray(ids))
        _eq(old, jold)
        upd = {k: torch.from_numpy(np.float32(0.5 * r + 1) * v.numpy())
               for k, v in old.items()}
        bank.put(ids, upd, keep=torch.from_numpy(keep), gathered=old)
        jbank = jbank.put(jnp.asarray(ids), {k: jnp.asarray(v.numpy())
                                             for k, v in upd.items()},
                          keep=jnp.asarray(keep), gathered=jold)
        _eq(bank.rows, jbank.rows)


def test_pad_ids_and_savable_round_trip():
    np.testing.assert_array_equal(
        SB.pad_ids([3, 1], 5, N),
        np.asarray(JSB.pad_ids(jnp.asarray([3, 1]), 5, N)))
    np.testing.assert_array_equal(SB.pad_ids([3, 1], 2, N), [3, 1])
    bank, _ = _banks(2)
    back = SB.ClientStateBank.from_savable(
        "ef", {k: torch.zeros_like(v) for k, v in bank.rows.items()},
        {k: v.numpy() for k, v in bank.savable().items()})
    _eq(back.rows, bank.rows)
    with pytest.raises(ValueError, match="shape"):
        SB.ClientStateBank.from_savable("ef", bank.rows, {
            "a": np.zeros((2, 3, 4), np.float32), "b": np.zeros((N, 5))})
    with pytest.raises(ValueError, match="host"):
        bank.gather(torch.tensor([1]).to("meta"))
    counters = {}
    SB.note_round_io(counters, 2, 1)
    SB.note_round_io(counters, 2, 0)
    assert counters == {"bank.gathers": 4, "bank.scatters": 1}


def _uniforms(spec, jspec, rkey, ids):
    """JAX's stochastic-rounding draws of ``roundtrip_rows``, keyed by
    client id (one key per leaf), as the port's draws hook gives them."""
    shapes = spec.draw_shapes({k: torch.zeros(s) for k, s in SHAPES.items()})
    out = {k: [] for k in shapes}
    for c in ids:
        keys = jax.random.split(JC.slot_key(jspec, rkey, c), len(SHAPES))
        for k, kk in zip(sorted(SHAPES), keys):
            if k in shapes:
                out[k].append(np.asarray(jax.random.uniform(
                    kk, shapes[k], jnp.float32)))
    return {k: torch.from_numpy(np.stack(v)) for k, v in out.items()}


@pytest.mark.parametrize("method", ["int8", "topk", "topk_int8"])
def test_roundtrip_rows_matches_jax_by_client_id(method):
    """Two rounds of a block of 4 slots (a sentinel among them) against
    the bank's rows: the decompressed deltas and the new residual rows bit
    for bit, the quantizer keyed by client id."""
    spec = C.CompressionSpec(method=method, topk_frac=0.2)
    jspec = JC.CompressionSpec(method=method, topk_frac=0.2)
    bank, jbank = _banks(4)
    for r, ids in enumerate(([6, 2, 0, N], [2, 5, 6, 3])):
        rkey = jax.random.key(20 + r)
        delta = _rows(10 + r, 4)
        rows, jrows = bank.gather(ids), jbank.gather(jnp.asarray(ids))
        deq, new = C.roundtrip_rows(
            spec, {k: torch.from_numpy(v) for k, v in delta.items()}, rows,
            _uniforms(spec, jspec, rkey, ids))
        # op by op: under jit XLA contracts g + q * scale (an ulp)
        jdeq, jnew = JC.roundtrip_rows(
            jspec, {k: jnp.asarray(v) for k, v in delta.items()}, jrows,
            rkey, jnp.asarray(ids))
        _eq(deq, jdeq)
        _eq(new, jnew)
        bank.put(ids, new)
        jbank = jbank.put(jnp.asarray(ids), jnew)
        _eq(bank.rows, jbank.rows)


def test_pad_stacked_payload_matches_jax_and_decodes_to_zero():
    method = "topk_int8"  # every part: indices, codes, scales
    spec = C.CompressionSpec(method=method, topk_frac=0.2, stochastic=False)
    jspec = JC.CompressionSpec(method=method, topk_frac=0.2,
                               stochastic=False)
    rows = _rows(6, 3)
    payloads = [C.compress_tree(spec, {k: torch.from_numpy(v[i])
                                       for k, v in rows.items()})
                for i in range(3)]
    stacked = {k: {p: torch.stack([pl[k][p] for pl in payloads])
                   for p in payloads[0][k]} for k in SHAPES}
    jstacked = jax.tree.map(lambda *x: jnp.stack(x), *[
        JC.compress_tree(jspec, {k: jnp.asarray(v[i])
                                 for k, v in rows.items()}, None)
        for i in range(3)])
    padded = C.pad_stacked_payload(stacked, 8)
    jpadded = JC.pad_stacked_payload(jstacked, 8)
    for k in SHAPES:
        _eq(padded[k], jpadded[k])
    template = {k: torch.zeros(s) for k, s in SHAPES.items()}
    dense = C.decompress_stacked(spec, padded, template)
    for k in SHAPES:
        assert dense[k].shape[0] == 8
        assert torch.equal(dense[k][3:], torch.zeros_like(dense[k][3:]))
    with pytest.raises(ValueError, match="does not fit"):
        C.pad_stacked_payload(stacked, 2)
