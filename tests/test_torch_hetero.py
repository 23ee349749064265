"""Heterogeneous-model FedGDKD in the port against the JAX package: the
fork's client config, the buckets and the cohorts, ``sample_cohort`` bit
for bit, two ``HeteroFedGDKD`` rounds and the clients' evaluation.

The rounds run at 6 clients, 4 a round, in three buckets: ``cnn_custom``
(8, 16), ``lr`` (no convolution, statistics or dropout) and ``cnn``
(CNN_DropOut), 2 clients each, on fake_mnist (96 training samples, 32
test), batch 8. The JAX sim's batch orders, noise, fake labels,
distillation-set noise and the ``cnn`` bucket's dropout masks are
replayed through the port's hooks (``tests/test_torch_dropout_gan.py``
``MaskReplay``), the distillation's and the drift correction's under the
hetero sim's keys (``fold_in(fold_in(rkey, salt), client)``, salts 0xAD
and 0xD1F7; the only dropout bucket is ``cnn``). Weights cross with ``fedml_tpu_torch/convert.py``. Float32
at the JAX package's own GAN band (rtol 1e-4, atol 1e-5), live members
only: the JAX package's padded lanes are not computed by the port."""

import json

import jax
import numpy as np
import pytest
import torch

import fedml_tpu.config as jc
import fedml_tpu_torch.config as tc
from fedml_tpu.algorithms import hetero as JH
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.models import gan as jgan
from fedml_tpu_torch.algorithms import hetero as TH
from fedml_tpu_torch.convert import bucket_state_dicts, generator_state_dict
from fedml_tpu_torch.data.loaders import make_fake_image_dataset
from fedml_tpu_torch.models.gan import generator_from_config
from tests import test_torch_distill as DI
from tests.test_torch_dropout_gan import KD_SALTS, MaskReplay
from tests.test_torch_gan import close_vars, to_numpy
from tests.torch_threads import one_torch_thread  # noqa: F401

ROUND = dict(rtol=1e-4, atol=1e-5)
K, SHAPE = 10, (28, 28, 1)
CLIENTS = {"client_models": [
    {"model": "cnn_custom", "freq": 2, "layers": [8, 16]},
    {"model": "lr", "freq": 2},
    {"model": "cnn", "freq": 2}]}
ARCHS = ("CNNParameterised", "LogisticRegression", "CNNDropOut")


def hetero_cfg(m):
    return m.ExperimentConfig(
        data=m.DataConfig(dataset="fake_mnist", num_clients=6,
                          batch_size=8, seed=0),
        train=m.TrainConfig(lr=0.05, epochs=1),
        fed=m.FedConfig(num_rounds=2, clients_per_round=4),
        gan=m.GanConfig(nz=16, ngf=8, distillation_size=16, kd_epochs=1),
        seed=0)


def hetero_kd_key(jsim):
    """The hetero sim's distillation keys: the round key folded with the
    phase's salt, then the client id (the cohorts are not replayed:
    ``sample_cohort`` is the same in both packages)."""
    return lambda stream, r, c: DI.fold(jax.random.fold_in(
        jsim.root_key, r), KD_SALTS[stream], c)


@pytest.fixture(scope="module")
def world():
    """Two JAX rounds and two port rounds from the same variables, with
    each round's states on the host."""
    jcfg, tcfg = hetero_cfg(jc), hetero_cfg(tc)
    jdata, tdata = DI.datasets(jcfg, tcfg)
    jsim = JH.HeteroFedGDKD(
        jgan.generator_from_config(jcfg.gan, K, 28, 1),
        JH.parse_client_config(CLIENTS, K, SHAPE), jdata, jcfg)
    cnn = jax_create_model(jc.ModelConfig(name="cnn", num_classes=K,
                                          input_shape=SHAPE))
    capture = DI.mask_capture(cnn.module)
    replay = MaskReplay(jsim, 4, lambda stream, tag: capture,
                        hetero_kd_key(jsim))
    tsim = TH.HeteroFedGDKD(
        generator_from_config(tcfg.gan, K, 28, 1, device="cpu"),
        TH.parse_client_config(CLIENTS, K, SHAPE), tdata, tcfg, "cpu",
        batch_orders=replay.batch_orders, draws=replay.draws)
    start = to_numpy((jsim.gen_vars, [b.stack for b in jsim.buckets]))
    tsim.gen_vars = generator_state_dict(start[0])
    for bucket, stack in zip(tsim.buckets, bucket_state_dicts(start[1],
                                                              ARCHS)):
        bucket.stack = stack
    rounds = []
    for _ in range(2):
        jinfo, tinfo = jsim.run_round(), tsim.run_round()
        rounds.append((jinfo, tinfo, to_numpy(
            (jsim.gen_vars, [b.stack for b in jsim.buckets])),
            (tsim.gen_vars, [dict(b.stack) for b in tsim.buckets]),
            list(tsim.last_drift)))
    return jsim, tsim, rounds


def test_client_config_and_buckets_match_jax(world, tmp_path):
    """The config from a dict and from a file, the buckets' ids, rows and
    architectures, their merging of equal model configs, and the cohort
    split equal the JAX package's."""
    jsim, tsim, _ = world
    path = tmp_path / "clients.json"
    path.write_text(json.dumps(CLIENTS))
    for config in (CLIENTS, str(path)):
        jspecs = JH.parse_client_config(config, K, SHAPE)
        tspecs = TH.parse_client_config(config, K, SHAPE)
        assert [(s.model.name, s.model.extra, s.model.input_shape, s.freq)
                for s in tspecs] == [
            (s.model.name, s.model.extra, s.model.input_shape, s.freq)
            for s in jspecs]
    assert tspecs[0].model.extra_dict()["convs"] == (8, 16)
    assert hash(tspecs[0].model) == hash(tc.ModelConfig(
        name="cnn_custom", num_classes=K, input_shape=SHAPE,
        extra=(("convs", (8, 16)),)))
    for t, j, arch in zip(tsim.buckets, jsim.buckets, ARCHS):
        np.testing.assert_array_equal(t.client_ids, j.client_ids)
        assert t.pos == j.pos
        assert type(t.model.module).__name__ == arch
        rows = len(t.client_ids)
        assert all(v.shape[0] == rows for v in t.stack.values())
    # equal model configs merge, in the order of their first entry
    lr = [{"model": "lr", "freq": 2}]
    other = tc.ModelConfig(name="lr", num_classes=K, input_shape=(7, 7, 1))
    tb = TH.build_buckets(
        [TH.ClientModelSpec(other, 1),
         *TH.parse_client_config({"client_models": lr * 2}, K, SHAPE),
         TH.ClientModelSpec(other, 2)], 0, 7, "cpu")
    jb = JH.build_buckets(
        [JH.ClientModelSpec(jc.ModelConfig(name="lr", num_classes=K,
                                           input_shape=(7, 7, 1)), 1),
         *JH.parse_client_config({"client_models": lr * 2}, K, SHAPE),
         JH.ClientModelSpec(jc.ModelConfig(name="lr", num_classes=K,
                                           input_shape=(7, 7, 1)), 2)],
        jax.random.key(0), 7)
    assert len(tb) == len(jb) == 2
    for t, j in zip(tb, jb):
        np.testing.assert_array_equal(t.client_ids, j.client_ids)
        assert t.pos == j.pos
    np.testing.assert_array_equal(tb[0].client_ids, [0, 5, 6])
    with pytest.raises(AssertionError, match="sum to num_clients"):
        TH.build_buckets([TH.ClientModelSpec(other, 1)], 0, 2, "cpu")
    for cohort, pad in (np.array([0, 2, 4, 6]), 4), (np.array([3]), 2):
        for (tm, tv), (jm, jv) in zip(TH.bucket_cohorts(tb, cohort, pad),
                                      JH.bucket_cohorts(jb, cohort, pad)):
            np.testing.assert_array_equal(tm, jm)
            np.testing.assert_array_equal(tv, jv)
            assert tm.dtype == jm.dtype and tv.dtype == jv.dtype


def test_bucket_streams_keep_their_own_rates():
    """Two buckets whose dropout sites share a name at different rates:
    each bucket's streams draw at its own keep probabilities, never the
    other's."""
    from fedml_tpu_torch.core import random as R

    specs = [TH.ClientModelSpec(tc.ModelConfig(
        name="cnn_custom", num_classes=K, input_shape=SHAPE,
        extra=(("convs", (4,)), ("dropout", rate))), 1)
        for rate in (0.25, 0.5)]
    cfg = tc.ExperimentConfig(data=tc.DataConfig(
        dataset="fake_mnist", num_clients=2, batch_size=8),
        gan=hetero_cfg(tc).gan)
    data = make_fake_image_dataset("mnist", cfg.data, n_train=32, n_test=16)
    sim = TH.HeteroFedGDKD(generator_from_config(cfg.gan, K, 28, 1,
                                                 device="cpu"),
                           specs, data, cfg, "cpu")
    assert [set(b.model.mask_sites) for b in sim.buckets] == [{"d0"}] * 2
    for b, keep in enumerate((0.75, 0.5)):
        for stream in ("dropout", "dropout_kd", "dropout_drift"):
            assert sim.draws.p[R.scoped(stream, b)] == {"d0": keep}
        masks = sim._kd_masks(R.scoped("dropout_kd", b), 0, [0, 1])["d0"]
        assert masks.shape == (2, 1, 2, 8, 128)
        assert abs(masks.float().mean().item() - keep) < 0.05, (b, keep)


@pytest.mark.parametrize("n,k", [(100, 10), (6, 4), (6, 6)])
def test_sample_cohort_is_bitwise(n, k):
    for r in range(10):
        got, want = TH.sample_cohort(r, n, k), JH.sample_cohort(r, n, k)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


@pytest.mark.parametrize("r", [0, 1])
def test_round_matches_jax(world, r):
    """Round ``r`` from the same variables, draws and masks: the generator
    and every classifier (the unsampled ones bit for bit as they were)
    within the band. Round 1 drift-corrects the cohort's new joiners, one
    of them in the dropout bucket."""
    jsim, tsim, rounds = world
    jinfo, tinfo, (jgen, jstacks), (tgen, tstacks), drift = rounds[r]
    assert tinfo["cohort"] == jinfo["cohort"] and tinfo["num_buckets"] == 3
    close_vars(tgen, generator_state_dict(jgen), ROUND,
               f"round {r} generator")
    for b, (t, j) in enumerate(zip(tstacks, bucket_state_dicts(jstacks,
                                                               ARCHS))):
        close_vars(t, j, ROUND, f"round {r} bucket {b}")
    for name in ("g_loss", "d_loss", "kd_loss"):
        assert torch.isfinite(tinfo[name]), name
    cohort = set(jinfo["cohort"])
    if r == 0:
        assert drift == [0, 0, 0]
        return
    prev = set(rounds[0][0]["cohort"])
    want = [sum(1 for c in b.client_ids if c in cohort and c not in prev)
            for b in tsim.buckets]
    assert drift == want and want[2] >= 1, (drift, want)
    assert tsim.counters["fedgdkd.drift_corrected"] == sum(want)
    for b, bucket in enumerate(tsim.buckets):
        idle = [i for i, c in enumerate(bucket.client_ids)
                if c not in cohort]
        for k, leaf in tstacks[b].items():
            assert torch.equal(leaf[idle], rounds[0][3][1][b][k][idle]), k


def test_evaluate_clients_matches_jax(world):
    jsim, tsim, _ = world
    jev, tev = jsim.evaluate_clients(), tsim.evaluate_clients()
    assert len(tev["per_client_acc"]) == 6
    np.testing.assert_allclose(tev["per_client_acc"], jev["per_client_acc"],
                               atol=1e-6)
    np.testing.assert_allclose(tev["test_acc"], jev["test_acc"], atol=1e-6)
