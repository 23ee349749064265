"""TurboAggregate in the port: the field layer bit for bit against
``fedml_tpu/algorithms/mpc.py`` on the same int64 inputs and numpy seeds,
one case for each of ``tests/test_mpc.py``'s (the modular inverse and
power, the overflow-safe product, the Lagrange coefficients, BGW encode
and decode from several survivor sets and its linearity, LCC and LCC at
given points, additive shares, quantize and dequantize, the aggregator
with and without dropped clients, and its refusals: too few survivors,
an update past the field's envelope); then the port's secure FedAvg
round against its own plain FedAvg round from the same state (atol
5e-4, the band of ``tests/test_mpc.py::test_secure_fedavg_matches_plain``),
under ``dropped`` (equal to the undropped round within 1e-6), and its
refusal of the settings the secure sum cannot carry."""

import dataclasses

import numpy as np
import pytest

import fedml_tpu_torch.config as tc
from fedml_tpu.algorithms import mpc as JM
from fedml_tpu_torch.algorithms import mpc as TM
from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
from fedml_tpu_torch.data import load_dataset
from fedml_tpu_torch.models import create_model
from tests.torch_threads import one_torch_thread  # noqa: F401

P = JM.P_DEFAULT


def _mod_inv(m):
    a = np.random.default_rng(0).integers(1, int(P), 32)
    return [m.mod_inv(a, P), m.mod_pow(a, 12345, P)]


def _mod_matmul(m):
    rng = np.random.default_rng(1)
    a = rng.integers(0, int(P), (4, 7)).astype(np.int64)
    b = rng.integers(0, int(P), (7, 5)).astype(np.int64)
    return [m.mod_matmul(a, b, P), m.mod_matmul(a, b[:, :, None], P)]


def _lagrange(m):
    beta = np.array([1, 2, 3, 4], np.int64)
    alpha = np.random.default_rng(2).integers(0, int(P), 6)
    return [m.gen_lagrange_coeffs(beta, beta, P),
            m.gen_lagrange_coeffs(alpha, beta, P)]


def _bgw(m):
    rng = np.random.default_rng(2)
    x = rng.integers(0, int(P), 11)
    shares = m.bgw_encode(x, 7, 2, P, rng)
    return [shares] + [m.bgw_decode(shares[s], np.asarray(s), P, t=2)
                       for s in ([0, 1, 2], [4, 5, 6], [0, 3, 6],
                                 [1, 2, 3, 4, 5])]


def _bgw_linearity(m):
    rng = np.random.default_rng(3)
    xs = rng.integers(0, 1000, (5, 8))
    all_shares = np.stack([m.bgw_encode(xs[i], 6, 2, P, rng)
                           for i in range(5)])
    summed = np.mod(all_shares.sum(axis=0), int(P))
    return [all_shares, m.bgw_decode(summed[[1, 3, 5]],
                                     np.asarray([1, 3, 5]), P)]


def _lcc(m):
    rng = np.random.default_rng(4)
    x = rng.integers(0, int(P), (8, 5))
    enc = m.lcc_encode(x, 9, 4, 1, P, rng)
    return [enc, m.lcc_decode(enc[:5], 9, 4, 1, list(range(5)), P),
            m.lcc_decode(enc[[0, 2, 4, 6, 8]], 9, 4, 1, [0, 2, 4, 6, 8], P)]


def _lcc_points(m):
    x = np.random.default_rng(5).integers(0, int(P), (3, 6))
    alpha = np.array([1, 2, 3], np.int64)
    beta = np.array([11, 12, 13, 14], np.int64)
    enc = m.lcc_encode_with_points(x, alpha, beta, P)
    return [enc, m.lcc_decode_with_points(enc, beta, alpha, P)]


def _additive(m):
    rng = np.random.default_rng(6)
    x = rng.integers(0, int(P), 13)
    return [m.additive_shares(x, 5, P, rng)]


def _quantize(m):
    v = np.concatenate([[0.5, -0.25, 1.5, -2.0, 0.0],
                        np.random.default_rng(7).normal(size=64)])
    q = m.quantize(v, 16)
    return [q, m.dequantize(q, 16), m.quantize(v, 20, P)]


def _aggregator(m):
    updates = np.random.default_rng(7).normal(size=(6, 20))
    agg = m.SecureAggregator(num_clients=6, threshold=2, scale_bits=16)
    return [agg.aggregate(updates), agg.aggregate(updates, dropped=[0, 5]),
            agg.aggregate_mean(updates, dropped=[2])]


def _too_few_survivors(m):
    agg = m.SecureAggregator(num_clients=6, threshold=2, scale_bits=16)
    with pytest.raises(ValueError, match="survivors"):
        agg.aggregate(np.zeros((6, 4)), dropped=[0, 1, 2, 3])
    with pytest.raises(ValueError, match="shares"):
        m.bgw_decode(np.zeros((2, 3), np.int64), np.asarray([0, 1]), P, t=2)
    return []


def _overflow(m):
    agg = m.SecureAggregator(num_clients=4, threshold=1, scale_bits=20)
    out = agg.aggregate(np.full((4, 8), 1.0))
    bound = int(P) / (2.0 * 4 * (1 << 20))
    with pytest.raises(ValueError, match="overflow"):
        agg.aggregate(np.full((4, 8), bound * 1.5))
    return [out]


FIELD_CASES = {f.__name__[1:]: f for f in (
    _mod_inv, _mod_matmul, _lagrange, _bgw, _bgw_linearity, _lcc,
    _lcc_points, _additive, _quantize, _aggregator, _too_few_survivors,
    _overflow)}


@pytest.mark.parametrize("case", sorted(FIELD_CASES))
def test_field_layer_matches_jax_bit_for_bit(case):
    want, got = FIELD_CASES[case](JM), FIELD_CASES[case](TM)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def secure_cfg(**fed):
    return tc.ExperimentConfig(
        data=tc.DataConfig(dataset="fake_mnist", num_clients=8,
                           batch_size=16, seed=0, dataset_r=0.2),
        model=tc.ModelConfig(name="lr", num_classes=10,
                             input_shape=(28, 28, 1)),
        train=tc.TrainConfig(lr=0.1, epochs=1),
        fed=tc.FedConfig(num_rounds=1, clients_per_round=4, eval_every=1,
                         **fed),
        seed=0)


@pytest.fixture(scope="module")
def secure_rounds():
    cfg = secure_cfg()
    data = load_dataset(cfg.data)
    model = create_model(cfg.model, "cpu")
    plain = FedAvgSim(model, data, cfg, "cpu")
    secure = TM.SecureFedAvgSim(model, data, cfg, "cpu")
    start = plain.init()
    return (plain.run_round(start), secure.run_round(start),
            secure.run_round(start, dropped=[1]), secure)


def test_secure_round_matches_plain(secure_rounds):
    (s1, m1), (s2, m2), _, secure = secure_rounds
    assert s2.round == 1
    for k, v in s1.variables.items():
        assert s2.variables[k].dtype == v.dtype
        np.testing.assert_allclose(s2.variables[k].numpy(), v.numpy(),
                                   atol=5e-4, err_msg=k)
    np.testing.assert_allclose(float(m2["train_loss"]),
                               float(m1["train_loss"]), rtol=1e-5)
    assert secure.last_field_s > 0


def test_secure_round_under_dropped(secure_rounds):
    _, (s2, _), (s3, _), _ = secure_rounds
    for k, v in s2.variables.items():
        np.testing.assert_allclose(s3.variables[k].numpy(), v.numpy(),
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("setting", [
    dict(server_optimizer="adam"), dict(server_lr=0.5),
    dict(server_momentum=0.9), dict(gmf=0.5),
    dict(robust_method="median"), dict(robust_norm_clip=1.0),
    dict(robust_noise_stddev=0.1), dict(algorithm="fednova")])
def test_secure_fedavg_refuses(setting):
    cfg = secure_cfg()
    cfg = dataclasses.replace(cfg, fed=dataclasses.replace(cfg.fed,
                                                           **setting))
    with pytest.raises(ValueError, match="unsupported settings"):
        TM.SecureFedAvgSim(create_model(cfg.model, "cpu"),
                           load_dataset(cfg.data), cfg, "cpu")
