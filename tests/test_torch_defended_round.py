"""The defended, attacked and compressed FedAvg round of the port alone:
on the CPU, and on the card, where a round must read nothing back from
the device. No JAX here, so the card's test runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_defended_round.py
"""

import math

import pytest
import torch

import fedml_tpu_torch.config as tc
from fedml_tpu_torch.algorithms import fedavg as tfed
from fedml_tpu_torch.data import load_dataset
from fedml_tpu_torch.models import create_model


def _cfg():
    """lr on fake_mnist, 6 of 8 clients, 2 seeded sign-flipping
    adversaries, krum (f = 2) with clip and noise, topk_int8 with error
    feedback."""
    return tc.ExperimentConfig(
        data=tc.DataConfig(dataset="fake_mnist", num_clients=8,
                           batch_size=32),
        model=tc.ModelConfig(name="lr", num_classes=10,
                             input_shape=(28, 28, 1)),
        train=tc.TrainConfig(lr=0.1),
        fed=tc.FedConfig(num_rounds=2, clients_per_round=6,
                         robust_method="krum", robust_num_adversaries=2,
                         robust_norm_clip=2.0, robust_noise_stddev=1e-3,
                         compress="topk_int8"),
        adversary=tc.AdversaryPolicy(mode="sign_flip", num_adversaries=2,
                                     seed=3))


def _two_rounds(device):
    cfg = _cfg()
    sim = tfed.FedAvgSim(create_model(cfg.model, device),
                         load_dataset(cfg.data), cfg, device=device)
    state, first = sim.run_round(sim.init())
    return sim, state, first


def test_defended_compressed_round_on_the_cpu():
    """The round's metrics stay tensors until the loop reads them; the
    residual is carried by slot; the counters take the residual's norm
    and the wire ratio."""
    sim, state, m = _two_rounds("cpu")
    assert all(isinstance(v, torch.Tensor) for v in m.values())
    assert sim.ef_residual["linear.weight"].shape == (6, 10, 784)
    record = tfed.consume_round_counters(dict(m), sim.counters)
    assert "compress_residual_norm" not in record
    assert sim.counters["compress.residual_norm"] == float(
        m["compress_residual_norm"]) > 0
    assert sim.counters["compress.ratio"] > 10
    state, m = sim.run_round(state)
    assert math.isfinite(float(m["train_loss"])) and state.round == 2
    assert all(torch.isfinite(v).all() for v in state.variables.values())


@pytest.mark.cuda
def test_defended_compressed_round_reads_nothing_back_on_the_card():
    """The same round after a warm-up round, under
    torch.cuda.set_sync_debug_mode("error"): any host sync raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    sim, state, _ = _two_rounds("cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = sim.run_round(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert math.isfinite(float(m["train_loss"]))
    assert float(m["compress_residual_norm"]) > 0
