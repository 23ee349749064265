"""The defended, attacked and compressed FedAvg round of the port alone,
stacked and streamed in blocks by the bulk engine: on the CPU, and on
the card, where a round must read nothing back from the device. No JAX
here, so the card's tests run where JAX is not installed:

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


# bulk rounds that must read nothing back, each with its own host-side
# plan: the int8 codec with the client-keyed residual bank, a streamed
# quantile rule, a streamed selection rule (fed settings)
BULK_SYNC_FREE = {
    "int8_bank": dict(compress="int8"),
    "streamed_median": dict(robust_method="median"),
    "streamed_multikrum": dict(robust_method="multikrum",
                               robust_num_adversaries=2),
}


def _bulk_rounds(device, **fed):
    """lr on fake_mnist, 6 of 8 clients in blocks of 4 (the last one
    partial), 2 sign-flipping adversaries: a warm-up round."""
    cfg = _cfg()
    cfg = tc.ExperimentConfig(
        data=cfg.data, model=cfg.model, train=cfg.train,
        fed=tc.FedConfig(num_rounds=2, clients_per_round=6,
                         client_block_size=4, **fed),
        adversary=cfg.adversary)
    sim = tfed.FedAvgSim(create_model(cfg.model, device),
                         load_dataset(cfg.data), cfg, device=device)
    state, first = sim.run_round(sim.init())
    return sim, state, first


def test_bulk_rounds_on_the_cpu():
    """Each plan's bulk round on the CPU: finite, the blocks counted."""
    for name, fed in BULK_SYNC_FREE.items():
        sim, state, m = _bulk_rounds("cpu", **fed)
        assert math.isfinite(float(m["train_loss"])), name
        assert sim.counters["bulk.rounds"] == 1.0
        assert sim.counters["bulk.blocks_per_round"] == 2.0
        # a streamed rule runs the blocks twice
        passes = 2 if "robust_method" in fed else 1
        assert [n for n, _ in sim.last_groups] == [4, 4] * passes
    assert sim.ef_bank is None
    assert sim.counters["defense.sketch_proj_dim"] == 256.0


@pytest.mark.cuda
@pytest.mark.parametrize("plan", sorted(BULK_SYNC_FREE))
def test_bulk_round_reads_nothing_back_on_the_card(plan):
    """A bulk round after a warm-up round (the capture), under
    torch.cuda.set_sync_debug_mode("error"): any host sync raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    sim, state, _ = _bulk_rounds("cuda", **BULK_SYNC_FREE[plan])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = sim.run_round(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert math.isfinite(float(m["train_loss"]))
    assert sim.cohort_update.programs.stats["misses"] == 1
