"""The batched cohort: the port's size-sorted groups against the JAX
package's, the vmapped local update against the per-client one on
ResNet-8 with clients of different sizes, and the gate that makes a step
on padding a no-op. On a CUDA card, the CUDA-graph path against the CPU.

The JAX package is imported inside the tests that compare with it, so
that the card's test also runs where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_cohort.py``
"""

import numpy as np
import pytest
import torch

import fedml_tpu_torch.config as tc
from fedml_tpu_torch.algorithms import fedavg as tfed
from fedml_tpu_torch.algorithms.base import build_local_step, make_task
from fedml_tpu_torch.algorithms.stack_utils import (
    resolve_cohort_groups,
    size_grouped_lanes,
)
from fedml_tpu_torch.data.federated import FederatedData
from fedml_tpu_torch.models import create_model


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """``tests/torch_threads.py``'s fixture, written out because this file
    also runs on the card's machine (``--noconftest``), where another
    installed package named ``tests`` hides this repo's."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RES_SHAPE = (16, 16, 3)
B = 4
COUNTS = (10, 3, 7, 5)  # 3, 1, 2 and 2 real batches of 4
# the reference's band for a grouped cohort against one group
# (tests/test_fedavg.py): vmapped and per-client sums differ in order
GROUP_TOL = dict(rtol=2e-5, atol=2e-6)
SGD = dict(optimizer="sgd", lr=0.1, momentum=0.5, weight_decay=1e-3)
# adam divides by sqrt(nu) + eps, so a weight whose gradient is near 0
# moves by up to lr whatever the gradient's size: the grouped and the
# per-client convolutions' rounding (about 1e-8 in the gradient) moves
# such a weight by up to lr / 20 a step. At lr 3e-5 the 6 steps stay at
# half the band (at 1e-4 they reach 1.6 times it), while every weight
# still moves by about 30 times the band.
ADAM = dict(optimizer="adam", lr=3e-5, weight_decay=1e-2, clip_norm=0.5)


@pytest.mark.parametrize("requested", range(13))
def test_resolve_cohort_groups_matches_jax(requested):
    from fedml_tpu.algorithms.fedavg import _resolve_cohort_groups

    for cohort in range(1, 21):
        for auto in (5, 2):
            assert resolve_cohort_groups(requested, cohort, auto) == \
                _resolve_cohort_groups(requested, cohort, auto), (cohort,
                                                                  auto)


@pytest.mark.parametrize("requested", [0, 1, 2, 3])
def test_size_grouped_lanes_matches_jax(requested):
    """A lane function whose output depends on its group (each lane gets
    its group's sum added): the same sort, groups and unsort as the JAX
    helper, which sorts by the mask rows' sums; the port's helper hands
    each group its host counts, largest first."""
    import jax.numpy as jnp

    from fedml_tpu.algorithms.stack_utils import size_grouped_lanes as jax_sgl

    counts = np.array([3, 9, 5, 9, 1, 7])  # a tie keeps cohort order
    rng = np.random.default_rng(0)
    a = rng.standard_normal((6, 3)).astype(np.float32)
    b = np.arange(6, dtype=np.int32)
    mask_rows = (np.arange(10)[None] < counts[:, None]).astype(np.float32)

    def lane_fn(a, b):
        return {"a": a + a.sum(0), "b": b * 10 + b.shape[0]}

    want = jax_sgl(lambda a, b: lane_fn(a, b),
                   (jnp.asarray(a), jnp.asarray(b)), jnp.asarray(mask_rows),
                   requested)
    seen = []

    def port_fn(a, b, group_counts):
        seen.append(list(group_counts))
        return lane_fn(a, b)

    got = size_grouped_lanes(port_fn, (torch.from_numpy(a),
                                       torch.from_numpy(b)), counts,
                             requested)
    np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]),
                               rtol=1e-6)
    np.testing.assert_array_equal(got["b"].numpy(), np.asarray(want["b"]))
    groups = resolve_cohort_groups(requested, 6, 2)
    assert len(seen) == groups
    flat = [n for g in seen for n in g]
    if groups > 1:
        assert flat == sorted(counts, reverse=True)


def _data():
    rng = np.random.default_rng(0)
    n = sum(COUNTS)
    x = rng.standard_normal((n + 8,) + RES_SHAPE).astype(np.float32)
    y = rng.integers(0, 10, n + 8).astype(np.int32)
    starts = np.cumsum((0,) + COUNTS)
    train = {i: np.arange(starts[i], starts[i + 1])
             for i in range(len(COUNTS))}
    test = {i: np.arange(2 * i, 2 * i + 2) for i in range(len(COUNTS))}
    return FederatedData(x[:n], y[:n], x[n:], y[n:], train, test, 10)


def _sim(train, groups, device="cpu", epochs=2):
    cfg = tc.ExperimentConfig(
        data=tc.DataConfig(num_clients=len(COUNTS), batch_size=B),
        model=tc.ModelConfig(name="resnet8", input_shape=RES_SHAPE),
        train=tc.TrainConfig(epochs=epochs, cohort_groups=groups, **train),
        fed=tc.FedConfig(clients_per_round=len(COUNTS)), seed=1)
    model = create_model(cfg.model, device)
    return tfed.FedAvgSim(model, _data(), cfg, device=device)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("train", [SGD, ADAM], ids=["sgd_momentum",
                                                     "adam_clip"])
def test_cohort_matches_per_client_loop(train, groups):
    """Two epochs of ResNet-8 on clients of 10, 3, 7 and 5 samples: the
    batched cohort (vmapped, in size-sorted groups, each group stepping
    as often as its largest client) gives each client the parameters,
    statistics, n_k and metric sums of its own per-client update."""
    sim = _sim(train, groups)
    state = sim.init()
    stacked, n_k, sums = sim._locals(state)
    assert [s for _, s in sim.last_groups] == (
        [3] if groups == 1 else [3, 2])
    a = sim.arrays
    cohort = sim.sampler(0, a.num_clients, len(COUNTS)).tolist()
    for i, c in enumerate(cohort):
        want, want_n, want_sums = sim.local_update(
            state.variables, a.idx[c], a.mask[c], a.x, a.y,
            sim.batch_orders(0, c))
        assert float(n_k[i]) == float(want_n) == COUNTS[c]
        for k in want:
            torch.testing.assert_close(stacked[k][i], want[k], **GROUP_TOL,
                                       msg=f"client {c} {k}")
        for k in want_sums:
            torch.testing.assert_close(sums[k][i], want_sums[k],
                                       **GROUP_TOL)


@pytest.mark.parametrize("train", [SGD, ADAM], ids=["sgd_momentum",
                                                     "adam_clip"])
def test_padded_step_is_a_bitwise_noop(train):
    """After one real step on two lanes (so momentum, adam's moments and
    its count are not zero), a step whose batch is all padding on lane 1
    leaves lane 1's parameters, statistics and optimizer state bitwise as
    they were, adam's count included, while lane 0 moves on."""
    sim = _sim(train, 1)
    init_carry, step = build_local_step(sim.model, make_task(
        "classification"), sim.cfg.train)
    vstep = torch.func.vmap(step, in_dims=(0, 0, 0, 0, None))
    a = sim.arrays
    variables = sim.init().variables
    gp = {k: v for k, v in variables.items()
          if k not in sim.model.stat_names}
    b_idx = a.idx[:2, :B].long()
    x_b, y_b = a.x[b_idx], a.y[b_idx]
    carry = vstep(init_carry(variables, 2), x_b, y_b, a.mask[:2, :B], gp)
    w = a.mask[:2, :B].clone()
    w[1] = 0.0
    out = vstep(carry, x_b, y_b, w, gp)
    for part in ("params", "stats", "opt"):
        before = {k: v[1] for k, v in _flat(carry[part]).items()}
        after = {k: v[1] for k, v in _flat(out[part]).items()}
        for k in before:
            assert torch.equal(after[k], before[k]), (part, k)
        assert any(not torch.equal(v[0], _flat(carry[part])[k][0])
                   for k, v in _flat(out[part]).items()), part
    if train["optimizer"] == "adam":
        assert out["opt"]["count"].tolist() == [2.0, 1.0]
    for k, v in out["sums"].items():
        assert torch.equal(v[1], carry["sums"][k][1]), k


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("train", [SGD, ADAM], ids=["sgd_momentum",
                                                     "adam_clip"])
def test_graphed_cohort_matches_cpu(cuda_device, train):
    """On the card each local step is one CUDA graph replay; two rounds
    of ResNet-8 in 2 groups there agree with the eager CPU rounds (float32,
    TF32 off), and the replays count the groups' steps."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sims = {d: _sim(train, 2, d) for d in ("cpu", cuda_device)}
    states = {d: s.init() for d, s in sims.items()}
    for _ in range(2):
        for d, s in sims.items():
            states[d], _ = s.run_round(states[d])
    graph = sims[cuda_device].cohort_update.graph
    assert sims["cpu"].cohort_update.graph is None
    assert graph.replays == 2 * 2 * sum(
        s for _, s in sims[cuda_device].last_groups)
    for k, v in states["cpu"].variables.items():
        torch.testing.assert_close(states[cuda_device].variables[k].cpu(),
                                   v, atol=1e-4, rtol=1e-4, msg=k)
