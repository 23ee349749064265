"""The port's synchronous deployment runtime against the JAX package's and
against its own simulator: loopback worlds of ``FedAvgServerActor`` and
``FedAvgClientActor`` held against the JAX actors (FedAvg, FedOpt adam,
one round of topk_int8 and of median) with JAX's batch orders and draws
replayed, and against ``FedAvgSim`` on the same orders; a BatchNorm
ResNet-8 world whose every client result is held against the JAX client
actor's update and FedAvgSim's one-lane update; the chaos matrix
over loopback and TCP; a crashed client's round closed at the deadline
over the survivors; the quorum-lost abort; dedup, the non-finite screen,
checkpoint and resume; the readiness barrier's ACK; the CLI's refusals;
and one world of three OS processes over TCP."""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu.config as jc
from fedml_tpu.algorithms import distributed_fedavg as jdf
from fedml_tpu.algorithms.base import _padded_perm
from fedml_tpu.core import compress as JC
from fedml_tpu.core import random as JR
from fedml_tpu.core.transport.loopback import LoopbackHub as JaxHub
from fedml_tpu.data.loaders import load_dataset as jax_load_dataset
from fedml_tpu.models import create_model as jax_create_model
import fedml_tpu_torch.config as tc
from fedml_tpu_torch.algorithms import distributed_fedavg as tdf
from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
from fedml_tpu_torch.convert import vision_state_dict
from fedml_tpu_torch.core import telemetry
from fedml_tpu_torch.core.manager import create_transport
from fedml_tpu_torch.core.message import (
    KEY_MODEL_PARAMS,
    KEY_NUM_SAMPLES,
    KEY_ROUND,
    MSG_TYPE_C2S_RESULT,
    Message,
)
from fedml_tpu_torch.core.transport.chaos import ChaosTransport, FaultPolicy
from fedml_tpu_torch.core.transport.loopback import LoopbackHub
from fedml_tpu_torch.data import load_dataset
from fedml_tpu_torch.experiments import deploy
from fedml_tpu_torch.experiments import run as cli
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.utils.checkpoint import RoundCheckpointer
from tests.test_torch_transport import free_ports
from tests.torch_threads import one_torch_thread  # noqa: F401

JAX_BAND = dict(atol=1e-5, rtol=1e-5)  # float32 training, both packages
# a BatchNorm ResNet's float32 step in both packages: the fast variance
# E[x^2] - E[x]^2 that both compute cancels, and its sums' rounding, in
# each package's order, moves a ResNet-8 gradient on a batch of 32 by up
# to 6e-4 of 0.13 (tests/test_torch_resnet_fedavg.py's TOL)
RESNET_BAND = dict(atol=1e-4, rtol=1e-4)
CLOSE = dict(atol=1e-7, rtol=1e-6)  # tests/test_torch_robust.py's
LR_LEAVES = (("bias", "linear.bias"), ("kernel", "linear.weight"))
JOIN_S = 30  # every join, wait and communicate


# model -> its dataset, image shape and the port's class name
MODELS = {"lr": ("fake_mnist", (28, 28, 1), "LogisticRegression"),
          "resnet8": ("fake_cifar10", (32, 32, 3), "ResNetCIFAR")}


def _cfg(m, rounds=2, clients=3, r=1.0, model="lr", **fed):
    """tests/test_runtime.py's actor world: fake_mnist, lr, 3 clients
    (or ``model`` on its dataset)."""
    dataset, shape, _ = MODELS[model]
    return m.ExperimentConfig(
        data=m.DataConfig(dataset=dataset, num_clients=clients,
                          batch_size=32, seed=0, dataset_r=r),
        model=m.ModelConfig(name=model, num_classes=10, input_shape=shape),
        train=m.TrainConfig(lr=0.1, epochs=1),
        fed=m.FedConfig(num_rounds=rounds, clients_per_round=clients,
                        eval_every=rounds, **fed),
        seed=0)


@functools.lru_cache(maxsize=None)
def _jax_data(clients=3, r=1.0, model="lr"):
    return jax_load_dataset(_cfg(jc, clients=clients, r=r, model=model).data)


@functools.lru_cache(maxsize=None)
def _data(clients=3, r=1.0, model="lr"):
    return load_dataset(_cfg(tc, clients=clients, r=r, model=model).data)


def _port(variables, model="lr") -> dict:
    return vision_state_dict(jax.device_get(variables), MODELS[model][2])


def _assert_close(got: dict, want: dict, band) -> None:
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **band,
                                   err_msg=k)


def _digest(variables) -> str:
    return deploy._params_digest(variables)


# -- the JAX package's world, and its draws for the port -------------------


def _jax_world(cfg, locals_=None):
    """A JAX loopback world of ``cfg``; ``locals_`` (client -> delta
    tree) fakes every local update as ``global + delta``. Returns the
    initial and final variables as port state dicts."""
    n = cfg.data.num_clients
    data = _jax_data(n, cfg.data.dataset_r, cfg.model.name)
    model = jax_create_model(cfg.model)
    hub = JaxHub()
    server = jdf.FedAvgServerActor(n + 1, hub.create(0), model, cfg,
                                   num_clients=n, data=data)
    init = _port(server.variables, cfg.model.name)
    clients = [jdf.FedAvgClientActor(r, n + 1, hub.create(r), model, data,
                                     cfg) for r in range(1, n + 1)]
    for c in clients[1:]:
        # each actor jits its own closure of the same update: compile once
        c._local_update = clients[0]._local_update
    if locals_ is not None:
        first = {int(clients[0].arrays.idx[c][0]): c for c in range(n)}

        def fake(variables, idx, mask, x, y, rng):
            delta = locals_[first[int(idx[0])]]
            new = jax.tree.map(lambda v, d: v + d, variables, delta)
            return new, jnp.sum(mask), {}

        for c in clients:
            c._local_update = fake
    _run(server, clients)
    return init, _port(server.variables, cfg.model.name)


def _run(server, clients, start=True):
    threads = [threading.Thread(target=c.run, daemon=True) for c in clients]
    for t in threads:
        t.start()
    server.transport.start()
    if start:
        server.start_round()
    server.run()
    for c in clients:
        c.transport.stop()
    for t in threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive()


def _jax_orders(cfg):
    """The JAX client's batch orders: ``fold_in(fold_in(root, round),
    client)``, then ``fold_in(rng, epoch)`` into ``_padded_perm``."""
    arrays = _jax_data(cfg.data.num_clients, cfg.data.dataset_r,
                       cfg.model.name).to_arrays(
        pad_multiple=cfg.data.batch_size)
    root, max_n = jax.random.key(cfg.seed), arrays.max_client_samples

    def orders(r, c):
        rng = jax.random.fold_in(jax.random.fold_in(root, r), c)
        return [torch.tensor(np.asarray(_padded_perm(
            jax.random.fold_in(rng, e), arrays.mask[c], max_n)))
            for e in range(cfg.train.epochs)]

    return orders


def _jax_quant_draws(jcfg):
    """The JAX client's quantizer draws, by slot ``rank - 1``."""
    jspec = JC.CompressionSpec.from_fed(jcfg.fed, seed=jcfg.seed)
    root = jax.random.key(jcfg.seed)

    def draws(stream, r, slots, shapes):
        assert stream == "quant"
        rkey = JR.round_key(root, jnp.asarray(r, jnp.int32))
        out = {name: [] for _, name in LR_LEAVES}
        for s in slots:
            for (_, name), k in zip(LR_LEAVES, jax.random.split(
                    JC.slot_key(jspec, rkey, s), 2)):
                shape = shapes[name]
                flip = len(shape) == 2
                x = np.asarray(jax.random.uniform(
                    k, shape[::-1] if flip else shape))
                out[name].append(x.T if flip else x)
        return {k: torch.from_numpy(np.stack(v)) for k, v in out.items()}

    return draws


# -- the port's world ------------------------------------------------------


def _world(cfg, init=None, transports=None, batch_orders=None, draws=None,
           locals_=None, client_cls=tdf.FedAvgClientActor, start=True,
           server_cls=tdf.FedAvgServerActor, **server_kw):
    """A port world of ``cfg`` in this process (loopback unless
    ``transports(rank)`` says otherwise), its clients sharing one
    trainer. Returns the server."""
    n = cfg.data.num_clients
    data = _data(n, cfg.data.dataset_r, cfg.model.name)
    model = create_model(cfg.model, "cpu")
    if transports is None:
        hub = LoopbackHub()
        transports = hub.create
    server = server_cls(n + 1, transports(0), model, cfg, num_clients=n,
                        data=data, initial_variables=init, **server_kw)
    trainer = tdf.LocalTrainer(model, data, cfg, batch_orders=batch_orders,
                               draws=draws)
    if locals_ is not None:
        trainer.update = lambda v, r, c: (
            {k: v[k] + locals_[c][k] for k in v},
            trainer.arrays.counts[c].float(), {})
    clients = [client_cls(r, n + 1, transports(r), model, None, cfg,
                          trainer=trainer) for r in range(1, n + 1)]
    _run(server, clients, start)
    return server


def _deltas(n, scale=0.01):
    """client -> the JAX tree of a fake local delta (and the port's)."""
    rng = np.random.default_rng(42)
    jdeltas = {c: {"params": {"Dense_0": {
        "kernel": (rng.standard_normal((784, 10)) * scale).astype(np.float32),
        "bias": (rng.standard_normal(10) * scale).astype(np.float32)}}}
        for c in range(n)}
    return jdeltas, {c: _port(d) for c, d in jdeltas.items()}


# -- parity ----------------------------------------------------------------


@pytest.mark.parametrize("fed", [{}, dict(server_optimizer="adam",
                                          server_lr=0.05)],
                         ids=["fedavg", "fedopt_adam"])
def test_loopback_world_matches_jax_and_the_sim(fed):
    jcfg, tcfg = _cfg(jc, **fed), _cfg(tc, **fed)
    init, want = _jax_world(jcfg)
    orders = _jax_orders(tcfg)
    server = _world(tcfg, init=init, batch_orders=orders)
    assert server.done.is_set() and server.round_idx == 2
    _assert_close(server.variables, want, JAX_BAND)
    # the port's own simulator on the same cohort and orders
    sim = FedAvgSim(create_model(tcfg.model, "cpu"), _data(), tcfg, "cpu",
                    sampler=lambda r, n, k: torch.arange(3),
                    batch_orders=orders)
    state = sim.init()
    state = state._replace(variables=init)
    for _ in range(2):
        state, _ = sim.run_round(state)
    _assert_close(server.variables, state.variables, JAX_BAND)


@pytest.mark.parametrize("fed", [dict(compress="topk_int8",
                                      compress_topk_frac=0.05),
                                 dict(robust_method="median")],
                         ids=["topk_int8", "median"])
def test_compressed_and_defended_rounds_match_jax(fed):
    """One round, the local updates faked alike in both packages, so the
    payloads, the receive-edge screen and the server rule are what is
    held."""
    jcfg, tcfg = _cfg(jc, rounds=1, **fed), _cfg(tc, rounds=1, **fed)
    jdeltas, tdeltas = _deltas(3)
    init, want = _jax_world(jcfg, locals_=jdeltas)
    server = _world(tcfg, init=init, locals_=tdeltas,
                    draws=_jax_quant_draws(jcfg))
    _assert_close(server.variables, want, CLOSE)


def test_loopback_world_matches_the_sim_at_its_own_orders():
    cfg = _cfg(tc, rounds=2, clients=4, r=0.3)
    server = _world(cfg)
    sim = FedAvgSim(create_model(cfg.model, "cpu"), _data(4, 0.3), cfg,
                    "cpu", sampler=lambda r, n, k: torch.arange(4))
    state = sim.init()
    for _ in range(2):
        state, _ = sim.run_round(state)
    for k, v in state.variables.items():
        assert torch.equal(server.variables[k], v), k


class _Recording(tdf.FedAvgServerActor):
    """Keeps each closed round's start and each rank's client and
    result (:attr:`closed`)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.closed = {}

    def _close_round(self, results, closed_idx, **kw):
        _, start, cohort, slots = self._round_sync
        self.closed[closed_idx] = (
            {k: torch.as_tensor(v) for k, v in start.items()},
            {r: (int(cohort[slots.get(r, r - 1) % len(cohort)]),
                 {k: torch.as_tensor(v) for k, v in row.items()}, n)
             for r, (row, n) in results.items()})
        super()._close_round(results, closed_idx, **kw)


R8_FRACTION = 0.01  # fake_cifar10's 6,000 images: 30 a client, 1 batch


def test_batchnorm_world_matches_jax_and_the_one_lane_sim():
    """ResNet-8 (BatchNorm) on fake_cifar10, 2 clients, 2 rounds, each
    client's one batch padded (the padded rows enter the statistics).
    Round 0's
    every result (parameters and running statistics) against the JAX
    client actor's update of that client from the same start with its
    own draws (the JAX server's eager aggregation of a ResNet compiles
    op by op on the CPU, beyond this file's time, so the port's server
    is held by the weighted mean below); in both rounds each result
    against FedAvgSim's update of that client alone from the round's
    start (a cohort of one runs one lane, as the actor does), and each
    round's global against the results' weighted mean."""
    jcfg = _cfg(jc, clients=2, model="resnet8", r=R8_FRACTION)
    tcfg = _cfg(tc, clients=2, model="resnet8", r=R8_FRACTION)
    jmodel = jax_create_model(jcfg.model)
    jstart = jax.jit(jmodel.init)(jax.random.key(jcfg.seed))
    orders = _jax_orders(tcfg)
    server = _world(tcfg, init=_port(jstart, "resnet8"), batch_orders=orders,
                    server_cls=_Recording)
    assert server.done.is_set() and server.round_idx == 2
    jclient = jdf.FedAvgClientActor(1, 2, JaxHub().create(1), jmodel,
                                    _jax_data(2, R8_FRACTION, "resnet8"),
                                    jcfg)
    a = jclient.arrays
    for client, got, n in server.closed[0][1].values():
        rng = jax.random.fold_in(jax.random.fold_in(jclient.root_key, 0),
                                 client)
        want, n_k, _ = jclient._local_update(jstart, a.idx[client],
                                             a.mask[client], a.x, a.y, rng)
        assert float(n_k) == n
        want = _port(want, "resnet8")
        assert any("running_var" in k for k in want)
        _assert_close(got, want, RESNET_BAND)
    pick = [0]
    sim = FedAvgSim(create_model(tcfg.model, "cpu"),
                    _data(2, R8_FRACTION, "resnet8"),
                    dataclasses.replace(tcfg, fed=dataclasses.replace(
                        tcfg.fed, clients_per_round=1)), "cpu",
                    sampler=lambda r, n, k: torch.tensor([pick[0]]),
                    batch_orders=orders)
    base = sim.init()
    ends = [server.closed[1][0], server.variables]
    for r, (start, results) in sorted(server.closed.items()):
        assert sorted(c for c, _, _ in results.values()) == [0, 1]
        for client, got, _ in results.values():
            pick[0] = client
            lane, _ = sim.run_round(base._replace(variables=dict(start),
                                                  round=r))
            _assert_close(got, lane.variables, JAX_BAND)
        w = torch.tensor([n for _, _, n in results.values()],
                         dtype=torch.float64)
        mean = {k: torch.tensordot(w / w.sum(), torch.stack(
            [row[k].double() for _, row, _ in results.values()]), 1)
            for k in start}
        _assert_close(ends[r], mean, CLOSE)


# -- faults ----------------------------------------------------------------


def _tcp_transports(n):
    ports = free_ports(n + 1)
    ip = {r: ("127.0.0.1", p) for r, p in enumerate(ports)}
    return lambda r: create_transport("tcp", r, ip_config=ip)


@pytest.mark.parametrize("backend", ["loopback", "tcp"])
def test_chaos_matrix_completes_with_the_clean_digest(backend):
    """Delayed, duplicated and reordered traffic on every client: the run
    completes, and keep-first dedup leaves the model bit for bit the
    fault-free one's; an all-zero policy changes nothing either."""
    cfg = _cfg(tc, rounds=2, r=0.3)
    clean = _digest(_world(cfg).variables)
    base = None if backend == "loopback" else _tcp_transports(3)
    hub = LoopbackHub()

    def chaotic(r):
        inner = hub.create(r) if base is None else base(r)
        if r == 0:
            return inner
        return ChaosTransport(inner, FaultPolicy(
            seed=r, delay_prob=0.3, delay_max_s=0.02, dup_prob=0.3,
            reorder_prob=0.2))

    server = _world(cfg, transports=chaotic)
    assert server.done.is_set() and server.failure is None
    assert _digest(server.variables) == clean
    hub = LoopbackHub()
    quiet = _world(cfg, transports=lambda r: ChaosTransport(
        hub.create(r), FaultPolicy(seed=9)))
    assert _digest(quiet.variables) == clean


def test_crashed_client_round_closes_at_deadline_renormalized():
    cfg = _cfg(tc, rounds=2, r=0.3)
    hub = LoopbackHub()
    closed = {}

    def transports(r):
        t = hub.create(r)
        return ChaosTransport(t, FaultPolicy(crash_at_round=1)) if r == 2 \
            else t

    class Recording(tdf.FedAvgServerActor):
        def _close_round(self, results, closed_idx, **kw):
            closed[closed_idx] = {r: (dict(v), n) for r, (v, n) in
                                  results.items()}
            super()._close_round(results, closed_idx, **kw)

    n = 3
    data = _data(n, 0.3)
    model = create_model(cfg.model, "cpu")
    server = Recording(n + 1, transports(0), model, cfg, num_clients=n,
                       data=data, round_policy=tdf.RoundPolicy(
                           quorum_fraction=0.5, round_deadline_s=1.0))
    trainer = tdf.LocalTrainer(model, data, cfg)
    clients = [tdf.FedAvgClientActor(r, n + 1, transports(r), model, None,
                                     cfg, trainer=trainer)
               for r in range(1, n + 1)]
    after0 = {}
    server.on_round_done = lambda r, info: after0.setdefault(
        r, {k: v.clone() for k, v in server.variables.items()})
    _run(server, clients)
    assert server.failure is None and server.done.is_set()
    assert sorted(closed[0]) == [1, 2, 3] and sorted(closed[1]) == [1, 3]
    # plain FedAvg (sgd, lr 1): round 1's model is the survivors' mean
    # weighted by their own sample counts
    ws = np.array([closed[1][r][1] for r in (1, 3)], np.float32)
    for k in server.variables:
        rows = np.stack([np.asarray(closed[1][r][0][k]) for r in (1, 3)])
        want = np.tensordot(ws / ws.sum(), rows, 1)
        np.testing.assert_allclose(server.variables[k].numpy(), want,
                                   rtol=1e-6, atol=1e-7)


def test_unreachable_quorum_raises_quorum_lost():
    """Every client crashes on round 1's sync: the deploy server rank's
    deadline fires under quorum and ``serve`` raises."""
    cfg = _cfg(tc, rounds=2, clients=2, r=0.3)
    hub = LoopbackHub()
    dep = deploy.DeployConfig(role="server", rank=0, world_size=3,
                              backend="loopback", heartbeats=False,
                              round_deadline_s=0.5)
    model = create_model(cfg.model, "cpu")
    server = tdf.FedAvgServerActor(
        3, hub.create(0), model, cfg, num_clients=2, data=_data(2, 0.3),
        round_policy=tdf.RoundPolicy(round_deadline_s=0.5))
    trainer = tdf.LocalTrainer(model, _data(2, 0.3), cfg)
    clients = [tdf.FedAvgClientActor(r, 3, ChaosTransport(
        hub.create(r), FaultPolicy(crash_at_round=1)), model, None, cfg,
        trainer=trainer) for r in (1, 2)]
    threads = [threading.Thread(target=c.run, daemon=True) for c in clients]
    for c, t in zip(clients, threads):
        c.transport.start()
        c.send_message(Message(8, c.rank, 0, {}))  # JOIN
        t.start()
    with pytest.raises(tdf.QuorumLostError, match="round 1 deadline"):
        deploy.serve(server, dep)
    for c in clients:
        c.transport.stop()
    for t in threads:
        t.join(timeout=JOIN_S)


class _PoisonClient(tdf.FedAvgClientActor):
    """Sends NaN parameters instead of its update."""

    def _handle_sync(self, msg):
        poisoned = {k: np.full_like(np.asarray(v), np.nan)
                    for k, v in msg.get(KEY_MODEL_PARAMS).items()}
        self.send_message(Message(MSG_TYPE_C2S_RESULT, self.rank, 0, {
            KEY_MODEL_PARAMS: poisoned, KEY_NUM_SAMPLES: 32.0,
            KEY_ROUND: int(msg.get(KEY_ROUND))}))


def test_dedup_and_nonfinite_screen():
    cfg = _cfg(tc, rounds=2, r=0.3)
    clean = _digest(_world(cfg).variables)
    telemetry.METRICS.enabled = True
    telemetry.METRICS.reset()
    try:
        hub = LoopbackHub()
        duped = _world(cfg, transports=lambda r: hub.create(r) if r == 0
                       else ChaosTransport(hub.create(r), FaultPolicy(
                           seed=5, dup_prob=1.0)))
        assert telemetry.METRICS.counter("round.duplicate_results") > 0
        assert _digest(duped.variables) == clean
        telemetry.METRICS.reset()
        clients = [tdf.FedAvgClientActor, _PoisonClient]

        class Mixed:
            def __new__(cls, rank, *a, **kw):
                return clients[rank == 2](rank, *a, **kw)

        screened = _world(cfg, client_cls=Mixed, round_policy=tdf.RoundPolicy(
            quorum_fraction=0.5, round_deadline_s=1.0))
        assert screened.failure is None and screened.done.is_set()
        assert telemetry.METRICS.counter("robust.nonfinite_rejected") >= 2
        assert all(bool(torch.isfinite(v).all())
                   for v in screened.variables.values())
    finally:
        telemetry.METRICS.enabled = False
        telemetry.METRICS.reset()


def test_checkpoint_resume_byte_identical(tmp_path):
    """A server restored from round 1's checkpoint (a killed server's
    successor) ends bit for bit as an uninterrupted run; one restored at
    the end finishes at once."""
    ckpt = str(tmp_path / "ckpt")
    ref = _world(_cfg(tc, rounds=3, r=0.3))
    first = _world(_cfg(tc, rounds=2, r=0.3),
                   checkpointer=RoundCheckpointer(ckpt))
    assert first.resumed_from == 0 and first.round_idx == 2
    second = _world(_cfg(tc, rounds=3, r=0.3),
                    checkpointer=RoundCheckpointer(ckpt))
    assert second.resumed_from == 2 and second.round_idx == 3
    assert _digest(second.variables) == _digest(ref.variables)
    at_end = _world(_cfg(tc, rounds=3, r=0.3),
                    checkpointer=RoundCheckpointer(ckpt))
    assert at_end.resumed_from == 3 and at_end.done.is_set()
    assert _digest(at_end.variables) == _digest(ref.variables)


# -- the deploy layer ------------------------------------------------------


def test_ready_is_acked_before_the_barrier_completes():
    """Client 1's announcement is ACKed while client 2 is still missing:
    its first inbound message is the ACK, not work."""
    cfg = _cfg(tc, rounds=1, clients=2, r=0.3)
    hub = LoopbackHub()
    dep = dict(world_size=3, backend="loopback", heartbeats=True,
               heartbeat_interval_s=0.2, heartbeat_timeout_s=10.0)
    model = create_model(cfg.model, "cpu")
    server = tdf.FedAvgServerActor(3, hub.create(0), model, cfg,
                                   num_clients=2, data=_data(2, 0.3))
    trainer = tdf.LocalTrainer(model, _data(2, 0.3), cfg)
    clients = [tdf.FedAvgClientActor(r, 3, hub.create(r), model, None, cfg,
                                     trainer=trainer) for r in (1, 2)]
    first = {}

    class FirstType:
        def __init__(self, rank):
            self.rank = rank

        def receive_message(self, t, m):
            first.setdefault(self.rank, t)

    errors = []

    def client(c):
        c.transport.add_observer(FirstType(c.rank))
        try:
            deploy._run_client(c, deploy.DeployConfig(
                role="client", rank=c.rank, **dep))
        except Exception as err:  # surfaced below
            errors.append(err)

    t1 = threading.Thread(target=client, args=(clients[0],), daemon=True)
    t1.start()
    ts = threading.Thread(target=deploy.serve, args=(
        server, deploy.DeployConfig(role="server", rank=0, **dep)),
        daemon=True)
    ts.start()
    deadline = time.monotonic() + JOIN_S
    while 1 not in first and time.monotonic() < deadline:
        time.sleep(0.02)
    assert first[1] == 6  # MSG_TYPE_S2C_ACK
    assert server._round_sync is None  # the barrier still waits
    t2 = threading.Thread(target=client, args=(clients[1],), daemon=True)
    t2.start()
    for t in (ts, t1, t2):
        t.join(timeout=JOIN_S)
        assert not t.is_alive()
    assert not errors and server.done.is_set()
    assert server.liveness is not None  # armed at kickoff


def _argv(extra=()):
    return ["--algorithm", "fedavg", "--dataset", "fake_mnist", "--model",
            "lr", "--num_classes", "10", "--input_shape", "28", "28", "1",
            "--client_num_in_total", "2", "--client_num_per_round", "2",
            "--comm_round", "2", "--batch_size", "32", "--lr", "0.1",
            "--epochs", "1", *extra]


def test_cli_refusals(tmp_path):
    ip = tmp_path / "ip.json"
    ip.write_text(json.dumps({"0": ["127.0.0.1", 1], "1": ["127.0.0.1", 2]}))
    base = _argv(["--device", "cpu", "--ip_config", str(ip)])
    for extra, match in (
            ([], "--role requires --world_size"),
            (["--world_size", "1"], "--world_size must be >= 2"),
            (["--world_size", "2", "--rank", "1"], "server is always rank 0"),
            (["--round_deadline", "0", "--recovery_extensions", "1",
              "--world_size", "2"], "--recovery_extensions requires"),
            (["--world_size", "2", "--quorum_fraction", "0"],
             "quorum_fraction")):
        with pytest.raises(SystemExit, match=match):
            cli.main(base + ["--role", "server", *extra])
    with pytest.raises(SystemExit, match="requires --rank"):
        cli.main(base + ["--role", "client", "--world_size", "2"])
    with pytest.raises(SystemExit, match="outside the launch world"):
        cli.main(base + ["--role", "client", "--world_size", "2", "--rank",
                         "5"])
    for extra in (["--backend", "grpc"], ["--supervise"]):
        with pytest.raises(NotImplementedError, match="item 14b"):
            cli.main(base + ["--role", "server", "--world_size", "2",
                             *extra])
    with pytest.raises(NotImplementedError, match="item 14b"):
        cli.main(_argv(["--supervise", "--world_size", "2"]))
    # a tier root's world is the root and its leaves
    with pytest.raises(ValueError, match="implies a root world of 3"):
        cli.main(base + ["--role", "server", "--world_size", "2",
                         "--tier_spec", "root:2"])
    with pytest.raises(SystemExit, match="requires --uplink_ip_config"):
        cli.main(base + ["--role", "leaf", "--world_size", "2", "--rank",
                         "1", "--tier_spec", "root:2"])
    with pytest.raises(SystemExit, match="decay"):
        cli.parse_args(base + ["--quarantine_decay", "1.5"])


def test_world_of_processes_over_tcp_matches_loopback(tmp_path):
    """A server and two clients as OS processes over TCP on localhost:
    the final digest is the in-process loopback world's."""
    ports = free_ports(3)
    ip = tmp_path / "ip.json"
    ip.write_text(json.dumps({str(r): ["127.0.0.1", p]
                              for r, p in enumerate(ports)}))
    common = _argv(["--device", "cpu", "--backend", "tcp", "--world_size",
                    "3", "--ip_config", str(ip), "--out_dir", str(tmp_path),
                    "--run_name", "w", "--heartbeat_interval", "0.5"])
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.getcwd() + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    mod = [sys.executable, "-m", "fedml_tpu_torch.experiments.run"]
    procs = [subprocess.Popen(mod + common + role, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for role in (["--role", "server"],
                          ["--role", "client", "--rank", "1"],
                          ["--role", "client", "--rank", "2"])]
    t0 = time.monotonic()
    try:
        outs = [p.communicate(timeout=max(1.0, 60 - (time.monotonic() - t0)))
                for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    summary = json.loads(outs[0][0].strip().splitlines()[-1])
    assert summary["rounds"] == 2 and summary["bytes_sent"] > 0
    cfg, _ = cli.parse_args(common + ["--role", "server"])
    assert summary["params_digest"] == _digest(_world(cfg).variables)
    clients = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs[1:]]
    assert [c["updates"] for c in clients] == [2, 2]
    assert all(sorted(c["local_s"]) == ["0", "1"]
               and all(s > 0 for s in c["local_s"].values())
               for c in clients)
