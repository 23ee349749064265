"""The port's buffered-async server and tier worlds against the JAX
package's: ``TierSpec`` and the partial screens with the JAX error
strings; the deployment's actor-class selection; an async loopback world
against the JAX async world with JAX's batch orders replayed; a scripted
arrival sequence driven into both async actors without threads (fresh,
stale, duplicate, future, aged-out and non-finite results, forced
emissions), compared after every step; tier worlds against the flat
world and against the JAX tier worlds (synchronous and async roots);
per-tier quarantine isolation; the progress deadline unwedging a silent
member; a SIGKILLed async root over TCP resuming its buffer; and the
CLI's tier and async refusals.

Every test leaves both packages' telemetry off and reset."""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

import fedml_tpu.config as jc
from fedml_tpu.algorithms import async_actors as jaa
from fedml_tpu.algorithms import distributed_fedavg as jdf
from fedml_tpu.core import telemetry as jtel
from fedml_tpu.core import tier as JT
from fedml_tpu.core.manager import Manager as JaxManager
from fedml_tpu.core.message import Message as JaxMessage
from fedml_tpu.core.transport.loopback import LoopbackHub as JaxHub
from fedml_tpu.experiments import run as jcli
from fedml_tpu.models import create_model as jax_create_model
import fedml_tpu_torch.config as tc
from fedml_tpu_torch.algorithms import async_actors as taa
from fedml_tpu_torch.algorithms import distributed_fedavg as tdf
from fedml_tpu_torch.core import telemetry
from fedml_tpu_torch.core import tier as TT
from fedml_tpu_torch.core.manager import Manager
from fedml_tpu_torch.core.message import (
    KEY_MODEL_PARAMS,
    KEY_NUM_SAMPLES,
    KEY_ROUND,
    MSG_TYPE_C2S_RESULT,
    Message,
)
from fedml_tpu_torch.core.reputation import QuarantinePolicy
from fedml_tpu_torch.core.transport.loopback import LoopbackHub
from fedml_tpu_torch.experiments import deploy
from fedml_tpu_torch.experiments import run as cli
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.utils.checkpoint import RoundCheckpointer
from tests.test_torch_deploy import (
    JAX_BAND,
    JOIN_S,
    _argv,
    _assert_close,
    _cfg,
    _data,
    _jax_data,
    _jax_orders,
    _port,
    _world,
)
from tests.test_torch_transport import free_ports
from tests.torch_threads import one_torch_thread  # noqa: F401

FLAT_BAND = dict(atol=1e-6, rtol=0)  # tests/test_async.py's tier vs flat
STEP_BAND = dict(atol=1e-6, rtol=1e-6)  # one emission's float32 step
COUNTERS = ("async.", "round.duplicate_results", "robust.nonfinite_rejected")


@pytest.fixture(autouse=True)
def _counting():
    """Both registries counting from zero; off and reset afterwards, the
    rest of the planes too (shutdown)."""
    for m in (jtel.METRICS, telemetry.METRICS):
        m.enabled = True
        m.reset()
    yield
    jtel.shutdown()
    telemetry.shutdown()


def _counters(metrics) -> dict:
    return {k: v for k, v in metrics.snapshot()["counters"].items()
            if k.startswith(COUNTERS)}


# -- (i) TierSpec and the partial screens ----------------------------------


def _spec_case(mod, spec):
    try:
        s = mod.TierSpec.parse(spec)
    except ValueError as err:
        return str(err)
    out = [s.n_leaves, s.root_world_size, s.leaf_ranks(),
           s.client_base(1, 10), s.client_base(s.n_leaves, 10)]
    try:
        s.client_base(s.n_leaves + 1, 10)
    except ValueError as err:
        out.append(str(err))
    return out


def _partial(kind):
    """A ``(payload, n_total)`` pair of numpy leaves over the template
    ``{"w": [7, 3], "b": [3]}``."""
    ones = {"w": np.ones((7, 3), np.float32), "b": np.ones(3, np.float32)}
    payloads = {
        "ok": ({"tier_sum": ones, "tier_count": 2}, 64.0),
        "nonfinite": ({"tier_sum": {**ones, "w": np.full((7, 3), np.nan,
                                                          np.float32)},
                       "tier_count": 2}, 64.0),
        "shape": ({"tier_sum": {k: np.ones((2, 2), np.float32)
                                for k in ones}, "tier_count": 2}, 64.0),
        "dtype": ({"tier_sum": {**ones, "b": np.ones(3, np.int32)},
                   "tier_count": 2}, 64.0),
        "nan_mass": ({"tier_sum": ones, "tier_count": 2}, float("nan")),
        "zero_mass": ({"tier_sum": ones, "tier_count": 2}, 0.0),
        "count_zero": ({"tier_sum": ones, "tier_count": 0}, 64.0),
        "count_str": ({"tier_sum": ones, "tier_count": "2"}, 64.0),
        "missing": ({}, 64.0),
        "not_a_dict": ([ones], 64.0),
        "structure": ({"tier_sum": {"nope": 1}, "tier_count": 1}, 64.0),
        "extra_leaf": ({"tier_sum": {**ones, "x": np.ones(1, np.float32)},
                        "tier_count": 1}, 64.0),
        "nested": ({"tier_sum": {**ones, "b": {"b": ones["b"]}},
                    "tier_count": 1}, 64.0),
    }
    return payloads[kind]


SPECS = ["root:4", "root:1", "root", "root:", "root:x", "tree:2", "root:0",
         "root:-1"]
SCREENS = ["ok", "nonfinite", "shape", "dtype", "nan_mass", "zero_mass",
           "count_zero", "count_str", "missing", "not_a_dict", "structure",
           "extra_leaf", "nested"]


@pytest.mark.parametrize("case", [f"spec={s}" for s in SPECS]
                         + [f"screen={s}" for s in SCREENS])
def test_tier_spec_and_partial_screens_match_jax(case):
    kind, _, arg = case.partition("=")
    if kind == "spec":
        assert _spec_case(TT, arg) == _spec_case(JT, arg)
        return
    payload, n = _partial(arg)
    want = JT.validate_partial(
        {"w": np.zeros((7, 3), np.float32), "b": np.zeros(3, np.float32)},
        payload, n)
    got = TT.validate_partial(
        {"w": torch.zeros(7, 3), "b": torch.zeros(3)}, payload, n)
    assert got == want
    assert (got is None) == (arg == "ok")


# -- (ii) the deployment's actor class --------------------------------------


@pytest.mark.parametrize("k,tier,want", [
    (0, None, tdf.FedAvgServerActor),
    (2, None, taa.AsyncFedAvgServerActor),
    (0, "root:2", taa.TierRootActor),
    (2, "root:2", taa.AsyncTierRootActor)],
    ids=["sync", "async", "tier", "async_tier"])
def test_server_class_selection(k, tier, want):
    cfg = _cfg(tc, clients=2, async_buffer_k=k)
    world = 3
    dep = deploy.DeployConfig(role="server", rank=0, world_size=world,
                              backend="loopback", tier_spec=tier)
    cls, extra = deploy.server_class(cfg, dep)
    assert cls is want
    server = cls(world, LoopbackHub().create(0), create_model(cfg.model,
                                                              "cpu"), cfg,
                 num_clients=2, data=_data(2), **extra)
    # with the knobs off: the synchronous actor itself, no subclass
    assert type(server) is want
    server.transport.stop()


# -- (iii) the async world against the JAX async world ----------------------


def _jax_async_world(cfg):
    n = cfg.data.num_clients
    data = _jax_data(n, cfg.data.dataset_r, cfg.model.name)
    model = jax_create_model(cfg.model)
    hub = JaxHub()
    server = jaa.AsyncFedAvgServerActor(n + 1, hub.create(0), model, cfg,
                                        num_clients=n, data=data)
    init = _port(server.variables)
    clients = [jdf.FedAvgClientActor(r, n + 1, hub.create(r), model, data,
                                     cfg) for r in range(1, n + 1)]
    for c in clients[1:]:
        c._local_update = clients[0]._local_update  # compile once
    _run_threads(server, clients)
    return server, init


def _run_threads(server, actors):
    """Run ``server`` in this thread and ``actors`` in their own until the
    server stops; then stop and join them."""
    threads = [threading.Thread(target=a.run, daemon=True) for a in actors]
    for t in threads:
        t.start()
    server.transport.start()
    server.start_round()
    server.run()
    for a in actors:
        a.transport.stop()
    for t in threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive()


def test_async_world_matches_jax():
    """2 clients at K = 2: every version folds both clients' fresh
    results, so the world is the same whatever the arrival order."""
    jcfg = _cfg(jc, rounds=5, clients=2, async_buffer_k=2)
    tcfg = _cfg(tc, rounds=5, clients=2, async_buffer_k=2)
    jserver, init = _jax_async_world(jcfg)
    assert jserver.round_idx == 5
    assert _counters(jtel.METRICS)["async.emits"] == 5
    telemetry.METRICS.reset()
    server = _world(tcfg, init=init, batch_orders=_jax_orders(tcfg),
                    server_cls=taa.AsyncFedAvgServerActor)
    assert server.done.is_set() and server.round_idx == 5
    _assert_close(server.variables, _port(jserver.variables), JAX_BAND)
    c = _counters(telemetry.METRICS)
    assert c["async.emits"] == 5 and c["async.folds"] == 10, c


# -- (iv) a scripted arrival sequence, no threads ---------------------------


def _delta(rank: int, v: int, nan: bool = False) -> dict:
    """A seeded JAX-layout delta of the lr model."""
    rng = np.random.default_rng(1000 * rank + v)
    d = {"params": {"Dense_0": {
        "kernel": (rng.standard_normal((784, 10)) * 0.01).astype(np.float32),
        "bias": (rng.standard_normal(10) * 0.01).astype(np.float32)}}}
    if nan:
        d["params"]["Dense_0"]["kernel"][3, 4] = np.nan
    return d


class _Pair:
    """The JAX async actor and the port's, from the same start, with
    every client rank's endpoint present so the resyncs land in inboxes
    nobody reads."""

    def __init__(self, clients: int, k: int, rounds: int):
        jcfg = _cfg(jc, rounds=rounds, clients=clients, async_buffer_k=k)
        tcfg = _cfg(tc, rounds=rounds, clients=clients, async_buffer_k=k)
        jhub, hub = JaxHub(), LoopbackHub()
        self.j = jaa.AsyncFedAvgServerActor(
            clients + 1, jhub.create(0), jax_create_model(jcfg.model), jcfg,
            num_clients=clients, data=_jax_data(clients))
        self.t = taa.AsyncFedAvgServerActor(
            clients + 1, hub.create(0), create_model(tcfg.model, "cpu"), tcfg,
            num_clients=clients, data=_data(clients),
            initial_variables=_port(self.j.variables))
        for r in range(1, clients + 1):
            jhub.create(r)
            hub.create(r)
        self.j.start_round()
        self.t.start_round()

    def result(self, rank: int, v: int, nan: bool = False) -> None:
        """The same result into both actors: each actor's own model of
        version ``v`` (its current one when ``v`` is not in its history)
        plus one delta."""
        jd = _delta(rank, v, nan)
        jbase = self.j._history.get(v, self.j._round_sync[1])
        jparams = jax.tree.map(lambda b, d: np.asarray(b) + d, jbase, jd)
        tbase = self.t._history.get(v, self.t._round_sync[1])
        td = _port(jd)
        tparams = {k: np.asarray(tbase[k]) + td[k].numpy() for k in tbase}
        n = 20.0 + rank
        self.j._handle_result(JaxMessage(
            MSG_TYPE_C2S_RESULT, rank, 0, {KEY_MODEL_PARAMS: jparams,
                                           KEY_NUM_SAMPLES: n, KEY_ROUND: v}))
        self.t._handle_result(Message(
            MSG_TYPE_C2S_RESULT, rank, 0, {KEY_MODEL_PARAMS: tparams,
                                           KEY_NUM_SAMPLES: n, KEY_ROUND: v}))

    def deadline(self) -> None:
        """The progress watchdog's firing (no timer is armed without a
        round deadline, so its generation is the current one)."""
        self.j._on_progress_deadline(self.j._deadline_gen)
        self.t._on_progress_deadline(self.t._deadline_gen)

    def check(self, step: str) -> None:
        j, t = self.j, self.t
        assert (t.round_idx, t._buffer.version, t._buffer.count) == (
            j.round_idx, j._buffer.version, j._buffer.count), step
        assert sorted(t._parked) == sorted(j._parked), step
        assert _counters(telemetry.METRICS) == _counters(jtel.METRICS), step
        _assert_close(t.variables, _port(j.variables), STEP_BAND)


def test_scripted_arrivals_match_jax():
    p = _Pair(clients=4, k=2, rounds=20)
    steps = [
        ("fresh", lambda: p.result(1, 0)),
        ("duplicate", lambda: p.result(1, 0)),
        ("fresh, emits v1", lambda: p.result(2, 0)),
        ("lag 1", lambda: p.result(3, 0)),
        ("future", lambda: p.result(1, 7)),
        ("fresh, emits v2", lambda: p.result(1, 1)),
        ("lag 2", lambda: p.result(4, 0)),
        ("non-finite", lambda: p.result(2, 2, nan=True)),
        ("forced, emits v3", p.deadline),
    ]
    # to version 11: natural emissions at even versions, forced at odd
    for v in range(3, 11):
        if v % 2 == 0:
            steps += [(f"v{v} rank 1", lambda v=v: p.result(1, v)),
                      (f"v{v} rank 2", lambda v=v: p.result(2, v))]
        else:
            steps += [(f"v{v} rank 4", lambda v=v: p.result(4, v)),
                      (f"v{v} forced", p.deadline)]
    steps += [
        # version 1 left the ring (depth 8) at version 10
        ("older than the history", lambda: p.result(3, 1)),
        # every live member parked with one fold pending: the stall valve
        ("fresh", lambda: p.result(1, 11)),
        ("non-finite", lambda: p.result(2, 11, nan=True)),
        ("non-finite", lambda: p.result(3, 11, nan=True)),
        ("stalled, emits v12", lambda: p.result(4, 11, nan=True)),
    ]
    for name, step in steps:
        step()
        p.check(name)
    assert p.t.round_idx == 12
    c = _counters(telemetry.METRICS)
    assert c["async.emits"] == 12 and c["async.too_stale"] == 2
    assert c["async.forced_emits"] == 6 and c["async.stale_folds"] == 2
    assert c["round.duplicate_results"] == 1
    assert c["robust.nonfinite_rejected"] == 4
    p.j.transport.stop()
    p.t.transport.stop()


# -- (v) tier worlds --------------------------------------------------------


def _tier_world(pkg, cfg, n_leaves, per_leaf, root_cls, init=None,
                orders=None, adversary_leaf=None, quarantine=None):
    """A tier world of ``pkg`` ("jax" or "torch") in this process: a root
    world over loopback, a loopback world a leaf. Returns the root, the
    leaves and the root's start in the port's layout."""
    jax_side = pkg == "jax"
    n = cfg.data.num_clients
    if jax_side:
        data = _jax_data(n, cfg.data.dataset_r, cfg.model.name)
        model = jax_create_model(cfg.model)
        hub_cls, mgr_cls, mod, spec_mod = JaxHub, JaxManager, jaa, JT
        root_kw = {}
    else:
        data = _data(n, cfg.data.dataset_r, cfg.model.name)
        model = create_model(cfg.model, "cpu")
        hub_cls, mgr_cls, mod, spec_mod = LoopbackHub, Manager, taa, TT
        root_kw = {"initial_variables": init}
        trainer = tdf.LocalTrainer(model, data, cfg, batch_orders=orders)
    spec = spec_mod.TierSpec.parse(f"root:{n_leaves}")
    root_hub = hub_cls()
    root = root_cls(spec.root_world_size, root_hub.create(0), model, cfg,
                    num_clients=n, data=data, tier_spec=spec, **root_kw)
    leaves, actors = [], []
    for leaf_rank in spec.leaf_ranks():
        hub = hub_cls()
        uplink = mgr_cls(leaf_rank, spec.root_world_size,
                         root_hub.create(leaf_rank))
        leaf_cfg = cfg
        if adversary_leaf == leaf_rank:
            leaf_cfg = dataclasses.replace(cfg, adversary=dataclasses.replace(
                cfg.adversary, mode="sign_flip", ranks=(per_leaf,),
                scale=10.0, seed=0))
        leaf = mod.TierAggregatorActor(
            per_leaf + 1, hub.create(0), uplink, model, leaf_cfg,
            client_base=spec.client_base(leaf_rank, per_leaf),
            num_clients=n, data=data, quarantine=quarantine)
        leaves.append(leaf)
        for r in range(1, per_leaf + 1):
            if jax_side:
                c = jdf.FedAvgClientActor(r, per_leaf + 1, hub.create(r),
                                          model, data, leaf_cfg)
                if actors:
                    c._local_update = actors[0]._local_update
            else:
                c = tdf.FedAvgClientActor(r, per_leaf + 1, hub.create(r),
                                          model, None, leaf_cfg,
                                          trainer=trainer)
            actors.append(c)
        actors += [uplink, leaf]
    start = (_port(root.variables) if jax_side
             else {k: v.clone() for k, v in root.variables.items()})
    _run_threads(root, actors)
    assert root.done.is_set(), (root.failure, root.round_idx)
    return root, leaves, start


def test_tier_world_matches_the_flat_world():
    """The tree changes where reduction happens, not what is computed:
    two leaves of two clients against the flat four-client world."""
    cfg = _cfg(tc, rounds=3, clients=4)
    root, leaves, _ = _tier_world("torch", cfg, 2, 2, taa.TierRootActor)
    flat = _world(cfg)
    _assert_close(root.variables, flat.variables, FLAT_BAND)
    assert [leaf.partials_sent for leaf in leaves] == [3, 3]
    c = telemetry.METRICS.snapshot()["counters"]
    assert c["tier.partial_sums"] == 12  # 6 sent by the leaves, 6 folded
    assert c["tier.forward_bytes"] == 6 * (784 * 10 + 10) * 4


@pytest.mark.parametrize("k", [0, 2], ids=["sync_root", "async_root_k2"])
def test_tier_worlds_match_jax(k):
    """The tier world against the JAX one on JAX's batch orders: the
    synchronous root, and the async root at K = 2 (both leaves' fresh
    partials fold each version)."""
    jcfg = _cfg(jc, rounds=3, clients=4, async_buffer_k=k)
    tcfg = _cfg(tc, rounds=3, clients=4, async_buffer_k=k)
    jroot, jleaves, init = _tier_world(
        "jax", jcfg, 2, 2, jaa.AsyncTierRootActor if k else jaa.TierRootActor)
    root, leaves, _ = _tier_world(
        "torch", tcfg, 2, 2,
        taa.AsyncTierRootActor if k else taa.TierRootActor, init=init,
        orders=_jax_orders(tcfg))
    _assert_close(root.variables, _port(jroot.variables), JAX_BAND)
    assert [x.partials_sent for x in leaves] == [
        x.partials_sent for x in jleaves] == [3, 3]
    assert root.round_idx == jroot.round_idx == 3


# -- (vi) quarantine per tier, the progress deadline ------------------------


def test_per_tier_quarantine_isolation():
    """A Byzantine client of leaf 1 trips leaf 1's own reputation plane;
    the sibling leaf's and the root's never hear of it."""
    cfg = _cfg(tc, rounds=4, clients=6)
    root, (bad, good), _ = _tier_world(
        "torch", cfg, 2, 3, taa.TierRootActor, adversary_leaf=1,
        quarantine=QuarantinePolicy(threshold=2.0, decay=0.2,
                                    warmup_rounds=0))
    assert bad._reputation is not good._reputation
    assert bad._reputation is not root._reputation
    assert bad.quarantined_ranks == [3], bad._reputation.scores
    assert good.quarantined_ranks == []
    assert good._reputation.score(3) < 2.0
    assert root.quarantined_ranks == []
    assert root.round_idx == 4


def test_async_progress_deadline_unwedges_silent_member():
    """Rank 2 never runs and, without heartbeats, is never declared dead:
    the progress deadline force-emits every window, so rank 1 keeps the
    run moving."""
    cfg = _cfg(tc, rounds=2, clients=2, async_buffer_k=2)
    hub = LoopbackHub()
    model = create_model(cfg.model, "cpu")
    server = taa.AsyncFedAvgServerActor(
        3, hub.create(0), model, cfg, num_clients=2, data=_data(2),
        round_policy=tdf.RoundPolicy(round_deadline_s=0.5))
    hub.create(2)
    client = tdf.FedAvgClientActor(1, 3, hub.create(1), model, _data(2), cfg)
    _run_threads(server, [client])
    assert server.done.is_set(), (server.failure, server.round_idx)
    assert server.round_idx == 2
    assert _counters(telemetry.METRICS).get("async.forced_emits", 0) >= 1


# -- (vii) a SIGKILLed async root over TCP -----------------------------------


def test_sigkill_async_root_restores_buffer(tmp_path):
    """Kill -9 the async root when its latest checkpoint holds pending
    folds (count > 0) at version 1 or later; the relaunch restores the
    buffer, not only the parameters, and finishes every version."""
    rounds = 8
    ports = free_ports(3)
    ip = tmp_path / "ip.json"
    ip.write_text(json.dumps({str(r): ["127.0.0.1", p]
                              for r, p in enumerate(ports)}))
    common = [
        "--algorithm", "fedavg", "--dataset", "fake_mnist", "--model", "lr",
        "--num_classes", "10", "--input_shape", "28", "28", "1",
        "--client_num_in_total", "2", "--client_num_per_round", "2",
        "--comm_round", str(rounds), "--batch_size", "32", "--lr", "0.1",
        "--epochs", "1", "--async_buffer_k", "2", "--device", "cpu",
        "--backend", "tcp", "--world_size", "3", "--ip_config", str(ip),
        "--out_dir", str(tmp_path), "--run_name", "async_kill",
        "--checkpoint_every", "1", "--heartbeat_interval", "0.5",
        "--heartbeat_timeout", "20"]
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.getcwd() + os.pathsep
           + os.environ.get("PYTHONPATH", "")}

    def spawn(*role):
        return subprocess.Popen(
            [sys.executable, "-m", "fedml_tpu_torch.experiments.run",
             *common, *role], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    # client 2's sends are delayed: after client 1's fold the checkpoint
    # holds count 1 until client 2's result lands, a window for the kill
    clients = [spawn("--role", "client", "--rank", "1"),
               spawn("--role", "client", "--rank", "2", "--fault_seed", "3",
                     "--fault_delay", "1.0", "--fault_delay_max", "0.8")]
    server = spawn("--role", "server")
    ckpt_dir = tmp_path / "async_kill" / "ckpt"
    killed = None
    t0 = time.monotonic()
    try:
        while time.monotonic() - t0 < 30 and server.poll() is None:
            raw = None
            if ckpt_dir.is_dir():
                try:
                    raw, _ = RoundCheckpointer(str(ckpt_dir)).restore_raw()
                except Exception:
                    raw = None  # a file replaced under the read; again
            if raw is not None and "async" in raw:
                count = int(raw["async"]["count"])
                version = int(raw["async"]["version"])
                if count > 0 and version >= 1:
                    os.kill(server.pid, signal.SIGKILL)
                    killed = (count, version)
                    break
            time.sleep(0.02)
        assert killed, ("no checkpoint with pending folds",
                        server.communicate(timeout=JOIN_S))
        server.wait(timeout=JOIN_S)
        server = spawn("--role", "server")
        out, err = server.communicate(timeout=30)
        assert server.returncode == 0, err[-3000:]
        summary = json.loads(out.strip().splitlines()[-1])
        assert summary["rounds"] == rounds, summary
        assert summary["resumed_from"] >= killed[1], (summary, killed)
        assert summary["async_restored_folds"] == killed[0], (summary,
                                                              killed)
        assert summary["async_buffer_k"] == 2, summary
        assert np.isfinite(summary["loss"]), summary
        for c in clients:
            c.communicate(timeout=JOIN_S)
            assert c.returncode == 0
    finally:
        for p in [server, *clients]:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.mark.parametrize("kind", ["pre_async", "not_composite"])
def test_restore_of_a_checkpoint_without_the_buffer(tmp_path, kind):
    """A composite from before async (no ``"async"`` part) restores the
    parameters and the version and warns; a bare state raises the JAX
    package's ValueError."""
    cfg = _cfg(tc, rounds=4, clients=2, async_buffer_k=2)
    model = create_model(cfg.model, "cpu")
    sync = tdf.FedAvgServerActor(3, LoopbackHub().create(0), model, cfg,
                                 num_clients=2, data=_data(2))
    state = sync.state._replace(
        variables={k: v + 1.0 for k, v in sync.state.variables.items()},
        round=2)
    ckpt = RoundCheckpointer(str(tmp_path))
    ckpt.save(1, {"server": state} if kind == "pre_async" else state)
    make = lambda: taa.AsyncFedAvgServerActor(  # noqa: E731
        3, LoopbackHub().create(0), model, cfg, num_clients=2, data=_data(2),
        checkpointer=ckpt)
    if kind == "not_composite":
        with pytest.raises(ValueError, match="non-composite checkpoint"):
            make()
        return
    with pytest.warns(UserWarning, match="pre-async checkpoint"):
        server = make()
    assert server.round_idx == server.resumed_from == 2
    assert server._buffer.version == 2 and server.restored_folds == 0
    _assert_close(server.variables, state.variables, dict(atol=0, rtol=0))


# -- (viii) the CLI ---------------------------------------------------------


def _leaf_argv(ip, *extra):
    return _argv(["--device", "cpu", "--backend", "tcp", "--ip_config",
                  str(ip), "--world_size", "3", *extra])


@pytest.mark.parametrize("extra,match", [
    (["--role", "leaf", "--rank", "1"], "--role leaf requires --tier_spec"),
    (["--role", "leaf", "--rank", "1", "--tier_spec", "root:2"],
     "--role leaf requires --uplink_ip_config"),
    (["--role", "leaf", "--rank", "3", "--tier_spec", "root:2",
      "--uplink_ip_config", "UP"], "leaf rank must be in 1..2"),
    (["--role", "leaf", "--tier_spec", "root:2"],
     "--role leaf requires --rank >= 1"),
    (["--role", "server", "--tier_spec", "tree:2"],
     "--tier_spec expects 'root:<n_leaves>'"),
    (["--role", "server", "--async_buffer_k", "2", "--algorithm", "fednova"],
     "async_buffer_k is incompatible with fednova")],
    ids=["no_tier_spec", "no_uplink", "leaf_rank", "no_rank", "bad_spec",
         "fednova"])
def test_cli_tier_and_async_refusals_match_jax(tmp_path, extra, match):
    ip = tmp_path / "ip.json"
    ip.write_text(json.dumps({str(r): ["127.0.0.1", 1 + r]
                              for r in range(3)}))
    argv = [str(ip) if a == "UP" else a for a in _leaf_argv(ip, *extra)]
    with pytest.raises(SystemExit, match=match) as got:
        cli.deploy_config(cli.parse_args(argv)[1])
    jargv = [a for a in argv if a not in ("--device", "cpu")]
    with pytest.raises(SystemExit) as want:
        jcli._deploy_config(jcli.parse_args(jargv)[1])
    assert str(got.value) == str(want.value)


def test_leaf_role_covers_the_fedavg_family_only(tmp_path):
    ip = tmp_path / "ip.json"
    ip.write_text(json.dumps({str(r): ["127.0.0.1", 1 + r]
                              for r in range(3)}))
    cfg, a = cli.parse_args(_leaf_argv(
        ip, "--role", "leaf", "--rank", "1", "--tier_spec", "root:2",
        "--uplink_ip_config", str(ip), "--algorithm", "splitnn"))
    with pytest.raises(ValueError, match="--role leaf covers the fedavg "
                                         "family only"):
        deploy.run_role(cfg, cli.deploy_config(a))
