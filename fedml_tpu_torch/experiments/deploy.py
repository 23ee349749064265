"""Process-separated deployment: one OS process per rank over a socket
(``fedml_tpu.experiments.deploy``).

The reference deploys N OS processes (``mpirun -np``, a per-rank
``main_fedavg.py``; the cross-silo ``run_server.sh`` and
``run_client.sh``). Here ``python -m fedml_tpu_torch.experiments.run
--role server|client --rank N --world_size W --backend tcp --ip_config
ip.json ...`` runs ONE rank of the synchronous FedAvg family on the card
(``--device cpu`` when asked). Every process derives its data partition,
model init and draws from the shared seeded config, and the actors are
:mod:`fedml_tpu_torch.algorithms.distributed_fedavg`'s, whose loopback
world is held against ``FedAvgSim``, so an N-process world over TCP
computes what the simulator computes.

Readiness: a client re-announces ``MSG_TYPE_C2S_JOIN`` every 0.5 s until
the server's ACK (``MSG_TYPE_S2C_ACK``, sent for each announcement), a
WELCOME or any other server message arrives; the server starts round 0
once every client of the world has announced. The ACK tells a client the
control channel works both ways before its first work message, so a
client never infers liveness from work traffic. Launch order does not
matter: sends to a server not yet bound are retried.

Liveness: once the run is underway both sides heartbeat and watch each
peer's last delivery. A client's death goes to the server actor's
``on_peer_dead`` (the round closes over the survivors at its deadline,
or the run aborts with :class:`QuorumLostError`), so the server never
blocks on its inbox for a dead client; a client whose server goes
silent stops and raises. Seeded fault injection rides
``DeployConfig.fault`` (:mod:`fedml_tpu_torch.core.transport.chaos`).

Not ported yet (ROADMAP Queue A item 14b): the async and tiered server
actors (``--async_buffer_k`` under ``--role``, ``--tier_spec``, the leaf
role), SplitNN ranks, the ``Supervisor`` (``--supervise``) and the grpc,
trpc, pubsub and pubsub_blob backends; each raises
``NotImplementedError`` naming the item.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
import threading
import time

import numpy as np
import torch

from fedml_tpu_torch.config import ExperimentConfig
from fedml_tpu_torch.core import telemetry
from fedml_tpu_torch.core.manager import Manager, create_transport
from fedml_tpu_torch.core.message import (
    MSG_TYPE_C2S_JOIN,
    MSG_TYPE_C2S_READY,
    MSG_TYPE_S2C_ACK,
    Message,
    to_host,
)
from fedml_tpu_torch.core.transport.base import BaseTransport
from fedml_tpu_torch.core.transport.chaos import ChaosTransport, FaultPolicy

FEDAVG_FAMILY = ("fedavg", "fedopt", "fednova")
DEPLOY_ALGORITHMS = FEDAVG_FAMILY + ("splitnn",)
ITEM_14B = "ROADMAP Queue A item 14b"


@dataclasses.dataclass(frozen=True)
class DeployConfig:
    """One rank's deployment coordinates (the reference's
    ``--client_id``/``--server_ip`` flags and ``ip_config`` tables)."""

    role: str  # "server" | "client"
    rank: int  # 0 = server, >= 1 = client
    world_size: int
    backend: str = "tcp"
    ip_config: dict[int, tuple[str, int]] | None = None
    ready_timeout: float = 120.0
    device: str = "cuda"
    # -- fault tolerance ---------------------------------------------------
    heartbeats: bool = True
    heartbeat_interval_s: float = 2.0
    heartbeat_timeout_s: float = 30.0
    quorum_fraction: float = 1.0
    round_deadline_s: float | None = None
    # server: checkpoint every N closed rounds under <run_dir>/ckpt and
    # resume from the latest on restart (0 = off)
    checkpoint_every: int = 0
    recovery_extensions: int = 0
    fault: FaultPolicy | None = None
    # -- Byzantine defense (server): the reputation plane's quarantine
    quarantine_threshold: float = 0.0
    quarantine_decay: float = 0.7
    quarantine_evict_after: int = 0
    # -- elastic membership (client): LEAVE after this round's result
    leave_after_round: int | None = None
    # server, on a restart: ranks that left or were evicted before it
    presumed_left: tuple[int, ...] = ()
    presumed_evicted: tuple[int, ...] = ()
    # -- telemetry ---------------------------------------------------------
    telemetry_dir: str | None = None
    trace: bool = False
    trace_torch: bool = False
    metrics_interval: float | None = None
    metrics_port: int | None = None
    metrics_host: str = "0.0.0.0"


def load_ip_config(path: str) -> dict[int, tuple[str, int]]:
    """JSON ``{"0": ["host", port], ...}`` to the rank table."""
    with open(path) as f:
        raw = json.load(f)
    return {int(r): (str(h), int(p)) for r, (h, p) in raw.items()}


def _make_transport(dep: DeployConfig) -> BaseTransport:
    if dep.backend.upper() == "TCP" and dep.ip_config is None:
        raise ValueError(f"{dep.backend} needs --ip_config")
    transport = create_transport(dep.backend, dep.rank,
                                 ip_config=dep.ip_config)
    if dep.fault is not None and dep.fault.enabled():
        transport = ChaosTransport(transport, dep.fault)
    return transport


# ---------------------------------------------------------------------------
# readiness handshake and liveness
# ---------------------------------------------------------------------------


class _AliveObserver:
    """The server's second observer: every inbound message's sender
    counts toward the barrier (after a server restart the surviving
    clients only heartbeat)."""

    def __init__(self, note):
        self._note = note

    def receive_message(self, msg_type: int, msg: Message) -> None:
        self._note(msg.sender)


def _serve_with_ready_barrier(server, dep: DeployConfig) -> None:
    """ACK every READY/JOIN, start (or resume) the run once every client
    has announced or otherwise shown it is alive, arm the dead-client
    watchdog (a death goes to the actor's ``on_peer_dead``: the round
    closes over the survivors or aborts), then drain until the actor
    finishes. A JOIN after kickoff goes to the actor's ``on_peer_join``
    (a rejoin, or an admission)."""
    ready: set[int] = set()
    started = threading.Event()
    for r in dep.presumed_left:
        server.on_peer_leave(r)
    for r in dep.presumed_evicted:
        server.evict_rank(r, notify=False)
    required = (set(server.client_ranks()) - set(dep.presumed_left)
                - set(dep.presumed_evicted))
    all_departed = (not required
                    and bool(dep.presumed_left or dep.presumed_evicted))
    if not required and not all_departed:
        required = set(range(1, dep.world_size))

    def note_alive(sender: int) -> None:
        # observers run on the one dispatch thread
        if started.is_set():
            return
        if sender not in required:
            if all_departed and sender in server.client_ranks():
                required.add(sender)
            else:
                return
        ready.add(sender)
        if len(ready) >= len(required):
            started.set()
            if dep.heartbeats:
                server.enable_liveness(
                    server.client_ranks(),
                    interval_s=dep.heartbeat_interval_s,
                    timeout_s=dep.heartbeat_timeout_s,
                    on_dead=server.on_peer_dead)
            server.kickoff()

    def ack(rank: int) -> None:
        try:
            server.send_message(Message(MSG_TYPE_S2C_ACK, 0, rank, {}))
        except Exception:
            pass  # the client's endpoint flapped; it announces again

    def on_ready(msg: Message) -> None:
        # ACK every announcement: duplicates come by design
        ack(msg.sender)
        note_alive(msg.sender)

    def on_join(msg: Message) -> None:
        membership = server.membership
        if msg.sender in membership["evicted"]:
            return  # a banned rank is never ACKed
        if started.is_set():
            if server.on_peer_join(msg.sender) == "admitted":
                ack(msg.sender)  # its first sync is at the next round
            return
        if (not 1 <= msg.sender < dep.world_size
                or msg.sender in membership["left"]):
            # a beyond-world rank, or one a restored ledger lists LEFT:
            # admitted into the ledger, its first slot at the next round
            if server.on_peer_join(msg.sender) == "rejected":
                return
        on_ready(msg)

    server.register_message_receive_handler(MSG_TYPE_C2S_READY, on_ready)
    server.register_message_receive_handler(MSG_TYPE_C2S_JOIN, on_join)
    server.transport.add_observer(_AliveObserver(note_alive))
    server.transport.start()
    server.run()  # until the actor's finish path stops the transport


def _announce_until_first_message(mgr: Manager, dep: DeployConfig
                                  ) -> tuple[threading.Event, list[str]]:
    """Client side: send JOIN every 0.5 s until the server's ACK, WELCOME
    or any other message arrives, then arm the server watchdog. Without
    any server message within ``ready_timeout`` the transport stops, so
    the caller's ``run()`` returns and the caller raises; a server that
    goes silent mid-run stops it too, with the failure recorded."""
    got = threading.Event()
    failures: list[str] = []

    class _FirstInbound:
        def receive_message(self, msg_type: int, msg: Message) -> None:
            got.set()

    mgr.transport.add_observer(_FirstInbound())

    def on_server_dead(rank: int) -> None:
        failures.append(
            "server became unreachable mid-run (no inbound traffic for "
            f"{dep.heartbeat_timeout_s}s)")
        telemetry.flight_dump("dead_peer", peer=rank, detail=failures[0])
        mgr.transport.stop()

    def loop() -> None:
        deadline = time.monotonic() + dep.ready_timeout
        while not got.is_set() and time.monotonic() < deadline:
            try:
                mgr.send_message(Message(MSG_TYPE_C2S_JOIN, mgr.rank, 0, {}))
            except Exception:
                pass  # the server endpoint is not up yet
            got.wait(0.5)
        if not got.is_set():
            mgr.transport.stop()
            return
        if dep.heartbeats:
            mgr.enable_liveness([0], interval_s=dep.heartbeat_interval_s,
                                timeout_s=dep.heartbeat_timeout_s,
                                on_dead=on_server_dead)

    threading.Thread(target=loop, daemon=True).start()
    return got, failures


def _run_client(mgr: Manager, dep: DeployConfig) -> None:
    """Announce, drain until FINISH; raise on a readiness timeout or a
    dead server."""
    mgr.transport.start()
    got, failures = _announce_until_first_message(mgr, dep)
    mgr.run()
    if not got.is_set():
        raise RuntimeError(
            f"server never contacted this client within --ready_timeout "
            f"{dep.ready_timeout}s — is the server rank up and reachable?")
    if failures:
        raise RuntimeError(failures[0])


# ---------------------------------------------------------------------------
# rank entry points
# ---------------------------------------------------------------------------


def _params_digest(tree) -> str:
    """sha256 over the leaves' bytes, in the variables' order."""
    h = hashlib.sha256()
    for leaf in to_host(dict(tree)).values():
        h.update(np.ascontiguousarray(np.asarray(leaf)).tobytes())
    return h.hexdigest()


def _run_dir(cfg: ExperimentConfig) -> str:
    d = os.path.join(cfg.out_dir, cfg.run_name)
    os.makedirs(d, exist_ok=True)
    return d


def _write_final(cfg: ExperimentConfig, tag: str, tree) -> str:
    """The final variables as a numpy pickle, the artifact worlds are
    compared by."""
    path = os.path.join(_run_dir(cfg), f"{tag}.pkl")
    with open(path, "wb") as f:
        pickle.dump(to_host(dict(tree)), f, protocol=5)
    return path


def serve(server, dep: DeployConfig) -> None:
    """Run a FedAvg server rank to its end: the barrier, then the rounds.
    Raises :class:`QuorumLostError` with the server's diagnostic when the
    straggler tolerance ran out, ``RuntimeError`` when the transport
    stopped before the last round."""
    from fedml_tpu_torch.algorithms.distributed_fedavg import QuorumLostError

    rounds = server.cfg.fed.num_rounds
    if server.resumed_from >= rounds:
        # restored at the end: nothing to run, no barrier to wait for
        server.done.set()
        server.finish_all()
    else:
        _serve_with_ready_barrier(server, dep)
    if server.failure is not None:
        raise QuorumLostError(f"run aborted (straggler tolerance "
                              f"exhausted): {server.failure}")
    if not server.done.is_set():
        raise RuntimeError(f"server stopped before completing {rounds} "
                           f"rounds (round_idx={server.round_idx})")


def _run_fedavg_rank(cfg: ExperimentConfig, dep: DeployConfig) -> dict:
    from fedml_tpu_torch.algorithms.base import build_evaluator, make_task
    from fedml_tpu_torch.algorithms.distributed_fedavg import (
        FedAvgClientActor,
        FedAvgServerActor,
        RoundPolicy,
    )
    from fedml_tpu_torch.core.async_agg import AsyncConfig
    from fedml_tpu_torch.core.reputation import QuarantinePolicy
    from fedml_tpu_torch.data import load_dataset
    from fedml_tpu_torch.models import create_model

    if dep.role == "leaf":
        raise NotImplementedError(
            f"tier worlds (--tier_spec, --role leaf) are not ported to "
            f"fedml_tpu_torch yet ({ITEM_14B})")
    if AsyncConfig.from_fed(cfg.fed).enabled() and dep.role == "server":
        raise NotImplementedError(
            f"the buffered-async server actor (--async_buffer_k under "
            f"--role) is not ported to fedml_tpu_torch yet ({ITEM_14B})")
    # every rank rebuilds the same seeded data and partition
    data = load_dataset(cfg.data)
    model = create_model(cfg.model, dep.device)
    transport = _make_transport(dep)

    if dep.role == "server":
        ckpt = None
        if dep.checkpoint_every > 0:
            from fedml_tpu_torch.utils.checkpoint import RoundCheckpointer

            ckpt = RoundCheckpointer(os.path.join(_run_dir(cfg), "ckpt"))
        server = FedAvgServerActor(
            dep.world_size, transport, model, cfg,
            num_clients=cfg.data.num_clients, data=data,
            round_policy=RoundPolicy(
                quorum_fraction=dep.quorum_fraction,
                round_deadline_s=dep.round_deadline_s,
                recovery_extensions=dep.recovery_extensions),
            checkpointer=ckpt,
            checkpoint_every=dep.checkpoint_every or 1,
            quarantine=QuarantinePolicy(
                threshold=dep.quarantine_threshold,
                decay=dep.quarantine_decay,
                evict_after=dep.quarantine_evict_after),
        )
        round_s: list[float] = []
        agg_s: list[float] = []
        closes: list[float] = []

        def on_round(next_round: int, info: dict) -> None:
            # a round: from its sync's broadcast to its close
            round_s.append(time.monotonic() - server.round_t0)
            agg_s.append(server.last_agg_s)
            closes.append(time.time())

        server.on_round_done = on_round
        t_start = time.monotonic()
        serve(server, dep)
        path = _write_final(cfg, "final_params", server.variables)
        # the final model on the test split (reference
        # test_on_server_for_all_clients, FedAVGAggregator.py:110-164)
        arrays = data.to_arrays(pad_multiple=cfg.data.batch_size,
                                device=model.device)
        ev = build_evaluator(model, make_task(data.task))
        metrics = {k: float(v) for k, v in ev(
            server.variables, arrays.test_x, arrays.test_y).items()}
        wire = getattr(transport, "inner", transport)
        return {
            "role": "server",
            "algorithm": cfg.fed.algorithm,
            "backend": dep.backend,
            "world_size": dep.world_size,
            "device": str(model.device),
            "rounds": server.round_idx,
            "resumed_from": server.resumed_from,
            "final_params": path,
            "params_digest": _params_digest(server.variables),
            "dead_peers": sorted(server.dead_peers),
            "defense": cfg.fed.robust_method,
            "quarantined": server.quarantined_ranks,
            "membership": server.membership,
            "elastic": bool(cfg.fed.elastic_buckets),
            "compress": cfg.fed.compress,
            # each round's seconds from its sync's broadcast to its
            # close, the aggregation's part of them (the step waited for),
            # and the wall-clock time of each close
            "round_s": round_s,
            "agg_s": agg_s,
            "round_close_unix": closes,
            "serve_s": time.monotonic() - t_start,
            "bytes_sent": wire.bytes_sent,
            "bytes_received": wire.bytes_received,
            "slos": list(cfg.fed.slos),
            **metrics,
        }

    client = FedAvgClientActor(dep.rank, dep.world_size, transport, model,
                               data, cfg,
                               leave_after_round=dep.leave_after_round)
    _run_client(client, dep)
    wire = getattr(transport, "inner", transport)
    return {
        "role": "client",
        "rank": dep.rank,
        "status": ("left" if client.left.is_set()
                   else "evicted" if client.finish_reason == "evicted"
                   else "finished"),
        "updates": client.trainer.updates,
        # round -> its local update's seconds, the result's copy to the
        # host included
        "local_s": {str(r): s for r, s in sorted(client.local_s.items())},
        "bytes_sent": wire.bytes_sent,
        "bytes_received": wire.bytes_received,
    }


def run_role(cfg: ExperimentConfig, dep: DeployConfig) -> dict:
    """Run THIS process's rank to completion; returns its summary."""
    if (dep.telemetry_dir or dep.trace or dep.trace_torch
            or dep.metrics_interval or dep.metrics_port is not None
            or cfg.fed.slos or cfg.fed.anatomy):
        telemetry.configure(
            telemetry_dir=dep.telemetry_dir
            or telemetry.default_dir(cfg.out_dir, cfg.run_name),
            rank=dep.rank, torch_profiler=dep.trace_torch,
            metrics_interval=dep.metrics_interval,
            metrics_port=dep.metrics_port, metrics_host=dep.metrics_host,
            slos=cfg.fed.slos, slo_scope=cfg.run_name)
        if cfg.fed.anatomy:
            from fedml_tpu_torch.core import anatomy

            anatomy.configure(anatomy=True, device=torch.device(dep.device))
    algo = cfg.fed.algorithm
    if algo in FEDAVG_FAMILY:
        return _run_fedavg_rank(cfg, dep)
    if algo == "splitnn":
        raise NotImplementedError(
            f"SplitNN ranks are not ported to fedml_tpu_torch yet "
            f"({ITEM_14B})")
    raise ValueError(
        f"algorithm {algo!r} has no deployment path; deployable: "
        f"{DEPLOY_ALGORITHMS} (every other algorithm runs via the "
        "simulator, python -m fedml_tpu_torch.experiments.run without "
        "--role)")
