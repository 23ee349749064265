"""Actor base classes: handler-registry managers over a transport
(``fedml_tpu.core.manager``).

Reference: ``ClientManager`` / ``ServerManager``
(``fedml_core/distributed/client/client_manager.py:21``,
``server/server_manager.py:15``): construct a backend by name, register as
Observer, dispatch inbound messages by ``msg_type`` to registered handlers.
``finish()`` there is ``MPI.COMM_WORLD.Abort()`` (``client_manager.py:92-93``);
here it's a cooperative FINISH broadcast + transport stop.

The heartbeat carries the RTT ping/echo; the fleet summary the JAX
package piggybacks on an uplink beat (``export.fleet_summary``,
``fold_fleet``) is ROADMAP Queue A item 14b, as are the grpc, trpc,
pubsub and pubsub_blob backends of :func:`create_transport`.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterable

from fedml_tpu_torch.core import telemetry
from fedml_tpu_torch.core.message import (
    MSG_TYPE_FINISH,
    MSG_TYPE_HEARTBEAT,
    MSG_TYPE_S2C_ACK,
    Message,
)
from fedml_tpu_torch.core.transport.base import BaseTransport

Handler = Callable[[Message], None]


class LivenessMonitor:
    """Per-peer heartbeat sender + staleness detector.

    The reference framework has NO liveness layer: a crashed MPI rank
    aborts the world, and a crashed cross-silo client leaves the server
    blocked in its recv loop forever. Here every manager can arm a
    monitor: a daemon thread beats ``MSG_TYPE_HEARTBEAT`` to each peer
    every ``interval_s`` and declares a peer dead — once — when nothing
    has been DELIVERED from it for ``timeout_s``. Arrival time is
    recorded by a transport deliver-hook, not at dispatch, so a peer busy
    inside a long handler (local training) still observes heartbeats.
    """

    def __init__(
        self,
        mgr: "Manager",
        peers: Iterable[int],
        interval_s: float,
        timeout_s: float,
        on_dead: Callable[[int], None] | None,
    ):
        self.mgr = mgr
        self.peers = list(peers)
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.on_dead = on_dead
        self.dead: set[int] = set()
        now = time.monotonic()
        self.last_seen: dict[int, float] = {p: now for p in self.peers}
        # per-peer watchdog generation: a revive/watch that supersedes
        # a still-sleeping watchdog bumps it, and the old thread exits
        # on its next wake instead of coexisting with its replacement
        # (an unwatch→rejoin inside one interval would otherwise leak
        # a duplicate watchdog per churn cycle)
        self._gen: dict[int, int] = {p: 0 for p in self.peers}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        mgr.transport.add_deliver_hook(self._on_deliver)
        # ONE thread per peer: a beat to a dead peer blocks inside the
        # transport's retry budget, and a shared loop would let a single
        # crashed rank starve every other peer of beats (whose own
        # watchdogs would then fire — a cascade that turns one failure
        # into a world failure)
        self._threads = [
            threading.Thread(
                target=self._run_peer, args=(p, 0), daemon=True,
                name=f"liveness-rank{mgr.rank}-peer{p}",
            )
            for p in self.peers
        ]
        for t in self._threads:
            t.start()

    def _on_deliver(self, msg: Message) -> None:
        with self._lock:
            if msg.sender in self.last_seen:
                self.last_seen[msg.sender] = time.monotonic()

    def _mark_dead_if_stale(self, peer: int) -> bool:
        """Commit a death ONLY if the peer is still stale at commit
        time. A JOIN-triggered :meth:`revive` (or any delivery) that
        refreshed ``last_seen`` between the caller's detection and this
        commit RETRACTS the death — without the re-check, an in-flight
        watchdog could commit a pre-refresh staleness verdict over a
        completed rejoin and strand a live, heartbeating rank outside
        the cohort forever. Returns True when the death was committed
        (the calling watchdog should exit) and False on retraction
        (keep watching)."""
        with self._lock:
            if peer in self.dead:
                return True  # someone else committed; watchdog exits
            if (time.monotonic() - self.last_seen[peer]
                    <= self.timeout_s):
                return False  # heard from since detection — retract
            self.dead.add(peer)
        telemetry.METRICS.inc("manager.dead_peer_events")
        telemetry.RECORDER.record(
            "dead_peer", peer=peer, rank=self.mgr.rank,
            timeout_s=self.timeout_s,
        )
        if self.on_dead is not None:
            self.on_dead(peer)
        return True

    def _run_peer(self, peer: int, gen: int) -> None:
        while not self._stop.wait(self.interval_s):
            if self.mgr.transport._stopped.is_set():
                return  # actor finished without an explicit stop()
            with self._lock:
                if self._gen.get(peer) != gen:
                    return  # superseded by a revive/watch replacement
                if peer in self.dead:
                    return
                stale = (
                    time.monotonic() - self.last_seen[peer]
                    > self.timeout_s
                )
            if stale and self._mark_dead_if_stale(peer):
                return
            try:
                # hb_ts: the peer's manager echoes it back so the next
                # inbound beat closes the loop into an RTT gauge
                payload = {"hb_ts": time.monotonic()}
                self.mgr.send_message(
                    Message(MSG_TYPE_HEARTBEAT, self.mgr.rank, peer,
                            payload)
                )
            except Exception:
                # endpoint gone (socket transports raise once the
                # retry budget is spent); pub/sub QoS-0 publishes
                # never raise for a dead PEER — there staleness is
                # the only detector. A send aborted because WE are
                # shutting down (stop event cut the retry short) is
                # not evidence about the peer — don't turn a clean
                # finish into a spurious dead-peer failure.
                if (self._stop.is_set()
                        or self.mgr.transport._stopped.is_set()):
                    return
                # a failed beat to a RECENTLY-heard-from peer (e.g. one
                # that just rejoined on a fresh endpoint) is retracted
                # by the staleness re-check: keep watching — a truly
                # dead peer goes stale within timeout_s and commits
                # then
                if self._mark_dead_if_stale(peer):
                    return

    def dead_snapshot(self) -> set[int]:
        """Consistent snapshot of the peers currently considered dead —
        the liveness source of truth the server's round-boundary
        rejoin/death reconciliation reads (docs/FAULT_TOLERANCE.md
        "Recovery")."""
        with self._lock:
            return set(self.dead)

    def revive(self, peer: int) -> None:
        """Re-arm monitoring for a peer that rejoined after being
        declared dead (docs/FAULT_TOLERANCE.md "Recovery"). Resets the
        peer's last-seen clock and restarts its watchdog thread (the old
        one returned when it fired). ``on_dead`` may therefore fire
        again for the same rank — once per death, not once per run.
        Idempotent for peers that were never declared dead (a duplicate
        JOIN only refreshes last-seen)."""
        with self._lock:
            if peer not in self.last_seen:
                return  # not a monitored peer
            self.last_seen[peer] = time.monotonic()
            if peer not in self.dead:
                return
            self.dead.discard(peer)
            # supersede the old watchdog (it may still be sleeping if
            # the dead flag came from unwatch rather than its own
            # staleness verdict): bump the generation so it exits on
            # wake instead of running alongside its replacement
            self._gen[peer] = gen = self._gen.get(peer, 0) + 1
        t = threading.Thread(
            target=self._run_peer, args=(peer, gen), daemon=True,
            name=f"liveness-rank{self.mgr.rank}-peer{peer}",
        )
        t.start()
        self._threads.append(t)

    def watch(self, peer: int) -> None:
        """Start monitoring a peer that was NOT part of the launch
        world — a mid-run elastic admission (docs/FAULT_TOLERANCE.md
        "Elastic membership"). For an already-known peer this is
        :meth:`revive`."""
        with self._lock:
            known = peer in self.last_seen
            if not known:
                self.peers.append(peer)
                self.last_seen[peer] = time.monotonic()
                self._gen[peer] = 0
        if known:
            self.revive(peer)
            return
        t = threading.Thread(
            target=self._run_peer, args=(peer, 0), daemon=True,
            name=f"liveness-rank{self.mgr.rank}-peer{peer}",
        )
        t.start()
        self._threads.append(t)

    def unwatch(self, peer: int) -> None:
        """Stop monitoring a peer that LEFT gracefully: its watchdog
        thread exits without firing ``on_dead`` (a departure is not a
        death), and a later :meth:`revive`/:meth:`watch` re-arms it.
        Implemented by marking the peer dead WITHOUT the on_dead
        callback — the watchdog loop's exit condition."""
        with self._lock:
            if peer not in self.last_seen:
                return
            self.dead.add(peer)

    def stop(self) -> None:
        self._stop.set()


#: the JAX package's backends this package has not ported yet
ITEM_14B_BACKENDS = ("GRPC", "TRPC", "TENSOR_RPC", "PUBSUB", "MQTT",
                     "PUBSUB_BLOB", "MQTT_S3")


def create_transport(
    backend: str,
    rank: int,
    *,
    hub=None,
    ip_config: dict[int, tuple[str, int]] | None = None,
) -> BaseTransport:
    """Backend dispatch by name (reference ``client_manager.py:28-50``):
    ``loopback`` (a shared :class:`LoopbackHub`) or ``tcp`` (the rank
    table ``ip_config``). The JAX package's grpc, trpc, pubsub and
    pubsub_blob raise ``NotImplementedError``."""
    name = backend.upper()
    if name == "LOOPBACK":
        if hub is None:
            raise ValueError("loopback needs a shared LoopbackHub")
        return hub.create(rank)
    if name == "TCP":
        from fedml_tpu_torch.core.transport.tcp import TcpTransport

        if ip_config is None:
            raise ValueError("tcp needs ip_config (rank -> (host, port))")
        return TcpTransport(rank, ip_config)
    if name in ITEM_14B_BACKENDS:
        raise NotImplementedError(
            f"the {backend} transport is not ported to fedml_tpu_torch yet "
            "(ROADMAP Queue A item 14b); use tcp or loopback")
    raise ValueError(f"unknown backend: {backend}")


class Manager:
    """Common actor machinery (both sides)."""

    def __init__(self, rank: int, size: int, transport: BaseTransport):
        self.rank = rank
        self.size = size
        self.transport = transport
        self._handlers: dict[int, Handler] = {}
        self.liveness: LivenessMonitor | None = None
        # why the peer FINISHed us, when it said (e.g. "evicted" —
        # docs/FAULT_TOLERANCE.md "Elastic membership"): the deploy
        # summary reports it so a supervisor can tell a departure BY
        # DESIGN from an ordinary wind-down
        self.finish_reason: str | None = None
        transport.add_observer(self)
        self.register_message_receive_handler(
            MSG_TYPE_FINISH, self._on_finish
        )
        # liveness/handshake beacons are protocol-level: every actor
        # accepts them (their primary side effect — the last-seen
        # refresh — happens at deliver time, before dispatch; the
        # handler only services the RTT ping/echo)
        self.register_message_receive_handler(
            MSG_TYPE_HEARTBEAT, self._on_heartbeat
        )
        self.register_message_receive_handler(
            MSG_TYPE_S2C_ACK, lambda msg: None
        )

    def _on_finish(self, msg: Message) -> None:
        self.finish_reason = msg.get("reason")
        self.finish()

    def _on_heartbeat(self, msg: Message) -> None:
        """Ping/echo half of the RTT measurement: a beat carrying
        ``hb_ts`` is echoed back (``hb_echo``); an echo of OUR beat
        closes the loop into a per-peer RTT gauge. Echoes carry no
        ``hb_ts``, so the exchange terminates after one hop."""
        hb_echo = msg.get("hb_echo")
        if hb_echo is not None:
            # cardinality-capped per-peer family: beyond the cap new
            # peers fold into manager.heartbeat_rtt_s.other instead of
            # minting one gauge per peer forever (the 10k-client
            # registry/scrape bound, docs/OBSERVABILITY.md)
            telemetry.METRICS.gauge_labeled(
                "manager.heartbeat_rtt_s", f"peer{msg.sender}",
                time.monotonic() - float(hb_echo),
            )
            return
        hb_ts = msg.get("hb_ts")
        if hb_ts is not None:
            try:
                self.send_message(
                    Message(MSG_TYPE_HEARTBEAT, self.rank, msg.sender,
                            {"hb_echo": hb_ts})
                )
            except Exception:
                pass  # peer flapped mid-echo; its watchdog will notice

    def register_message_receive_handler(
        self, msg_type: int, handler: Handler
    ) -> None:
        self._handlers[msg_type] = handler

    def receive_message(self, msg_type: int, msg: Message) -> None:
        handler = self._handlers.get(msg_type)
        if handler is None:
            raise KeyError(
                f"rank {self.rank}: no handler for msg_type {msg_type}"
            )
        tr = telemetry.TRACER
        trace = getattr(msg, "trace", None) if tr is not None else None
        if trace is None:
            handler(msg)
            return
        # bind the inbound trace id for the handler's duration: any
        # message the handler sends inherits it, which is what connects
        # a server's round-sync to the client's result across processes
        telemetry.set_current_trace(trace[0])
        try:
            with tr.span(
                f"handle:{msg_type}", rank=self.rank, trace_id=trace[0],
                parent_span=trace[1], sender=msg.sender,
                msg_type=msg_type,
            ):
                handler(msg)
        finally:
            telemetry.set_current_trace(None)

    def send_message(self, msg: Message) -> None:
        tr = telemetry.TRACER
        if tr is not None and msg.msg_type != MSG_TYPE_HEARTBEAT:
            # heartbeats stay untraced: a 2 s beacon cadence would bury
            # the work-message timeline under protocol noise
            if getattr(msg, "trace", None) is None:
                tid = telemetry.current_trace()
                msg.trace = (
                    tid if tid is not None else telemetry.new_trace_id(),
                    telemetry.new_span_id(),
                )
            tr.event(
                "msg_send", rank=self.rank, trace_id=msg.trace[0],
                span_id=msg.trace[1], receiver=msg.receiver,
                msg_type=msg.msg_type,
            )
        self.transport.send_message(msg)

    def enable_liveness(
        self,
        peers: Iterable[int],
        interval_s: float = 2.0,
        timeout_s: float = 30.0,
        on_dead: Callable[[int], None] | None = None,
    ) -> LivenessMonitor:
        """Arm the heartbeat protocol toward ``peers``. ``on_dead(rank)``
        fires exactly once per peer DEATH, from the monitor thread (a
        peer revived via :meth:`LivenessMonitor.revive` is watched again
        and may die again)."""
        if self.liveness is not None:
            raise RuntimeError("liveness already enabled")
        self.liveness = LivenessMonitor(
            self, peers, interval_s, timeout_s, on_dead
        )
        return self.liveness

    def run(self) -> None:
        self.transport.handle_receive_message()

    def finish(self) -> None:
        if self.liveness is not None:
            self.liveness.stop()
        self.transport.stop()


class ServerManager(Manager):
    """Rank-0 actor (reference ``server_manager.py:15``)."""

    def client_ranks(self) -> list[int]:
        """The client ranks this server currently serves. The default
        is the launch world (``1..size-1``); elastic actors override it
        with their membership ledger so broadcasts and FINISH reach
        mid-run admissions and skip departed ranks
        (docs/FAULT_TOLERANCE.md "Elastic membership")."""
        return list(range(1, self.size))

    def broadcast(
        self,
        msg_type: int,
        payload_fn,
        ranks: Iterable[int] | None = None,
        on_send_error: Callable[[int, Exception], None] | None = None,
    ) -> None:
        """Send ``Message(msg_type, 0, r, payload_fn(r))`` to every
        served client rank (or just ``ranks``). With ``on_send_error`` a
        failed send is reported per-rank instead of aborting the whole
        broadcast — the fault-tolerant round path treats it as a dead
        peer and keeps the cohort's survivors moving."""
        targets = self.client_ranks() if ranks is None else ranks
        for r in targets:
            msg = Message(msg_type, self.rank, r, payload_fn(r))
            if on_send_error is None:
                self.send_message(msg)
                continue
            try:
                self.send_message(msg)
            except Exception as err:
                on_send_error(r, err)

    def finish_all(self) -> None:
        for r in self.client_ranks():
            try:
                self.send_message(
                    Message(MSG_TYPE_FINISH, self.rank, r, {})
                )
            except Exception:
                pass  # peer already gone — FINISH is best-effort
        self.finish()


class ClientManager(Manager):
    """Rank>=1 actor (reference ``client_manager.py:21``)."""
