"""Chaos-injection transport: seeded, deterministic fault injection.

Real cross-device FL (the workload the reference was built for) is
defined by clients that crash, stall, and drop mid-round — but neither
the reference nor a clean-room simulator exercises those paths unless
faults can be injected ON DEMAND and REPRODUCIBLY. FedJAX (arxiv
2108.02117) makes the same argument for modelling client unreliability
deterministically inside the simulator; this module brings it to the
cross-process runtime: :class:`ChaosTransport` wraps any
:class:`~fedml_tpu_torch.core.transport.base.BaseTransport` and perturbs its
traffic according to a :class:`FaultPolicy` whose every decision comes
from a seeded RNG — the same seed replays the same faults.

Fault model (send-side, plus crash-on-receive):

- **drop** — the message silently never leaves this rank (QoS-0 loss).
- **delay** — delivery deferred by a bounded random interval (congested
  WAN link).
- **duplicate** — the message is sent twice (at-least-once transports,
  MQTT QoS 1 re-delivery).
- **reorder** — the message is held back and ships after the NEXT send
  (multi-path routing).
- **corrupt** — seeded bit-flips in the message's SEALED wire frame
  (cosmic rays, failing NICs, buggy middleboxes). The transport codecs
  that seal frames (tcp, pubsub — :mod:`.wire`) compute the CRC first
  and flip after, so the receiver detects the damage, counts
  ``transport.corrupt_frames``, and drops the frame; the retry /
  straggler machinery heals it like a drop.
- **crash-at-round-N** — the first inbound message tagged with
  ``round_idx >= N`` kills this rank: either it goes silent (swallows
  all subsequent traffic, ``crash_mode="silent"``) or the whole process
  exits (``crash_mode="exit"``, exit code :data:`CHAOS_EXIT_CODE`) — the
  deterministic stand-in for ``kill -9`` mid-round.

``FINISH`` frames and the liveness/handshake plane (READY/ACK/HEARTBEAT)
are protected by default (``protect_types``): the former so a
zero-straggler-tolerance run still terminates, the latter so
timing-driven protocol traffic doesn't consume RNG draws and break the
work-message fault pattern's replayability. Chaos on those planes is
opt-in (``protect_types=()``).
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading

from fedml_tpu_torch.core import telemetry
from fedml_tpu_torch.core.message import (
    KEY_ROUND,
    MSG_TYPE_C2S_JOIN,
    MSG_TYPE_C2S_LEAVE,
    MSG_TYPE_C2S_READY,
    MSG_TYPE_FINISH,
    MSG_TYPE_HEARTBEAT,
    MSG_TYPE_S2C_ACK,
    MSG_TYPE_S2C_WELCOME,
    Message,
)
from fedml_tpu_torch.core.transport.base import BaseTransport

#: Exit status of a rank killed by ``crash_mode="exit"`` — launchers and
#: tests can tell an injected crash from a genuine failure.
CHAOS_EXIT_CODE = 86


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """Per-rank fault configuration. All probabilities are per-message;
    decisions are drawn from ``random.Random(seed ^ rank)`` in a fixed
    order, so a run is replayable given (seed, message sequence)."""

    seed: int = 0
    drop_prob: float = 0.0
    delay_prob: float = 0.0
    delay_min_s: float = 0.005
    delay_max_s: float = 0.05
    dup_prob: float = 0.0
    reorder_prob: float = 0.0
    # per-message probability of seeded bit-flips in the sealed wire
    # frame (detected + dropped by the CRC codecs; see module doc)
    corrupt_prob: float = 0.0
    crash_at_round: int | None = None
    crash_mode: str = "silent"  # "silent" | "exit"
    # protected by default: FINISH (so a zero-tolerance run still
    # terminates) and the liveness/handshake/recovery plane (READY/ACK/
    # HEARTBEAT/JOIN/WELCOME counts are timing-driven — re-announce
    # loops, monitor threads, supervised restarts — so letting them
    # consume RNG draws would make the WORK-message fault pattern
    # non-replayable across runs). Chaos on these planes is opt-in via
    # protect_types=(). Note crash_at_round is a RECEIVE-side trigger
    # and ignores this list: a WELCOME tagged round >= N still kills a
    # rank whose policy says so — restart argv should drop fault flags
    # (the Supervisor's restart_argv does).
    protect_types: tuple[int, ...] = (
        MSG_TYPE_FINISH,
        MSG_TYPE_C2S_READY,
        MSG_TYPE_S2C_ACK,
        MSG_TYPE_HEARTBEAT,
        MSG_TYPE_C2S_JOIN,
        MSG_TYPE_S2C_WELCOME,
        MSG_TYPE_C2S_LEAVE,
    )

    def __post_init__(self):
        if self.crash_mode not in ("silent", "exit"):
            raise ValueError(
                f"crash_mode must be 'silent' or 'exit', "
                f"got {self.crash_mode!r}"
            )

    def enabled(self) -> bool:
        return bool(
            self.drop_prob
            or self.delay_prob
            or self.dup_prob
            or self.reorder_prob
            or self.corrupt_prob
            or self.crash_at_round is not None
        )


class _InboundShim:
    """Sole observer of the inner transport: funnels its dispatch loop
    into the chaos layer's inbound fault check."""

    def __init__(self, outer: "ChaosTransport"):
        self.outer = outer

    def receive_message(self, msg_type: int, msg: Message) -> None:
        self.outer._on_inbound(msg)


class ChaosTransport(BaseTransport):
    """Fault-injecting wrapper. The manager talks to THIS transport; the
    wrapped transport does the real I/O on a background pump thread."""

    def __init__(self, inner: BaseTransport, policy: FaultPolicy):
        super().__init__(inner.rank)
        self.inner = inner
        self.policy = policy
        self._rng = random.Random(policy.seed ^ (inner.rank * 0x9E3779B9))
        self._rng_lock = threading.Lock()
        self.crashed = threading.Event()
        self._held: Message | None = None  # reorder buffer
        self._held_lock = threading.Lock()
        self._pump: threading.Thread | None = None
        # counters for diagnostics / tests ({fault -> count})
        self.stats = {
            "sent": 0, "dropped": 0, "delayed": 0, "duplicated": 0,
            "reordered": 0, "corrupted": 0,
        }
        # the inner transport still counts wire bytes at its decode
        # site, but deliver-time telemetry (trace marks, inbox gauge)
        # belongs to THIS transport — the one the actor drains
        inner._telemetry_deliver = False
        inner.add_observer(_InboundShim(self))

    def _stat(self, key: str, n: int = 1) -> None:
        """Bump a fault counter in both the local stats dict (tests)
        and the process metrics registry (docs/OBSERVABILITY.md)."""
        self.stats[key] += n
        telemetry.METRICS.inc("chaos." + key, n)

    # -- receive path ------------------------------------------------------
    def start(self) -> None:
        self.inner.start()
        if self._pump is None:
            # drain the inner transport's inbox through its dispatch loop
            # (which calls our shim) on a dedicated thread, so the outer
            # inbox — the one the actor blocks on — sees faulted traffic
            self._pump = threading.Thread(
                target=self.inner.handle_receive_message,
                daemon=True,
                name=f"chaos-pump-rank{self.rank}",
            )
            self._pump.start()

    def _crash(self) -> None:
        self.crashed.set()
        telemetry.METRICS.inc("chaos.crashes")
        telemetry.RECORDER.record(
            "chaos_crash", rank=self.rank, mode=self.policy.crash_mode
        )
        if self.policy.crash_mode == "exit":
            # the deterministic `kill -9`: no atexit, no cleanup, no
            # FINISH — exactly what a preempted spot VM looks like
            os._exit(CHAOS_EXIT_CODE)

    def _on_inbound(self, msg: Message) -> None:
        if self.crashed.is_set():
            return  # dead processes read nothing
        n = self.policy.crash_at_round
        if n is not None:
            rnd = msg.get(KEY_ROUND)
            if rnd is not None and int(rnd) >= n:
                self._crash()
                return  # the fatal message is never seen by the actor
        self.deliver(msg)

    # -- send path ---------------------------------------------------------
    def send_message(self, msg: Message) -> None:
        if self.crashed.is_set():
            return  # dead processes send nothing
        if msg.msg_type in self.policy.protect_types:
            self.inner.send_message(msg)
            return
        p = self.policy
        with self._rng_lock:
            # fixed draw order keeps the decision stream aligned across
            # runs even when an earlier fault short-circuits
            r_drop, r_dup, r_delay, r_reorder, r_u, r_corrupt = (
                self._rng.random() for _ in range(6)
            )
        if r_drop < p.drop_prob:
            self._stat("dropped")
            return
        if r_corrupt < p.corrupt_prob:
            # mark the message; the sealing codec (tcp/pubsub) flips
            # seeded bits AFTER computing the CRC, so the receiver's
            # checksum detects + drops the frame. The corruption seed
            # derives from the draw itself — no extra RNG consumption,
            # fully replayable. Composes with dup/delay (the marker
            # rides every copy).
            msg.chaos_corrupt = int(r_corrupt * (1 << 31))
            self._stat("corrupted")
        elif getattr(msg, "chaos_corrupt", None) is not None:
            # a RETRY re-sends the same Message object: clear a stale
            # marker so this send's draw decides its fate — otherwise a
            # once-corrupted message is re-corrupted on every retry and
            # the retry machinery can never heal the loss
            del msg.chaos_corrupt
        if r_reorder < p.reorder_prob:
            swap = None
            with self._held_lock:
                if self._held is None:
                    self._held = msg  # ships after the NEXT send
                    self._stat("reordered")
                    # a tail message must not be held forever if no
                    # successor ever comes
                    t = threading.Timer(0.25, self._flush_held)
                    t.daemon = True
                    t.start()
                    return
                swap = self._held
                self._held = None
            self._send_now(msg)  # overtakes the held one
            self._send_now(swap, swallow_errors=True)
            return
        delay = None
        if r_delay < p.delay_prob:
            delay = p.delay_min_s + r_u * (p.delay_max_s - p.delay_min_s)
        if r_dup < p.dup_prob:
            self._stat("duplicated")
            self._dispatch(msg, delay)
            self._dispatch(msg, delay)
            return
        self._dispatch(msg, delay)
        with self._held_lock:
            held, self._held = self._held, None
        if held is not None:
            self._send_now(held, swallow_errors=True)

    def _dispatch(self, msg: Message, delay: float | None) -> None:
        if delay is None:
            self._send_now(msg)
            return
        self._stat("delayed")
        t = threading.Timer(
            delay, self._send_now, args=(msg,), kwargs={
                "swallow_errors": True}
        )
        t.daemon = True
        t.start()

    def _flush_held(self) -> None:
        with self._held_lock:
            held, self._held = self._held, None
        if held is not None:
            self._send_now(held, swallow_errors=True)

    def _send_now(self, msg: Message, swallow_errors: bool = False) -> None:
        if self.crashed.is_set():
            return
        self._stat("sent")
        if not swallow_errors:
            self.inner.send_message(msg)
            return
        try:
            # async redeliveries (timer threads) degrade send failures to
            # drops — the fault-tolerance layer above must absorb loss
            # anyway, and a timer thread has no caller to raise into
            self.inner.send_message(msg)
        except Exception:
            self._stat("dropped")

    def stop(self) -> None:
        super().stop()
        self.inner.stop()
