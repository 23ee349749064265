"""Transport contract.

Reference: ``BaseCommunicationManager``
(``fedml_core/distributed/communication/base_com_manager.py:7-27``) and
``Observer`` (``observer.py:4-8``). The reference runs per-backend
send/receive daemon threads with a 0.3s poll loop
(``mpi/com_manager.py:71-79``) and kills them via
``PyThreadState_SetAsyncExc`` (``mpi_receive_thread.py:44-50``); here every
transport drains into one thread-safe inbox and a single dispatch loop with
cooperative shutdown — no async thread kills (SURVEY.md §5.2).
"""

from __future__ import annotations

import abc
import collections
import queue
import threading
import time
from typing import Callable, Protocol

from fedml_tpu_torch.core import telemetry
from fedml_tpu_torch.core.message import (
    MSG_TYPE_HEARTBEAT,
    Message,
    msg_type_name,
)

#: default bound on the dispatch inbox (docs/OBSERVABILITY.md
#: ``manager.inbox_*``): under open-loop async arrivals an unbounded
#: inbox can grow without bound while the depth gauge — only SAMPLED at
#: deliver time — shows whatever the last arrival saw. The bound sheds
#: the OLDEST HEARTBEAT first (liveness beacons are refreshed by ANY
#: delivery and re-sent every interval, so one is always safe to drop);
#: work messages (results, joins, partials) are NEVER shed — a full
#: inbox of work degrades to the old unbounded behavior, visibly via
#: the high-water-mark gauge.
INBOX_CAPACITY = 4096


class _BoundedInbox:
    """Drop-in for the previous ``queue.Queue`` with the shed policy
    above. ``get`` keeps the queue.Empty contract the dispatch loop
    (and the TRPC handshake) rely on."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._d: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self.hwm = 0
        self.shed = 0

    def put(self, item: "Message | None") -> bool:
        """Enqueue; returns True when an old heartbeat was shed to
        make room (the caller counts it — this class stays
        metrics-free so the lock never nests into telemetry)."""
        shed = False
        with self._cv:
            if item is not None and len(self._d) >= self.capacity:
                for i, m in enumerate(self._d):
                    if (m is not None
                            and m.msg_type == MSG_TYPE_HEARTBEAT):
                        del self._d[i]
                        self.shed += 1
                        shed = True
                        break
            self._d.append(item)
            if len(self._d) > self.hwm:
                self.hwm = len(self._d)
            self._cv.notify()
        return shed

    def get(self, timeout: float | None = None):
        deadline = (
            time.monotonic() + timeout if timeout is not None else None
        )
        with self._cv:
            while not self._d:
                if deadline is None:
                    self._cv.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._cv.wait(remaining):
                        if not self._d:
                            raise queue.Empty
            return self._d.popleft()

    def qsize(self) -> int:
        return len(self._d)

#: metric-name cache for the per-type byte counters: one small string
#: per DISTINCT message type, so the enabled hot path still allocates
#: no per-message strings (docs/OBSERVABILITY.md vocabulary)
_BYTES_BY_TYPE: dict[int, str] = {}


def _bytes_by_type_metric(msg_type: int) -> str:
    name = _BYTES_BY_TYPE.get(msg_type)
    if name is None:
        name = _BYTES_BY_TYPE[msg_type] = (
            f"transport.bytes_by_type.{msg_type_name(msg_type)}"
        )
    return name


class Observer(Protocol):
    def receive_message(self, msg_type: int, msg: Message) -> None: ...


class BaseTransport(abc.ABC):
    """4-method contract + shared inbox/dispatch machinery."""

    # cleared on a wrapped inner transport (ChaosTransport) so the one
    # message is not trace-marked/gauged twice on its way to the actor
    _telemetry_deliver = True

    def __init__(self, rank: int, inbox_capacity: int = INBOX_CAPACITY):
        self.rank = rank
        self._observers: list[Observer] = []
        self._inbox = _BoundedInbox(inbox_capacity)
        self._stopped = threading.Event()
        # called at DELIVER time (receiver thread), before the message
        # waits in the inbox — liveness tracking must see arrivals even
        # while the dispatch thread is busy inside a long handler (a
        # client mid-local-update would otherwise look dead to itself)
        self._deliver_hooks: list[Callable[[Message], None]] = []
        # gauge names resolved ONCE through the registry's label-capped
        # families (a 10k-rank world folds ranks beyond the cap into
        # one `...other` overflow gauge instead of growing the registry
        # and every scrape forever), then CACHED so the enabled
        # per-message hot path allocates no strings and takes no
        # label-ledger lock — resolution is lazy because the cap
        # decision belongs to the registry that is live at first use,
        # not whichever was live at construction
        # this transport's own wire byte counts (every frame, whatever
        # the telemetry plane)
        self.bytes_sent = 0
        self.bytes_received = 0
        self._inbox_label = f"rank{rank}"
        self._depth_gauge: str | None = None
        self._hwm_gauge: str | None = None

    # -- to implement ------------------------------------------------------
    @abc.abstractmethod
    def send_message(self, msg: Message) -> None: ...

    def start(self) -> None:  # start background receivers if any
        pass

    def stop(self) -> None:
        self._stopped.set()
        self._inbox.put(None)  # wake the dispatch loop

    # -- shared ------------------------------------------------------------
    def add_observer(self, obs: Observer) -> None:
        self._observers.append(obs)

    def add_deliver_hook(self, hook: Callable[[Message], None]) -> None:
        self._deliver_hooks.append(hook)

    # -- telemetry (docs/OBSERVABILITY.md) ---------------------------------
    def note_send(self, msg: Message, nbytes: int) -> None:
        """Account one outbound wire frame. Every concrete transport
        calls this once per send with the encoded frame size. Bytes are
        also attributed per message type
        (``transport.bytes_by_type.<name>``) so a wire-reduction claim
        can name the payload class it shrank."""
        self.bytes_sent += nbytes
        m = telemetry.METRICS
        if m.enabled:
            m.inc("transport.messages_sent")
            m.inc("transport.bytes_sent", nbytes)
            m.inc(_bytes_by_type_metric(msg.msg_type), nbytes)

    def note_receive(self, nbytes: int, msg_type: int | None = None) -> None:
        """Account one inbound wire frame — called at the transport's
        decode site (real I/O), NOT in :meth:`deliver`, so a wrapping
        transport (chaos) never double-counts. ``msg_type`` (known only
        after a successful decode; None for frames dropped before
        decode, e.g. CRC failures) feeds the per-type attribution."""
        self.bytes_received += nbytes
        m = telemetry.METRICS
        if m.enabled:
            m.inc("transport.messages_received")
            m.inc("transport.bytes_received", nbytes)
            if msg_type is not None:
                m.inc(_bytes_by_type_metric(msg_type), nbytes)

    def deliver(self, msg: Message) -> None:
        """Called by receiver machinery (or peers, for loopback)."""
        if self._telemetry_deliver:
            tr = telemetry.TRACER
            if tr is not None:
                trace = getattr(msg, "trace", None)
                if trace is not None:
                    tr.event(
                        "msg_deliver", rank=self.rank, trace_id=trace[0],
                        span_id=trace[1], sender=msg.sender,
                        msg_type=msg.msg_type,
                    )
            m = telemetry.METRICS
            if m.enabled:
                name = self._depth_gauge
                if name is None:
                    name = self._depth_gauge = m.labeled_name(
                        "transport.inbox_depth", self._inbox_label
                    )
                m.gauge(name, self._inbox.qsize())
        for hook in self._deliver_hooks:
            hook(msg)
        shed = self._inbox.put(msg)
        if self._telemetry_deliver:
            # backpressure surface (docs/OBSERVABILITY.md): the
            # high-water-mark is cumulative truth about the worst
            # backlog, where the sampled depth gauge above only shows
            # what the last arrival happened to see. Per-rank name
            # (gauges are last-write-wins) and gated exactly like the
            # depth gauge — a chaos-wrapped inner inbox, drained by
            # its pump thread, must not overwrite the real one's hwm.
            # The shed counter is additive, so a shared name is fine.
            m = telemetry.METRICS
            if m.enabled:
                name = self._hwm_gauge
                if name is None:
                    name = self._hwm_gauge = m.labeled_name(
                        "manager.inbox_hwm", self._inbox_label
                    )
                m.gauge(name, self._inbox.hwm)
                if shed:
                    m.inc("manager.inbox_shed")

    def handle_receive_message(self, timeout: float | None = None) -> None:
        """Blocking dispatch loop (reference
        ``MpiCommunicationManager.handle_receive_message``,
        ``com_manager.py:71-79`` — but event-driven, no 0.3s poll)."""
        self.start()
        while not self._stopped.is_set():
            try:
                msg = self._inbox.get(timeout=timeout)
            except queue.Empty:
                return
            if msg is None:
                break
            for obs in self._observers:
                obs.receive_message(msg.msg_type, msg)
