"""In-memory loopback transport for tests and single-host multi-actor runs.

The reference has NO mock/in-memory transport — its CI launches real MPI
worlds (SURVEY.md §4). This fills that gap: N ranks share a
:class:`LoopbackHub`; sends go through the full encode/decode path so codec
bugs surface in unit tests."""

from __future__ import annotations

from fedml_tpu_torch.core.message import Message
from fedml_tpu_torch.core.transport.base import BaseTransport


class LoopbackHub:
    def __init__(self):
        self.transports: dict[int, "LoopbackTransport"] = {}

    def create(self, rank: int) -> "LoopbackTransport":
        t = LoopbackTransport(rank, self)
        self.transports[rank] = t
        return t


class LoopbackTransport(BaseTransport):
    def __init__(self, rank: int, hub: LoopbackHub):
        super().__init__(rank)
        self.hub = hub

    def send_message(self, msg: Message) -> None:
        # round-trip through the wire codec to keep tests honest
        data = msg.encode()
        self.note_send(msg, len(data))
        peer = self.hub.transports[msg.receiver]
        decoded = Message.decode(data)
        peer.note_receive(len(data), decoded.msg_type)
        peer.deliver(decoded)
