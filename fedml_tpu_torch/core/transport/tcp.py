"""TCP socket transport: length-prefixed, sealed message frames.

The DCN-class control-plane transport (reference analog: the gRPC backend,
``fedml_core/distributed/communication/gRPC/grpc_comm_manager.py:22-98`` —
each process runs a server, send opens a channel to ``ip_config[receiver]``).
Here: each rank runs one accept loop; sends use pooled persistent
connections; frames are ``8-byte big-endian length || sealed payload``
where the seal is the protocol-version byte + CRC32 of
:mod:`fedml_tpu_torch.core.transport.wire`. A CRC mismatch (bit-flip in
flight, or the chaos ``corrupt`` fault) is counted
(``transport.corrupt_frames``) and DROPPED — the retry/heartbeat/
straggler machinery heals it like any loss; a protocol-version mismatch
(rolling-restart skew) fails the rank loudly instead of garbling a
pytree (docs/FAULT_TOLERANCE.md).
"""

from __future__ import annotations

import socket
import struct
import sys
import threading

from fedml_tpu_torch.core import telemetry
from fedml_tpu_torch.core.message import Message
from fedml_tpu_torch.core.transport import wire
from fedml_tpu_torch.core.transport.base import BaseTransport
from fedml_tpu_torch.core.transport.retry import RetryPolicy, call_with_retry

_HDR = struct.Struct(">Q")

#: Per-attempt socket timeout for connect. A wedged peer (bound port,
#: dead process) turns into a retryable ``socket.timeout`` instead of an
#: unbounded stall.
_SOCKET_TIMEOUT_S = 10.0
#: Floor throughput assumed when bounding a send: the per-attempt send
#: timeout is ``max(_SOCKET_TIMEOUT_S, frame_bytes / _MIN_SEND_BPS)`` —
#: a multi-GB model sync over a slow cross-silo link gets the time it
#: legitimately needs, while a truly wedged peer still times out.
_MIN_SEND_BPS = 1 << 20  # 1 MiB/s


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class TcpTransport(BaseTransport):
    def __init__(
        self,
        rank: int,
        ip_config: dict[int, tuple[str, int]],
        retry: RetryPolicy | None = None,
    ):
        """``ip_config``: rank -> (host, port) for every participant
        (reference ``ip_config_utils.py`` CSV tables)."""
        super().__init__(rank)
        self.ip_config = ip_config
        self.retry = retry if retry is not None else RetryPolicy()
        self._server: socket.socket | None = None
        self._conns: dict[int, socket.socket] = {}
        # one lock per peer rank so a slow/blocked connect or send to one
        # peer never serializes traffic to the others; a global lock guards
        # only the dict itself
        self._lock = threading.Lock()
        self._rank_locks: dict[int, threading.Lock] = {}
        self._threads: list[threading.Thread] = []

    # -- receive side ------------------------------------------------------
    def start(self) -> None:
        if self._server is not None:
            return
        host, port = self.ip_config[self.rank]
        srv = socket.create_server((host, port), reuse_port=False)
        srv.settimeout(0.5)
        self._server = srv
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def _accept_loop(self) -> None:
        assert self._server is not None
        while not self._stopped.is_set():
            try:
                conn, _ = self._server.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(
                target=self._read_loop, args=(conn,), daemon=True
            )
            t.start()
            self._threads.append(t)

    def _read_loop(self, conn: socket.socket) -> None:
        with conn:
            while not self._stopped.is_set():
                hdr = _recv_exact(conn, _HDR.size)
                if hdr is None:
                    return
                (length,) = _HDR.unpack(hdr)
                data = _recv_exact(conn, length)
                if data is None:
                    return
                try:
                    payload = wire.open_sealed(data)
                except wire.CorruptFrameError:
                    self.note_receive(_HDR.size + length)
                    # damaged in flight: count + drop; the length
                    # prefix framed the stream correctly, so the next
                    # frame parses — and the fault-tolerance layer
                    # above heals the loss (retries re-send syncs,
                    # straggler rounds close without the result)
                    telemetry.METRICS.inc("transport.corrupt_frames")
                    telemetry.RECORDER.record(
                        "corrupt_frame", rank=self.rank, nbytes=length
                    )
                    continue
                except wire.WireVersionError as err:
                    # rolling-restart skew: every further frame from
                    # this peer is unparseable — fail THIS rank loudly
                    # (stop unblocks the actor's run loop into its
                    # incomplete-run error) instead of silently
                    # dropping traffic forever
                    self.note_receive(_HDR.size + length)
                    telemetry.flight_dump(
                        "wire_version_mismatch", rank=self.rank,
                        detail=str(err),
                    )
                    print(f"rank {self.rank}: {err}", file=sys.stderr)
                    self.stop()
                    return
                msg = Message.decode(payload)
                self.note_receive(_HDR.size + length, msg.msg_type)
                self.deliver(msg)

    # -- send side ---------------------------------------------------------
    def _rank_lock(self, rank: int) -> threading.Lock:
        with self._lock:
            lock = self._rank_locks.get(rank)
            if lock is None:
                lock = self._rank_locks[rank] = threading.Lock()
            return lock

    def send_message(self, msg: Message) -> None:
        payload = msg.encode()
        corrupt_seed = getattr(msg, "chaos_corrupt", None)
        if corrupt_seed is not None:
            # the chaos 'corrupt' fault marked this message: flip
            # seeded bits in the SEALED frame (after the CRC was
            # computed, so the receiver's checksum catches it)
            sealed = wire.flip_bits(
                wire.seal(payload), corrupt_seed
            )
            frame = _HDR.pack(len(sealed)) + sealed
        else:
            # single join: length prefix + 5-byte seal + payload — the
            # payload is the multi-MB model frame on sync/result sends,
            # so an intermediate sealed copy is a real cost
            frame = b"".join((
                _HDR.pack(wire.SEAL_OVERHEAD + len(payload)),
                wire.seal_header(payload),
                payload,
            ))
        self.note_send(msg, len(frame))
        self._send_wire(msg.receiver, frame)

    def _evict(self, rank: int) -> None:
        with self._lock:
            sock = self._conns.pop(rank, None)
        if sock is not None:
            telemetry.METRICS.inc("transport.reconnects")
            try:
                sock.close()
            except OSError:
                pass

    def _send_once(self, rank: int, frame: bytes) -> None:
        """One attempt: reuse (or open) the pooled connection, ship the
        frame. Raises OSError/socket.timeout on a dead or wedged peer.
        The send timeout bounds the WHOLE ``sendall`` (python >= 3.5
        semantics), so it scales with the frame size — a legitimate
        slow bulk transfer must not be indistinguishable from a stall."""
        with self._lock:
            sock = self._conns.get(rank)
        if sock is None:
            host, port = self.ip_config[rank]
            sock = socket.create_connection(
                (host, port), timeout=_SOCKET_TIMEOUT_S
            )
            with self._lock:
                self._conns[rank] = sock
        sock.settimeout(
            max(_SOCKET_TIMEOUT_S, len(frame) / _MIN_SEND_BPS)
        )
        sock.sendall(frame)

    def _send_wire(self, rank: int, frame: bytes) -> None:
        """Ship pre-framed bytes to ``rank`` over the pooled connection,
        with exponential-backoff retries and a per-op deadline (peer
        restarted / broken pipe / not yet bound). Subclasses with their
        own wire format (tensor_rpc) reuse this for the connection
        machinery. A half-sent frame poisons the stream, so every retry
        starts on a FRESH connection (``_evict`` between attempts)."""
        with self._rank_lock(rank):
            call_with_retry(
                lambda: self._send_once(rank, frame),
                policy=self.retry,
                retry_on=(OSError,),
                describe=f"tcp send rank {self.rank} -> {rank}",
                seed=self.rank * 1000 + rank,
                stop=self._stopped,
                cleanup=lambda: self._evict(rank),
            )

    def stop(self) -> None:
        super().stop()
        if self._server is not None:
            self._server.close()
        with self._lock:
            for sock in self._conns.values():
                try:
                    sock.close()
                except OSError:
                    pass
            self._conns.clear()
