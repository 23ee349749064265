"""The port's wire layer against the JAX package's: the native
tensor-frame codec (frames byte-identical, native and pure paths equal,
crc32 zlib's), the Message envelope on torch tensors, loopback and TCP
echo, retry's backoff, the chaos fault stream replayed from its seed,
and the heartbeat monitor."""

import random
import socket
import threading
import time

import numpy as np
import pytest
import torch

from fedml_tpu.native.codec import TensorCodec as JaxCodec
from fedml_tpu_torch.core.manager import Manager, create_transport
from fedml_tpu_torch.core.message import (
    MSG_TYPE_HEARTBEAT,
    MSG_TYPE_S2C_SYNC_MODEL,
    Message,
)
from fedml_tpu_torch.core.transport import wire
from fedml_tpu_torch.core.transport.base import BaseTransport
from fedml_tpu_torch.core.transport.chaos import ChaosTransport, FaultPolicy
from fedml_tpu_torch.core.transport.loopback import LoopbackHub
from fedml_tpu_torch.core.transport.retry import (
    RetryExhausted,
    RetryPolicy,
    call_with_retry,
)
from fedml_tpu_torch.native import codec
from tests.torch_threads import one_torch_thread  # noqa: F401

DTYPES = ("float32", "float64", "int32", "int64", "uint8", "bool",
          "float16", "int8", "uint16", "uint32", "uint64", "int16")


def free_ports(n: int) -> list[int]:
    """``n`` ports the kernel hands out for port 0 (then released)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


# -- the codec -------------------------------------------------------------


def test_frames_match_jax_for_every_dtype():
    rng = np.random.default_rng(0)
    arrays = [(rng.standard_normal((3, 5, 7)) * 50).astype(d)
              for d in DTYPES]
    arrays += [np.zeros((0, 4), np.float32), np.float32(2.5).reshape(()),
               np.arange(12, dtype=np.int64).reshape(3, 4)[:, ::2]]
    want = JaxCodec().pack(arrays)
    native = codec.TensorCodec()
    assert native.native and codec.native_available()
    got = native.pack(arrays)
    assert got == want
    assert codec.TensorCodec(native=False).pack(arrays) == want
    for a, b in zip(native.unpack(got), arrays):
        b = np.ascontiguousarray(b)  # a 0-d array packs as (1,), as in JAX
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert codec.library_path().parent.name == "native"
    assert not codec.codec_supports(np.dtype("complex64"))
    with pytest.raises(ValueError):
        native.unpack(b"XXXX" + got[4:])


def test_threaded_gather_frames_match_pure():
    """A payload large enough for two gather threads packs to the pure
    path's frame; a ResNet-56 payload (3,440,104 bytes) takes one."""
    assert codec.gather_threads(3_440_104) == 1
    assert codec.gather_threads(20 << 20) == 2
    assert codec.gather_threads(1 << 30) == 4
    rng = np.random.default_rng(1)
    arrays = [rng.standard_normal(n).astype(np.float32)
              for n in (3 << 20, 1 << 20, 17, 1 << 20)]
    assert codec.gather_threads(sum(a.nbytes for a in arrays)) == 2
    native = codec.TensorCodec()
    assert native.native
    assert native.pack(arrays) == codec.TensorCodec(native=False).pack(arrays)


def test_crc32_is_zlibs():
    import zlib

    for n in (0, 1, 7, 4096, 100_003):
        buf = np.random.default_rng(n).integers(0, 256, n, np.uint8)
        assert codec.crc32(buf.tobytes()) == zlib.crc32(buf.tobytes())


# -- the envelope ----------------------------------------------------------


def test_message_roundtrip_with_tensors():
    big = torch.arange(600, dtype=torch.float32).reshape(20, 30)
    msg = Message(MSG_TYPE_S2C_SYNC_MODEL, 0, 3, {
        "model_params": {"w": big, "b": torch.ones(3),
                         "h": torch.full((200,), 1.5, dtype=torch.bfloat16)},
        "round_idx": 7,
        "rows": [np.arange(100, dtype=np.int64), (1, "x")],
    }, trace=("t" * 16, "s" * 16))
    meta, frame = msg.encode_parts()
    # only the two large codec-typed arrays ride the frame
    assert len(codec.TensorCodec().unpack(frame)) == 2
    out = Message.decode(msg.encode())
    assert (out.msg_type, out.sender, out.receiver) == (2, 0, 3)
    assert out.trace == ("t" * 16, "s" * 16)
    p = out.payload["model_params"]
    np.testing.assert_array_equal(p["w"], big.numpy())
    assert isinstance(p["b"], np.ndarray) and p["b"].dtype == np.float32
    # bf16 has no numpy type: a CPU tensor on the pickle side
    assert isinstance(p["h"], torch.Tensor) and p["h"].dtype == torch.bfloat16
    assert torch.equal(p["h"], msg.payload["model_params"]["h"])
    np.testing.assert_array_equal(out.payload["rows"][0], np.arange(100))
    assert out.payload["rows"][1] == (1, "x") and out.get("round_idx") == 7
    with pytest.raises(ValueError):
        Message.decode(b"nope")


# -- transports ------------------------------------------------------------


def _echo_world(transport_a, transport_b):
    """rank 0 sends to rank 1; rank 1 replies doubled; rank 0 records."""
    got = []

    class Echo(Manager):
        def __init__(self, rank, t):
            super().__init__(rank, 2, t)
            self.register_message_receive_handler(10, self.on10)
            self.register_message_receive_handler(11, self.on11)

        def on10(self, msg):
            self.send_message(Message(11, self.rank, msg.sender,
                                      {"v": msg.get("v") * 2}))

        def on11(self, msg):
            got.append(msg.get("v"))
            self.finish()

    m0, m1 = Echo(0, transport_a), Echo(1, transport_b)
    t1 = threading.Thread(target=m1.run, daemon=True)
    t1.start()
    transport_a.start()
    m0.send_message(Message(10, 0, 1, {"v": torch.full((100,), 21.0)}))
    m0.run()
    m1.finish()
    t1.join(timeout=10)
    assert not t1.is_alive()
    np.testing.assert_array_equal(got[0], np.full(100, 42.0, np.float32))
    return got


def test_loopback_echo():
    hub = LoopbackHub()
    _echo_world(hub.create(0), hub.create(1))


def test_tcp_echo_counts_its_bytes():
    ports = free_ports(2)
    ip = {r: ("127.0.0.1", p) for r, p in enumerate(ports)}
    a = create_transport("tcp", 0, ip_config=ip)
    b = create_transport("tcp", 1, ip_config=ip)
    b.start()
    _echo_world(a, b)
    assert a.bytes_sent > 400 and b.bytes_received == a.bytes_sent


def test_create_transport_refuses_what_is_not_ported():
    for backend in ("grpc", "trpc", "pubsub", "pubsub_blob"):
        with pytest.raises(NotImplementedError, match="item 14b"):
            create_transport(backend, 0, ip_config={})
    with pytest.raises(ValueError):
        create_transport("carrier_pigeon", 0)


def test_sealed_frames_detect_corruption_and_skew():
    payload = b"model bytes" * 10
    sealed = wire.seal(payload)
    assert bytes(wire.open_sealed(sealed)) == payload
    with pytest.raises(wire.CorruptFrameError):
        wire.open_sealed(wire.flip_bits(sealed, seed=3))
    with pytest.raises(wire.WireVersionError, match="pre-seal"):
        wire.open_sealed(b"F" + sealed[1:])


# -- retry -----------------------------------------------------------------


def test_retry_backoff_schedule_and_success():
    policy = RetryPolicy(max_attempts=5, base_delay_s=0.1, max_delay_s=1.0,
                         multiplier=2.0, jitter=0.0)
    rng = random.Random(0)
    assert [policy.delay(k, rng) for k in range(5)] == [0.1, 0.2, 0.4, 0.8,
                                                        1.0]
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    out = call_with_retry(flaky, policy=RetryPolicy(
        max_attempts=5, base_delay_s=0.001, deadline_s=5.0))
    assert out == "ok" and len(calls) == 3


def test_retry_exhaustion_raises_with_cause_and_runs_cleanup():
    evicted = []

    def always_down():
        raise ConnectionRefusedError("down")

    with pytest.raises(RetryExhausted) as ei:
        call_with_retry(always_down, policy=RetryPolicy(
            max_attempts=3, base_delay_s=0.001, deadline_s=1.0),
            describe="probe", cleanup=lambda: evicted.append(1))
    assert isinstance(ei.value.__cause__, ConnectionRefusedError)
    assert "probe" in str(ei.value) and len(evicted) == 3
    stop = threading.Event()
    stop.set()
    t0 = time.monotonic()
    with pytest.raises(RetryExhausted):
        call_with_retry(always_down, policy=RetryPolicy(
            max_attempts=10, base_delay_s=1.0, deadline_s=60.0), stop=stop)
    assert time.monotonic() - t0 < 0.5  # no backoff sleep taken


# -- chaos -----------------------------------------------------------------


class _RecordingTransport(BaseTransport):
    def __init__(self, rank=0):
        super().__init__(rank)
        self.sent: list[Message] = []

    def send_message(self, msg: Message) -> None:
        self.sent.append(msg)


def _drive_chaos(policy: FaultPolicy, n=200):
    inner = _RecordingTransport()
    chaos = ChaosTransport(inner, policy)
    for i in range(n):
        chaos.send_message(Message(100, 0, 1, {"i": i}))
    time.sleep(0.4)  # delay timers and reorder flushes settle
    return inner, chaos


def test_chaos_fault_stream_replays_from_its_seed():
    kw = dict(drop_prob=0.2, dup_prob=0.1, delay_prob=0.1,
              delay_max_s=0.01, reorder_prob=0.1)
    a_inner, a = _drive_chaos(FaultPolicy(seed=7, **kw))
    b_inner, b = _drive_chaos(FaultPolicy(seed=7, **kw))
    assert a.stats == b.stats
    assert a.stats["dropped"] > 0 and a.stats["duplicated"] > 0
    delivered = sorted(m.get("i") for m in a_inner.sent)
    assert delivered == sorted(m.get("i") for m in b_inner.sent)
    c_inner, _ = _drive_chaos(FaultPolicy(seed=8, **kw))
    assert sorted(m.get("i") for m in c_inner.sent) != delivered
    # protected types consume no draw and always ship
    hb = _RecordingTransport()
    ChaosTransport(hb, FaultPolicy(seed=7, drop_prob=1.0)).send_message(
        Message(MSG_TYPE_HEARTBEAT, 0, 1, {}))
    assert len(hb.sent) == 1


def test_chaos_crash_at_round_goes_silent():
    inner = _RecordingTransport()
    chaos = ChaosTransport(inner, FaultPolicy(crash_at_round=2))
    seen = []

    class Obs:
        def receive_message(self, t, m):
            seen.append(m)

    chaos.add_observer(Obs())
    threading.Thread(target=chaos.handle_receive_message,
                     daemon=True).start()
    inner.deliver(Message(1, 0, 1, {"round_idx": 0}))
    inner.deliver(Message(1, 0, 1, {"round_idx": 1}))
    deadline = time.monotonic() + 5
    while len(seen) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert [m.get("round_idx") for m in seen] == [0, 1]
    inner.deliver(Message(1, 0, 1, {"round_idx": 2}))  # the fatal one
    time.sleep(0.2)
    assert chaos.crashed.is_set() and len(seen) == 2
    chaos.send_message(Message(3, 1, 0, {"after": True}))
    assert inner.sent == []  # a dead rank sends nothing
    chaos.stop()
    with pytest.raises(ValueError):
        FaultPolicy(crash_mode="explode")


# -- liveness --------------------------------------------------------------


def test_heartbeat_monitor_detects_silent_peer_once():
    hub = LoopbackHub()
    a = Manager(0, 3, hub.create(0))
    b = Manager(1, 3, hub.create(1))
    hub.create(2)  # rank 2 exists but never answers
    dead = []
    tb = threading.Thread(target=b.run, daemon=True)
    tb.start()
    mon = a.enable_liveness([1, 2], interval_s=0.05, timeout_s=0.4,
                            on_dead=dead.append)
    ta = threading.Thread(target=a.run, daemon=True)
    ta.start()
    time.sleep(1.2)
    assert dead == [2]  # once, and never the live peer
    assert mon.dead_snapshot() == {2}
    with pytest.raises(RuntimeError):
        a.enable_liveness([1])
    a.finish()
    b.finish()
    ta.join(timeout=5)
    tb.join(timeout=5)
