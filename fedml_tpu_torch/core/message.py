"""Message envelope of the deployment runtime (``fedml_tpu.core.message``).

A typed envelope ``(msg_type, sender, receiver)`` with a payload of any
nesting of dicts, lists and tuples (the reference's ``Message``,
``fedml_core/distributed/communication/message.py:5-81``), and the
message types and payload keys of the JAX package, with their numbers.

On the wire a message is ``MAGIC || meta_len || meta || tensor frame``:
the bulk arrays (numpy, at least 256 bytes, of a type the codec carries)
ride the native tensor frame (:mod:`fedml_tpu_torch.native.codec`,
byte-identical to the JAX package's), everything else is pickled into
``meta`` with :class:`_TensorRef` placeholders. The meta pickles this
package's own classes, so a JAX rank cannot read a port rank's message;
the tensor frame is the same bytes. The meta is unpickled on receipt, as
in the JAX package: the ranks of a world trust one another.

Torch tensors leave through :meth:`Message.host_copy`: a tensor on a card
goes to the host in one pinned device-to-host copy per dtype (the leaves
of a dtype concatenated on the card, one copy, one synchronize for the
whole payload), then numpy views. bfloat16 has no numpy type: it stays a
CPU tensor and rides the pickle side, as bf16 does in the JAX package
(the codec has no bf16). The receiving actor turns the arrays back into
tensors on its own device (:func:`to_tensors`).
"""

from __future__ import annotations

import dataclasses
import pickle
import struct
from typing import Any, Callable

import numpy as np
import torch

_WIRE_MAGIC = b"FMG1"
_HDR = struct.Struct("<Q")


@dataclasses.dataclass(frozen=True)
class _TensorRef:
    """Placeholder for an array lifted out of the pickled payload into the
    tensor frame."""

    idx: int


# the JAX package's message types (type 1 stays reserved there)
MSG_TYPE_S2C_SYNC_MODEL = 2
MSG_TYPE_C2S_RESULT = 3
MSG_TYPE_FINISH = 4
# a client announces that its receive endpoint is live
MSG_TYPE_C2S_READY = 5
# the server's reply to each READY: the control channel works both ways
MSG_TYPE_S2C_ACK = 6
# liveness beacon, either direction; any delivered message refreshes the
# receiver's last-seen table
MSG_TYPE_HEARTBEAT = 7
# a (re)started client's announcement: READY before the run is underway,
# a rejoin after (answered by WELCOME with the current round's sync)
MSG_TYPE_C2S_JOIN = 8
MSG_TYPE_S2C_WELCOME = 9
# a graceful departure (no restart, no suspicion)
MSG_TYPE_C2S_LEAVE = 10
# a leaf aggregator's partial reduction (the tier topology, item 14b)
MSG_TYPE_L2R_PARTIAL = 11

#: names of the per-type wire-byte counters
#: (``transport.bytes_by_type.<name>``)
MSG_TYPE_NAMES = {
    MSG_TYPE_S2C_SYNC_MODEL: "s2c_sync_model",
    MSG_TYPE_C2S_RESULT: "c2s_result",
    MSG_TYPE_FINISH: "finish",
    MSG_TYPE_C2S_READY: "c2s_ready",
    MSG_TYPE_S2C_ACK: "s2c_ack",
    MSG_TYPE_HEARTBEAT: "heartbeat",
    MSG_TYPE_C2S_JOIN: "c2s_join",
    MSG_TYPE_S2C_WELCOME: "s2c_welcome",
    MSG_TYPE_C2S_LEAVE: "c2s_leave",
    MSG_TYPE_L2R_PARTIAL: "l2r_partial",
}


def msg_type_name(msg_type: int) -> str:
    """Symbolic name of a message type (others: their integer)."""
    return MSG_TYPE_NAMES.get(msg_type, str(msg_type))


# payload keys (the reference's Message.MSG_ARG_KEY_*)
KEY_MODEL_PARAMS = "model_params"
KEY_NUM_SAMPLES = "num_samples"
KEY_CLIENT_INDEX = "client_index"
KEY_ROUND = "round_idx"
# a compressed result (core/compress.py) in place of KEY_MODEL_PARAMS:
# {"codec": method, "payload": {leaf: {part: array}}}
KEY_COMPRESSED = "compressed_delta"


def tree_map(fn: Callable, obj):
    """``fn`` over the leaves of nested dicts, lists and tuples."""
    if isinstance(obj, dict):
        return type(obj)((k, tree_map(fn, v)) for k, v in obj.items())
    if isinstance(obj, list):
        return [tree_map(fn, v) for v in obj]
    if isinstance(obj, tuple) and not hasattr(obj, "_fields"):
        return tuple(tree_map(fn, v) for v in obj)
    return fn(obj)


def _host_leaf(t: torch.Tensor):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.to("cpu", copy=True)  # the pickle side
    return t.to("cpu").numpy()


def to_host(payload):
    """Every torch tensor of ``payload`` as numpy (a bf16 one as a CPU
    tensor). The tensors on a card go through one pinned copy per dtype
    and a single synchronize."""
    leaves: list[torch.Tensor] = []

    def collect(v):
        if isinstance(v, torch.Tensor) and v.device.type == "cuda":
            leaves.append(v)
        return v

    tree_map(collect, payload)
    done: dict[int, Any] = {}
    if leaves:
        by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
        for t in leaves:
            by_dtype.setdefault(t.dtype, []).append(t)
        copies = []
        for dtype, group in by_dtype.items():
            flat = torch.cat([t.detach().reshape(-1) for t in group])
            host = torch.empty(flat.shape, dtype=dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            copies.append((group, host))
        torch.cuda.synchronize(leaves[0].device)
        for group, host in copies:
            off = 0
            for t in group:
                part = host[off:off + t.numel()].view(t.shape)
                off += t.numel()
                done[id(t)] = (part.clone() if t.dtype == torch.bfloat16
                               else part.numpy())

    def convert(v):
        if not isinstance(v, torch.Tensor):
            return v
        got = done.get(id(v))
        return got if got is not None else _host_leaf(v)

    return tree_map(convert, payload)


def to_tensors(payload, device: torch.device):
    """Every numpy array (and CPU tensor) of ``payload`` as a tensor on
    ``device``; to a card through pinned memory without blocking."""
    from fedml_tpu_torch.core.device import to_device

    def convert(v):
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v if v.flags.c_contiguous else v.copy())
        if isinstance(v, torch.Tensor):
            return to_device(v, device)
        return v

    return tree_map(convert, payload)


@dataclasses.dataclass
class Message:
    msg_type: int
    sender: int
    receiver: int
    payload: dict[str, Any] = dataclasses.field(default_factory=dict)
    # the cross-process trace context (trace_id, span_id), stamped by the
    # sending Manager while the tracer is on (None otherwise)
    trace: tuple[str, str] | None = None

    def get(self, key: str, default=None):
        return self.payload.get(key, default)

    def add(self, key: str, value: Any) -> "Message":
        self.payload[key] = value
        return self

    def host_copy(self) -> "Message":
        """The message with its tensors on the host (:func:`to_host`)."""
        return Message(self.msg_type, self.sender, self.receiver,
                       to_host(self.payload), trace=self.trace)

    def encode_parts(self) -> tuple[bytes, bytes]:
        """``(meta, tensor frame)``: the bulk arrays in the native frame,
        the rest pickled with placeholders."""
        from fedml_tpu_torch.native.codec import TensorCodec, codec_supports

        host = self.host_copy()
        arrays: list[np.ndarray] = []

        def strip(v):
            if (isinstance(v, np.ndarray) and v.nbytes >= 256
                    and codec_supports(v.dtype)):
                arrays.append(v)
                return _TensorRef(len(arrays) - 1)
            return v  # small and exotic values ride the pickle side

        meta = pickle.dumps(
            Message(self.msg_type, self.sender, self.receiver,
                    tree_map(strip, host.payload), trace=self.trace),
            protocol=5)
        frame = TensorCodec().pack(arrays) if arrays else b""
        return meta, frame

    @staticmethod
    def from_parts(meta, frame) -> "Message":
        """The inverse of :meth:`encode_parts`; ``frame`` may be any
        buffer. The arrays are copied out, so they do not pin the wire
        buffer."""
        msg = pickle.loads(meta)
        if not isinstance(msg, Message):
            raise ValueError(f"not a Message: {type(msg).__name__}")
        if frame:
            from fedml_tpu_torch.native.codec import TensorCodec

            arrays = [a.copy() for a in TensorCodec().unpack(frame)]
            msg.payload = tree_map(
                lambda v: arrays[v.idx] if isinstance(v, _TensorRef) else v,
                msg.payload)
        return msg

    def encode(self) -> bytes:
        meta, frame = self.encode_parts()
        return _WIRE_MAGIC + _HDR.pack(len(meta)) + meta + frame

    @staticmethod
    def decode(data) -> "Message":
        """``data`` may be any buffer (the sealed transports hand over a
        zero-copy view of the payload)."""
        view = memoryview(data)
        if bytes(view[:len(_WIRE_MAGIC)]) != _WIRE_MAGIC:
            raise ValueError("not a message frame (no FMG1 magic)")
        off = len(_WIRE_MAGIC)
        (meta_len,) = _HDR.unpack_from(view, off)
        off += _HDR.size
        return Message.from_parts(view[off:off + meta_len],
                                  view[off + meta_len:])
