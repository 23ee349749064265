"""Sealed wire frames: protocol-version byte + CRC32 payload checksum.

The chaos transport covers drop/delay/dup/reorder/crash — every wire
failure class except CORRUPTION. A flipped bit in a pickled pytree is
the nastiest of the lot: without a checksum it either crashes the
decoder or, far worse, silently garbles a tensor that then aggregates
into the global model. This module closes that hole for the socket
codecs that ship raw frames (``tcp.py``; the pub/sub payloads that ride
``broker.py``'s daemon end to end):

``seal(payload)``  -> ``u8 version || u32 crc32(payload) || payload``
``open_sealed(b)`` -> payload, or raises

- :class:`CorruptFrameError` — CRC mismatch. The receiving transport
  counts ``transport.corrupt_frames`` and DROPS the frame; the
  fault-tolerance layer above (retry/heartbeat/straggler rounds,
  docs/FAULT_TOLERANCE.md) heals the loss like any drop.
- :class:`WireVersionError` — the version byte does not match. This is
  rolling-restart skew (one rank runs an older build with a different
  frame layout) and MUST fail loudly: treating mismatched framing as
  corruption would silently drop every message forever. The legacy
  pre-seal TCP frame is detected specifically (its first payload byte
  is ``FMG1``'s ``F``/0x46, never a version number) so the diagnostic
  names the actual problem.

gRPC keeps its own HTTP/2 integrity machinery and stays unsealed.
"""

from __future__ import annotations

import random
import struct
import zlib

#: bump when the sealed frame layout changes; receivers reject anything
#: else loudly (rolling-restart skew must not garble pytrees)
PROTOCOL_VERSION = 1

_SEAL_HDR = struct.Struct(">BI")  # version byte || crc32
SEAL_OVERHEAD = _SEAL_HDR.size

#: first byte of a legacy (pre-seal) message frame: the wire magic
#: ``FMG1`` of the Message codec
_LEGACY_MAGIC0 = ord("F")


class CorruptFrameError(ValueError):
    """CRC32 mismatch: the payload was damaged in flight. Count it,
    drop it, let retries/stragglers heal it."""


class WireVersionError(RuntimeError):
    """Frame carries a different protocol version — rolling-restart
    skew. Fail loudly; do not attempt to parse."""


def seal_header(payload) -> bytes:
    """The 5-byte seal for ``payload`` alone. Transports that build a
    frame from pieces anyway (length prefix + seal + payload) use this
    to skip ``seal``'s intermediate full-payload concatenation — on the
    model-sync path the payload is multi-MB and the extra copy is pure
    waste."""
    return _SEAL_HDR.pack(
        PROTOCOL_VERSION, zlib.crc32(payload) & 0xFFFFFFFF
    )


def seal(payload: bytes) -> bytes:
    """Wrap ``payload`` with the version byte + CRC32."""
    return seal_header(payload) + payload


def open_sealed(data):
    """Verify + strip the seal. Raises :class:`WireVersionError` on a
    version mismatch, :class:`CorruptFrameError` on a CRC mismatch.

    Returns a zero-copy :class:`memoryview` of the payload region —
    every downstream consumer (``Message.decode``, ``zlib``, ``pickle``)
    reads buffers, and copying the multi-MB model frames here would
    double the receive path's transient memory."""
    if len(data) < SEAL_OVERHEAD:
        raise CorruptFrameError(
            f"sealed frame truncated to {len(data)} bytes"
        )
    version, crc = _SEAL_HDR.unpack_from(data, 0)
    if version != PROTOCOL_VERSION:
        hint = (
            " (peer is running a pre-seal build — the legacy frame "
            "starts with the FMG1 message magic)"
            if version == _LEGACY_MAGIC0 else ""
        )
        raise WireVersionError(
            f"wire protocol version mismatch: got {version}, this "
            f"build speaks {PROTOCOL_VERSION}{hint}; rolling restarts "
            "must upgrade every rank of a world together"
        )
    payload = memoryview(data)[SEAL_OVERHEAD:]
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise CorruptFrameError(
            f"frame CRC mismatch over {len(payload)} payload bytes"
        )
    return payload


def flip_bits(frame: bytes, seed: int, n_flips: int = 3) -> bytes:
    """Seeded bit corruption of a SEALED frame (the chaos ``corrupt``
    fault, :mod:`fedml_tpu_torch.core.transport.chaos`): flips ``n_flips``
    bits anywhere past the version byte — the CRC field and the payload
    are both fair game, the version byte is not (corrupting it would
    exercise the skew path, which is a different failure class with its
    own fault)."""
    if len(frame) <= 1:
        return frame
    rng = random.Random(seed)
    buf = bytearray(frame)
    for _ in range(max(1, n_flips)):
        i = rng.randrange(1, len(buf))
        buf[i] ^= 1 << rng.randrange(8)
    return bytes(buf)
