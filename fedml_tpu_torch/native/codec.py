"""ctypes binding of the tensor-frame codec (``codec.cpp``).

``codec.cpp`` is the JAX package's C++ source, copied: a multi-threaded
gather of many buffers into one frame and a table-driven CRC32. The
binding sets the gather's threads from the payload's size
(:func:`gather_threads`). It builds the library with ``g++`` on first
use into ``build/native/`` at the repository root; the library's file
name carries a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. Several processes may
build at once (every rank of a deployment on one host): each compiles
into its own temporary file and renames it into place.

A frame is byte-identical to the JAX package's ``TensorCodec.pack`` for
the same arrays: a little-endian header (magic ``FTC1``, the count, each
tensor's dtype code, rank, dims and byte count, the payload start)
followed by the 8-byte-aligned raw buffers. ``unpack`` returns zero-copy
numpy views into the frame.

The pure-numpy pack (``TensorCodec(native=False)``) is the plain version
the native one is held against. ``TensorCodec()`` uses the library; if the
library cannot be built, it says so on stderr once, with the compiler's
message, and packs with the pure path (:func:`native_available` is then
False: a deployment that needs the native path asserts it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import sys
import threading
import zlib
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "codec.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")
_lock = threading.Lock()
_lib = None
_error: str | None = None

_DTYPES = [
    np.dtype("float32"), np.dtype("float64"), np.dtype("int32"),
    np.dtype("int64"), np.dtype("uint8"), np.dtype("bool"),
    np.dtype("float16"), np.dtype("int8"), np.dtype("uint16"),
    np.dtype("uint32"), np.dtype("uint64"), np.dtype("int16"),
]
_DTYPE_CODE = {d: i for i, d in enumerate(_DTYPES)}
_MAGIC = b"FTC1"
# the gather's threads: one for each _BYTES_PER_THREAD of payload, at
# most _MAX_THREADS (a ResNet-56 payload, 3.4 MB in 287 buffers, takes
# one: the threads' start costs more than they copy)
_BYTES_PER_THREAD = 8 << 20
_MAX_THREADS = 4


def codec_supports(dtype) -> bool:
    """Whether the frame codec carries this dtype (bf16, complex and
    object arrays stay on the pickle side)."""
    try:
        return np.dtype(dtype) in _DTYPE_CODE
    except TypeError:
        return False


def library_path() -> Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"_codec-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f".{target.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}): "
                           f"{proc.stderr.strip()}")
    os.replace(tmp, target)
    return target


def _load():
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as err:
            _error = f"{type(err).__name__}: {err}"
            print(f"fedml_tpu_torch.native: the tensor-frame codec did not "
                  f"build ({_error}); frames are packed by the pure-numpy "
                  "path", file=sys.stderr)
            return None
        lib.fedml_crc32.restype = ctypes.c_uint32
        lib.fedml_crc32.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        u64s = ctypes.POINTER(ctypes.c_uint64)
        lib.fedml_copy_gather.argtypes = [
            ctypes.c_void_p, ptrs, u64s, u64s, ctypes.c_uint32,
            ctypes.c_uint32,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    """True once the library is built and loaded (builds it if needed)."""
    return _load() is not None


def native_error() -> str | None:
    """Why the library is not in use (None while it is, or untried)."""
    return _error


def crc32(buf: bytes) -> int:
    """CRC32 (zlib's polynomial and value) by the library, or zlib."""
    lib = _load()
    if lib is None:
        return zlib.crc32(buf) & 0xFFFFFFFF
    return int(lib.fedml_crc32(buf, len(buf)))


def gather_threads(nbytes: int) -> int:
    """The native gather's thread count for a payload of ``nbytes``."""
    return max(1, min(_MAX_THREADS, nbytes // _BYTES_PER_THREAD))


class TensorCodec:
    """Pack/unpack a flat list of numpy arrays into one contiguous frame:
    through the library when it built (:attr:`native`), or with
    ``native=False`` by the pure path."""

    def __init__(self, native: bool = True):
        self.native = native and native_available()

    def pack(self, arrays: list[np.ndarray]) -> bytes:
        arrays = [np.ascontiguousarray(a) for a in arrays]
        header = bytearray(_MAGIC)
        header += struct.pack("<I", len(arrays))
        for a in arrays:
            header += struct.pack("<II", _DTYPE_CODE[a.dtype], a.ndim)
            header += struct.pack(f"<{a.ndim}q", *a.shape)
            header += struct.pack("<Q", a.nbytes)
        base = (len(header) + 8 + 7) & ~7  # + the u64 payload start
        header += struct.pack("<Q", base)
        offsets, sizes, cur = [], [], base
        for a in arrays:
            offsets.append(cur)
            sizes.append(a.nbytes)
            cur = (cur + a.nbytes + 7) & ~7
        frame = bytearray(cur)
        frame[:len(header)] = header
        if not self.native or not arrays:
            for a, off in zip(arrays, offsets):
                frame[off:off + a.nbytes] = a.tobytes()
            return bytes(frame)
        n = len(arrays)
        srcs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrays])
        dst = (ctypes.c_char * len(frame)).from_buffer(frame)
        _lib.fedml_copy_gather(
            ctypes.addressof(dst),
            ctypes.cast(srcs, ctypes.POINTER(ctypes.c_void_p)),
            (ctypes.c_uint64 * n)(*sizes), (ctypes.c_uint64 * n)(*offsets),
            n, gather_threads(sum(sizes)),
        )
        del dst  # release the export before the bytearray is copied
        return bytes(frame)

    def unpack(self, frame) -> list[np.ndarray]:
        view = memoryview(frame)
        if bytes(view[:4]) != _MAGIC:
            raise ValueError("bad tensor frame")
        pos = 4
        (n,) = struct.unpack_from("<I", view, pos)
        pos += 4
        metas = []
        for _ in range(n):
            code, ndim = struct.unpack_from("<II", view, pos)
            pos += 8
            shape = struct.unpack_from(f"<{ndim}q", view, pos)
            pos += 8 * ndim
            (nbytes,) = struct.unpack_from("<Q", view, pos)
            pos += 8
            metas.append((_DTYPES[code], shape, nbytes))
        (cur,) = struct.unpack_from("<Q", view, pos)
        out = []
        for dtype, shape, nbytes in metas:
            out.append(np.frombuffer(view[cur:cur + nbytes],
                                     dtype=dtype).reshape(shape))
            cur = (cur + nbytes + 7) & ~7
        return out
