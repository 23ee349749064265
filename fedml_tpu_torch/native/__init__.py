"""Native (C++) runtime components, loaded with ctypes."""

from fedml_tpu_torch.native.codec import (  # noqa: F401
    TensorCodec,
    crc32,
    native_available,
)
