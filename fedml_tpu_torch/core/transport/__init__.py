"""Transports of the deployment runtime (``fedml_tpu.core.transport``).

One 4-method contract (the reference's ``BaseCommunicationManager``):

- ``LoopbackTransport`` — in memory, for tests and one-process worlds;
- ``TcpTransport``      — length-prefixed, sealed (version byte + CRC32)
  frames over sockets, with pooled connections and retries;
- ``ChaosTransport``    — seeded, replayable fault injection over either.

The JAX package's grpc, trpc, pubsub and pubsub_blob transports are
ROADMAP Queue A item 14b: ``core/manager.py`` ``create_transport`` raises
``NotImplementedError`` for them.
"""

from fedml_tpu_torch.core.transport.base import BaseTransport, Observer
from fedml_tpu_torch.core.transport.chaos import ChaosTransport, FaultPolicy
from fedml_tpu_torch.core.transport.loopback import (
    LoopbackHub,
    LoopbackTransport,
)
from fedml_tpu_torch.core.transport.retry import RetryPolicy
from fedml_tpu_torch.core.transport.tcp import TcpTransport
