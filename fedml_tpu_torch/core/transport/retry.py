"""Retry with exponential backoff + jitter and per-op deadlines.

The real transports each grew an ad-hoc recovery loop (tcp's one-shot
dead-socket retry, the broker client's fixed 0.2 s connect poll, grpc's
none at all). This module replaces them with one policy: capped
exponential backoff, seeded jitter (so N clients restarting against the
same server don't reconnect in lockstep), an overall per-op deadline,
and cooperative abort via the transport's stop event.

The reference has no equivalent — its MQTT path leans on paho's internal
reconnect and its gRPC path simply raises (``grpc_comm_manager.py``);
crash-recovery there is "restart the run".
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable, Iterable

from fedml_tpu_torch.core import telemetry


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff schedule + deadline for one logical operation (a connect,
    a send). Delay for attempt k (0-based) is
    ``min(max_delay_s, base_delay_s * multiplier**k)`` stretched by up to
    ``jitter`` (fraction, seeded)."""

    max_attempts: int = 6
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5
    deadline_s: float = 15.0  # overall wall-clock budget for the op
    # attempts the deadline may NOT cut short: a single SLOW failed
    # attempt (a bulk frame that died mid-transfer after outliving the
    # deadline) must still get its one fresh-connection retry — one
    # transient fault on a long transfer is not a dead peer
    min_attempts: int = 2

    def delay(self, attempt: int, rng: random.Random) -> float:
        d = min(self.max_delay_s, self.base_delay_s * self.multiplier**attempt)
        return d * (1.0 + self.jitter * rng.random())


class RetryExhausted(ConnectionError):
    """All attempts failed (or the deadline/stop event cut them short).
    ``__cause__`` is the last underlying error."""


def call_with_retry(
    fn: Callable,
    *,
    policy: RetryPolicy,
    retry_on: tuple[type[BaseException], ...] = (OSError,),
    describe: str = "op",
    seed: int = 0,
    stop: threading.Event | None = None,
    cleanup: Callable[[], None] | None = None,
):
    """Run ``fn()`` under ``policy``. ``cleanup`` runs between attempts
    (evict a dead pooled socket / channel). ``stop`` aborts immediately
    when set — a stopping transport must not sit out a backoff sleep."""
    rng = random.Random(seed)
    deadline = time.monotonic() + policy.deadline_s
    last: BaseException | None = None
    attempts = 0
    for attempt in range(policy.max_attempts):
        if stop is not None and stop.is_set():
            break
        attempts += 1
        try:
            return fn()
        except retry_on as err:
            last = err
            telemetry.METRICS.inc("transport.retry_attempts")
            telemetry.RECORDER.record(
                "retry", op=describe, attempt=attempts, error=repr(err)
            )
            if cleanup is not None:
                cleanup()
            pause = policy.delay(attempt, rng)
            if (attempts >= policy.min_attempts
                    and time.monotonic() + pause >= deadline):
                break
            if stop is not None:
                if stop.wait(pause):
                    break
            else:
                time.sleep(pause)
    telemetry.METRICS.inc("transport.retry_exhausted")
    telemetry.RECORDER.record(
        "retry_exhausted", op=describe, attempts=attempts, error=repr(last)
    )
    raise RetryExhausted(
        f"{describe} failed after {attempts} attempts "
        f"(budget {policy.max_attempts} / {policy.deadline_s}s): {last!r}"
    ) from last


def iter_attempts(
    policy: RetryPolicy, *, seed: int = 0, stop: threading.Event | None = None
) -> Iterable[int]:
    """Generator form for call sites whose attempt body doesn't fit a
    closure (multi-step connect + handshake): yields attempt indices,
    sleeping the backoff between them, until attempts/deadline/stop run
    out. The caller breaks out on success."""
    rng = random.Random(seed)
    deadline = time.monotonic() + policy.deadline_s
    for attempt in range(policy.max_attempts):
        if stop is not None and stop.is_set():
            return
        yield attempt
        pause = policy.delay(attempt, rng)
        if time.monotonic() + pause >= deadline:
            return
        if stop is not None:
            if stop.wait(pause):
                return
        else:
            time.sleep(pause)
