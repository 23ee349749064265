"""Cross-round client reputation: accumulate anomaly scores, quarantine.

Per-round defenses (:mod:`fedml_tpu_torch.core.robust`) look at ONE cohort's
deltas; a patient adversary that poisons a little every round slides
under any single-round threshold. The reputation plane integrates over
time: every reporting client's per-round anomaly score
(:func:`fedml_tpu_torch.core.robust.anomaly_scores`) feeds an EWMA, and a
client whose accumulated score crosses ``threshold`` is QUARANTINED —
excluded from aggregation but still served (it keeps receiving syncs
and its results keep being scored), so a false positive whose behavior
normalizes earns its way back out (``release`` hysteresis below the
trip threshold). A client that goes silent keeps its score frozen:
leaving and rejoining does not launder a reputation — which is exactly
the interplay with the JOIN/WELCOME rejoin protocol
(docs/FAULT_TOLERANCE.md): a quarantined client's JOIN is welcomed,
its results stay excluded.

State is two fixed-shape arrays (``scores[world]``,
``quarantined_at[world]``) so it persists through the server's
:class:`~fedml_tpu_torch.utils.checkpoint.RoundCheckpointer` alongside
``ServerState`` — a SIGKILLed server does not forget who it banned.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class QuarantinePolicy:
    """Reputation knobs. ``threshold <= 0`` disables quarantine (scores
    are still tracked when scoring runs).

    - ``threshold``: EWMA score above which a client is quarantined.
    - ``release_frac``: hysteresis — a quarantined client is released
      once its EWMA drops below ``threshold * release_frac``.
    - ``decay``: EWMA memory (``score = decay * old + (1-decay) *
      new``); higher = slower to trip AND slower to forgive.
    - ``warmup_rounds``: rounds at the start of a run during which
      scores accumulate but nobody trips (round-0 deltas are noisy).
    - ``evict_after``: rounds a rank may sit in quarantine without
      earning release before it is PERMANENTLY evicted from the
      membership ledger (docs/FAULT_TOLERANCE.md "Elastic
      membership"). 0 (default) = never escalate — quarantine stays
      recoverable forever.
    """

    threshold: float = 0.0
    release_frac: float = 0.5
    decay: float = 0.7
    warmup_rounds: int = 1
    evict_after: int = 0

    def __post_init__(self):
        if not (0.0 <= self.release_frac < 1.0):
            raise ValueError(
                f"release_frac must be in [0, 1), "
                f"got {self.release_frac}"
            )
        if not (0.0 <= self.decay < 1.0):
            raise ValueError(f"decay must be in [0, 1), got {self.decay}")
        if self.evict_after < 0:
            raise ValueError(
                f"evict_after must be >= 0, got {self.evict_after}"
            )

    def enabled(self) -> bool:
        return self.threshold > 0


class ReputationTracker:
    """Per-rank reputation for a ``size``-rank world (rank 0, the
    server, never quarantines itself — its slots stay zero).

    Elastic worlds (docs/FAULT_TOLERANCE.md "Elastic membership") grow
    past the launch ``world_size``: :meth:`ensure_size` extends the
    arrays for a newly admitted rank with a clean slate, and
    :meth:`load_arrays` accepts a checkpoint written by a DIFFERENT
    world size — the restored run keeps every score the checkpoint
    carries (leaving and rejoining, or restarting the server into a
    smaller launch world, must never launder a reputation)."""

    def __init__(self, size: int, policy: QuarantinePolicy | None = None):
        self.size = size
        self.policy = policy or QuarantinePolicy()
        self.scores = np.zeros(size, np.float32)
        # round at which the rank was quarantined; -1 = not quarantined
        self.quarantined_at = np.full(size, -1, np.int32)
        # elastic worlds mutate the tracker from more than one thread:
        # an admission's ensure_size arrives on the transport dispatch
        # thread while a round-deadline Timer (or liveness watchdog)
        # drives observe() through the round close — without this lock
        # an in-place observe write can land in an array concat just
        # discarded, silently losing the reputation update
        self._lock = threading.Lock()

    def ensure_size(self, size: int) -> None:
        """Grow the per-rank arrays to cover ``size`` ranks (new slots
        start clean: score 0, not quarantined). Shrinking never happens
        — a departed rank keeps its slot so a later rejoin resumes its
        accumulated reputation."""
        with self._lock:
            self._ensure_size_locked(size)

    def _ensure_size_locked(self, size: int) -> None:
        if size <= self.size:
            return
        pad = size - self.size
        self.scores = np.concatenate(
            [self.scores, np.zeros(pad, np.float32)]
        )
        self.quarantined_at = np.concatenate(
            [self.quarantined_at, np.full(pad, -1, np.int32)]
        )
        self.size = size

    # -- per-round update --------------------------------------------------

    def observe(self, round_idx: int, ranks: list[int],
                round_scores: np.ndarray) -> dict:
        """Fold one round's anomaly scores (``round_scores[i]`` belongs
        to ``ranks[i]``) into the EWMAs and apply the quarantine /
        release thresholds. Returns ``{"quarantined": [...],
        "released": [...], "suspected": [...]}`` — the NEW transitions
        plus the ranks whose instant score exceeded the threshold this
        round."""
        with self._lock:
            return self._observe_locked(round_idx, ranks, round_scores)

    def _observe_locked(self, round_idx, ranks, round_scores) -> dict:
        p = self.policy
        newly_q, released, suspected = [], [], []
        for rank, s in zip(ranks, np.asarray(round_scores, np.float32)):
            s = float(s)
            self.scores[rank] = (
                p.decay * self.scores[rank] + (1.0 - p.decay) * s
            )
            if not p.enabled():
                continue
            if s > p.threshold:
                suspected.append(rank)
            ewma = self.scores[rank]
            if self.quarantined_at[rank] < 0:
                if ewma > p.threshold and round_idx >= p.warmup_rounds:
                    self.quarantined_at[rank] = round_idx
                    newly_q.append(rank)
            elif ewma < p.threshold * p.release_frac:
                self.quarantined_at[rank] = -1
                released.append(rank)
        return {
            "quarantined": newly_q,
            "released": released,
            "suspected": suspected,
        }

    # -- queries -----------------------------------------------------------

    def is_quarantined(self, rank: int) -> bool:
        return bool(self.quarantined_at[rank] >= 0)

    def quarantined(self) -> list[int]:
        return [int(r) for r in np.nonzero(self.quarantined_at >= 0)[0]]

    def score(self, rank: int) -> float:
        return float(self.scores[rank])

    # -- checkpoint persistence (utils/checkpoint.py) ----------------------

    def state_arrays(self) -> dict[str, np.ndarray]:
        """Fixed-shape snapshot for the round checkpointer (rides the
        server's composite checkpoint payload)."""
        with self._lock:
            return {
                "scores": self.scores.copy(),
                "quarantined_at": self.quarantined_at.copy(),
            }

    def load_arrays(self, blob: dict) -> None:
        """Restore, tolerating a checkpoint written by a different
        world size: a larger checkpoint grows this tracker (an elastic
        run admitted ranks past the launch world before the crash); a
        smaller one restores into a clean-slate prefix (the world was
        relaunched bigger). Either way no saved score is dropped."""
        scores = np.asarray(blob["scores"], np.float32).ravel()
        qat = np.asarray(blob["quarantined_at"], np.int32).ravel()
        if scores.shape != qat.shape:
            raise ValueError(
                f"reputation checkpoint arrays disagree: scores "
                f"{scores.shape} vs quarantined_at {qat.shape}"
            )
        saved = scores.shape[0]
        with self._lock:
            self._ensure_size_locked(saved)
            self.scores = np.zeros(self.size, np.float32)
            self.quarantined_at = np.full(self.size, -1, np.int32)
            self.scores[:saved] = scores
            self.quarantined_at[:saved] = qat
