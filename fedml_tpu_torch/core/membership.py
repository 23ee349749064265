"""Dynamic world membership: the server-side ledger of who is in the run.

The reference FedML's MQTT/cross-device path exists because real
federated populations churn — devices appear, vanish, and reappear
continuously — yet both the reference's MPI path and (until this module)
this runtime froze the world at launch: a JOIN from a rank outside the
initial ``world_size`` was silently dropped, and every per-rank state
array assumed ``rank < world_size``. FedJAX (arxiv 2108.02117) stops at
fixed-population simulation; the ROADMAP north-star ("millions of
users") demands a world that grows and shrinks mid-run.

:class:`MembershipLedger` is the single source of truth the
:class:`~fedml_tpu_torch.algorithms.distributed_fedavg.FedAvgServerActor`
consults (docs/FAULT_TOLERANCE.md "Elastic membership"):

- **Admission** — a ``MSG_TYPE_C2S_JOIN`` from a rank *beyond* the
  launch world is admitted with a stable client id derived purely from
  its rank (``(rank - 1) % num_clients`` — the same id it would have
  been assigned had it been present at launch, so a late joiner derives
  the same seeded data shards as an original member of that rank).
  Per-round WORK assignment stays the reference's: the server samples
  a cohort of client ids and deals it over the member ranks by their
  position in the SORTED active set — so admission order cannot
  perturb any assignment (the slot map depends only on the member
  set), a full world trains each rank on exactly its rank-derived id,
  and a shrunken world keeps every sampled cohort entry covered by
  re-dealing rather than leaving a departed rank's slice untrained.
  Admission takes effect at the NEXT round boundary
  (``active_from = current_round + 1``): a member admitted mid-round
  must not raise the in-flight round's quorum bar for a sync it never
  received.
- **Graceful departure** — ``MSG_TYPE_C2S_LEAVE`` marks the rank LEFT:
  distinct from a crash (no restart budget spent, no dead-peer flight
  dump, no quarantine suspicion). A LEFT rank may JOIN again later.
- **Eviction** — permanent ban: subsequent JOINs are rejected and
  counted (``membership.rejected_joins``). Nothing un-evicts a rank
  short of a fresh run directory.

State is four parallel int32 arrays (``ranks / status / client_id /
active_from``) so the ledger rides the server's
:class:`~fedml_tpu_torch.utils.checkpoint.RoundCheckpointer` composite payload
— a SIGKILLed server does not forget who joined, left, or was banned,
and the arrays restore across a *different* relaunch ``world_size``
(the checkpoint, not the launch flag, is authoritative for membership).
"""

from __future__ import annotations

import threading

import numpy as np

from fedml_tpu_torch.core import telemetry

#: member status codes (the ``status`` checkpoint array)
ACTIVE = 0
LEFT = 1
EVICTED = 2

_STATUS_NAMES = {ACTIVE: "active", LEFT: "left", EVICTED: "evicted"}


class MembershipLedger:
    """Per-rank membership state for an elastic world.

    Thread-safe: admission/leave/evict arrive on transport dispatch
    threads while round closes read the active set under the server's
    own lock."""

    def __init__(self, world_size: int, num_clients: int):
        self.num_clients = num_clients
        self._lock = threading.Lock()
        # rank -> [status, client_id, active_from]
        self._members: dict[int, list[int]] = {
            r: [ACTIVE, self.client_id_for(r), 0]
            for r in range(1, world_size)
        }

    # -- identity ----------------------------------------------------------

    def client_id_for(self, rank: int) -> int:
        """The rank's stable client identity: purely rank-derived, so a
        late joiner gets the SAME id (and therefore the same seeded data
        partition) it would have received at launch — admission order
        cannot perturb anyone's shards."""
        return (rank - 1) % max(1, self.num_clients)

    def _n_active_locked(self) -> int:
        """Caller holds ``self._lock``. The one definition of 'counts
        as active' the ``membership.active`` gauge reports after every
        transition."""
        return sum(
            1 for v in self._members.values() if v[0] == ACTIVE
        )

    # -- transitions -------------------------------------------------------

    def admit(self, rank: int, round_idx: int, *,
              immediate: bool = False) -> str:
        """Process a JOIN. Returns the verdict:

        - ``"member"`` — already an active member (a rejoin after a
          crash; the caller runs the JOIN/WELCOME rejoin protocol).
        - ``"admitted"`` — new or returning (LEFT) rank, now ACTIVE
          from round ``round_idx + 1`` (or ``round_idx`` itself with
          ``immediate`` — the caller's round is not in flight, so there
          is no quorum bar the admission could retroactively raise).
        - ``"rejected"`` — permanently evicted; the JOIN is dropped
          (and never ACKed, so the client times out loudly instead of
          idling forever against a world that will never serve it).
        """
        with self._lock:
            rec = self._members.get(rank)
            if rec is not None and rec[0] == EVICTED:
                telemetry.METRICS.inc("membership.rejected_joins")
                telemetry.RECORDER.record(
                    "join_rejected", peer=rank, round=round_idx
                )
                return "rejected"
            if rec is not None and rec[0] == ACTIVE:
                return "member"
            returning = rec is not None
            self._members[rank] = [
                ACTIVE, self.client_id_for(rank),
                round_idx if immediate else round_idx + 1
            ]
            n_active = self._n_active_locked()
        telemetry.METRICS.inc("membership.joins")
        telemetry.METRICS.gauge("membership.active", n_active)
        telemetry.RECORDER.record(
            "member_admitted", peer=rank, round=round_idx,
            returning=returning,
        )
        return "admitted"

    def leave(self, rank: int, round_idx: int) -> bool:
        """Graceful departure. Returns True if the rank was active."""
        with self._lock:
            rec = self._members.get(rank)
            if rec is None or rec[0] != ACTIVE:
                return False
            rec[0] = LEFT
            rec[2] = round_idx
            n_active = self._n_active_locked()
        telemetry.METRICS.inc("membership.leaves")
        telemetry.METRICS.gauge("membership.active", n_active)
        telemetry.RECORDER.record("member_left", peer=rank,
                                  round=round_idx)
        return True

    def evict(self, rank: int, round_idx: int) -> None:
        """Permanent ban; future JOINs from this rank are rejected."""
        with self._lock:
            rec = self._members.get(rank)
            if rec is not None and rec[0] == EVICTED:
                return
            cid = (rec[1] if rec is not None
                   else self.client_id_for(rank))
            self._members[rank] = [EVICTED, cid, round_idx]
            n_active = self._n_active_locked()
        telemetry.METRICS.inc("membership.evictions")
        telemetry.METRICS.gauge("membership.active", n_active)
        telemetry.RECORDER.record("member_evicted", peer=rank,
                                  round=round_idx)

    # -- queries -----------------------------------------------------------

    def active_ranks(self, round_idx: int | None = None) -> list[int]:
        """Sorted ACTIVE ranks. With ``round_idx``, only members whose
        admission has taken effect (``active_from <= round_idx``) — a
        mid-round admission waits for the next boundary."""
        with self._lock:
            return sorted(
                r for r, v in self._members.items()
                if v[0] == ACTIVE
                and (round_idx is None or v[2] <= round_idx)
            )

    def is_active(self, rank: int) -> bool:
        with self._lock:
            rec = self._members.get(rank)
            return rec is not None and rec[0] == ACTIVE

    def status(self, rank: int) -> str | None:
        with self._lock:
            rec = self._members.get(rank)
            return None if rec is None else _STATUS_NAMES[rec[0]]

    def client_id(self, rank: int) -> int:
        with self._lock:
            rec = self._members.get(rank)
            return (rec[1] if rec is not None
                    else self.client_id_for(rank))

    def summary(self) -> dict:
        """Run-summary view: rank lists per status."""
        with self._lock:
            out: dict[str, list[int]] = {
                name: [] for name in _STATUS_NAMES.values()
            }
            for r, v in sorted(self._members.items()):
                out[_STATUS_NAMES[v[0]]].append(r)
            return out

    # -- checkpoint persistence (utils/checkpoint.py) ----------------------

    def state_arrays(self) -> dict[str, np.ndarray]:
        """Parallel int32 arrays for the round checkpointer (rides the
        server's composite payload next to ServerState + reputation)."""
        with self._lock:
            ranks = sorted(self._members)
            return {
                "ranks": np.asarray(ranks, np.int32),
                "status": np.asarray(
                    [self._members[r][0] for r in ranks], np.int32
                ),
                "client_id": np.asarray(
                    [self._members[r][1] for r in ranks], np.int32
                ),
                "active_from": np.asarray(
                    [self._members[r][2] for r in ranks], np.int32
                ),
            }

    def load_arrays(self, blob: dict) -> None:
        """Restore from a checkpoint — REPLACES the launch-derived
        membership entirely: after a server restart the checkpoint, not
        the relaunch ``world_size``, is authoritative (that is what lets
        a grown/shrunk world survive a SIGKILL)."""
        ranks = np.asarray(blob["ranks"], np.int32).ravel()
        status = np.asarray(blob["status"], np.int32).ravel()
        cid = np.asarray(blob["client_id"], np.int32).ravel()
        active_from = np.asarray(blob["active_from"], np.int32).ravel()
        if not (len(ranks) == len(status) == len(cid)
                == len(active_from)):
            raise ValueError(
                "membership checkpoint arrays disagree on length: "
                f"{len(ranks)}/{len(status)}/{len(cid)}/"
                f"{len(active_from)}"
            )
        with self._lock:
            self._members = {
                int(r): [int(s), int(c), int(a)]
                for r, s, c, a in zip(ranks, status, cid, active_from)
            }
