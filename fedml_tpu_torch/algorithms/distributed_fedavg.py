"""Actor-based distributed FedAvg over the message-passing runtime
(``fedml_tpu.algorithms.distributed_fedavg``).

Redesign of ``fedml_api/distributed/fedavg`` (``FedAvgAPI.py`` init and
rank split, ``FedAVGAggregator``, ``FedAVGTrainer``, the two managers,
``message_define.py``). Rank 0 is the server; rank ``r >= 1`` trains the
partition of client ``cohort[(r - 1) % len(cohort)]`` each round
(reference ``FedAvgAPI.py:36-66``).

The math is :class:`~fedml_tpu_torch.algorithms.fedavg.FedAvgSim`'s by
construction: a client's local update is the sim's batched step as one
lane (:class:`LocalTrainer`: ``CohortUpdate``, a CUDA graph a step on the
card), its batch orders come from the sim's function
(:func:`~fedml_tpu_torch.algorithms.fedavg.client_orders`), and the server
closes a round through the sim's ``server_update``. The draws (the
compressor's uniforms by slot ``rank - 1``, the adversaries' by rank, the
aggregate's noise) come from a ``draws`` hook as in the sim, so tests can
replay the JAX package's.

Around that math: straggler-tolerant rounds (:class:`RoundPolicy`: a
quorum of live workers closes a round at its deadline, the weighted mean
renormalizing over the survivors; an unreachable quorum raises
:class:`QuorumLostError` at the deploy layer), the membership ledger
(join, leave, evict, rejoin with WELCOME), keep-first dedup of results,
the non-finite and compressed-payload screens at the receive edge, the
reputation plane's cross-round quarantine, and checkpoint and resume of
the server's state, reputation and membership.

The JAX server compiles its aggregation per power-of-two bucket under
``elastic_buckets``; the port's server step is eager and has no program to
bucket, so ``elastic_buckets`` only opens the world to mid-run admissions.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Callable

import numpy as np
import torch

from fedml_tpu_torch.algorithms.base import CohortUpdate, make_task
from fedml_tpu_torch.algorithms.fedavg import (
    LocalSteps,
    ServerState,
    check_ported,
    client_orders,
    local_reducer,
    make_server_optimizer,
    server_update,
)
from fedml_tpu_torch.config import ExperimentConfig
from fedml_tpu_torch.core import adversary as A
from fedml_tpu_torch.core import compress as C
from fedml_tpu_torch.core import export as EXPORT
from fedml_tpu_torch.core import memscope as MEMSCOPE
from fedml_tpu_torch.core import random as R
from fedml_tpu_torch.core import robust, telemetry
from fedml_tpu_torch.core import tree as T
from fedml_tpu_torch.core.anatomy import ANATOMY
from fedml_tpu_torch.core.device import to_device
from fedml_tpu_torch.core.manager import ClientManager, ServerManager
from fedml_tpu_torch.core.membership import MembershipLedger
from fedml_tpu_torch.core.message import (
    KEY_CLIENT_INDEX,
    KEY_COMPRESSED,
    KEY_MODEL_PARAMS,
    KEY_NUM_SAMPLES,
    KEY_ROUND,
    MSG_TYPE_C2S_JOIN,
    MSG_TYPE_C2S_LEAVE,
    MSG_TYPE_C2S_RESULT,
    MSG_TYPE_FINISH,
    MSG_TYPE_S2C_SYNC_MODEL,
    MSG_TYPE_S2C_WELCOME,
    Message,
    to_host,
    to_tensors,
)
from fedml_tpu_torch.core.reputation import QuarantinePolicy, ReputationTracker
from fedml_tpu_torch.core.transport.base import BaseTransport
from fedml_tpu_torch.data.federated import FederatedData, arrays_and_batch
from fedml_tpu_torch.models.base import FedModel, Params
from fedml_tpu_torch.utils.checkpoint import from_savable


@dataclasses.dataclass(frozen=True)
class RoundPolicy:
    """Straggler tolerance of the server (Server Averaging for FL, arxiv
    2103.11619: progress from whichever updates arrive).

    - ``quorum_fraction``: the share of the round's LIVE workers whose
      results close the round once the deadline fires (the weighted mean
      renormalizes over the survivors' sample mass). 1.0 and no deadline
      is the strict everyone-reports round, the simulator's.
    - ``round_deadline_s``: the round's wall-clock budget. At expiry the
      round closes with a quorum or the run aborts with a diagnostic;
      None waits for every live worker (dead ones are still skipped
      through the heartbeat's dead-peer callback).
    - ``recovery_extensions``: how often a deadline that fires under
      quorum re-arms for the same round before the abort, so a
      restarted rank can rejoin."""

    quorum_fraction: float = 1.0
    round_deadline_s: float | None = None
    recovery_extensions: int = 0

    def __post_init__(self):
        if not 0.0 < self.quorum_fraction <= 1.0:
            raise ValueError(f"quorum_fraction must be in (0, 1], "
                             f"got {self.quorum_fraction}")
        if self.round_deadline_s is not None and self.round_deadline_s <= 0:
            raise ValueError(f"round_deadline_s must be positive or None, "
                             f"got {self.round_deadline_s}")
        if self.recovery_extensions < 0:
            raise ValueError(f"recovery_extensions must be >= 0, "
                             f"got {self.recovery_extensions}")
        if self.recovery_extensions and self.round_deadline_s is None:
            raise ValueError(
                "recovery_extensions requires round_deadline_s: "
                "extensions re-arm the round deadline, so without one "
                "there is nothing to extend and the quorum-lost abort "
                "would still fire immediately")


class QuorumLostError(RuntimeError):
    """The server could not assemble a quorum of client results."""


def _result_is_finite(params, n_k: float) -> bool:
    """True iff a result holds only finite floats (and a finite count)."""
    if not math.isfinite(n_k):
        return False
    for leaf in params.values():
        t = _host_tensor(leaf)
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            return False
    return True


def _host_tensor(v) -> torch.Tensor:
    """A payload leaf (numpy, or a CPU tensor for bf16) as a tensor."""
    if isinstance(v, torch.Tensor):
        return v
    a = np.asarray(v)  # (ascontiguousarray would make a 0-d array 1-d)
    return torch.from_numpy(a if a.flags.c_contiguous else a.copy())


def resolve_steps(data: FederatedData, dcfg) -> tuple[int, int]:
    """``(steps_per_epoch, batch_size)`` as ``arrays_and_batch`` resolves
    them (full-batch mode, a batch larger than the largest client),
    from the host index maps."""
    max_n = max(len(v) for v in data.train_idx_map.values())
    pad = 1 if dcfg.full_batch else dcfg.batch_size
    max_n = -(-max_n // pad) * pad
    batch = max_n if dcfg.full_batch else min(dcfg.batch_size, max_n)
    return max_n // batch, batch


def default_draws(cfg: ExperimentConfig, device, mask_keep=None
                  ) -> R.DeviceDraws:
    """The sim's draw streams, seeded as :class:`FedAvgSim` seeds them."""
    return R.DeviceDraws(
        {"noise": cfg.seed, "quant": cfg.seed, "gauss": cfg.adversary.seed,
         "collude": cfg.adversary.seed, "dropout": cfg.seed}, device,
        p={"dropout": mask_keep or {}})


def initial_state(model: FedModel, cfg: ExperimentConfig,
                  variables: Params | None = None) -> ServerState:
    """Round 0's server state, :meth:`FedAvgSim.init`'s (without PEFT:
    the actors train and ship the full model)."""
    if variables is None:
        variables = model.init(R.generator(cfg.seed, 0x7FFFFFFF))
    else:
        variables = {k: v.to(model.device, copy=True)
                     for k, v in variables.items()}
    params = {k: v for k, v in variables.items()
              if k not in model.stat_names}
    fed = cfg.fed
    opt = make_server_optimizer(fed.server_optimizer, fed.server_lr,
                                fed.server_momentum)
    return ServerState(variables, opt.init(params), T.tree_zeros_like(params),
                       0)


class FedAvgServerActor(ServerManager):
    """Rank-0 aggregator (reference ``FedAVGServerManager`` and
    ``FedAVGAggregator``): a round closes when every live worker reports,
    when the deadline fires with a quorum in hand, or aborts loudly when
    the quorum cannot be met. ``model`` lives on the server's device."""

    def __init__(
        self,
        size: int,
        transport: BaseTransport,
        model: FedModel,
        cfg: ExperimentConfig,
        num_clients: int,
        on_round_done: Callable[[int, dict], None] | None = None,
        initial_variables: Params | None = None,
        steps_per_epoch: int | None = None,
        batch_size: int | None = None,
        data: FederatedData | None = None,
        round_policy: RoundPolicy | None = None,
        checkpointer=None,
        checkpoint_every: int = 1,
        quarantine: QuarantinePolicy | None = None,
        draws: R.Draws | None = None,
    ):
        super().__init__(0, size, transport)
        check_ported(cfg)
        self.cfg = cfg
        self.num_clients = num_clients
        self.model = model
        self.device = model.device
        self.state = initial_state(model, cfg, initial_variables)
        if data is not None and (steps_per_epoch is None
                                 or batch_size is None):
            spe, rbatch = resolve_steps(data, cfg.data)
            batch_size = rbatch if batch_size is None else batch_size
            steps_per_epoch = spe if steps_per_epoch is None \
                else steps_per_epoch
        if cfg.fed.algorithm == "fednova" and (
                steps_per_epoch is None or batch_size is None):
            raise ValueError(
                "fednova server rule needs BOTH steps_per_epoch and "
                "batch_size (the RESOLVED values — full-batch mode and "
                "batch > max_n clamping change them): pass data= to "
                "resolve automatically, or both values explicitly")
        if steps_per_epoch is not None and steps_per_epoch < 1:
            raise ValueError(
                f"steps_per_epoch must be >= 1, got {steps_per_epoch}")
        if batch_size is not None and batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.local_steps = LocalSteps(
            cfg.data.batch_size if batch_size is None else batch_size,
            1 if steps_per_epoch is None else steps_per_epoch,
            cfg.train.epochs)
        self.draws = draws or default_draws(cfg, self.device)
        self.round_idx = 0
        self.round_t0 = time.monotonic()  # the current round's broadcast
        self.last_agg_s = 0.0  # the last close's aggregation seconds
        self._idle_gap_flagged = False
        self._results: dict[int, tuple[dict, float]] = {}
        self._lock = threading.Lock()
        self.on_round_done = on_round_done
        self.done = threading.Event()
        self.round_policy = round_policy or RoundPolicy()
        # the ledger, not the launch world_size, says who is served
        self._ledger = MembershipLedger(size, num_clients)
        self._elastic = bool(cfg.fed.elastic_buckets)
        self.dead_peers: set[int] = set()
        self.failure: str | None = None  # the quorum-lost diagnostic
        self._deadline_timer: threading.Timer | None = None
        # every armed deadline timer carries a generation: a superseded
        # timer whose callback already waits on the lock is void
        self._deadline_gen = 0
        self._extensions_used = 0
        # the current round's (round, host variables, cohort, slots): a
        # mid-round rejoiner's WELCOME replays exactly this sync
        self._round_sync: tuple | None = None
        # rank -> round of its last WELCOME (duplicate JOINs refresh the
        # watchdog and send nothing)
        self._welcomed: dict[int, int] = {}
        self._ckpt = checkpointer
        self.checkpoint_every = checkpoint_every
        self.resumed_from = 0
        self._pipeline = robust.DefensePipeline.from_fed(cfg.fed)
        robust.check_fednova_compat(cfg.fed.algorithm, self._pipeline.method)
        self._quarantine = quarantine or QuarantinePolicy()
        self._reputation = ReputationTracker(size, self._quarantine)
        self._cspec = C.CompressionSpec.from_fed(cfg.fed, seed=cfg.seed)
        self._payload_template = (
            C.payload_template(self._cspec, self.state.variables)
            if self._cspec.enabled() else None)
        if self._cspec.enabled():
            telemetry.METRICS.gauge(
                "compress.ratio",
                C.wire_ratio(self._cspec, self.state.variables))
        MEMSCOPE.MONITOR.attach(self.device, cfg.fed.mem_headroom_warn)
        if checkpointer is not None:
            self._restore(checkpointer, checkpoint_every)
        self.register_message_receive_handler(MSG_TYPE_C2S_RESULT,
                                              self._handle_result)
        # the deploy barrier re-registers JOIN with its wrapper
        self.register_message_receive_handler(
            MSG_TYPE_C2S_JOIN, lambda msg: self.on_peer_join(msg.sender))
        self.register_message_receive_handler(
            MSG_TYPE_C2S_LEAVE, lambda msg: self.on_peer_leave(msg.sender))
        EXPORT.register_status_source("server", self)

    def _restore(self, checkpointer, checkpoint_every: int) -> None:
        if checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be >= 1 with a "
                             f"checkpointer, got {checkpoint_every}")
        raw, start = checkpointer.restore_raw()
        if raw is None:
            return
        self.state = from_savable(self.state, raw["server"])
        self._reputation.load_arrays(
            {k: np.asarray(v) for k, v in raw["reputation"].items()})
        if "membership" in raw:
            self._ledger.load_arrays(
                {k: np.asarray(v) for k, v in raw["membership"].items()})
        if self.state.round != start:
            raise ValueError(
                f"checkpoint at step {start - 1} carries "
                f"round={self.state.round}; expected {start} — wrong run "
                "directory?")
        self.round_idx = self.resumed_from = start
        telemetry.METRICS.inc("recovery.resumes")
        telemetry.METRICS.gauge("recovery.resumed_from_round", start)
        telemetry.RECORDER.record("resume", round=start)

    def status(self) -> dict:
        """One ``/statusz`` snapshot."""
        with self._lock:
            pending = len(self._results)
            dead = sorted(self.dead_peers)
            failure = self.failure
            round_idx = self.round_idx
        return {
            "actor": type(self).__name__,
            "round": round_idx,
            "num_rounds": self.cfg.fed.num_rounds,
            "results_pending": pending,
            "membership": {k: len(v)
                           for k, v in self._ledger.summary().items()},
            "quarantined": self._reputation.quarantined(),
            "dead_peers": dead,
            "resumed_from": self.resumed_from,
            "done": self.done.is_set(),
            "failure": failure,
        }

    @property
    def variables(self) -> Params:
        return self.state.variables

    def _sample(self) -> np.ndarray:
        """Seeded cohort sampling (reference ``client_sampling``,
        ``FedAVGAggregator.py:90-98``): the cohort is as large as the
        current member worker count, one client a rank; with more workers
        than clients every client is sampled and the slots wrap."""
        n_workers = max(1, len(self._member_workers()))
        if n_workers >= self.num_clients:
            return np.arange(self.num_clients)
        rng = np.random.default_rng(self.round_idx)
        return rng.choice(self.num_clients, n_workers, replace=False)

    # -- straggler accounting ----------------------------------------------

    def client_ranks(self) -> list[int]:
        """Every ACTIVE member (broadcast and FINISH targets)."""
        return self._ledger.active_ranks()

    def _member_workers(self) -> list[int]:
        """Members of the CURRENT round (a mid-round admission waits for
        the next boundary)."""
        return self._ledger.active_ranks(self.round_idx)

    def _live_workers(self) -> list[int]:
        return [r for r in self._member_workers() if r not in self.dead_peers]

    def _quorum(self) -> int:
        live = len(self._live_workers())
        return max(1, math.ceil(self.round_policy.quorum_fraction * live))

    def kickoff(self) -> None:
        """The barrier's entry: start the (possibly resumed) run unless a
        round is already in flight."""
        with self._lock:
            sync = self._round_sync
            if sync is not None and sync[0] == self.round_idx:
                return
        self.start_round()

    def start_round(self) -> None:
        if self.round_idx >= self.cfg.fed.num_rounds:
            self.done.set()
            self.finish_all()
            return
        # a rank in dead_peers that the liveness monitor no longer holds
        # dead was revived by a JOIN racing its death callback: heal it
        mon = self.liveness
        if mon is not None:
            mon_dead = mon.dead_snapshot()
            with self._lock:
                stranded = sorted(self.dead_peers - mon_dead)
                self.dead_peers -= set(stranded)
            if stranded:
                telemetry.METRICS.inc("recovery.rejoins_reconciled",
                                      len(stranded))
                telemetry.RECORDER.record("rejoin_reconciled",
                                          peers=stranded,
                                          round=self.round_idx)
        cohort = self._sample()
        self.round_t0 = time.monotonic()
        if ANATOMY.enabled:
            ANATOMY.begin_round(self.round_idx, path="deploy")
        tr = telemetry.TRACER
        if tr is not None:
            telemetry.set_current_trace(telemetry.new_trace_id())
            tr.log_round_start(self.round_idx)
        host_vars = to_host(self.variables)
        slots = {r: i for i, r in enumerate(self._member_workers())}
        with self._lock:
            ranks = self._live_workers()
            self._extensions_used = 0
            self._deadline_gen += 1
            gen = self._deadline_gen
            self._round_sync = (self.round_idx, host_vars, cohort, slots)
        self.broadcast(
            MSG_TYPE_S2C_SYNC_MODEL,
            lambda r: {
                KEY_MODEL_PARAMS: host_vars,
                KEY_CLIENT_INDEX: int(cohort[slots.get(r, r - 1)
                                             % len(cohort)]),
                KEY_ROUND: self.round_idx,
            },
            ranks=ranks,
            on_send_error=lambda r, err: self.on_peer_dead(r),
        )
        if self.round_policy.round_deadline_s is not None:
            self._arm_deadline(self.round_idx, gen)

    def _arm_deadline(self, round_idx: int, gen: int) -> None:
        t = threading.Timer(self.round_policy.round_deadline_s,
                            self._maybe_close_round,
                            kwargs={"deadline_fired": True,
                                    "deadline_round": round_idx,
                                    "deadline_gen": gen})
        t.daemon = True
        self._deadline_timer = t
        t.start()

    # -- membership ----------------------------------------------------------

    def on_peer_join(self, rank: int) -> str | None:
        """A JOIN, by the ledger's verdict: an active member's is a
        crash-recovery rejoin (WELCOME with the current round's sync);
        an unknown or LEFT rank is admitted (its first slot at the next
        round boundary, or this one when no round is in flight; a static
        world drops a never-seen rank); an EVICTED rank is dropped,
        never ACKed."""
        with self._lock:
            if self.done.is_set() or self.failure is not None:
                return None
            if not self._elastic and self._ledger.status(rank) is None:
                telemetry.METRICS.inc("membership.rejected_joins")
                return None
            sync = self._round_sync
            in_flight = sync is not None and sync[0] == self.round_idx
            verdict = self._ledger.admit(rank, self.round_idx,
                                         immediate=not in_flight)
            effective = rank in self._ledger.active_ranks(self.round_idx)
        if verdict == "rejected":
            return verdict
        if verdict == "member":
            if effective:
                self.on_peer_rejoin(rank)
            return verdict
        self._reputation.ensure_size(rank + 1)
        with self._lock:
            self.dead_peers.discard(rank)
        if self.liveness is not None:
            self.liveness.watch(rank)
        return verdict

    def on_peer_leave(self, rank: int) -> None:
        """A graceful LEAVE: the rank is LEFT, not dead (its reputation
        frozen, a result it already sent still valid); the round
        re-checks its close condition at once."""
        if not self._ledger.leave(rank, self.round_idx):
            return
        if self.liveness is not None:
            self.liveness.unwatch(rank)
        with self._lock:
            self.dead_peers.discard(rank)
            self._welcomed.pop(rank, None)
        self._maybe_close_round(deadline_fired=False)

    def evict_rank(self, rank: int, notify: bool = True) -> None:
        """A permanent ban; with ``notify`` a FINISH with reason
        ``"evicted"`` tells the rank to wind down."""
        self._ledger.evict(rank, self.round_idx)
        if self.liveness is not None:
            self.liveness.unwatch(rank)
        with self._lock:
            self.dead_peers.discard(rank)
            self._results.pop(rank, None)
            self._welcomed.pop(rank, None)
        if notify:
            try:
                self.send_message(Message(MSG_TYPE_FINISH, self.rank, rank,
                                          {"reason": "evicted"}))
            except Exception:
                pass  # unreachable; its announce loop times out loudly
        self._maybe_close_round(deadline_fired=False)

    def on_peer_rejoin(self, rank: int) -> None:
        """Reverse a dead-peer removal, re-arm the rank's watchdog and
        WELCOME it with the current round's sync (a duplicate JOIN of a
        live rank only refreshes the watchdog)."""
        with self._lock:
            if self.done.is_set() or self.failure is not None:
                return
            was_dead = rank in self.dead_peers
            self.dead_peers.discard(rank)
            sync = self._round_sync
            if sync is not None and sync[0] != self.round_idx:
                sync = None  # mid-close: the next broadcast covers it
            if sync is not None:
                duplicate = (not was_dead
                             and self._welcomed.get(rank) == sync[0])
                if duplicate:
                    sync = None
                else:
                    self._welcomed[rank] = sync[0]
            else:
                duplicate = not was_dead
        if self.liveness is not None:
            self.liveness.revive(rank)
        if duplicate:
            return
        telemetry.METRICS.inc("recovery.rejoins")
        telemetry.RECORDER.record("rejoin", peer=rank, was_dead=was_dead)
        if sync is None:
            return
        round_idx, host_vars, cohort, slots = sync
        try:
            self.send_message(Message(MSG_TYPE_S2C_WELCOME, self.rank, rank, {
                KEY_MODEL_PARAMS: host_vars,
                KEY_CLIENT_INDEX: int(cohort[slots.get(rank, rank - 1)
                                             % len(cohort)]),
                KEY_ROUND: round_idx,
            }))
        except Exception:
            self.on_peer_dead(rank)

    def on_peer_dead(self, rank: int) -> None:
        """The dead-peer callback (heartbeat monitor, failed sends): safe
        from any thread, idempotent per rank."""
        with self._lock:
            if rank in self.dead_peers or self.done.is_set():
                return
            self.dead_peers.add(rank)
            self._results.pop(rank, None)
            dead = sorted(self.dead_peers)
        telemetry.METRICS.inc("round.dead_peers")
        telemetry.flight_dump("dead_peer", peer=rank, round=self.round_idx,
                              dead_peers=dead)
        self._maybe_close_round(deadline_fired=False)

    # -- closing a round -------------------------------------------------------

    def _maybe_close_round(self, deadline_fired: bool,
                           deadline_round: int | None = None,
                           deadline_gen: int | None = None) -> None:
        """Close the round when every live worker reported, or the
        deadline fired with a quorum; re-arm the deadline while recovery
        extensions remain; abort when no live worker is left or the
        deadline passes under quorum. The round index advances under the
        lock that claims the results, so a result racing the close is a
        stale straggler, and a timer is re-validated against its own
        round and generation."""
        extended = None
        with self._lock:
            if self.done.is_set() or self.failure is not None:
                return
            if deadline_round is not None and (
                    deadline_round != self.round_idx
                    or (deadline_gen is not None
                        and deadline_gen != self._deadline_gen)):
                return  # a stale timer
            live = self._live_workers()
            n_results = len(self._results)
            # a graceful leaver's booked result counts for quorum but
            # cannot stand in for a live member still computing
            n_live_results = sum(1 for r in live if r in self._results)
            quorum = self._quorum()
            abort = results = None
            closed_idx = self.round_idx
            dead = sorted(self.dead_peers)
            if live and (n_live_results >= len(live)
                         or (deadline_fired and n_results >= quorum)):
                results, self._results = self._results, {}
                self.round_idx += 1
                if self._deadline_timer is not None:
                    self._deadline_timer.cancel()
                    self._deadline_timer = None
            elif deadline_fired or not live:
                sync = self._round_sync
                if not deadline_fired and (sync is None
                                           or sync[0] != self.round_idx):
                    return  # no round in flight: nothing to abort
                if (self._extensions_used
                        < self.round_policy.recovery_extensions
                        and self.round_policy.round_deadline_s is not None):
                    self._extensions_used += 1
                    extended = self._extensions_used
                    if self._deadline_timer is not None:
                        self._deadline_timer.cancel()
                    self._deadline_gen += 1
                    self._arm_deadline(self.round_idx, self._deadline_gen)
                elif not live:
                    spent = (f" ({self._extensions_used} recovery "
                             "extensions spent)"
                             if self.round_policy.recovery_extensions
                             else "")
                    abort = (f"no live workers left before round "
                             f"{self.round_idx} closed "
                             f"({len(self._member_workers())} members, dead "
                             f"peers {sorted(self.dead_peers)}{spent})")
                else:
                    abort = (f"round {self.round_idx} deadline "
                             f"({self.round_policy.round_deadline_s}s) "
                             f"expired with {n_results}/{len(live)} live "
                             f"results (quorum {quorum}; dead peers "
                             f"{sorted(self.dead_peers)}; "
                             f"{self._extensions_used} recovery extensions "
                             "spent)")
            else:
                return  # stragglers may still arrive
            if abort is not None:
                self.failure = abort
        if extended is not None:
            telemetry.METRICS.inc("recovery.deadline_extensions")
            telemetry.RECORDER.record(
                "deadline_extended", round=closed_idx, extension=extended,
                results=n_results, quorum=quorum)
            return
        if abort is not None:
            telemetry.METRICS.inc("round.quorum_lost_aborts")
            telemetry.flight_dump("quorum_lost", detail=abort,
                                  round=closed_idx, dead_peers=dead)
            self.finish_all()  # done unset: the deploy layer raises
            return
        self._close_round(results, closed_idx, n_live=len(live), dead=dead)

    def _discard_locked(self, msg: Message) -> bool:
        """Cheap drops, under the lock: a finished run, a stale round tag,
        a dead or evicted sender, a duplicate ``(round, rank)`` result
        (the first is kept, so sample mass is never counted twice)."""
        if self.done.is_set() or self.failure is not None:
            return True
        msg_round = msg.get(KEY_ROUND)
        if msg_round is not None and int(msg_round) != self.round_idx:
            telemetry.METRICS.inc("round.stale_results")
            return True
        if msg.sender in self.dead_peers:
            return True
        if self._ledger.status(msg.sender) == "evicted":
            return True
        if msg.sender in self._results:
            telemetry.METRICS.inc("round.duplicate_results")
            return True
        return False

    def _screen_compressed(self, msg: Message):
        """A compressed result's payload, or None: the codec tag, every
        leaf's parts, shapes and types, in-range top-k indices and finite
        floats are checked before anything is stacked."""
        comp = msg.get(KEY_COMPRESSED)
        if not isinstance(comp, dict) or "payload" not in comp:
            err = ("dense result on a compressed wire"
                   if msg.get(KEY_MODEL_PARAMS) is not None
                   else "missing compressed payload")
        elif comp.get("codec") != self._cspec.method:
            err = (f"codec {comp.get('codec')!r} != configured "
                   f"{self._cspec.method!r}")
        else:
            err = C.validate_payload(self._payload_template, comp["payload"])
        if err is not None:
            telemetry.METRICS.inc("compress.decode_errors")
            telemetry.RECORDER.record("compress_decode_error",
                                      peer=msg.sender,
                                      round=msg.get(KEY_ROUND), detail=err)
            return None
        return comp["payload"]

    def _handle_result(self, msg: Message) -> None:
        with self._lock:
            if self._discard_locked(msg):
                return
        n_k = float(msg.get(KEY_NUM_SAMPLES))
        if self._cspec.enabled():
            params = self._screen_compressed(msg)
            if params is None:
                return
            finite = math.isfinite(n_k)
        else:
            params = msg.get(KEY_MODEL_PARAMS)
            if params is None:
                telemetry.METRICS.inc("compress.decode_errors")
                telemetry.RECORDER.record(
                    "compress_decode_error", peer=msg.sender,
                    round=msg.get(KEY_ROUND),
                    detail="compressed result on a dense wire")
                return
            # one NaN defeats the mean and the clip alike: a poisoned
            # result never enters the aggregate (its rank stays live and
            # counts against quorum like a straggler)
            finite = _result_is_finite(params, n_k)
        if not finite:
            telemetry.METRICS.inc("robust.nonfinite_rejected")
            telemetry.RECORDER.record("nonfinite_rejected", peer=msg.sender,
                                      round=msg.get(KEY_ROUND))
            return
        with self._lock:
            if self._discard_locked(msg):  # the round may have moved on
                return
            self._results[msg.sender] = (params, n_k)
        self._maybe_close_round(deadline_fired=False)

    @property
    def quarantined_ranks(self) -> list[int]:
        return self._reputation.quarantined()

    @property
    def membership(self) -> dict:
        return self._ledger.summary()

    def _stack(self, rows: list) -> Params:
        """Host rows (``{name: array}``, or a payload's ``{name: {part:
        array}}``) stacked on a leading axis, on the server's device."""
        first = rows[0]
        if isinstance(next(iter(first.values())), dict):
            return {k: self._stack([r[k] for r in rows]) for k in first}
        return {k: to_device(torch.stack([_host_tensor(r[k]) for r in rows]),
                             self.device) for k in first}

    def _dense_stack(self, results: dict, ranks: list[int]) -> Params:
        """The ranks' results as stacked variables: dense rows as they
        came, compressed payloads through one stacked decompress
        (``global + delta``)."""
        if not self._cspec.enabled():
            return self._stack([results[r][0] for r in ranks])
        payload = self._stack([results[r][0] for r in ranks])
        gv = self.state.variables
        delta = C.decompress_stacked(self._cspec, payload, gv)
        return {k: (gv[k][None] + d).to(gv[k].dtype) for k, d in delta.items()}

    def _score_and_exclude(self, results: dict, closed_idx: int,
                           stacked: Params) -> list[int]:
        """The reputation pass: score every reporter, fold the scores into
        the cross-round tracker, and return the included ranks
        (quarantined reporters are scored, not aggregated). Skipped on
        the plain path (the mean, no quarantine, metrics off)."""
        ranks = sorted(results)
        m = telemetry.METRICS
        if not (self._quarantine.enabled()
                or (self._pipeline.method != "mean" and m.enabled)):
            return ranks
        self._reputation.ensure_size(max(ranks) + 1)
        gv = self.state.variables
        deltas = {k: stacked[k] - gv[k][None] for k in gv
                  if k not in self.model.stat_names}
        scores = robust.anomaly_scores(deltas)["score"].cpu().numpy()
        events = self._reputation.observe(closed_idx, ranks, scores)
        if self._quarantine.evict_after > 0:
            for r in list(self._reputation.quarantined()):
                q_at = int(self._reputation.quarantined_at[r])
                if (closed_idx - q_at >= self._quarantine.evict_after
                        and self._ledger.status(r) != "evicted"):
                    self.evict_rank(r)
        excluded = [r for r in ranks if self._reputation.is_quarantined(r)]
        included = [r for r in ranks if r not in excluded]
        if not included:
            # every reporter quarantined: aggregate them all rather than
            # stall, the round's defense rule carrying it
            telemetry.RECORDER.record("quarantine_overruled",
                                      round=closed_idx, ranks=ranks)
            included, excluded = ranks, []
        if m.enabled:
            for key in ("suspected", "quarantined"):
                if events[key]:
                    m.inc("defense." + ("quarantines" if key == "quarantined"
                                        else key), len(events[key]))
            if events["released"]:
                m.inc("defense.releases", len(events["released"]))
            excluded_n = len(excluded) + self._pipeline.excluded_count(
                len(included))
            if excluded_n:
                m.inc("defense.excluded", excluded_n)
            if self._pipeline.method == "fltrust":
                m.inc("defense.reweighted", len(included))
            m.gauge("defense.quarantined",
                    len(self._reputation.quarantined()))
            m.gauge("defense.anomaly_score_max", float(scores.max()))
            for r in ranks:
                m.gauge_labeled("defense.score_rank", str(r),
                                self._reputation.score(r), sep="")
        if events["released"]:
            telemetry.RECORDER.record("quarantine_released",
                                      round=closed_idx,
                                      peers=events["released"])
        if events["quarantined"]:
            telemetry.RECORDER.record("quarantine", round=closed_idx,
                                      peers=events["quarantined"])
            telemetry.flight_dump(
                "quarantine", round=closed_idx, peers=events["quarantined"],
                scores={r: self._reputation.score(r) for r in ranks},
                quarantined=self._reputation.quarantined())
        return included

    def _noise(self, round_idx: int):
        return lambda shapes: {k: v[0] for k, v in self.draws(
            "noise", round_idx, [0], shapes).items()}

    def _close_round(self, results: dict, closed_idx: int,
                     n_live: int | None = None,
                     dead: list[int] | None = None) -> None:
        """Aggregate ``results`` through the sim's ``server_update``
        (reference ``FedAvgServerManager.py:45-82``, FedOpt's aggregator):
        a partial cohort's weighted mean renormalizes over the survivors'
        sample counts by construction. ``round_idx`` already advanced;
        ``closed_idx`` is the round the results belong to."""
        tr = telemetry.TRACER
        if tr is not None:
            tr.log_round_end(closed_idx)
        anat = ANATOMY.enabled
        t_close = time.monotonic()
        if anat:
            ANATOMY.phase("wire", t_close - self.round_t0)
        m = telemetry.METRICS
        if m.enabled:
            wall = t_close - self.round_t0
            m.observe("round.wall_s", wall)
            m.observe("perf.round_wall_s", wall)
            m.gauge("round.results", len(results))
            if n_live is not None and n_live > len(results):
                m.inc("round.stragglers", n_live - len(results))
            if len(results) < len(self._ledger.active_ranks(closed_idx)):
                m.inc("round.quorum_renormalizations")
        telemetry.RECORDER.record("round_close", round=closed_idx,
                                  results=len(results),
                                  dead_peers=dead or [])
        t_agg0 = time.monotonic()
        ranks = sorted(results)
        stacked = self._dense_stack(results, ranks)
        included = self._score_and_exclude(results, closed_idx, stacked)
        if included != ranks:
            keep = torch.tensor([ranks.index(r) for r in included],
                                device=self.device)
            stacked = {k: v.index_select(0, keep) for k, v in stacked.items()}
        weights = torch.tensor([results[r][1] for r in included],
                               dtype=torch.float32, device=self.device)
        t_def_end = time.monotonic()
        if anat:
            ANATOMY.phase("defense_agg", t_def_end - t_agg0)
        self.state = server_update(
            self.cfg.fed, self.state, stacked, weights, local_reducer(),
            self.model.stat_names, self.local_steps,
            normals=self._noise(closed_idx))
        # the step waited for (the next sync's host copy waits anyway), so
        # the aggregation's seconds are its device time
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        agg_s = self.last_agg_s = time.monotonic() - t_agg0
        if m.enabled:
            if anat:
                ANATOMY.phase("server_update", time.monotonic() - t_def_end)
            wall_s = max(time.monotonic() - self.round_t0, 1e-9)
            m.observe("perf.agg_wall_s", agg_s)
            m.gauge("perf.host_wait_s", max(0.0, wall_s - agg_s))
            agg_frac = min(1.0, agg_s / wall_s)
            m.gauge("perf.agg_frac", agg_frac)
            if agg_frac < 0.005:
                m.inc("perf.idle_gap_rounds")
                if not self._idle_gap_flagged:
                    self._idle_gap_flagged = True
                    telemetry.RECORDER.record(
                        "perf_idle_gap", round=closed_idx,
                        agg_s=round(agg_s, 6), wall_s=round(wall_s, 6),
                        note="aggregation occupies <0.5% of the round; the "
                             "server device is idle waiting on clients and "
                             "the transport")
            MEMSCOPE.MONITOR.sample(tag=f"round{closed_idx}")
        t_ck = time.monotonic()
        if self._ckpt is not None and (
                (closed_idx + 1) % self.checkpoint_every == 0
                or closed_idx + 1 >= self.cfg.fed.num_rounds):
            # the full ServerState (with the round every draw derives
            # from), the reputation plane and the membership ledger
            self._ckpt.save(closed_idx, {
                "server": self.state,
                "reputation": {k: torch.from_numpy(v) for k, v in
                               self._reputation.state_arrays().items()},
                "membership": {k: torch.from_numpy(v) for k, v in
                               self._ledger.state_arrays().items()},
            })
            telemetry.METRICS.inc("recovery.checkpoints")
            telemetry.RECORDER.record("checkpoint", round=closed_idx)
            telemetry.flush_metrics()
            if anat:
                ANATOMY.phase("checkpoint", time.monotonic() - t_ck)
        if anat:
            ANATOMY.end_round(wall_s=time.monotonic() - self.round_t0)
        if self.on_round_done is not None:
            self.on_round_done(self.round_idx, {
                "num_results": len(results),
                "dead_peers": sorted(self.dead_peers),
            })
        if self.round_idx >= self.cfg.fed.num_rounds:
            self.done.set()
            self.finish_all()
        else:
            self.start_round()


class LocalTrainer:
    """One process's local training for its client actors: the data on
    the device, the sim's batched update (:class:`CohortUpdate`, a CUDA
    graph a step on the card) run as one lane, the batch orders and the
    dropout and adversary draws. Client actors of one process that share
    a configuration share one trainer, so ten loopback clients hold one
    copy of the data and capture one graph; :attr:`lock` serializes
    their device work (a capture tolerates no other thread's CUDA
    calls).

    ``batch_orders(round, client)`` returns the client's per-epoch orders
    (default :func:`client_orders`, the sim's); ``draws`` the sim's
    draws hook."""

    def __init__(self, model: FedModel, data: FederatedData,
                 cfg: ExperimentConfig, batch_orders=None,
                 draws: R.Draws | None = None):
        self.model = model
        self.cfg = cfg
        self.device = model.device
        self.task = make_task(data.task)
        self.arrays, self.batch_size = arrays_and_batch(data, cfg.data,
                                                        self.device)
        self.max_n = self.arrays.max_client_samples
        self._host_mask = self.arrays.mask.cpu()
        self._host_counts = self.arrays.counts.cpu().numpy()
        self.cohort_update = CohortUpdate(
            model, self.task, cfg.train, self.batch_size,
            graphed=self.device.type == "cuda", family="deploy_client")
        self.batch_orders = batch_orders or (
            lambda r, c: client_orders(cfg.seed, r, c, self._host_mask[c],
                                       self.max_n, cfg.train.epochs))
        self.draws = draws or default_draws(cfg, self.device,
                                            model.mask_keep)
        self.lock = threading.Lock()
        self.updates = 0

    def update(self, variables: Params, round_idx: int, client: int):
        """Client ``client``'s local update from ``variables`` (on the
        device): ``(new variables, n_k, metric sums)``."""
        epochs = self.cfg.train.epochs
        orders = torch.stack(list(self.batch_orders(round_idx, client))
                             [:epochs]).long()[None]
        steps = min(-(-int(self._host_counts[client]) // self.batch_size),
                    self.max_n // self.batch_size)
        ids = to_device(torch.tensor([client]), self.device)
        a = self.arrays
        extra = {}
        sites = self.model.mask_sites
        if sites:
            extra["masks"] = self.draws(
                "dropout", round_idx, [client],
                R.mask_shapes(sites, (epochs, steps), self.batch_size))
        stacked, n_k, sums = self.cohort_update(
            variables, a.idx.index_select(0, ids),
            a.mask.index_select(0, ids), a.x, a.y,
            to_device(orders, self.device), steps, **extra)
        self.updates += 1
        return ({k: v[0] for k, v in stacked.items()}, n_k[0],
                {k: v[0] if v.ndim else v for k, v in sums.items()})


class FedAvgClientActor(ClientManager):
    """Rank >= 1 worker (reference ``FedAVGClientManager`` and
    ``FedAVGTrainer``). ``trainer`` shares one :class:`LocalTrainer`
    between actors of a process (built here from ``model``, ``data`` and
    ``cfg`` when None)."""

    def __init__(
        self,
        rank: int,
        size: int,
        transport: BaseTransport,
        model: FedModel,
        data: FederatedData | None,
        cfg: ExperimentConfig,
        leave_after_round: int | None = None,
        trainer: LocalTrainer | None = None,
    ):
        super().__init__(rank, size, transport)
        self.cfg = cfg
        self.model = model
        self.trainer = trainer or LocalTrainer(model, data, cfg)
        self.device = self.trainer.device
        # after its result for this round the client LEAVEs gracefully
        self.leave_after_round = leave_after_round
        self.left = threading.Event()
        self.last_round = -1
        self.last_sums: dict | None = None
        # round -> seconds of its local update, the result's copy to the
        # host included (the last sync of a round, if it came twice)
        self.local_s: dict[int, float] = {}
        adv = cfg.adversary
        self._adversary = (adv if adv.enabled()
                           and adv.is_member(rank, size - 1, base=1)
                           else None)
        self._cspec = C.CompressionSpec.from_fed(cfg.fed, seed=cfg.seed)
        self._residual: Params | None = None  # the error-feedback carry
        self._comp_cache: tuple[int, dict] | None = None
        self.register_message_receive_handler(MSG_TYPE_S2C_SYNC_MODEL,
                                              self._handle_sync)
        # a WELCOME carries the round's sync and is worked the same way
        self.register_message_receive_handler(MSG_TYPE_S2C_WELCOME,
                                              self._handle_sync)
        EXPORT.register_status_source("client", self)

    def status(self) -> dict:
        return {"actor": type(self).__name__, "rank": self.rank,
                "last_round": self.last_round, "left": self.left.is_set()}

    def _draw(self, round_idx: int):
        return lambda stream, slots, shapes: self.trainer.draws(
            stream, round_idx, slots, shapes)

    def _compress_result(self, synced: Params, new: Params,
                         round_idx: int) -> dict:
        """Delta, the carried residual folded in, compressed, the carry
        advanced, ONCE a round: a duplicate sync of the same round re-sends
        the cached payload, and one of an older round (whose result the
        server discards) is compressed without touching the carry. The
        quantizer's draws are slot ``rank - 1``'s, as the sim's slots."""
        if self._comp_cache is not None and round_idx == self._comp_cache[0]:
            return self._comp_cache[1]
        spec = self._cspec
        delta = {k: new[k] - synced[k] for k in synced}
        shapes = spec.draw_shapes(synced)
        draws = ({k: v[0] for k, v in self.trainer.draws(
            "quant", round_idx, [self.rank - 1], shapes).items()}
            if shapes else None)
        if self._comp_cache is not None and round_idx < self._comp_cache[0]:
            return {"codec": spec.method,
                    "payload": C.compress_tree(spec, delta, draws)}
        payload, _, self._residual = C.apply_with_feedback(
            spec, delta, self._residual, draws)
        m = telemetry.METRICS
        if m.enabled:
            m.gauge("compress.residual_norm",
                    float(T.tree_l2_norm(self._residual)))
        wire = {"codec": spec.method, "payload": payload}
        self._comp_cache = (round_idx, wire)
        return wire

    def _handle_sync(self, msg: Message) -> None:
        t0 = time.monotonic()
        client_idx = int(msg.get(KEY_CLIENT_INDEX))
        round_idx = int(msg.get(KEY_ROUND))
        self.last_round = round_idx
        with self.trainer.lock, telemetry.maybe_span(
                "local_update", rank=self.rank, round=round_idx,
                client=client_idx):
            variables = to_tensors(msg.get(KEY_MODEL_PARAMS), self.device)
            t_loc = time.monotonic()
            new_vars, n_k, sums = self.trainer.update(variables, round_idx,
                                                      client_idx)
            if self._adversary is not None:
                new_vars = A.corrupt_client_vars(
                    self._adversary, variables, new_vars,
                    self.model.stat_names, self.rank, self._draw(round_idx))
                telemetry.METRICS.inc("adversary.corrupted_results")
            if self._cspec.enabled():
                result = {KEY_COMPRESSED: self._compress_result(
                    variables, new_vars, round_idx)}
            else:
                result = {KEY_MODEL_PARAMS: new_vars}
            # one pinned copy a dtype for the whole result, the count and
            # the metric sums
            result, n_k, self.last_sums = to_host((result, n_k, sums))
        t_send = time.monotonic()
        self.local_s[round_idx] = t_send - t_loc
        self.send_message(Message(MSG_TYPE_C2S_RESULT, self.rank, 0, {
            **result,
            KEY_NUM_SAMPLES: float(n_k),
            # the round tag lets the server drop a late straggler
            KEY_ROUND: round_idx,
        }))
        m = telemetry.METRICS
        if m.enabled:
            m.observe("perf.round_wall_s", time.monotonic() - t0)
            if ANATOMY.enabled:
                m.observe("perf.phase.local_s", t_send - t_loc)
        if (self.leave_after_round is not None
                and round_idx >= self.leave_after_round):
            # LEAVE after RESULT on the same ordered channel: the server
            # books the contribution before the departure
            try:
                self.send_message(Message(MSG_TYPE_C2S_LEAVE, self.rank, 0,
                                          {}))
            except Exception:
                pass  # the server is gone; its staleness covers it
            self.left.set()
            telemetry.RECORDER.record("leave", rank=self.rank,
                                      round=round_idx)
            self.finish()
