"""Asynchronous and hierarchical aggregation actors
(``fedml_tpu.algorithms.async_actors``).

Two server-side shapes over the message-passing runtime of
:mod:`fedml_tpu_torch.algorithms.distributed_fedavg`:

- :class:`AsyncFedAvgServerActor`, the FedBuff-style buffered-async
  server: every screened delta that arrives folds into a
  staleness-weighted :class:`~fedml_tpu_torch.core.async_agg.AsyncBuffer`
  tagged with the model version it trained against; every
  ``async_buffer_k`` folds a new model is emitted through the unchanged
  ``server_update``; the sender is re-synced alone the moment its result
  lands, so a slow client never blocks a fast one (Server Averaging for
  FL, arxiv 2103.11619).
- :class:`TierAggregatorActor` (a leaf) with :class:`TierRootActor` or
  :class:`AsyncTierRootActor` (the root): the two-level aggregator tree
  (the Smart-NIC partial-reduction shape, arxiv 2307.06561). Each leaf
  terminates its clients' transports in its own world, runs decompress,
  screen, clip and partial sum near the wire, and forwards one typed
  ``[sum, n, count]`` partial a flush upstream
  (:mod:`fedml_tpu_torch.core.tier`); the root folds one row a leaf
  through the same ``server_update`` and defense pipeline. Each tier has
  its own membership ledger, liveness monitor and reputation plane: a
  leaf's Byzantine client is quarantined at its leaf and never reaches a
  sibling's or the root's reputation.

Both ride the sealed wire frames and are opt-in: with
``async_buffer_k`` 0 and no tier spec the deployment constructs
:class:`FedAvgServerActor` itself. The async server checkpoints its
buffer and version as a ``torch.save`` composite ``{"server",
"reputation", "membership", "async"}`` through ``RoundCheckpointer``, so a
killed root resumes its buffer, not only its parameters.
"""

from __future__ import annotations

import math
import threading
import time
import warnings

import numpy as np
import torch

from fedml_tpu_torch.algorithms.distributed_fedavg import (
    FedAvgServerActor,
    _host_tensor,
    _result_is_finite,
)
from fedml_tpu_torch.algorithms.fedavg import local_reducer, server_update
from fedml_tpu_torch.config import ExperimentConfig
from fedml_tpu_torch.core import async_agg as AA
from fedml_tpu_torch.core import compress as C
from fedml_tpu_torch.core import telemetry
from fedml_tpu_torch.core import tier as TIER
from fedml_tpu_torch.core.device import to_device
from fedml_tpu_torch.core.manager import Manager
from fedml_tpu_torch.core.message import (
    KEY_CLIENT_INDEX,
    KEY_MODEL_PARAMS,
    KEY_NUM_SAMPLES,
    KEY_ROUND,
    MSG_TYPE_C2S_RESULT,
    MSG_TYPE_FINISH,
    MSG_TYPE_L2R_PARTIAL,
    MSG_TYPE_S2C_SYNC_MODEL,
    MSG_TYPE_S2C_WELCOME,
    Message,
    to_host,
    to_tensors,
    tree_map,
)
from fedml_tpu_torch.utils.checkpoint import from_savable


def check_async_compat(cfg: ExperimentConfig) -> None:
    """Refuse the pairings the buffered-async server cannot run, at
    construction or parse time."""
    acfg = AA.AsyncConfig.from_fed(cfg.fed)
    if not acfg.enabled():
        return
    if cfg.fed.algorithm == "fednova":
        raise ValueError(
            "async_buffer_k is incompatible with fednova: the async "
            "emit is ONE staleness-folded row, but tau-normalization "
            "needs per-client step counts — run fednova synchronously")
    if cfg.fed.shard_aggregation:
        raise ValueError(
            "async_buffer_k is incompatible with --shard_aggregation: "
            "the async emit aggregates one folded row — there is no "
            "client axis left to shard (the fan-out lives in the tier "
            "tree instead, --tier_spec)")


def _savable(blob):
    """Host numpy leaves as CPU tensors (``torch.load(weights_only=True)``
    reads tensors, not numpy arrays)."""
    return tree_map(lambda v: torch.as_tensor(v)
                    if isinstance(v, np.ndarray) else v, blob)


class AsyncFedAvgServerActor(FedAvgServerActor):
    """The buffered-async rank 0. It keeps the membership ledger,
    liveness routing, reputation plane, compression screens and defense
    pipeline of :class:`FedAvgServerActor`, and replaces the round
    barrier by a fold a result and an emission every K folds.
    ``round_idx`` is the model version (the emission count), so every
    inherited reader of it (membership activation, the WELCOME replay,
    the summaries) keeps working."""

    def __init__(self, *args, checkpointer=None, **kwargs):
        # the base restore ties a checkpoint step to a closed round; here
        # a step counts saves and the buffer rides the payload, so this
        # class restores on its own (_restore_async)
        super().__init__(*args, checkpointer=None, **kwargs)
        self._acfg = AA.AsyncConfig.from_fed(self.cfg.fed)
        if not self._acfg.enabled():
            raise ValueError(
                "AsyncFedAvgServerActor needs fed.async_buffer_k >= 1 "
                "(with 0, construct the synchronous FedAvgServerActor)")
        check_async_compat(self.cfg)
        self._buffer = AA.AsyncBuffer(self._acfg, self.state.variables)
        # the model of each still-foldable version: a dense result is a
        # whole variables dict, whose delta needs the model it trained
        # from (compressed results and tier partials carry deltas)
        self._history_depth = max(8, 2 * self._acfg.buffer_k)
        self._history: dict[int, dict] = {}
        # rank -> the versions it folded (a chaos duplicate, a replay)
        self._folded: dict[int, set[int]] = {}
        # members whose result went into the current version wait here
        # for the next emission (the same model would give the same
        # result); every emission drains the set
        self._parked: set[int] = set()
        self._folds = 0
        # the checkpoint step: monotonic and distinct from the fold count,
        # since a forced emission saves too
        self._save_step = 0
        self.restored_folds = 0
        self._ckpt = checkpointer
        if checkpointer is not None:
            self._restore_async(checkpointer)

    def status(self) -> dict:
        """``/statusz``: the synchronous snapshot and the async plane."""
        st = super().status()
        with self._lock:
            st["async"] = {
                "buffer_k": self._acfg.buffer_k,
                "buffer_count": self._buffer.count,
                "version": self._buffer.version,
                "folds": self._folds,
                "parked": sorted(self._parked),
                "restored_folds": self.restored_folds,
            }
        return st

    # -- checkpoints ---------------------------------------------------------

    def _restore_async(self, ckpt) -> None:
        """Restore the composite: the ``"async"`` part carries the buffer
        mid-accumulation and ``resumed_from`` is the restored version. A
        checkpoint from before async (no ``"async"``) restores the
        parameters and starts the buffer empty."""
        raw, start = ckpt.restore_raw()
        if raw is None:
            return
        if not (isinstance(raw, dict) and "server" in raw):
            raise ValueError(
                "async server found a non-composite checkpoint in its "
                "run dir — wrong run directory? (the async path always "
                "writes {'server', ..., 'async'} composites)")
        self.state = from_savable(self.state, raw["server"])
        if "reputation" in raw:
            self._reputation.load_arrays(
                {k: np.asarray(v) for k, v in raw["reputation"].items()})
        if "membership" in raw:
            self._ledger.load_arrays(
                {k: np.asarray(v) for k, v in raw["membership"].items()})
        if "async" in raw:
            self._buffer.load_arrays(raw["async"])
            self.restored_folds = self._buffer.count
        else:
            self._buffer.version = int(self.state.round)
            warnings.warn(
                "restored a pre-async checkpoint (no buffer payload); "
                "the staleness buffer starts empty", stacklevel=2)
        self._folds = 0  # the cadence restarts; the save step must not
        self._save_step = start
        self.round_idx = self.resumed_from = self._buffer.version
        telemetry.METRICS.inc("recovery.resumes")
        telemetry.METRICS.gauge("recovery.resumed_from_round",
                                self.resumed_from)
        telemetry.METRICS.gauge("recovery.async_buffer_restored",
                                self.restored_folds)
        telemetry.RECORDER.record("resume", round=self.resumed_from,
                                  mode="async",
                                  buffer_count=self.restored_folds)

    def _save_checkpoint(self) -> None:
        if self._ckpt is None:
            return
        self._save_step += 1
        self._ckpt.save(self._save_step, {
            "server": self.state,
            "reputation": _savable(self._reputation.state_arrays()),
            "membership": _savable(self._ledger.state_arrays()),
            "async": _savable(self._buffer.state_arrays()),
        })
        telemetry.METRICS.inc("recovery.checkpoints")
        telemetry.RECORDER.record("checkpoint", round=self.round_idx,
                                  folds=self._folds)
        telemetry.flush_metrics()

    # -- versions ------------------------------------------------------------

    def _assignment(self, rank: int) -> int:
        """Every member trains its ledger-stable client id every version:
        the open loop is the cohort."""
        return self._ledger.client_id(rank)

    def _stash_sync_locked(self, host_vars: dict) -> None:
        """The WELCOME replay's snapshot and the history entry of the
        current version. Caller holds ``self._lock``."""
        members = self._member_workers()
        cohort = np.asarray([self._assignment(r) for r in members] or [0],
                            np.int32)
        slots = {r: i for i, r in enumerate(members)}
        self._round_sync = (self.round_idx, host_vars, cohort, slots)
        self._history[self.round_idx] = host_vars
        floor = self.round_idx - self._history_depth
        for v in [v for v in self._history if v < floor]:
            del self._history[v]
        for r, seen in self._folded.items():
            self._folded[r] = {v for v in seen if v >= floor}

    def start_round(self) -> None:
        """Start (or resume) the open loop: the current version to every
        live member. Called once, at the readiness barrier; afterwards
        each arrival re-syncs its sender."""
        if self.round_idx >= self.cfg.fed.num_rounds:
            self.done.set()
            self.finish_all()
            return
        self.round_t0 = time.monotonic()
        host_vars = to_host(self.variables)
        with self._lock:
            self._stash_sync_locked(host_vars)
            ranks = self._live_workers()
            # --round_deadline is a progress deadline here: without
            # heartbeats it is the only backstop against a crashed client
            self._arm_progress_deadline_locked()
        self.broadcast(
            MSG_TYPE_S2C_SYNC_MODEL,
            lambda r: {KEY_MODEL_PARAMS: host_vars,
                       KEY_CLIENT_INDEX: self._assignment(r),
                       KEY_ROUND: self.round_idx},
            ranks=ranks, on_send_error=lambda r, err: self.on_peer_dead(r))

    def _resync(self, rank: int) -> None:
        """Sync ``rank`` alone with the current model."""
        with self._lock:
            if self.done.is_set() or self.failure is not None:
                return
            sync = self._round_sync
        if sync is None:
            return
        try:
            self.send_message(Message(
                MSG_TYPE_S2C_SYNC_MODEL, self.rank, rank,
                {KEY_MODEL_PARAMS: sync[1],
                 KEY_CLIENT_INDEX: self._assignment(rank),
                 KEY_ROUND: sync[0]}))
        except Exception:
            self.on_peer_dead(rank)

    def on_peer_join(self, rank: int) -> str | None:
        verdict = super().on_peer_join(rank)
        if verdict == "admitted":
            # no next-round broadcast covers a mid-run admission
            self._resync(rank)
        return verdict

    # -- arrivals ------------------------------------------------------------

    def _handle_result(self, msg: Message) -> None:
        n_raw = msg.get(KEY_NUM_SAMPLES)
        msg_round = msg.get(KEY_ROUND)
        sender = msg.sender
        with self._lock:
            if self.done.is_set() or self.failure is not None:
                return
            if sender in self.dead_peers:
                return
            if self._ledger.status(sender) == "evicted":
                return
            if msg_round is None:
                return  # async results are always version-tagged
            v = int(msg_round)
            if v in self._folded.get(sender, ()):
                telemetry.METRICS.inc("round.duplicate_results")
                return
            version = self.round_idx
        lag = version - v
        if lag < 0:
            # a version from the future: config skew or a corrupted tag
            telemetry.METRICS.inc("async.too_stale")
            self._resync(sender)
            return
        n_k = float(n_raw) if n_raw is not None else float("nan")
        delta = None
        if self._cspec.enabled():
            payload = self._screen_compressed(msg)
            if payload is not None and math.isfinite(n_k):
                # a compressed payload is a delta: no history needed
                delta = C.decompress_tree(
                    self._cspec, to_tensors(payload, self.device),
                    self.state.variables)
            elif payload is not None:
                telemetry.METRICS.inc("robust.nonfinite_rejected")
        else:
            params = msg.get(KEY_MODEL_PARAMS)
            if params is not None and _result_is_finite(params, n_k):
                base = self._history.get(v)
                if base is None:
                    # its model left the history ring: the delta cannot be
                    # recovered; the resync below puts the client to work
                    telemetry.METRICS.inc("async.too_stale")
                else:
                    delta = {k: to_device(_host_tensor(params[k])
                                          - _host_tensor(b), self.device)
                             for k, b in base.items()}
            elif params is not None:
                telemetry.METRICS.inc("robust.nonfinite_rejected")
                telemetry.RECORDER.record("nonfinite_rejected", peer=sender,
                                          round=v)
        if delta is not None:
            self._fold(sender, delta, n_k, v, lag)
        self._after_result(sender, v)

    def _fold(self, sender: int, delta: dict, n_k: float, v: int,
              lag: int) -> None:
        """A screened delta, clipped, into the staleness-weighted buffer,
        then maybe an emission."""
        m = telemetry.METRICS
        if self._reputation.is_quarantined(sender):
            # quarantined ranks stay served; their folds are excluded
            m.inc("defense.excluded")
            return
        # the clip of the defense pipeline a delta at a time; the emission
        # applies the rest to the aggregate
        clipped = {k: x[0] for k, x in self._pipeline.preprocess(
            {k: x[None] for k, x in delta.items()}).items()}
        with self._lock:
            if self.done.is_set() or self.failure is not None:
                return
            self._folded.setdefault(sender, set()).add(v)
            w = self._buffer.fold(clipped, n_k, lag)
            self._folds += 1
            folds = self._folds
            if m.enabled:
                m.inc("async.folds")
                m.gauge("async.buffer_depth", self._buffer.count)
                m.gauge("async.staleness", lag)
                m.gauge("async.staleness_weight", w)
                if lag > 0:
                    m.inc("async.stale_folds")
        if not self._maybe_emit() and folds % self.checkpoint_every == 0:
            self._save_checkpoint()

    def _arm_progress_deadline_locked(self) -> None:
        """(Re-)arm the progress watchdog: every deadline window must see
        an emission. Caller holds ``self._lock``; the generation voids a
        timer whose callback already waits on the lock."""
        if self.round_policy.round_deadline_s is None:
            return
        if self._deadline_timer is not None:
            self._deadline_timer.cancel()
        self._deadline_gen += 1
        t = threading.Timer(self.round_policy.round_deadline_s,
                            self._on_progress_deadline,
                            args=(self._deadline_gen,))
        t.daemon = True
        self._deadline_timer = t
        t.start()

    def _on_progress_deadline(self, gen: int) -> None:
        """A window without an emission: force out what the buffer holds,
        or, with an empty buffer, abort loudly (whoever should fill it is
        gone)."""
        with self._lock:
            if (self.done.is_set() or self.failure is not None
                    or gen != self._deadline_gen):
                return
            pending = self._buffer.count
            if not pending:
                self.failure = (
                    f"no emission within the "
                    f"{self.round_policy.round_deadline_s}s progress "
                    f"deadline at version {self.round_idx} with an empty "
                    f"buffer (members {self._member_workers()}, dead peers "
                    f"{sorted(self.dead_peers)}, parked "
                    f"{sorted(self._parked)})")
        if pending:
            telemetry.METRICS.inc("async.forced_emits")
            self._maybe_emit(force=True)  # re-arms the watchdog
            return
        telemetry.METRICS.inc("round.quorum_lost_aborts")
        telemetry.flight_dump("quorum_lost", detail=self.failure,
                              round=self.round_idx)
        self.finish_all()

    def _maybe_emit(self, force: bool = False) -> bool:
        """Emit when the buffer holds K folds (``force``: any), then
        checkpoint, check completion and re-sync every parked member with
        the new version."""
        with self._lock:
            if self.done.is_set() or self.failure is not None:
                return False
            if not (self._buffer.ready()
                    or (force and self._buffer.count > 0)):
                return False
            self._emit_locked()
            self._arm_progress_deadline_locked()
            parked = sorted(self._parked)
            self._parked.clear()
        self._save_checkpoint()
        if self.on_round_done is not None:
            self.on_round_done(self.round_idx, {"async": True})
        self.round_t0 = time.monotonic()  # the next version's start
        if self.round_idx >= self.cfg.fed.num_rounds:
            self.done.set()
            self.finish_all()
            return True
        for r in parked:
            self._resync(r)
        return True

    def _after_result(self, sender: int, v: int) -> None:
        """A sender whose result (or unusable attempt) was for the current
        version parks until the next emission; one behind it goes back
        to work on the current model at once."""
        with self._lock:
            if self.done.is_set() or self.failure is not None:
                return
            park = v >= self.round_idx
            if park:
                self._parked.add(sender)
        if park:
            self._recover_if_stalled()
        else:
            self._resync(sender)

    def _recover_if_stalled(self) -> None:
        """When every live member is parked no arrival can complete the
        buffer: emit what is pending (``async.forced_emits``), or abort
        when the buffer is empty (every current-version result was
        screened out; a deterministic retry cannot fix that)."""
        with self._lock:
            if self.done.is_set() or self.failure is not None:
                return
            if self._round_sync is None:
                return  # arrivals before the kickoff park until it
            live = self._live_workers()
            if not live or any(r not in self._parked for r in live):
                return
            pending = self._buffer.count
            if not pending:
                self.failure = (
                    f"async world stalled at version {self.round_idx}: "
                    f"every live member ({live}) is parked and the buffer "
                    f"is empty (all current-version results were screened "
                    f"out)")
        if pending:
            telemetry.METRICS.inc("async.forced_emits")
            self._maybe_emit(force=True)
            return
        telemetry.METRICS.inc("round.quorum_lost_aborts")
        telemetry.flight_dump("async_stalled", detail=self.failure,
                              round=self.round_idx)
        self.finish_all()

    def _emit_locked(self) -> None:
        """Drain the buffer into one ``server_update`` step, the body of
        every synchronous round, and advance the version. Caller holds
        ``self._lock``."""
        t0 = time.monotonic()
        mean_delta, mass = self._buffer.emit()
        gv = self.state.variables
        row = {k: (g + mean_delta[k].to(g.dtype))[None] for k, g in gv.items()}
        self.state = server_update(
            self.cfg.fed, self.state, row,
            torch.tensor([mass], dtype=torch.float32, device=self.device),
            local_reducer(), self.model.stat_names, self.local_steps,
            normals=self._noise(self.state.round))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_agg_s = time.monotonic() - t0
        self.round_idx = self._buffer.version
        telemetry.METRICS.inc("async.emits")
        telemetry.RECORDER.record("async_emit", version=self.round_idx,
                                  mass=float(mass))
        self._stash_sync_locked(to_host(self.state.variables))

    # -- the inherited protocol ----------------------------------------------

    def _maybe_close_round(self, deadline_fired: bool,
                           deadline_round: int | None = None,
                           deadline_gen: int | None = None) -> None:
        """No round to close: a LEAVE, an eviction or a death only has to
        keep the run loud (no live member left can never emit again)."""
        with self._lock:
            if self.done.is_set() or self.failure is not None:
                return
            if self._round_sync is None:
                return  # a departure replayed before the kickoff
            alive = bool(self._live_workers())
            if not alive:
                self.failure = (
                    f"no live workers left at version {self.round_idx} "
                    f"({len(self._member_workers())} members, dead peers "
                    f"{sorted(self.dead_peers)})")
        if alive:
            # the one unparked member may have gone: re-check the valve
            self._recover_if_stalled()
            return
        telemetry.METRICS.inc("round.quorum_lost_aborts")
        telemetry.flight_dump("quorum_lost", detail=self.failure,
                              round=self.round_idx)
        self.finish_all()


# ---------------------------------------------------------------------------
# the tier actors
# ---------------------------------------------------------------------------


class TierAggregatorActor(FedAvgServerActor):
    """A leaf: rank 0 of its own world (its clients' transports) and a
    member rank of the root world (``uplink``). It keeps the whole
    server-side client protocol (barrier, ledger, liveness, straggler
    rounds, receive-edge screens, decompression, its own reputation and
    quarantine) and replaces the aggregation tail: a closed round becomes
    one clipped partial ``[sum, n, count]`` sent upstream. It serves its
    clients the model of the last root sync; the root alone owns the
    optimizer state and the versions."""

    def __init__(self, size: int, transport, uplink: Manager, model,
                 cfg: ExperimentConfig, *, client_base: int = 0, **kwargs):
        kwargs.pop("checkpointer", None)  # the root owns durability
        super().__init__(size, transport, model, cfg, checkpointer=None,
                         **kwargs)
        self._uplink = uplink
        self._client_base = int(client_base)
        self.partials_sent = 0
        self.root_finished = threading.Event()
        uplink.register_message_receive_handler(MSG_TYPE_S2C_SYNC_MODEL,
                                                self.on_root_sync)
        uplink.register_message_receive_handler(MSG_TYPE_S2C_WELCOME,
                                                self.on_root_sync)
        uplink.register_message_receive_handler(MSG_TYPE_FINISH,
                                                self.on_root_finish)

    def status(self) -> dict:
        st = super().status()
        st["tier"] = {"role": "leaf", "client_base": self._client_base,
                      "partials_sent": self.partials_sent}
        return st

    def _sample(self) -> np.ndarray:
        """A contiguous block of global client ids from ``client_base``:
        sibling leaves cover disjoint shards."""
        n = max(1, len(self._member_workers()))
        return (self._client_base + np.arange(n)) % self.num_clients

    # -- the root's side -----------------------------------------------------

    def on_root_sync(self, msg: Message) -> None:
        """A root sync (or WELCOME) opens leaf round ``version``: adopt
        the model and run the inherited round over this leaf's clients.
        A duplicate of the version in flight does nothing; a sync of a
        version already flushed re-runs it (the root re-serves a version
        only when its partial died with an incarnation)."""
        version = int(msg.get(KEY_ROUND))
        variables = to_tensors(msg.get(KEY_MODEL_PARAMS), self.device)
        with self._lock:
            if self.done.is_set() or self.failure is not None:
                return
            sync = self._round_sync
            if (sync is not None and sync[0] == version
                    and self.round_idx == version):
                return
            # every inherited reader (variables, decompression, the
            # anomaly scorer's reference) now sees the tier model
            self.state = self.state._replace(variables={
                k: variables[k] for k in self.state.variables})
            self.round_idx = version
        self.start_round()

    def on_root_finish(self, msg: Message) -> None:
        self.root_finished.set()
        self.done.set()
        self.finish_all()  # FINISH this leaf's clients, stop the downlink
        self._uplink.finish()

    # -- the aggregation tail ------------------------------------------------

    def _close_round(self, results: dict, closed_idx: int,
                     n_live: int | None = None,
                     dead: list[int] | None = None) -> None:
        """Decompress, score and exclude (this leaf's reputation), clip,
        sum, one frame upstream. No server step, no checkpoint and no
        next round here: the next root sync opens it."""
        tr = telemetry.TRACER
        if tr is not None:
            tr.log_round_end(closed_idx)
        m = telemetry.METRICS
        ranks = sorted(results)
        stacked = self._dense_stack(results, ranks)
        included = self._score_and_exclude(results, closed_idx, stacked)
        if included != ranks:
            keep = torch.tensor([ranks.index(r) for r in included],
                                device=self.device)
            stacked = {k: v.index_select(0, keep) for k, v in stacked.items()}
        weights = torch.tensor([results[r][1] for r in included],
                               dtype=torch.float32, device=self.device)
        gv = self.variables
        clipped = self._pipeline.preprocess(
            {k: stacked[k] - g[None] for k, g in gv.items()})
        # the weighted sum over the client axis, in the leaves' type
        psum = {k: torch.tensordot(weights.to(d.dtype), d, dims=1)
                for k, d in clipped.items()}
        n_total = float(weights.sum())
        payload = TIER.build_partial(psum, n_total, len(included))
        nbytes = sum(a.numel() * a.element_size()
                     if isinstance(a, torch.Tensor) else a.nbytes
                     for a in payload[TIER.KEY_TIER_SUM].values())
        self.partials_sent += 1
        if m.enabled:
            m.inc("tier.partial_sums")
            m.inc("tier.leaf_rounds")
            m.inc("tier.forward_bytes", nbytes)
            m.gauge("round.results", len(results))
        telemetry.RECORDER.record("tier_partial", version=closed_idx,
                                  clients=len(included), n=n_total)
        try:
            self._uplink.send_message(Message(
                MSG_TYPE_L2R_PARTIAL, self._uplink.rank, 0,
                {**payload, KEY_NUM_SAMPLES: n_total,
                 KEY_ROUND: closed_idx}))
        except Exception:
            # the root is unreachable: the uplink watchdog owns the
            # verdict, and the root's straggler machinery absorbs the
            # lost partial
            telemetry.METRICS.inc("tier.partial_send_failures")


class _PartialRootMixin:
    """The root's partial handling, shared by both roots so that the
    synchronous and async trees cannot drift on the wire contract: the
    receive-edge screen and ``[sum, n, count]`` to the delta a fold or a
    round consumes."""

    def _init_partial_plane(self, tier_spec: TIER.TierSpec) -> None:
        self.tier_spec = tier_spec
        # partials ride the leaf-to-root edge dense (one frame a flush);
        # the client codec is the leaves' business, so the inherited
        # compressed-result screens are switched off here
        self._cspec = C.CompressionSpec()
        self._payload_template = None
        self.register_message_receive_handler(MSG_TYPE_L2R_PARTIAL,
                                              self._handle_partial)
        # a client wired straight at the root is a topology error: its
        # result must not join the leaves' partials
        self.register_message_receive_handler(MSG_TYPE_C2S_RESULT,
                                              self._reject_direct_result)

    def status(self) -> dict:
        st = super().status()
        st["tier"] = {
            "role": "root",
            "n_leaves": self.tier_spec.n_leaves,
            "partials_folded": telemetry.METRICS.counter("tier.partial_sums"),
            "partials_rejected": telemetry.METRICS.counter(
                "tier.partial_rejected"),
        }
        return st

    def _reject_direct_result(self, msg: Message) -> None:
        telemetry.METRICS.inc("tier.direct_results_rejected")
        telemetry.RECORDER.record("tier_direct_result_rejected",
                                  peer=msg.sender, round=msg.get(KEY_ROUND))

    def _screen_partial(self, msg: Message):
        """One partial through the receive-edge screen: ``(mean delta on
        the host, n)``, or None (counted and dropped)."""
        n_raw = msg.get(KEY_NUM_SAMPLES)
        n_total = float(n_raw) if n_raw is not None else float("nan")
        err = TIER.validate_partial(self.state.variables, msg.payload,
                                    n_total)
        if err is not None:
            telemetry.METRICS.inc("tier.partial_rejected")
            telemetry.RECORDER.record("tier_partial_rejected",
                                      peer=msg.sender,
                                      round=msg.get(KEY_ROUND), detail=err)
            return None
        inv = 1.0 / n_total
        mean_delta = {k: _host_tensor(s) * inv
                      for k, s in msg.get(TIER.KEY_TIER_SUM).items()}
        telemetry.METRICS.inc("tier.partial_sums")
        return mean_delta, n_total


class TierRootActor(_PartialRootMixin, FedAvgServerActor):
    """The synchronous root: the unchanged round machinery (quorum,
    deadline, defense, reputation, checkpoints) where each worker is a
    leaf and each booked result its partial as one weighted row
    ``global + sum / n``. The weighted mean over leaf rows is the flat
    world's over every client; the defense rule and the reputation plane
    act at leaf granularity, the root's own tier."""

    def __init__(self, *args, tier_spec: TIER.TierSpec, **kwargs):
        super().__init__(*args, **kwargs)
        self._init_partial_plane(tier_spec)

    def _handle_partial(self, msg: Message) -> None:
        with self._lock:
            if self._discard_locked(msg):
                return
        screened = self._screen_partial(msg)
        if screened is None:
            return
        mean_delta, n_total = screened
        with self._lock:
            if self._discard_locked(msg):
                return
            sync = self._round_sync
            if sync is None or sync[0] != self.round_idx:
                return
            # one row a leaf against the round's model: the inherited
            # close recovers sum / n as the leaf's delta
            row = {}
            for k, g in sync[1].items():
                g = _host_tensor(g)
                row[k] = g + mean_delta[k].to(g.dtype)
            self._results[msg.sender] = (row, n_total)
        self._maybe_close_round(deadline_fired=False)


class AsyncTierRootActor(_PartialRootMixin, AsyncFedAvgServerActor):
    """The asynchronous root: a partial folds into the staleness buffer
    as it lands (it carries its delta, so even one older than the
    history ring can be folded), its leaf is re-synced alone, and the
    model is emitted every K partials: the tree with no barrier at
    all."""

    def __init__(self, *args, tier_spec: TIER.TierSpec, **kwargs):
        super().__init__(*args, **kwargs)
        self._init_partial_plane(tier_spec)

    def _handle_partial(self, msg: Message) -> None:
        sender = msg.sender
        msg_round = msg.get(KEY_ROUND)
        with self._lock:
            if self.done.is_set() or self.failure is not None:
                return
            if sender in self.dead_peers:
                return
            if self._ledger.status(sender) == "evicted":
                return
            if msg_round is None:
                return
            v = int(msg_round)
            if v in self._folded.get(sender, ()):
                telemetry.METRICS.inc("round.duplicate_results")
                return
            version = self.round_idx
        lag = version - v
        if lag < 0:
            telemetry.METRICS.inc("async.too_stale")
            self._resync(sender)
            return
        screened = self._screen_partial(msg)
        if screened is not None:
            mean_delta, n_total = screened
            self._fold(sender, {k: to_device(d, self.device)
                                for k, d in mean_delta.items()},
                       n_total, v, lag)
        self._after_result(sender, v)
