"""The experiment harness: the algorithm registry and the seeded
repetition runner, with round checkpoints and resume
(``fedml_tpu.experiments.harness``, its FedAvg family).

:class:`Experiment` runs N repetitions of a config, repetition ``k`` with
``seed + k`` and ``data.seed + k`` under the run name
``<run_name>_rep<k>``, each writing ``<out_dir>/<run_name>_rep<k>/``:
``config.json``, ``metrics.jsonl`` (one record a round), ``summary.json``
and, with ``checkpoint_every > 0``, ``ckpt/`` (``utils/checkpoint.py``).
A run that finds a checkpoint there resumes after it: it logs
``{"resumed_from": r}`` and stamps every row it logs ``"resumed":
true``, so when a round appears twice in ``metrics.jsonl`` (rounds run
again after the last checkpoint) the stamped row is the one to keep.

The JAX package's perf monitor, profiler captures, anatomy, tracer spans
and ``/statusz`` run state wait for the port's observability planes
(ROADMAP Queue A item 11).
"""

from __future__ import annotations

import dataclasses
import os

import torch

from fedml_tpu_torch.algorithms.fedavg import (
    FedAvgSim,
    ServerState,
    consume_round_counters,
)
from fedml_tpu_torch.config import ExperimentConfig
from fedml_tpu_torch.core import fuse as FU
from fedml_tpu_torch.data import load_dataset
from fedml_tpu_torch.metrics import MetricsSink
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.utils.checkpoint import RoundCheckpointer, from_savable

# the registry's FedAvg family: --algorithm -> the FedConfig.algorithm
# FedAvgSim runs (fedprox is fedavg with TrainConfig.prox_mu; the robust
# and multiclient aliases are fedavg with the FedConfig defenses and the
# adversaries, as in the JAX package)
ALGORITHMS = {"fedavg": "fedavg", "fedopt": "fedopt", "fedprox": "fedavg",
              "fednova": "fednova", "fedavg_robust": "fedavg",
              "fedavg_multiclient": "fedavg"}


def build_sim(cfg: ExperimentConfig,
              device: str | torch.device = "cuda") -> FedAvgSim:
    """The simulation of ``cfg.fed.algorithm`` on ``device``."""
    algo = cfg.fed.algorithm
    if algo not in ALGORITHMS:
        raise NotImplementedError(
            f"algorithm={algo!r} is not ported to fedml_tpu_torch yet "
            "(ROADMAP: Queue A item 13, the other algorithm families)")
    cfg = dataclasses.replace(cfg, fed=dataclasses.replace(
        cfg.fed, algorithm=ALGORITHMS[algo]))
    return FedAvgSim(create_model(cfg.model, device), load_dataset(cfg.data),
                     cfg, device)


class Experiment:
    """Seeded repetitions of ``cfg`` on ``device``."""

    def __init__(self, cfg: ExperimentConfig, repetitions: int = 1,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.repetitions = repetitions
        self.device = device

    def run(self) -> list[dict]:
        """Run every repetition; returns their summaries (the last value
        of every logged key, and the run name)."""
        summaries = []
        for rep in range(self.repetitions):
            cfg = dataclasses.replace(
                self.cfg, seed=self.cfg.seed + rep,
                data=dataclasses.replace(self.cfg.data,
                                         seed=self.cfg.data.seed + rep),
                run_name=f"{self.cfg.run_name}_rep{rep}")
            out_dir = os.path.join(cfg.out_dir, cfg.run_name)
            sim = build_sim(cfg, self.device)
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, "config.json"), "w") as f:
                f.write(cfg.to_json())
            sink = MetricsSink(path=os.path.join(out_dir, "metrics.jsonl"))
            try:
                self._run_sim(sim, cfg, sink)
            finally:
                sink.close()
            summaries.append(dict(sink.summary, run_name=cfg.run_name))
        return summaries

    @staticmethod
    def _run_sim(sim: FedAvgSim, cfg: ExperimentConfig,
                 sink: MetricsSink) -> None:
        """Without checkpoints the sim's own :meth:`FedAvgSim.run`; with
        ``checkpoint_every > 0`` the harness's loop, which restores the
        latest checkpoint of ``<run dir>/ckpt`` and saves one every
        ``checkpoint_every`` rounds and after the last."""
        if cfg.checkpoint_every <= 0:
            sim.run(metrics_sink=sink)
            return
        ckpt = RoundCheckpointer(os.path.join(os.path.dirname(sink.path),
                                              "ckpt"))
        try:
            state, start_round = Experiment._restore_state(ckpt, sim,
                                                           sim.init())
            if start_round:
                sink.log({"resumed_from": start_round})
            if cfg.fed.fuse_rounds > 1:
                Experiment._fused_loop(sim, cfg, sink, state, start_round,
                                       ckpt)
            else:
                Experiment._round_loop(sim, cfg, sink, state, start_round,
                                       ckpt)
        finally:
            ckpt.close()

    @staticmethod
    def _record(round_idx: int, start_round: int, metrics: dict,
                counters: dict) -> dict:
        record = {"round": round_idx}
        if start_round:
            # this incarnation resumed: its rows win over any earlier row
            # of the same round
            record["resumed"] = True
        record.update(consume_round_counters(metrics, counters))
        return record

    @staticmethod
    def _is_eval(cfg: ExperimentConfig, r: int) -> bool:
        return ((r + 1) % cfg.fed.eval_every == 0
                or r == cfg.fed.num_rounds - 1)

    @staticmethod
    def _is_ckpt(cfg: ExperimentConfig, r: int) -> bool:
        return ((r + 1) % cfg.checkpoint_every == 0
                or r == cfg.fed.num_rounds - 1)

    @staticmethod
    def _round_loop(sim, cfg, sink, state, start_round, ckpt) -> None:
        for r in range(start_round, cfg.fed.num_rounds):
            state, m = sim.run_round(state)
            record = Experiment._record(r, start_round, m, sim.counters)
            if Experiment._is_eval(cfg, r):
                record.update(Experiment._eval_record(sim, state))
            sink.log(record)
            if Experiment._is_ckpt(cfg, r):
                Experiment._save_state(ckpt, sim, r, state)

    @staticmethod
    def _fused_loop(sim, cfg, sink, state, start_round, ckpt) -> None:
        """The loop in fused blocks (``core/fuse.py`` ``drive``, as
        ``FedAvgSim._run_fused``): the blocks end on every evaluation and
        checkpoint round, so both see the state the per-round loop
        would."""
        box = [state]

        def run_block(length):
            box[0], metrics = sim.run_block(box[0], length)
            return metrics

        def make_records(start, rows):
            return [Experiment._record(start + i, start_round, row,
                                       sim.counters)
                    for i, row in enumerate(rows)]

        def boundary_hook(r_last, last):
            if Experiment._is_eval(cfg, r_last):
                last.update(Experiment._eval_record(sim, box[0]))
            sink.log(last)
            if Experiment._is_ckpt(cfg, r_last):
                Experiment._save_state(ckpt, sim, r_last, box[0])

        sim.last_blocks = FU.drive(
            run_block, FU.plan_blocks(start_round, cfg.fed.num_rounds,
                                      cfg.fed.fuse_rounds,
                                      cfg.fed.eval_every,
                                      cfg.checkpoint_every),
            make_records=make_records, log=sink.log,
            boundary_hook=boundary_hook,
            programs=sim.cohort_update.programs)

    @staticmethod
    def _save_state(ckpt: RoundCheckpointer, sim: FedAvgSim, r: int,
                    state: ServerState) -> None:
        """Checkpoint round ``r``: with client-state banks (a personalized
        run's adapters, the bulk engine's error-feedback residual) the
        ``{"server": state, "bank": {name: rows}}`` composite, so every
        client's row restores bit for bit; without them the bare state.
        The stacked round's ``[C, ...]`` residual
        (``FedAvgSim.ef_residual``) is not saved, as in the JAX package: a
        resumed stacked compressed run starts it from zero."""
        banks = sim.bank_state()
        ckpt.save(r, {"server": state, "bank": banks} if banks else state)

    @staticmethod
    def _restore_state(ckpt: RoundCheckpointer, sim: FedAvgSim,
                       state: ServerState) -> tuple[ServerState, int]:
        """The restore half of :meth:`_save_state`: ``(state, next
        round)``. A composite's banks go to :meth:`FedAvgSim.
        restore_banks`; a bare checkpoint (or a composite without this
        run's bank) leaves the fresh banks to be made at the first
        round."""
        raw, nxt = ckpt.restore_raw()
        if raw is None:
            return state, 0
        bank = None
        if "server" in raw:
            raw, bank = raw["server"], raw.get("bank")
        restored = from_savable(state, raw)
        sim.restore_banks(restored, bank)
        return restored, nxt

    @staticmethod
    def _eval_record(sim: FedAvgSim, state: ServerState) -> dict:
        """The global evaluation, ``acc`` and ``loss`` under the
        summary's names ``test_acc`` and ``test_loss``."""
        rename = {"acc": "test_acc", "loss": "test_loss"}
        return {rename.get(k, k): v
                for k, v in sim.evaluate_global(state).items()}
