"""The experiment harness: the algorithm registry and the seeded
repetition runner, with round checkpoints and resume
(``fedml_tpu.experiments.harness``, its FedAvg family with the
``fedseg`` alias, the GAN family: FedGAN, FedGDKD, FedDTG, FedSSGAN and
FedUAGAN, the distillation family: FedMD, FD+FAug and FedArjun, and the
topologies: hierarchical, decentralized DSGD and push-sum, and their
online variants ``dol_dsgd`` and ``dol_pushsum``, split learning:
FedGKT, SplitNN and classical vertical FL, FedNAS, TurboAggregate's
secure FedAvg and the local-only and centralized baselines): every name
of the JAX package's ``ALGORITHMS``.

:class:`Experiment` runs N repetitions of a config, repetition ``k`` with
``seed + k`` and ``data.seed + k`` under the run name
``<run_name>_rep<k>``, each writing ``<out_dir>/<run_name>_rep<k>/``:
``config.json``, ``metrics.jsonl`` (one record a round), ``summary.json``
and, with ``checkpoint_every > 0``, ``ckpt/`` (``utils/checkpoint.py``).
A run that finds a checkpoint there resumes after it: it logs
``{"resumed_from": r}`` and stamps every row it logs ``"resumed":
true``, so when a round appears twice in ``metrics.jsonl`` (rounds run
again after the last checkpoint) the stamped row is the one to keep.
The GAN family's states (generators, discriminators, classifier and
discriminator banks, FedGDKD's last distillation set and cohort,
UA-GAN's generator optimizer) and the distillation family's (the
client model banks, FD's teachers, FedArjun's adapter) checkpoint the
same way; they have no fused blocks, so ``fuse_rounds > 1`` warns and
the rounds run one by one, as in the JAX package. A sim without ``run``
(all of the GAN family but FedGDKD, the distillation family, the
hierarchical and decentralized sims) goes through the harness's round
loop, and one without an evaluator (FedGAN, FedSSGAN, FedUAGAN) logs no
evaluation. The online sims have ``run`` only: they log their regret
rows themselves, and ``checkpoint_every`` warns and is ignored for them,
as in the JAX package. The round loop drives each sim's own protocol:
``run_round(state, round_idx)`` where the sim takes the round index
(the centralized trainer, the secure FedAvg), ``run_round(state)``
otherwise, and the first evaluator the sim has of ``evaluate_global``,
``evaluate_clients``, ``evaluate_consensus`` and ``evaluate``.

The observability planes ride the loops as in the JAX package: a sim's
own ``run`` is one ``sim_run`` tracer span; the harness's round loop
builds the perf pair (``core/perf.py``: capture windows, round rate; MFU
for the FedAvg family only), sets the ``/statusz`` run block, wraps each
round in a ``sim_round`` span and notes its wall after the host has read
its metrics; the fused loop does the same by block (``sim_block``
spans, ``core/fuse.py`` ``drive``).
"""

from __future__ import annotations

import dataclasses
import inspect
import os
import warnings

import numpy as np
import torch

from fedml_tpu_torch.algorithms.decentralized import (
    DecentralizedSim,
    OnlineDecentralizedSim,
)
from fedml_tpu_torch.algorithms.distill import (
    FDSim,
    FedArjunSim,
    FedMDSim,
)
from fedml_tpu_torch.algorithms.fedavg import (
    FedAvgSim,
    ServerState,
    consume_round_counters,
)
from fedml_tpu_torch.algorithms.gan_family import (
    FedDTGSim,
    FedGANSim,
    FedGDKDSim,
)
from fedml_tpu_torch.algorithms.fednas import FedNASSim
from fedml_tpu_torch.algorithms.hierarchical import HierarchicalFedAvg
from fedml_tpu_torch.algorithms.local_baselines import (
    BaselineSim,
    CentralizedTrainer,
)
from fedml_tpu_torch.algorithms.mpc import SecureFedAvgSim
from fedml_tpu_torch.algorithms.sgan import FedSSGANSim, FedUAGANSim
from fedml_tpu_torch.algorithms.split import FedGKTSim, SplitNNSim, VFLSim
from fedml_tpu_torch.config import ExperimentConfig
from fedml_tpu_torch.core import export
from fedml_tpu_torch.core import fuse as FU
from fedml_tpu_torch.core import perf as P
from fedml_tpu_torch.core import telemetry
from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.data import load_dataset
from fedml_tpu_torch.data import streaming as S
from fedml_tpu_torch.data.vertical import (
    load_lending_club_two_party,
    load_nus_wide_two_party,
)
from fedml_tpu_torch.metrics import MetricsSink
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models import gkt as GKT
from fedml_tpu_torch.models.base import FedModel, weightless
from fedml_tpu_torch.models.darts import DARTSNetwork
from fedml_tpu_torch.models.gan import (
    acgan_discriminator,
    generator_from_config,
)
from fedml_tpu_torch.utils.checkpoint import RoundCheckpointer, from_savable

# the registry's FedAvg family: --algorithm -> the FedConfig.algorithm
# FedAvgSim runs (fedprox is fedavg with TrainConfig.prox_mu; the robust
# and multiclient aliases are fedavg with the FedConfig defenses and the
# adversaries, fedseg fedavg with the segmentation task its dataset
# names, as in the JAX package)
ALGORITHMS = {"fedavg": "fedavg", "fedopt": "fedopt", "fedprox": "fedavg",
              "fednova": "fednova", "fedavg_robust": "fedavg",
              "fedavg_multiclient": "fedavg", "fedseg": "fedavg"}


# the GAN family (fedml_tpu.experiments.harness _build_gan)
GAN_FAMILY = ("fedgan", "fedgdkd", "feddtg", "fedssgan", "feduagan")


def _build_gan(cfg: ExperimentConfig, device):
    """The GAN family's sims as the JAX harness builds them: the
    conditional generator at the data's image size (its nz and ngf from
    ``cfg.gan``); FedGDKD's and FedDTG's classifiers from ``cfg.model``;
    the ACGAN discriminator at its defaults (features 32/64/128, dropout
    0.25), without its validity head for FedSSGAN."""
    algo = cfg.fed.algorithm
    shape = tuple(cfg.model.input_shape)
    k = cfg.model.num_classes
    gen = generator_from_config(cfg.gan, k, shape[0], shape[-1],
                                device=device)
    data = load_dataset(cfg.data)
    if algo == "fedgdkd":
        return FedGDKDSim(gen, create_model(cfg.model, device), data, cfg,
                          device)
    disc = acgan_discriminator(k, shape, validity_head=algo != "fedssgan",
                               device=device)
    if algo == "fedgan":
        return FedGANSim(gen, disc, data, cfg, device)
    if algo == "feddtg":
        return FedDTGSim(gen, disc, create_model(cfg.model, device), data,
                         cfg, device)
    if algo == "fedssgan":
        return FedSSGANSim(gen, disc, data, cfg, device)
    return FedUAGANSim(gen, disc, data, cfg, device)


# the distillation family (fedml_tpu.experiments.harness _build_distill)
DISTILL_FAMILY = ("fedmd", "fd_faug", "fedarjun")


def _build_distill(cfg: ExperimentConfig, device):
    """The distillation family's sims as the JAX harness builds them, on
    ``cfg.model``; FedArjun's private local model is ``cfg.model`` renamed
    ``lr``. FedMD's ``init`` pretrains."""
    algo = cfg.fed.algorithm
    data = load_dataset(cfg.data)
    model = create_model(cfg.model, device)
    if algo == "fedmd":
        return FedMDSim(model, data, cfg, device)
    if algo == "fd_faug":
        return FDSim(model, data, cfg, device)
    local = create_model(dataclasses.replace(cfg.model, name="lr"), device)
    return FedArjunSim(model, local, data, cfg, device)


# the topologies (fedml_tpu.experiments.harness _build_hierarchical,
# _build_decentralized, _build_dol)
TOPOLOGY_FAMILY = ("hierarchical", "decentralized_dsgd",
                   "decentralized_pushsum", "dol_dsgd", "dol_pushsum")


def _build_topology(cfg: ExperimentConfig, device):
    """The hierarchical sim (2 groups, one inner round, the JAX harness's
    defaults) or a decentralized one over the ring of 2 neighbours. The
    online sims (``dol_*``) run ``comm_round`` iterations on the UCI
    stream that ``susy`` or ``ro`` reads under ``data.data_dir``, else on
    the procedural SUSY-shaped stream, ``beta`` from ``partition_alpha``
    only under ``partition_method == "hetero"``, logging every
    ``eval_every``."""
    algo = cfg.fed.algorithm
    if algo.startswith("dol_"):
        name = cfg.data.dataset.lower()
        n, t = cfg.data.num_clients, cfg.fed.num_rounds
        beta = (cfg.data.partition_alpha
                if cfg.data.partition_method == "hetero" else 0.0)
        if name in ("susy", "ro"):
            xs, ys = S.load_uci_stream(name, cfg.data.data_dir, n, t,
                                       beta=beta, seed=cfg.data.seed)
        else:
            xs, ys = S.make_susy_like_stream(n, t, beta=beta,
                                             seed=cfg.data.seed)
        sim = OnlineDecentralizedSim(
            xs, ys, method=algo[len("dol_"):], lr=cfg.train.lr,
            weight_decay=cfg.train.weight_decay, seed=cfg.seed,
            device=device)
        sim.log_every = cfg.fed.eval_every
        return sim
    data = load_dataset(cfg.data)
    model = create_model(cfg.model, device)
    if algo == "hierarchical":
        return HierarchicalFedAvg(model, data, cfg, device)
    return DecentralizedSim(model, data, cfg, device,
                            method=algo[len("decentralized_"):])


def _fed_model(module_fn, shape, device) -> FedModel:
    return FedModel(weightless(module_fn), tuple(shape),
                    resolve_device(device))


def _build_fedgkt(cfg: ExperimentConfig, device):
    """FedGKT at the JAX harness's defaults: the ``resnet8_56`` edge and
    the Bottleneck [6, 6, 6] server, on ``cfg.data``'s images."""
    shape = tuple(cfg.model.input_shape)
    k = cfg.model.num_classes
    return FedGKTSim(
        _fed_model(lambda: GKT.GKTClientResNet(k, in_channels=shape[-1]),
                   shape, device),
        _fed_model(lambda: GKT.GKTServerResNet(k), shape[:2]
                   + (GKT.EDGE_WIDTH,), device),
        load_dataset(cfg.data), cfg, device)


def _build_splitnn(cfg: ExperimentConfig, device):
    """SplitNN at the JAX harness's defaults (convs 32/64, hidden 128),
    on ``cfg.data``'s images."""
    shape = tuple(cfg.model.input_shape)
    width = GKT.split_out_features(shape)
    return SplitNNSim(
        _fed_model(lambda: GKT.SplitClientNet(in_channels=shape[-1]), shape,
                   device),
        _fed_model(lambda: GKT.SplitServerNet(width, cfg.model.num_classes),
                   (width,), device),
        load_dataset(cfg.data), cfg, device)


def vfl_data(cfg: ExperimentConfig) -> dict:
    """Vertical FL's two-party set: ``nus_wide`` ("person" against the
    rest: the sim is binary) or ``lending_club`` read under
    ``data.data_dir``, else the offline ``fake_vfl``: 512 train and 128
    test rows of 24 standard normal features, labelled by a seeded
    ``x @ w > 0``, the columns split in halves."""
    ds = cfg.data.dataset
    if ds == "nus_wide":
        return load_nus_wide_two_party(cfg.data.data_dir,
                                       binary_positive="person")
    if ds == "lending_club":
        return load_lending_club_two_party(cfg.data.data_dir)
    rng = np.random.default_rng(cfg.data.seed)
    n, dim = 512, 24
    w = rng.normal(size=(dim,))
    x = rng.normal(size=(n, dim)).astype(np.float32)
    xt = rng.normal(size=(n // 4, dim)).astype(np.float32)
    return {"train": (x, (x @ w > 0).astype(np.float32)),
            "test": (xt, (xt @ w > 0).astype(np.float32)),
            "splits": [(0, dim // 2), (dim // 2, dim)]}


def _build_vfl(cfg: ExperimentConfig, device):
    """Two-party classical vertical FL: a party's local model (hidden
    16, out 8) and its dense logit head over its column slice."""
    d = vfl_data(cfg)
    models = []
    for lo, hi in d["splits"]:
        models.append((
            _fed_model(lambda w=hi - lo: GKT.VFLLocalModel(w, 8, 16),
                       (hi - lo,), device),
            _fed_model(lambda: GKT.VFLDenseModel(8), (8,), device)))
    return VFLSim(models, d["splits"], *d["train"], *d["test"], cfg, device)


def _build_fednas(cfg: ExperimentConfig, device):
    """FedNAS over ``DARTSNetwork`` at its defaults."""
    shape = tuple(cfg.model.input_shape)
    return FedNASSim(_fed_model(lambda: DARTSNetwork(
        cfg.model.num_classes, in_channels=shape[-1]), shape, device),
        load_dataset(cfg.data), cfg, device)


def _build_turboaggregate(cfg: ExperimentConfig, device):
    """FedAvg with TurboAggregate's secure sum as the server's rule."""
    return SecureFedAvgSim(create_model(cfg.model, device),
                           load_dataset(cfg.data), cfg, device)


def _build_baseline(cfg: ExperimentConfig, device):
    return BaselineSim(create_model(cfg.model, device),
                       load_dataset(cfg.data), cfg, device)


def _build_centralized(cfg: ExperimentConfig, device):
    return CentralizedTrainer(create_model(cfg.model, device),
                              load_dataset(cfg.data), cfg, device)


# the rest of the registry (fedml_tpu.experiments.harness _build_fedgkt,
# _build_splitnn, _build_vfl, _build_turboaggregate, _build_fednas,
# _build_baseline, _build_centralized)
REGISTRY = {
    **{name: _build_gan for name in GAN_FAMILY},
    **{name: _build_distill for name in DISTILL_FAMILY},
    **{name: _build_topology for name in TOPOLOGY_FAMILY},
    "fedgkt": _build_fedgkt, "splitnn": _build_splitnn,
    "vfl": _build_vfl, "classical_vertical_fl": _build_vfl,
    "turboaggregate": _build_turboaggregate, "fednas": _build_fednas,
    "baseline": _build_baseline, "centralized": _build_centralized,
}


def build_sim(cfg: ExperimentConfig, device: str | torch.device = "cuda"):
    """The simulation of ``cfg.fed.algorithm`` on ``device``; an unknown
    name raises ``ValueError``, as in the JAX package."""
    algo = cfg.fed.algorithm
    if algo in REGISTRY:
        return REGISTRY[algo](cfg, device)
    if algo not in ALGORITHMS:
        raise ValueError(f"unknown algorithm: {algo}; known: "
                         f"{sorted({*ALGORITHMS, *REGISTRY})}")
    cfg = dataclasses.replace(cfg, fed=dataclasses.replace(
        cfg.fed, algorithm=ALGORITHMS[algo]))
    return FedAvgSim(create_model(cfg.model, device), load_dataset(cfg.data),
                     cfg, device)


def _wants_round(sim) -> bool:
    """Whether the sim's ``run_round`` takes the round index too."""
    return len(inspect.signature(sim.run_round).parameters) >= 2


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
    def _run_sim(sim, cfg: ExperimentConfig, sink: MetricsSink) -> None:
        """Without checkpoints the sim's own ``run`` where it has one;
        otherwise the harness's loop, which with ``checkpoint_every > 0``
        restores the latest checkpoint of ``<run dir>/ckpt`` and saves one
        every ``checkpoint_every`` rounds and after the last. A sim
        without ``run_block`` (the GAN family) runs its rounds one by one
        under ``fuse_rounds > 1``, with a warning."""
        if cfg.checkpoint_every > 0 and not hasattr(sim, "run_round"):
            warnings.warn(
                f"checkpoint_every={cfg.checkpoint_every} ignored: "
                f"{type(sim).__name__} has no init/run_round state "
                "protocol", stacklevel=2)
            with telemetry.maybe_span("sim_run", sim=type(sim).__name__):
                sim.run(metrics_sink=sink)
            return
        fused = cfg.fed.fuse_rounds > 1 and hasattr(sim, "run_block")
        if cfg.fed.fuse_rounds > 1 and not fused:
            warnings.warn(
                f"fuse_rounds={cfg.fed.fuse_rounds} ignored: "
                f"{type(sim).__name__} has no fused blocks (run_block); "
                "running per round", stacklevel=2)
        if cfg.checkpoint_every <= 0:
            if hasattr(sim, "run"):
                # a sim's own loop: one span over the whole run
                with telemetry.maybe_span("sim_run", sim=type(sim).__name__):
                    sim.run(metrics_sink=sink)
            else:
                Experiment._round_loop(sim, cfg, sink, sim.init(), 0, None)
            return
        ckpt = RoundCheckpointer(os.path.join(os.path.dirname(sink.path),
                                              "ckpt"))
        try:
            state, start_round = Experiment._restore_state(ckpt, sim,
                                                           sim.init())
            if start_round:
                sink.log({"resumed_from": start_round})
            if fused:
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
        """The per-round loop, with the perf pair (inert unless
        ``profile_rounds > 0``): a round's capture window and wall end
        after the host has read its metrics (``_record``), so they cover
        the device's work."""
        rp = P.RoundPerf(sim)
        try:
            for r in range(start_round, cfg.fed.num_rounds):
                export.set_round(r, cfg)
                with rp.round(r), telemetry.maybe_span("sim_round", round=r):
                    state, m = (sim.run_round(state, r) if _wants_round(sim)
                                else sim.run_round(state))
                    record = Experiment._record(r, start_round, m,
                                                sim.counters)
                if Experiment._is_eval(cfg, r):
                    record.update(Experiment._eval_record(sim, state))
                sink.log(record)
                if ckpt is not None and Experiment._is_ckpt(cfg, r):
                    Experiment._save_state(ckpt, sim, r, state)
        finally:
            rp.close()

    @staticmethod
    def _fused_loop(sim, cfg, sink, state, start_round, ckpt) -> None:
        """The loop in fused blocks (``core/fuse.py`` ``drive``, as
        ``FedAvgSim._run_fused``): the blocks end on every evaluation and
        checkpoint round, so both see the state the per-round loop
        would."""
        rp = P.RoundPerf(sim)
        try:
            Experiment._drive_blocks(sim, cfg, sink, state, start_round,
                                     ckpt, rp.profiler, rp.monitor)
        finally:
            rp.close()

    @staticmethod
    def _drive_blocks(sim, cfg, sink, state, start_round, ckpt, profiler,
                      monitor) -> None:
        box = [state]

        def run_block(length):
            box[0], metrics = sim.run_block(box[0], length)
            return metrics

        def make_records(start, rows):
            return [Experiment._record(start + i, start_round, row,
                                       sim.counters)
                    for i, row in enumerate(rows)]

        def boundary_hook(r_last, last):
            export.set_round(r_last, cfg)
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
            programs=sim.cohort_update.programs, profiler=profiler,
            monitor=monitor, span=lambda start, rounds: telemetry.maybe_span(
                "sim_block", start=start, rounds=rounds))

    @staticmethod
    def _save_state(ckpt: RoundCheckpointer, sim, r: int, state) -> None:
        """Checkpoint round ``r``: with client-state banks (a personalized
        run's adapters, the bulk engine's error-feedback residual) the
        ``{"server": state, "bank": {name: rows}}`` composite, so every
        client's row restores bit for bit; without them the bare state.
        The stacked round's ``[C, ...]`` residual
        (``FedAvgSim.ef_residual``) is not saved, as in the JAX package: a
        resumed stacked compressed run starts it from zero. A sim without
        banks (FedGDKD) saves its bare state."""
        banks = sim.bank_state() if hasattr(sim, "bank_state") else {}
        ckpt.save(r, {"server": state, "bank": banks} if banks else state)

    @staticmethod
    def _restore_state(ckpt: RoundCheckpointer, sim, state
                       ) -> tuple[ServerState, int]:
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
        if hasattr(sim, "restore_banks"):
            sim.restore_banks(restored, bank)
        return restored, nxt

    @staticmethod
    def _eval_record(sim, state) -> dict:
        """The evaluation: the global model's (``evaluate_global``), the
        mean over the clients' own models (``evaluate_clients``: FedGDKD,
        FedDTG, the distillation family and the local baseline), the
        clients' mean model (``evaluate_consensus``: the decentralized
        sims) or the sim's own (``evaluate``: split learning, FedNAS, the
        centralized trainer), its scalars with
        ``acc`` and ``loss`` under the summary's names ``test_acc`` and
        ``test_loss``; nothing for a sim without an evaluator."""
        evaluate = (getattr(sim, "evaluate_global", None)
                    or getattr(sim, "evaluate_clients", None)
                    or getattr(sim, "evaluate_consensus", None)
                    or getattr(sim, "evaluate", None))
        if evaluate is None:
            return {}
        rename = {"acc": "test_acc", "loss": "test_loss"}
        return {rename.get(k, k): v for k, v in evaluate(state).items()
                if isinstance(v, (int, float))}
