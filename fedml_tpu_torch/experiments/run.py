"""CLI entry: ``python -m fedml_tpu_torch.experiments.run ...``.

The FedAvg family of ``fedml_tpu.experiments.run`` (``--algorithm``
fedavg, fedopt, fedprox, fednova, fedavg_robust, fedavg_multiclient and
fedseg, the segmentation alias: the task comes from the dataset) and
the GAN family (``--algorithm`` fedgan, fedgdkd, feddtg, fedssgan,
feduagan) and the distillation family (``--algorithm`` fedmd, fd_faug,
fedarjun; their settings, as the GAN family's, the ``gan`` section of
the ``--config`` JSON, as the JAX CLI has no GAN flags) and the
topologies (``--algorithm`` hierarchical, decentralized_dsgd,
decentralized_pushsum, and the online dol_dsgd and dol_pushsum, whose
``--comm_round`` is the stream's length) and the rest of the JAX
registry (``--algorithm`` fedgkt, splitnn, vfl, classical_vertical_fl,
fednas, turboaggregate, baseline, centralized; vfl's ``--dataset`` is
fake_vfl, or nus_wide or lending_club), with its flag names: the data
directory (``--data_dir``: the files a dataset name reads, MNIST's IDX,
CIFAR's pickles, the TFF h5 and LEAF json splits, ImageNet, Landmarks,
the UCI streams; ``data/loaders.py``), the
defenses
(``--defense`` or ``--robust_method``, ``--defense_*``,
``--robust_norm_clip``, ``--robust_noise_stddev``), the wire codec
(``--compress``, ``--compress_topk_frac``), the seeded adversaries
(``--adversary_*``), buffered asynchronous aggregation
(``--async_buffer_k``, ``--staleness_fn``, ``--staleness_alpha``:
checked when parsed with ``check_async_compat``, then a deployment
setting, which the simulators ignore with a warning, as the JAX CLI
does), the bulk engine (``--client_block_size``) and
elastic buckets (``--elastic``), fused blocks (``--fuse_rounds``), LoRA
fine-tuning (``--peft lora``, ``--lora_rank``, ``--lora_alpha``,
``--lora_targets``, ``--peft_personalize``) and the harness's flags
(``--repetitions``, ``--run_name``, ``--out_dir``,
``--checkpoint_every``) and the observability planes' (``--telemetry_dir``,
``--trace``, ``--trace_torch``, ``--profile_rounds``, ``--metrics_interval``,
``--mem_headroom_warn``, ``--metrics_port``, ``--metrics_host``, ``--slo``,
``--anatomy``, ``--profile_on_breach``, ``--profile_window_s``,
``--profile_max_captures``; any of them switches telemetry on for the
process, its artifacts under ``--telemetry_dir`` or
``<out_dir>/<run_name>/telemetry``) and the deployment's (``--role
server|client|leaf`` with ``--rank``, ``--world_size``, ``--backend tcp``,
``--ip_config``, ``--ready_timeout``, the liveness flags
``--heartbeat_interval``/``--heartbeat_timeout``/``--no_heartbeats``, the
round policy ``--quorum_fraction``/``--round_deadline``/
``--recovery_extensions``, the chaos flags ``--fault_*``, the reputation
plane's ``--quarantine_*``, ``--leave_after_round``, the tier world's
``--tier_spec``, ``--uplink_ip_config`` and ``--tier_client_base``: one
rank of the FedAvg family, synchronous or buffered-async, flat or
tiered, ``experiments/deploy.py``; its default backend
is tcp, where the JAX CLI's is grpc, which this package has not ported).
Config precedence: ``--config``
JSON (the full :class:`ExperimentConfig` shape, the same file the JAX
package reads) overridden by explicit flags. Client momentum and
weight decay come in through ``--config``, and so does FedProx's
``prox_mu``. The run goes
through :class:`~fedml_tpu_torch.experiments.harness.Experiment` on
``--device`` (default ``cuda``, which raises without a card), writes
``<out_dir>/<run_name>_rep<k>/`` and prints each repetition's summary as
one JSON line. With ``--checkpoint_every N`` a run started again with the
same flags resumes after its last checkpoint. A setting the port does
not have yet raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from fedml_tpu_torch.algorithms.async_actors import check_async_compat
from fedml_tpu_torch.config import ADVERSARY_MODES, ExperimentConfig
from fedml_tpu_torch.core import anatomy, telemetry
from fedml_tpu_torch.core.async_agg import STALENESS_FNS
from fedml_tpu_torch.core.bulk import BulkSpec, check_bulk_compat
from fedml_tpu_torch.core.compress import METHODS, CompressionSpec
from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.core.reputation import QuarantinePolicy
from fedml_tpu_torch.core.robust import (
    DefensePipeline,
    check_fednova_compat,
)
from fedml_tpu_torch.core.slo import parse_specs
from fedml_tpu_torch.core.tier import TierSpec
from fedml_tpu_torch.peft import (
    LORA_TARGETS,
    LoRASpec,
    check_model_supported,
    check_peft_compat,
)


def parse_args(argv=None) -> tuple[ExperimentConfig, argparse.Namespace]:
    p = argparse.ArgumentParser(
        prog="fedml_tpu_torch.experiments.run",
        description="federated learning experiment runner (PyTorch port)",
    )
    p.add_argument("--config", type=str, default=None,
                   help="JSON file with the full ExperimentConfig")
    p.add_argument("--algorithm", type=str, default=None,
                   help="fedavg, fedopt, fedprox, fednova, fedavg_robust, "
                        "fedavg_multiclient, fedseg, the GAN family: "
                        "fedgan, fedgdkd, feddtg, fedssgan, feduagan, the "
                        "distillation family: fedmd, fd_faug, fedarjun, "
                        "the topologies: hierarchical, "
                        "decentralized_dsgd, decentralized_pushsum, "
                        "dol_dsgd, dol_pushsum, split learning: fedgkt, "
                        "splitnn, vfl, classical_vertical_fl, or fednas, "
                        "turboaggregate, baseline, centralized")
    p.add_argument("--dataset", type=str, default=None)
    p.add_argument("--data_dir", type=str, default=None,
                   help="where a dataset read from disk lives (default "
                        "./data): mnist/emnist IDX files, cifar10/100 "
                        "pickles, cinic10's ImageFolder tree, the TFF h5 "
                        "and leaf_* json splits, imagenet, landmarks, "
                        "susy/ro for the dol sims")
    p.add_argument("--model", type=str, default=None)
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--input_shape", type=int, nargs="+", default=None)
    p.add_argument("--client_num_in_total", type=int, default=None)
    p.add_argument("--client_num_per_round", type=int, default=None)
    p.add_argument("--comm_round", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None,
                   help="-1 = full batch (one batch per client)")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--client_optimizer", type=str, default=None)
    p.add_argument("--server_optimizer", type=str, default=None,
                   choices=["sgd", "adam", "adagrad", "yogi"],
                   help="server-side optimizer applied to the aggregated "
                        "delta ('sgd' with --server_lr 1.0 == plain "
                        "FedAvg)")
    p.add_argument("--server_lr", type=float, default=None)
    p.add_argument("--server_momentum", type=float, default=None)
    p.add_argument("--gmf", type=float, default=None,
                   help="global momentum factor (0 disables)")
    p.add_argument("--compute_dtype", type=str, default=None,
                   choices=["float32", "bfloat16"],
                   help="mixed-precision compute dtype (params stay f32)")
    p.add_argument("--no_cohort_fused", action="store_true",
                   help="the JAX package's per-client fallback; the port's "
                        "client loop reads it and runs the same way")
    p.add_argument("--partition_method", type=str, default=None)
    p.add_argument("--partition_alpha", type=float, default=None)
    p.add_argument("--frequency_of_the_test", type=int, default=None)
    defenses = list(DefensePipeline.METHODS)
    p.add_argument("--robust_method", type=str, default=None,
                   choices=defenses)
    p.add_argument("--defense", type=str, default=None, choices=defenses,
                   help="aggregation defense rule (alias of "
                        "--robust_method, taking precedence); composes "
                        "with --robust_norm_clip and --robust_noise_stddev")
    p.add_argument("--defense_num_adversaries", type=int, default=None,
                   help="adversary count f the Krum family assumes (each "
                        "score sums the C-f-2 nearest distances)")
    p.add_argument("--defense_multikrum_m", type=int, default=None,
                   help="multi-Krum keep count m (0 = auto: C - f)")
    p.add_argument("--defense_trim_frac", type=float, default=None,
                   help="trimmed_mean's trim fraction, each side")
    p.add_argument("--robust_norm_clip", type=float, default=None)
    p.add_argument("--robust_noise_stddev", type=float, default=None)
    p.add_argument("--compress", type=str, default=None, choices=METHODS,
                   help="wire codec for the client->server delta, with "
                        "error feedback ('none' keeps it dense)")
    p.add_argument("--compress_topk_frac", type=float, default=None,
                   help="share of each leaf's entries the topk family "
                        "keeps (at least 1)")
    p.add_argument("--adversary_mode", type=str, default=None,
                   choices=["none", *ADVERSARY_MODES],
                   help="make selected clients send malicious deltas, "
                        "seeded by --adversary_seed")
    p.add_argument("--adversary_seed", type=int, default=None)
    p.add_argument("--adversary_ranks", type=int, nargs="+", default=None,
                   help="the adversaries' client ids; overrides "
                        "--adversary_num")
    p.add_argument("--adversary_num", type=int, default=None,
                   help="a seeded choice of this many adversaries")
    p.add_argument("--adversary_scale", type=float, default=None,
                   help="sign_flip/scale_boost factor, constant value, "
                        "collude norm")
    p.add_argument("--adversary_noise", type=float, default=None,
                   help="gauss's standard deviation")
    p.add_argument("--async_buffer_k", type=int, default=None,
                   help="FedBuff-style buffered-async aggregation: fold "
                        "every arriving delta into a staleness-weighted "
                        "buffer and emit a new model every K arrivals "
                        "(core/async_agg.py). A deployment setting: the "
                        "simulators run synchronous rounds and ignore it "
                        "with a warning. 0 (default) keeps it off")
    p.add_argument("--staleness_fn", type=str, default=None,
                   choices=list(STALENESS_FNS),
                   help="staleness discount for async folds: poly = "
                        "(1+lag)^-alpha over the version lag, const = "
                        "full weight for every arrival")
    p.add_argument("--staleness_alpha", type=float, default=None,
                   help="exponent of the poly staleness discount "
                        "(0.5 = the FedAsync default)")
    p.add_argument("--client_block_size", type=int, default=None,
                   help="stream the sampled cohort through the device in "
                        "blocks of B clients (the bulk engine): each "
                        "block runs the batched local update and is "
                        "folded into O(model) partial sums, so round "
                        "memory is O(B + model), not O(cohort). Composes "
                        "with --elastic (bucketed block count), "
                        "--compress (a client-keyed error-feedback bank), "
                        "every --defense (two streamed passes) and every "
                        "adversary mode. 0/unset = the stacked round")
    p.add_argument("--elastic", action="store_true",
                   help="pad the cohort to a power-of-two bucket so that "
                        "a live cohort that changes size reuses the one "
                        "program (a captured CUDA graph on the card); "
                        "rides config.json as fed.elastic_buckets")
    p.add_argument("--fuse_rounds", type=int, default=None,
                   help="run the round loop in blocks of K rounds enqueued "
                        "back to back, each block's metrics read back "
                        "once, at its end; evaluation and checkpoint "
                        "rounds end a block. 1 (default) keeps the "
                        "per-round loop")
    p.add_argument("--peft", type=str, default=None,
                   choices=["none", "lora"],
                   help="parameter-efficient fine-tuning: 'lora' wraps the "
                        "transformer's targeted projections with zero-init "
                        "low-rank branches and trains and aggregates only "
                        "the adapters and the LM head; the frozen base takes "
                        "no optimizer state, builds no delta and ships no "
                        "wire bytes (composes with --compress). Transformer "
                        "models only; round 0 computes what the base model "
                        "does")
    p.add_argument("--lora_rank", type=int, default=None,
                   help="LoRA rank r (>= 1); the branch is (alpha / r) x "
                        "A B, A seeded and B zero at init")
    p.add_argument("--lora_alpha", type=float, default=None,
                   help="LoRA scale alpha (> 0)")
    p.add_argument("--lora_targets", type=str, nargs="+", default=None,
                   help=f"which TransformerLM projections get adapters "
                        f"(a subset of {' '.join(LORA_TARGETS)}; default "
                        "q_proj v_proj)")
    p.add_argument("--peft_personalize", action="store_true",
                   help="keep each client's adapters in a private "
                        "per-client bank: only the LM head aggregates. "
                        "Composes with --client_block_size, --elastic, "
                        "--fuse_rounds and --checkpoint_every; --compress, "
                        "a defense other than mean and adversaries are "
                        "refused")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--repetitions", type=int, default=1)
    p.add_argument("--run_name", type=str, default=None)
    p.add_argument("--out_dir", type=str, default=None)
    p.add_argument("--checkpoint_every", type=int, default=None,
                   help="checkpoint the round state every N rounds into "
                        "<out_dir>/<run>/ckpt and resume from the latest "
                        "checkpoint on restart (0 = off)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; 'cpu' only "
                        "when asked)")
    # -- the observability planes (core/telemetry.py, perf.py,
    # memscope.py, export.py, slo.py, anatomy.py) ------------------------
    p.add_argument("--telemetry_dir", type=str, default=None,
                   help="enable the telemetry plane and write THIS "
                        "rank's artifacts here: trace_rank<r>.json span "
                        "dump, metrics_rank<r>.json snapshot, "
                        "flight_rank<r>_*.json crash rings")
    p.add_argument("--trace", action="store_true",
                   help="enable span tracing + metrics without naming a "
                        "directory (dumps to <out_dir>/<run>/telemetry; "
                        "implied by --telemetry_dir)")
    p.add_argument("--trace_torch", action="store_true",
                   help="additionally wrap tracer spans in "
                        "torch.profiler.record_function so device "
                        "timelines line up with host spans in a "
                        "torch.profiler capture")
    p.add_argument("--profile_rounds", type=int, default=None,
                   help="capture a torch.profiler window around each of "
                        "the first K rounds and parse it into a "
                        "per-round device-time breakdown (compute/"
                        "collective/host/idle) under "
                        "<telemetry_dir>/torch_profile/, plus live "
                        "perf.* gauges (round rate, MFU, dispatch-"
                        "bound detector) for the whole run; composes "
                        "with --trace_torch (span annotations land "
                        "inside the captures). Implies telemetry.")
    p.add_argument("--metrics_interval", type=float, default=None,
                   help="seconds between periodic metrics snapshots "
                        "appended to metrics_rank<r>.jsonl in the "
                        "telemetry dir (round-latency SLO time "
                        "series: histograms carry p50/p95/p99); "
                        "implies telemetry")
    p.add_argument("--mem_headroom_warn", type=float, default=None,
                   help="used fraction of device memory at which "
                        "the memory monitor leaves its one "
                        "mem_headroom flight-recorder event (default "
                        "0.9). The monitor itself rides the telemetry "
                        "plane: mem.bytes_in_use/mem.peak_bytes gauges "
                        "at round boundaries from torch.cuda.memory_stats "
                        "(the process's RSS for a run on the CPU), "
                        "per-program mem.program.* accounting at every "
                        "CUDA graph capture")
    p.add_argument("--metrics_port", type=int, default=None,
                   help="serve THIS rank's live metrics over HTTP: "
                        "/metrics (OpenMetrics text a stock Prometheus "
                        "scrape parses, with real histogram buckets), "
                        "/statusz (JSON run introspection: round, "
                        "memory, SLO verdicts), /healthz — all on one "
                        "stdlib listener. 0 binds an ephemeral port "
                        "(read it back from export_rank<r>.json in "
                        "the telemetry dir); unset (default) opens no "
                        "socket. Implies telemetry")
    p.add_argument("--metrics_host", type=str, default="0.0.0.0",
                   help="interface the metrics listener binds "
                        "(default 0.0.0.0 so a remote Prometheus can "
                        "scrape; the endpoints are unauthenticated "
                        "and /statusz exposes run introspection — on "
                        "a shared network bind 127.0.0.1)")
    p.add_argument("--slo", action="append", default=None,
                   metavar="SPEC",
                   help="declarative SLO (repeatable), e.g. "
                        "'perf.round_wall_s:p99<2.0@60s': metric, "
                        "statistic (p50/p95/p99/mean/max/min over the "
                        "window, 'value' for gauges, 'rate' for "
                        "counters), healthy relation, threshold, "
                        "window. Evaluated on the metrics time-series "
                        "cadence; exports slo.ok/slo.breach_seconds/"
                        "slo.burn_rate gauges, records ONE flight "
                        "event per breach transition, and writes "
                        "slo_rank<r>.json verdicts at shutdown. "
                        "Implies telemetry")
    p.add_argument("--anatomy", action="store_true",
                   help="enable the round-anatomy plane: per-phase "
                        "wall-time attribution (perf.phase.* "
                        "histograms + dominant-phase gauge) timed at "
                        "the sync points each round path already has, "
                        "and a last-N-rounds /tracez ring on the "
                        "--metrics_port listener. Off (default) costs "
                        "one attribute check per round and keeps "
                        "results byte-identical. Implies telemetry")
    p.add_argument("--profile_on_breach", action="store_true",
                   help="arm a one-shot torch.profiler deep-profile "
                        "window fired on an SLO breach TRANSITION or "
                        "the mem_headroom crossing, written under "
                        "<telemetry_dir>/profiles/ with a flight "
                        "event linking breach -> artifact path. "
                        "Requires an armed breach source (--slo or "
                        "--mem_headroom_warn). The window opens and "
                        "closes at round boundaries, after the "
                        "--profile_rounds windows. Implies telemetry")
    p.add_argument("--profile_window_s", type=float, default=None,
                   help="breach-profile capture window in seconds "
                        "(> 0; default 5)")
    p.add_argument("--profile_max_captures", type=int, default=None,
                   help="lifetime cap on breach-profile captures "
                        "(>= 1; default 3) — re-armed breaches after "
                        "the cap are counted in profile.skipped, "
                        "never captured")
    add_deploy_args(p)
    a = p.parse_args(argv)

    if a.config:
        with open(a.config) as f:
            cfg = ExperimentConfig.from_dict(json.load(f))
    else:
        cfg = ExperimentConfig()

    def rep(obj, **kw):
        kw = {k: v for k, v in kw.items() if v is not None}
        return dataclasses.replace(obj, **kw) if kw else obj

    cfg = rep(
        cfg,
        data=rep(
            cfg.data,
            dataset=a.dataset,
            data_dir=a.data_dir,
            num_clients=a.client_num_in_total,
            batch_size=None if a.batch_size == -1 else a.batch_size,
            full_batch=True if a.batch_size == -1 else None,
            partition_method=a.partition_method,
            partition_alpha=a.partition_alpha,
        ),
        model=rep(
            cfg.model,
            name=a.model,
            num_classes=a.num_classes,
            input_shape=tuple(a.input_shape) if a.input_shape else None,
        ),
        train=rep(
            cfg.train, lr=a.lr, epochs=a.epochs,
            optimizer=a.client_optimizer,
            compute_dtype=a.compute_dtype,
            cohort_fused=False if a.no_cohort_fused else None,
        ),
        fed=rep(
            cfg.fed,
            algorithm=a.algorithm,
            num_rounds=a.comm_round,
            clients_per_round=a.client_num_per_round,
            eval_every=a.frequency_of_the_test,
            server_optimizer=a.server_optimizer,
            server_lr=a.server_lr,
            server_momentum=a.server_momentum,
            gmf=a.gmf,
            robust_method=a.defense or a.robust_method,
            robust_norm_clip=a.robust_norm_clip,
            robust_noise_stddev=a.robust_noise_stddev,
            robust_num_adversaries=a.defense_num_adversaries,
            robust_multikrum_m=a.defense_multikrum_m,
            robust_trim_frac=a.defense_trim_frac,
            compress=a.compress,
            compress_topk_frac=a.compress_topk_frac,
            async_buffer_k=a.async_buffer_k,
            staleness_fn=a.staleness_fn,
            staleness_alpha=a.staleness_alpha,
            elastic_buckets=True if a.elastic else None,
            client_block_size=a.client_block_size,
            fuse_rounds=a.fuse_rounds,
            peft=a.peft,
            lora_rank=a.lora_rank,
            lora_alpha=a.lora_alpha,
            lora_targets=tuple(a.lora_targets) if a.lora_targets else None,
            peft_personalize=True if a.peft_personalize else None,
            profile_rounds=a.profile_rounds,
            mem_headroom_warn=a.mem_headroom_warn,
            slos=tuple(a.slo) if a.slo else None,
            anatomy=True if a.anatomy else None,
            profile_on_breach=True if a.profile_on_breach else None,
            profile_window_s=a.profile_window_s,
            profile_max_captures=a.profile_max_captures,
        ),
        adversary=rep(
            cfg.adversary,
            mode=a.adversary_mode,
            seed=a.adversary_seed,
            ranks=tuple(a.adversary_ranks) if a.adversary_ranks else None,
            num_adversaries=a.adversary_num,
            scale=a.adversary_scale,
            noise_stddev=a.adversary_noise,
        ),
        seed=a.seed,
        run_name=a.run_name,
        out_dir=a.out_dir,
        checkpoint_every=a.checkpoint_every,
    )
    if cfg.fed.fuse_rounds < 1:
        raise SystemExit(
            f"--fuse_rounds must be >= 1, got {cfg.fed.fuse_rounds}")
    # a defense, codec or fednova pairing the JAX package refuses is
    # refused here, before any data is made, as the JAX CLI does
    try:
        DefensePipeline.from_fed(cfg.fed)
        CompressionSpec.from_fed(cfg.fed)
        check_fednova_compat(cfg.fed.algorithm, cfg.fed.robust_method)
        bulk = BulkSpec.from_fed(cfg.fed)
        if a.tier_spec is not None:
            TierSpec.parse(a.tier_spec)
        check_async_compat(cfg)  # AsyncConfig's own checks first
    except ValueError as err:
        raise SystemExit(str(err)) from err
    try:
        QuarantinePolicy(threshold=a.quarantine_threshold,
                         decay=a.quarantine_decay,
                         evict_after=a.quarantine_evict_after)
    except ValueError as err:
        raise SystemExit(str(err)) from err
    check_peft(cfg, deploying=a.role is not None or a.supervise)
    check_observability(cfg, a)
    if bulk.enabled() and a.role is None:
        check_bulk_compat(cfg.fed, cfg.adversary)
        if bulk.block_size >= cfg.fed.clients_per_round:
            print(f"warning: --client_block_size {bulk.block_size} >= "
                  f"clients_per_round {cfg.fed.clients_per_round}: the "
                  "whole cohort fits one block — the stacked round "
                  "(client_block_size=0) runs the same work without the "
                  "streaming wrapper and wins", file=sys.stderr)
    return cfg, a


def check_peft(cfg: ExperimentConfig, deploying: bool = False) -> None:
    """PEFT's settings, checked at parse time against the merged config
    (as the JAX CLI does): a warning for lora_* settings without
    peft='lora'; ``SystemExit`` for a bad spec, a model without the named
    projections, an algorithm outside the FedAvg family or a combination
    ``check_peft_compat`` refuses. ``deploying`` (``--role``): PEFT covers
    the simulators only, so the spec is checked and the rest warned
    about."""
    fed, default = cfg.fed, type(cfg.fed)()
    if fed.peft == "none" and not fed.peft_personalize:
        if ((fed.lora_rank, fed.lora_alpha, fed.lora_targets)
                != (default.lora_rank, default.lora_alpha,
                    default.lora_targets)):
            print("warning: lora_rank/lora_alpha/lora_targets are inert "
                  "without peft='lora': this run fine-tunes the FULL model",
                  file=sys.stderr)
        return
    if deploying:
        try:
            LoRASpec.from_fed(fed)
        except ValueError as err:
            raise SystemExit(str(err)) from err
        print("warning: peft covers the simulators and is inert under "
              "--role/--supervise — this deployment trains and ships the "
              "FULL model", file=sys.stderr)
        return
    from fedml_tpu_torch.experiments.harness import ALGORITHMS

    try:
        LoRASpec.from_fed(fed)
        check_peft_compat(fed, cfg.adversary)
        check_model_supported(cfg.model.name)
    except ValueError as err:
        raise SystemExit(str(err)) from err
    if fed.algorithm not in ALGORITHMS:
        raise SystemExit(
            f"--peft covers the FedAvg family ({sorted(ALGORITHMS)}); "
            f"{fed.algorithm!r} would fine-tune the full model under a "
            "'lora' label")


def check_observability(cfg: ExperimentConfig, a) -> None:
    """The observability planes' settings, checked at parse time against
    the merged config, as the JAX CLI does: ``SystemExit`` for a
    malformed ``--slo``, a port out of range, a headroom outside (0, 1],
    a breach window or cap out of range, or ``--profile_on_breach``
    without a breach source; a warning for breach knobs without
    ``--profile_on_breach``."""
    fed = cfg.fed
    try:
        if fed.slos:
            parse_specs(fed.slos)
        if a.metrics_port is not None and not 0 <= a.metrics_port < 65536:
            raise ValueError(f"--metrics_port must be in [0, 65535] (0 = "
                             f"ephemeral), got {a.metrics_port}")
        if not 0.0 < fed.mem_headroom_warn <= 1.0:
            raise ValueError(
                f"--mem_headroom_warn is a used FRACTION of device memory "
                f"in (0, 1], got {fed.mem_headroom_warn}")
        if fed.profile_window_s <= 0:
            raise ValueError(f"--profile_window_s must be > 0, got "
                             f"{fed.profile_window_s}")
        if fed.profile_max_captures < 1:
            raise ValueError(f"--profile_max_captures must be >= 1, got "
                             f"{fed.profile_max_captures}")
        if fed.profile_on_breach and not fed.slos \
                and a.mem_headroom_warn is None:
            # without a breach source the armed profiler never fires
            raise ValueError(
                "--profile_on_breach needs an armed breach source: add "
                "--slo spec(s) and/or an explicit --mem_headroom_warn "
                "threshold")
    except ValueError as err:
        raise SystemExit(str(err)) from err
    if (fed.profile_window_s != 5.0 or fed.profile_max_captures != 3) \
            and not fed.profile_on_breach:
        print("warning: --profile_window_s/--profile_max_captures are "
              "inert without --profile_on_breach", file=sys.stderr)


def configure_telemetry(cfg: ExperimentConfig, a, device) -> None:
    """Switch the planes on for this process when any of their flags is
    set: telemetry (its directory, the tracer, the time series, the
    listener, the SLO engine), then the anatomy plane and the breach
    profiler on ``device``."""
    fed = cfg.fed
    if not (a.telemetry_dir or a.trace or a.trace_torch
            or fed.profile_rounds or a.metrics_interval
            or a.metrics_port is not None or fed.slos or fed.anatomy
            or fed.profile_on_breach):
        return
    telemetry.configure(
        telemetry_dir=a.telemetry_dir
        or telemetry.default_dir(cfg.out_dir, cfg.run_name),
        rank=0, torch_profiler=a.trace_torch,
        metrics_interval=a.metrics_interval, metrics_port=a.metrics_port,
        metrics_host=a.metrics_host, slos=fed.slos,
        slo_scope=cfg.run_name)
    if fed.anatomy or fed.profile_on_breach:
        anatomy.configure(anatomy=fed.anatomy,
                          profile_on_breach=fed.profile_on_breach,
                          profile_window_s=fed.profile_window_s,
                          profile_max_captures=fed.profile_max_captures,
                          device=device)


def main(argv=None) -> int:
    from fedml_tpu_torch.experiments.harness import Experiment

    cfg, a = parse_args(argv)
    if a.supervise:
        raise NotImplementedError(
            "--supervise (the Supervisor that launches and restarts every "
            "rank) is not ported to fedml_tpu_torch yet (ROADMAP Queue A "
            "item 14b); launch each rank with --role")
    if a.role is not None:
        dep = deploy_config(a)
        resolve_device(a.device)  # no card: raise before any socket
        from fedml_tpu_torch.experiments.deploy import run_role

        print(json.dumps(run_role(cfg, dep), default=float))
        return 0
    warn_deploy_flags(cfg, a)
    device = resolve_device(a.device)  # no card: raise before any file
    configure_telemetry(cfg, a, device)
    for summary in Experiment(cfg, a.repetitions, device).run():
        print(json.dumps(summary, default=float))
    # the run's flight ring (mem_headroom, breach profiles, the
    # dispatch-bound detector, ...) as flight_rank<r>_<n>_run_end.json
    telemetry.flight_dump("run_end")
    return 0


def add_deploy_args(p: argparse.ArgumentParser) -> None:
    """The deployment's flags, under the JAX CLI's names."""
    p.add_argument("--role", type=str, default=None,
                   choices=["server", "client", "leaf"],
                   help="run ONE deployment rank instead of the simulator "
                        "(requires --world_size; clients and leaves also "
                        "--rank); leaf: a tier world's leaf aggregator "
                        "(with --tier_spec and --uplink_ip_config)")
    p.add_argument("--rank", type=int, default=None,
                   help="this process's rank (server=0, clients>=1)")
    p.add_argument("--world_size", type=int, default=None,
                   help="total process count (1 server + N clients)")
    p.add_argument("--backend", type=str, default="tcp",
                   choices=["tcp", "grpc", "trpc", "pubsub", "pubsub_blob"],
                   help="deployment transport (default tcp; grpc, trpc, "
                        "pubsub and pubsub_blob are not ported yet)")
    p.add_argument("--ip_config", type=str, default=None,
                   help='JSON file {"rank": ["host", port], ...} (tcp)')
    p.add_argument("--ready_timeout", type=float, default=120.0,
                   help="seconds a client re-announces readiness before "
                        "giving up")
    p.add_argument("--no_heartbeats", action="store_true",
                   help="disable the liveness protocol (heartbeats and "
                        "dead-peer detection)")
    p.add_argument("--heartbeat_interval", type=float, default=2.0,
                   help="seconds between liveness beacons")
    p.add_argument("--heartbeat_timeout", type=float, default=30.0,
                   help="seconds of peer silence before it is declared dead")
    p.add_argument("--quorum_fraction", type=float, default=1.0,
                   help="fraction of live workers whose results close a "
                        "round once --round_deadline expires (server rank)")
    p.add_argument("--round_deadline", "--round_deadline_s", type=float,
                   default=None, dest="round_deadline",
                   help="per-round wall-clock budget in seconds: at expiry "
                        "the round closes with >= quorum results or the run "
                        "aborts (0/unset = no deadline)")
    p.add_argument("--recovery_extensions", type=int, default=0,
                   help="times a round deadline that expires under quorum "
                        "re-arms before the quorum-lost abort fires")
    p.add_argument("--supervise", action="store_true",
                   help="launch and restart every rank under a Supervisor "
                        "(not ported yet)")
    p.add_argument("--fault_seed", type=int, default=0,
                   help="seed of the deterministic fault stream")
    p.add_argument("--fault_drop", type=float, default=0.0,
                   help="per-message send drop probability")
    p.add_argument("--fault_delay", type=float, default=0.0,
                   help="per-message send delay probability")
    p.add_argument("--fault_delay_max", type=float, default=0.05,
                   help="max injected delay in seconds")
    p.add_argument("--fault_dup", type=float, default=0.0,
                   help="per-message duplication probability")
    p.add_argument("--fault_reorder", type=float, default=0.0,
                   help="per-message reorder probability")
    p.add_argument("--fault_corrupt", type=float, default=0.0,
                   help="per-message bit-flip probability in the sealed tcp "
                        "frame (the CRC drops it: transport.corrupt_frames)")
    p.add_argument("--fault_crash_round", type=int, default=None,
                   help="crash this rank on the first message tagged with "
                        "round_idx >= N")
    p.add_argument("--fault_crash_mode", type=str, default="silent",
                   choices=["silent", "exit"],
                   help="silent: the rank stops communicating; exit: the "
                        "process dies (os._exit) like kill -9")
    p.add_argument("--quarantine_threshold", type=float, default=0.0,
                   help="server rank: quarantine a client whose EWMA "
                        "anomaly score exceeds this (0 = off)")
    p.add_argument("--quarantine_decay", type=float, default=0.7,
                   help="EWMA memory of the anomaly score, in [0, 1)")
    p.add_argument("--quarantine_evict_after", type=int, default=0,
                   help="rounds in quarantine before a permanent eviction "
                        "(0 = never)")
    p.add_argument("--leave_after_round", type=int, default=None,
                   help="client rank: LEAVE gracefully after this round's "
                        "result")
    p.add_argument("--tier_spec", type=str, default=None,
                   help="tier topology, e.g. root:2 — one root "
                        "aggregator serving 2 leaf aggregators, each "
                        "leaf terminating its own clients' transports "
                        "in its own world and forwarding one partial "
                        "[sum, n, count] upstream per flush. Set on "
                        "the root (--role server) and every leaf "
                        "(--role leaf); clients are topology-blind")
    p.add_argument("--uplink_ip_config", type=str, default=None,
                   help="leaf rank: the ROOT world's rank table "
                        "(--ip_config stays this leaf's own world, "
                        "where it is rank 0)")
    p.add_argument("--tier_client_base", type=int, default=None,
                   help="leaf rank: global client id of this leaf's "
                        "slot 0 (default: contiguous equal-size "
                        "blocks per leaf rank)")


def fault_policy(a):
    """The chaos flags as a :class:`FaultPolicy` (None when off)."""
    from fedml_tpu_torch.core.transport.chaos import FaultPolicy

    policy = FaultPolicy(
        seed=a.fault_seed, drop_prob=a.fault_drop, delay_prob=a.fault_delay,
        delay_max_s=a.fault_delay_max, dup_prob=a.fault_dup,
        reorder_prob=a.fault_reorder, corrupt_prob=a.fault_corrupt,
        crash_at_round=a.fault_crash_round, crash_mode=a.fault_crash_mode)
    return policy if policy.enabled() else None


def deploy_config(a):
    """``--role``'s :class:`DeployConfig`, with the JAX CLI's checks and
    messages: ``SystemExit`` for a bad world, rank, leaf or pairing,
    ``NotImplementedError`` for what ROADMAP Queue A item 14b still ports
    (a backend other than tcp), and a warning for each simulator flag
    that is inert under ``--role``."""
    from fedml_tpu_torch.experiments.deploy import (
        DeployConfig,
        load_ip_config,
    )

    if a.backend != "tcp":
        raise NotImplementedError(
            f"the {a.backend} backend is not ported to fedml_tpu_torch yet "
            "(ROADMAP Queue A item 14b); use --backend tcp")
    if a.world_size is None:
        raise SystemExit("--role requires --world_size")
    if a.world_size < 2:
        raise SystemExit(
            "--world_size must be >= 2 (1 server + at least 1 client); "
            "for a single-process run drop --role and use the simulator")
    rank = a.rank if a.rank is not None else (
        0 if a.role == "server" else None)
    if rank is None:
        raise SystemExit(f"--role {a.role} requires --rank >= 1")
    if a.role == "server" and rank != 0:
        raise SystemExit("server is always rank 0")
    if a.role == "client" and rank < 1:
        raise SystemExit("client rank must be >= 1")
    if a.role == "leaf":
        # a leaf lives in two worlds: rank 0 of its own (--ip_config) and
        # a member rank of the root's (--uplink_ip_config). tcp, the one
        # backend here, is rank-addressed, as a tier world needs
        if not a.tier_spec:
            raise SystemExit("--role leaf requires --tier_spec")
        if not a.uplink_ip_config:
            raise SystemExit(
                "--role leaf requires --uplink_ip_config (the root "
                "world's rank table; --ip_config is this leaf's own "
                "client-facing world)")
        spec = TierSpec.parse(a.tier_spec)  # checked when parsed
        if not 1 <= rank <= spec.n_leaves:
            raise SystemExit(
                f"leaf rank must be in 1..{spec.n_leaves} of the root "
                f"world ({a.tier_spec}), got {rank}")
    if a.role == "client" and rank >= a.world_size and not a.elastic:
        raise SystemExit(
            f"client rank {rank} is outside the launch world "
            f"[1, {a.world_size}); joining a running world mid-run "
            "requires --elastic (on BOTH the server and this client)")
    if a.ip_config is None:
        raise SystemExit("--backend tcp requires --ip_config")
    if a.recovery_extensions and not a.round_deadline:
        raise SystemExit(
            "--recovery_extensions requires --round_deadline: extensions "
            "re-arm the round deadline, so without one there is nothing "
            "to extend")
    if not 0.0 < a.quorum_fraction <= 1.0:
        raise SystemExit(f"--quorum_fraction must be in (0, 1], got "
                         f"{a.quorum_fraction}")
    # simulator-only flags are inert under --role: say so
    if a.profile_rounds:
        print("warning: --profile_rounds capture windows cover the "
              "simulator paths; under --role the aggregation path reports "
              "perf.agg_wall_s / perf.host_wait_s / idle-gap signals "
              "instead", file=sys.stderr)
    if a.fuse_rounds and a.fuse_rounds > 1:
        print("warning: --fuse_rounds covers the simulator round loop and "
              "is inert under --role (deploy rounds close on the transport "
              "barrier)", file=sys.stderr)
    if a.repetitions != 1:
        print("warning: --repetitions is a simulator flag and is ignored "
              "under --role (each deployment process runs exactly one "
              "rank)", file=sys.stderr)
    if a.client_block_size:
        print("warning: --client_block_size covers the simulators and is "
              "inert under --role (a deploy client trains one client)",
              file=sys.stderr)
    return DeployConfig(
        role=a.role, rank=rank, world_size=a.world_size, backend=a.backend,
        ip_config=load_ip_config(a.ip_config),
        ready_timeout=a.ready_timeout, device=a.device,
        heartbeats=not a.no_heartbeats,
        heartbeat_interval_s=a.heartbeat_interval,
        heartbeat_timeout_s=a.heartbeat_timeout,
        quorum_fraction=a.quorum_fraction,
        round_deadline_s=a.round_deadline or None,
        checkpoint_every=a.checkpoint_every or 0,
        recovery_extensions=a.recovery_extensions,
        fault=fault_policy(a),
        quarantine_threshold=a.quarantine_threshold,
        quarantine_decay=a.quarantine_decay,
        quarantine_evict_after=a.quarantine_evict_after,
        leave_after_round=a.leave_after_round,
        tier_spec=a.tier_spec,
        uplink_ip_config=(load_ip_config(a.uplink_ip_config)
                          if a.uplink_ip_config else None),
        tier_client_base=a.tier_client_base,
        telemetry_dir=a.telemetry_dir, trace=a.trace,
        trace_torch=a.trace_torch, metrics_interval=a.metrics_interval,
        metrics_port=a.metrics_port, metrics_host=a.metrics_host,
    )


def warn_deploy_flags(cfg: ExperimentConfig, a) -> None:
    """The deployment flags the simulators ignore, each with the JAX
    CLI's warning."""
    if cfg.fed.async_buffer_k:
        # the buffer is a deploy server actor's: a simulator is one
        # synchronous program, with no arrival stream to fold
        print("warning: --async_buffer_k is a deployment flag and is "
              "ignored by the simulator (use --role server with "
              "--async_buffer_k)", file=sys.stderr)
    if a.quarantine_threshold:
        print("warning: --quarantine_threshold is a deployment flag and is "
              "ignored by the simulator (use --role; --defense still "
              "applies here)", file=sys.stderr)
    if a.leave_after_round is not None:
        print("warning: --leave_after_round is a deployment flag and is "
              "ignored by the simulator (use --role client; "
              "set_cohort_size drives churn in the simulator)",
              file=sys.stderr)
    if a.tier_spec:
        print("warning: --tier_spec is a deployment flag and is ignored "
              "by the simulator (tier worlds are --role server/leaf/"
              "client processes)", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
