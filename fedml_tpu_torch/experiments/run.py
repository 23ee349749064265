"""CLI entry: ``python -m fedml_tpu_torch.experiments.run ...``.

The FedAvg family of ``fedml_tpu.experiments.run`` (``--algorithm``
fedavg, fedopt, fedprox, fednova), with its flag names: the defenses
(``--defense`` or ``--robust_method``, ``--defense_*``,
``--robust_norm_clip``, ``--robust_noise_stddev``), the wire codec
(``--compress``, ``--compress_topk_frac``) and the seeded adversaries
(``--adversary_*``). Config
precedence: ``--config`` JSON (the full :class:`ExperimentConfig` shape,
the same file the JAX package reads) overridden by explicit flags. Client
momentum and weight decay come in through ``--config``, and so does
FedProx's ``prox_mu``. The run goes on ``--device`` (default ``cuda``,
which raises without a card); it prints the run's summary as one JSON
line. A setting the port does not have yet raises ``NotImplementedError``
naming its ROADMAP item.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from fedml_tpu_torch.config import ADVERSARY_MODES, ExperimentConfig
from fedml_tpu_torch.core.compress import METHODS, CompressionSpec
from fedml_tpu_torch.core.robust import (
    DefensePipeline,
    check_fednova_compat,
)


def parse_args(argv=None) -> tuple[ExperimentConfig, argparse.Namespace]:
    p = argparse.ArgumentParser(
        prog="fedml_tpu_torch.experiments.run",
        description="federated learning experiment runner (PyTorch port)",
    )
    p.add_argument("--config", type=str, default=None,
                   help="JSON file with the full ExperimentConfig")
    p.add_argument("--algorithm", type=str, default=None)
    p.add_argument("--dataset", type=str, default=None)
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
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; 'cpu' only "
                        "when asked)")
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
    )
    # a defense, codec or fednova pairing the JAX package refuses is
    # refused here, before any data is made, as the JAX CLI does
    try:
        DefensePipeline.from_fed(cfg.fed)
        CompressionSpec.from_fed(cfg.fed)
        check_fednova_compat(cfg.fed.algorithm, cfg.fed.robust_method)
    except ValueError as err:
        raise SystemExit(str(err)) from err
    return cfg, a


# --algorithm -> the FedConfig.algorithm FedAvgSim runs, as the JAX
# package's harness maps them (fedprox is fedavg with TrainConfig.prox_mu)
FEDAVG_FAMILY = {"fedavg": "fedavg", "fedopt": "fedopt",
                 "fedprox": "fedavg", "fednova": "fednova"}


def run(cfg: ExperimentConfig, device: str = "cuda") -> dict:
    """One FedAvg-family simulation of ``cfg`` on ``device``; returns its
    summary (the last value of every logged metric, and the run name)."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
    from fedml_tpu_torch.data import load_dataset
    from fedml_tpu_torch.metrics import MetricsSink
    from fedml_tpu_torch.models import create_model

    if cfg.fed.algorithm not in FEDAVG_FAMILY:
        raise NotImplementedError(
            f"algorithm={cfg.fed.algorithm!r} is not ported to "
            "fedml_tpu_torch yet (ROADMAP: Queue A item 13, the other "
            "algorithm families)")
    cfg = dataclasses.replace(cfg, fed=dataclasses.replace(
        cfg.fed, algorithm=FEDAVG_FAMILY[cfg.fed.algorithm]))
    model = create_model(cfg.model, device)
    sim = FedAvgSim(model, load_dataset(cfg.data), cfg, device)
    sink = MetricsSink()
    sim.run(metrics_sink=sink)
    return dict(sink.summary, run_name=cfg.run_name)


def main(argv=None) -> int:
    cfg, a = parse_args(argv)
    print(json.dumps(run(cfg, a.device), default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
