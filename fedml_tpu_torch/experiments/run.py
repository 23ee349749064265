"""CLI entry: ``python -m fedml_tpu_torch.experiments.run ...``.

The FedAvg family of ``fedml_tpu.experiments.run`` (``--algorithm``
fedavg, fedopt, fedprox, fednova), with its flag names. Config
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

from fedml_tpu_torch.config import ExperimentConfig


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
        ),
        seed=a.seed,
    )
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
