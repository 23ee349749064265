"""Typed, immutable experiment configuration for the PyTorch port.

The fields are those the plain FedAvg path reads, with the names, defaults
and JSON schema of :mod:`fedml_tpu.config`, so a config written by this
package is read unchanged by the JAX package. Settings that select a
feature the port does not have yet are kept as fields so that
:class:`~fedml_tpu_torch.algorithms.fedavg.FedAvgSim` can refuse them by
name instead of ignoring them.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset + partition settings."""

    dataset: str = "synthetic"
    data_dir: str = "./data"
    num_clients: int = 10
    partition_method: str = "homo"  # "homo" | "hetero"
    partition_alpha: float = 0.5
    batch_size: int = 32
    dataset_r: float = 1.0  # fraction of the dataset to keep
    full_batch: bool = False  # one batch per client (batch_size=-1 mode)
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model factory settings."""

    name: str = "lr"
    num_classes: int = 10
    input_shape: tuple[int, ...] = (28, 28, 1)
    # extra per-model knobs as a tuple of pairs, so the dataclass stays
    # hashable (e.g. (("num_layers", 2), ("embed_dim", 128)))
    extra: tuple[tuple[str, Any], ...] = ()

    def extra_dict(self) -> dict[str, Any]:
        return dict(self.extra)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Client-side local training hyperparameters."""

    optimizer: str = "sgd"  # "sgd" | "adam" (adamw)
    lr: float = 0.03
    momentum: float = 0.0
    weight_decay: float = 0.0
    epochs: int = 1
    prox_mu: float = 0.0  # FedProx proximal coefficient (0 disables)
    clip_norm: float = 0.0  # global-norm gradient clip (0 disables)
    # mixed precision: "float32" (exact, default) or "bfloat16" (master
    # params, optimizer state and BN statistics stay float32; the network
    # runs in bf16)
    compute_dtype: str = "float32"
    # Execution-layout settings of the JAX package's compiled client loop,
    # none of which changes a result (the reference pins that). The port
    # runs the cohort in cohort_groups size-sorted groups (0: groups of
    # about 5 clients). It reads scan_unroll (the scan's unroll factor)
    # and cohort_fused (the cohort-grouped network) and does nothing with
    # them; they are kept so that one config file drives both packages.
    scan_unroll: int = 1
    cohort_fused: bool = True
    cohort_groups: int = 0


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """Server-side / round-level settings."""

    algorithm: str = "fedavg"
    num_rounds: int = 10
    clients_per_round: int = 10
    eval_every: int = 5
    # server optimizer ("sgd" with lr 1.0 == plain FedAvg)
    server_optimizer: str = "sgd"
    server_lr: float = 1.0
    server_momentum: float = 0.0
    robust_norm_clip: float = 0.0
    robust_noise_stddev: float = 0.0
    robust_method: str = "mean"
    gmf: float = 0.0  # global momentum factor
    # features of the JAX package not ported yet; any value other than
    # the default makes FedAvgSim raise NotImplementedError
    elastic_buckets: bool = False
    compress: str = "none"
    client_block_size: int = 0
    fuse_rounds: int = 1
    peft: str = "none"


@dataclasses.dataclass(frozen=True)
class AdversaryPolicy:
    """Byzantine adversary injection (the JAX package's policy has more
    fields). The port has none yet: a mode other than "none" makes
    FedAvgSim raise."""

    mode: str = "none"

    def enabled(self) -> bool:
        return self.mode != "none"


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    fed: FedConfig = dataclasses.field(default_factory=FedConfig)
    adversary: AdversaryPolicy = dataclasses.field(
        default_factory=AdversaryPolicy
    )
    seed: int = 0
    run_name: str = "run"
    out_dir: str = "./runs"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), default=str, indent=2)

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "ExperimentConfig":
        def detuple(x):
            return tuple(detuple(e) for e in x) if isinstance(x, list) else x

        def build(cls, sub):
            if sub is None:
                return cls()
            fields = {f.name for f in dataclasses.fields(cls)}
            kw = {}
            for k, v in sub.items():
                if k not in fields:
                    raise KeyError(f"unknown {cls.__name__} field: {k}")
                if k == "extra" and isinstance(v, Mapping):
                    v = tuple(sorted(v.items()))
                elif k == "extra" and isinstance(v, Sequence):
                    # JSON turns the tuple of pairs into lists
                    v = tuple((p[0], detuple(p[1])) for p in v)
                elif k == "input_shape" and isinstance(v, Sequence):
                    v = tuple(v)
                kw[k] = v
            return cls(**kw)

        return ExperimentConfig(
            data=build(DataConfig, d.get("data")),
            model=build(ModelConfig, d.get("model")),
            train=build(TrainConfig, d.get("train")),
            fed=build(FedConfig, d.get("fed")),
            adversary=build(AdversaryPolicy, d.get("adversary")),
            seed=d.get("seed", 0),
            run_name=d.get("run_name", "run"),
            out_dir=d.get("out_dir", "./runs"),
        )
