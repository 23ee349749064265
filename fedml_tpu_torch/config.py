"""Typed, immutable experiment configuration for the PyTorch port.

The fields are those the FedAvg family reads, with the names, defaults
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

import numpy as np


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
    # the defense pipeline (core/robust.py): clip each client's delta,
    # reduce with robust_method ("mean" | "median" | "trimmed_mean" |
    # "krum" | "multikrum" | "fltrust"), then noise the aggregate
    robust_norm_clip: float = 0.0  # 0 disables norm clipping
    robust_noise_stddev: float = 0.0  # 0 disables the aggregate's noise
    robust_method: str = "mean"
    # the adversary count f the Krum family assumes (each score sums the
    # C - f - 2 nearest distances)
    robust_num_adversaries: int = 0
    robust_multikrum_m: int = 0  # multi-Krum's keep count (0: C - f)
    robust_trim_frac: float = 0.1  # trimmed mean's trim, each side
    gmf: float = 0.0  # global momentum factor
    # the client->server wire codec (core/compress.py): "none" | "int8" |
    # "topk" | "topk_int8", with error feedback carried across rounds
    compress: str = "none"
    compress_topk_frac: float = 0.01  # share of each leaf topk keeps
    # elastic buckets (core/elastic.py): the round runs the power-of-two
    # bucket above the cohort, so the live cohort may change size
    elastic_buckets: bool = False
    # the bulk engine (core/bulk.py): stream the cohort in blocks of this
    # many clients (0: the stacked round)
    client_block_size: int = 0
    # run the round loop in blocks of this many rounds (core/fuse.py): the
    # host reads a block's metrics back once, at its end (1: per round)
    fuse_rounds: int = 1
    # parameter-efficient fine-tuning (fedml_tpu_torch/peft): "lora" wraps
    # the transformer's targeted projections (lora_targets, from q_proj,
    # k_proj, v_proj, attn_out, mlp_up, mlp_down) with zero-init rank
    # lora_rank branches scaled by lora_alpha / lora_rank, and the rounds
    # train and aggregate only the adapters and the LM head
    peft: str = "none"
    lora_rank: int = 4
    lora_alpha: float = 8.0
    lora_targets: tuple[str, ...] = ("q_proj", "v_proj")
    # keep each client's adapters in a private per-client bank: only the
    # LM head aggregates (fedml_tpu_torch/peft/personal.py)
    peft_personalize: bool = False


@dataclasses.dataclass(frozen=True)
class GanConfig:
    """GAN and knowledge-distillation settings of the fork's GAN family
    (the JAX package's ``GanConfig``, every field, so a ``gan`` section
    round-trips). FedGDKD reads ``nz``, ``ngf``, ``gen_optimizer``,
    ``gen_lr``, ``kd_alpha``, ``kd_epochs``, ``kd_temperature`` and
    ``distillation_size``; the rest belong to algorithms not ported yet."""

    nz: int = 100  # latent vector size
    ngf: int = 64  # generator feature multiplier
    gen_optimizer: str = "adam"  # "adam" | "sgd"
    gen_lr: float = 1e-3
    kd_alpha: float = 0.8  # weight of the KD term against the CE
    kd_epochs: int = 5
    kd_temperature: float = 4.0  # SoftTarget's T
    distillation_size: int = 1024
    pseudo_label_threshold: float = 0.9
    public_size: int = 1024
    digest_epochs: int = 1
    revisit_epochs: int = 1
    pretrain_epochs_public: int = 1
    pretrain_epochs_private: int = 1
    kd_lambda: float = 1.0
    kd_gamma: float = 0.1


ADVERSARY_MODES = ("sign_flip", "scale_boost", "gauss", "zero", "constant",
                   "collude")


@dataclasses.dataclass(frozen=True)
class AdversaryPolicy:
    """Which clients are malicious, and how (core/adversary.py applies it).

    - ``mode``: one of :data:`ADVERSARY_MODES`, or ``"none"``.
    - ``ranks``: explicit adversary identities (client ids in the
      simulation).
    - ``num_adversaries``: without ``ranks``, a seeded choice of this
      many members of the population.
    - ``scale``: sign_flip's and scale_boost's factor, constant's value,
      the norm of collude's shared delta.
    - ``noise_stddev``: gauss's standard deviation.
    """

    seed: int = 0
    mode: str = "none"
    ranks: tuple[int, ...] = ()
    num_adversaries: int = 0
    scale: float = 10.0
    noise_stddev: float = 1.0

    def __post_init__(self):
        if self.mode not in ("none", *ADVERSARY_MODES):
            raise ValueError(
                f"adversary mode must be one of "
                f"{('none', *ADVERSARY_MODES)}, got {self.mode!r}")
        if self.num_adversaries < 0:
            raise ValueError(f"num_adversaries must be >= 0, "
                             f"got {self.num_adversaries}")

    def enabled(self) -> bool:
        return self.mode != "none" and bool(self.ranks
                                            or self.num_adversaries)

    def member_ids(self, population: int, base: int = 0) -> np.ndarray:
        """The adversaries among ``[base, base + population)``, sorted:
        ``ranks`` when given (checked to lie in range), else a seeded
        choice of ``num_adversaries`` without replacement, the same
        clients as the JAX package's policy picks
        (``np.random.default_rng(seed).choice``)."""
        if not self.enabled():
            return np.zeros((0,), np.int32)
        if self.ranks:
            ids = np.asarray(sorted(set(self.ranks)), np.int32)
            lo, hi = base, base + population
            if ids.size and (ids[0] < lo or ids[-1] >= hi):
                raise ValueError(
                    f"adversary ranks {sorted(set(self.ranks))} outside "
                    f"the population [{lo}, {hi})")
            return ids
        n = min(self.num_adversaries, population)
        rng = np.random.default_rng(self.seed)
        ids = rng.choice(population, size=n, replace=False) + base
        return np.sort(ids).astype(np.int32)

    def is_member(self, ident: int, population: int, base: int = 0) -> bool:
        return bool(np.isin(ident, self.member_ids(population, base)))


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    fed: FedConfig = dataclasses.field(default_factory=FedConfig)
    gan: GanConfig = dataclasses.field(default_factory=GanConfig)
    adversary: AdversaryPolicy = dataclasses.field(
        default_factory=AdversaryPolicy
    )
    seed: int = 0
    run_name: str = "run"
    out_dir: str = "./runs"
    # checkpoint the round state every N rounds into <out_dir>/<run>/ckpt
    # and resume from the latest checkpoint on a restart
    # (utils/checkpoint.py, experiments/harness.py); 0 = off
    checkpoint_every: int = 0

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
                elif k == "ranks" and isinstance(v, Sequence):
                    v = tuple(int(r) for r in v)
                elif k == "lora_targets" and isinstance(v, Sequence) \
                        and not isinstance(v, str):
                    v = tuple(v)
                kw[k] = v
            return cls(**kw)

        return ExperimentConfig(
            data=build(DataConfig, d.get("data")),
            model=build(ModelConfig, d.get("model")),
            train=build(TrainConfig, d.get("train")),
            fed=build(FedConfig, d.get("fed")),
            gan=build(GanConfig, d.get("gan")),
            adversary=build(AdversaryPolicy, d.get("adversary")),
            seed=d.get("seed", 0),
            run_name=d.get("run_name", "run"),
            out_dir=d.get("out_dir", "./runs"),
            checkpoint_every=d.get("checkpoint_every", 0),
        )
