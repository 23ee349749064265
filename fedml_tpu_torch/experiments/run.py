"""CLI entry: ``python -m fedml_tpu_torch.experiments.run ...``.

The FedAvg family of ``fedml_tpu.experiments.run`` (``--algorithm``
fedavg, fedopt, fedprox, fednova, fedavg_robust, fedavg_multiclient) and
the GAN family (``--algorithm`` fedgan, fedgdkd, feddtg, fedssgan,
feduagan: their GAN settings, the ``gan`` section of the ``--config``
JSON, as the JAX CLI has no GAN flags), with its flag names: the
defenses
(``--defense`` or ``--robust_method``, ``--defense_*``,
``--robust_norm_clip``, ``--robust_noise_stddev``), the wire codec
(``--compress``, ``--compress_topk_frac``), the seeded adversaries
(``--adversary_*``), the bulk engine (``--client_block_size``) and
elastic buckets (``--elastic``), fused blocks (``--fuse_rounds``), LoRA
fine-tuning (``--peft lora``, ``--lora_rank``, ``--lora_alpha``,
``--lora_targets``, ``--peft_personalize``) and the harness's flags
(``--repetitions``, ``--run_name``, ``--out_dir``,
``--checkpoint_every``). Config precedence: ``--config`` JSON (the full
:class:`ExperimentConfig` shape, the same file the JAX package reads)
overridden by explicit flags. Client momentum and weight decay come in
through ``--config``, and so does FedProx's ``prox_mu``. The run goes
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

from fedml_tpu_torch.config import ADVERSARY_MODES, ExperimentConfig
from fedml_tpu_torch.core.bulk import BulkSpec, check_bulk_compat
from fedml_tpu_torch.core.compress import METHODS, CompressionSpec
from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.core.robust import (
    DefensePipeline,
    check_fednova_compat,
)
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
                        "fedavg_multiclient, or the GAN family: fedgan, "
                        "fedgdkd, feddtg, fedssgan, feduagan")
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
            elastic_buckets=True if a.elastic else None,
            client_block_size=a.client_block_size,
            fuse_rounds=a.fuse_rounds,
            peft=a.peft,
            lora_rank=a.lora_rank,
            lora_alpha=a.lora_alpha,
            lora_targets=tuple(a.lora_targets) if a.lora_targets else None,
            peft_personalize=True if a.peft_personalize else None,
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
    except ValueError as err:
        raise SystemExit(str(err)) from err
    check_peft(cfg)
    if bulk.enabled():
        check_bulk_compat(cfg.fed, cfg.adversary)
        if bulk.block_size >= cfg.fed.clients_per_round:
            print(f"warning: --client_block_size {bulk.block_size} >= "
                  f"clients_per_round {cfg.fed.clients_per_round}: the "
                  "whole cohort fits one block — the stacked round "
                  "(client_block_size=0) runs the same work without the "
                  "streaming wrapper and wins", file=sys.stderr)
    return cfg, a


def check_peft(cfg: ExperimentConfig) -> None:
    """PEFT's settings, checked at parse time against the merged config
    (as the JAX CLI does): a warning for lora_* settings without
    peft='lora'; ``SystemExit`` for a bad spec, a model without the named
    projections, an algorithm outside the FedAvg family or a combination
    ``check_peft_compat`` refuses."""
    fed, default = cfg.fed, type(cfg.fed)()
    if fed.peft == "none" and not fed.peft_personalize:
        if ((fed.lora_rank, fed.lora_alpha, fed.lora_targets)
                != (default.lora_rank, default.lora_alpha,
                    default.lora_targets)):
            print("warning: lora_rank/lora_alpha/lora_targets are inert "
                  "without peft='lora': this run fine-tunes the FULL model",
                  file=sys.stderr)
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


def main(argv=None) -> int:
    from fedml_tpu_torch.experiments.harness import Experiment

    cfg, a = parse_args(argv)
    device = resolve_device(a.device)  # no card: raise before any file
    for summary in Experiment(cfg, a.repetitions, device).run():
        print(json.dumps(summary, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
