"""Parameter-efficient federated fine-tuning (PEFT/LoRA), the JAX
package's ``fedml_tpu.peft``:

- :mod:`fedml_tpu_torch.peft.lora`: adapter injection, zero-init
  low-rank branches on the transformer's named projections (round 0
  computes what the base model does);
- :mod:`fedml_tpu_torch.peft.partition`: the trainable/frozen split
  every round path rides: local training steps only the trainable
  leaves, with the frozen base a per-round constant, and the server folds
  updates of the aggregated leaves only;
- :mod:`fedml_tpu_torch.peft.personal`: private per-client adapter
  banks (only the shared head aggregates).

:func:`build_peft` is what the simulation calls; :func:`check_peft_compat`
raises for a combination the PEFT paths cannot run (also at the CLI's
parse time).
"""

from __future__ import annotations

from fedml_tpu_torch.peft.lora import (
    LORA_MODELS,
    LORA_TARGETS,
    LoRALinear,
    LoRASpec,
    apply_lora,
    check_model_supported,
    dense_factory,
)
from fedml_tpu_torch.peft.partition import (
    ParamPartition,
    PeftPlan,
    adapter_partition,
    private_partition,
    tree_bytes,
)

__all__ = [
    "LORA_MODELS",
    "LORA_TARGETS",
    "LoRALinear",
    "LoRASpec",
    "ParamPartition",
    "PeftPlan",
    "adapter_partition",
    "apply_lora",
    "build_peft",
    "check_model_supported",
    "check_peft_compat",
    "compound_wire_ratio",
    "dense_factory",
    "private_partition",
]


def check_peft_compat(fed, adversary=None) -> None:
    """Raise ``ValueError`` for a configuration the PEFT paths cannot run
    exactly. Non-personalized LoRA composes with everything (codecs, the
    bulk engine, fused blocks, elastic buckets, defenses, adversaries):
    the aggregation just sees a smaller tree. The private adapter bank
    rides the bulk engine, fused blocks, elastic buckets and the
    checkpoint composite. Personalization is refused with:

    - ``compress``: the codec's error-feedback residual assumes the
      aggregated leaves are the whole client update, but a personalized
      client also carries private adapters that never ride the wire;
    - a defended ``robust_method``: the selection rules are untested on
      the head-only shared aggregate;
    - an ``adversary``: the injection rewrites the aggregated stacked
      variables and has no private-bank seam."""
    spec = LoRASpec.from_fed(fed)
    if not getattr(fed, "peft_personalize", False):
        return
    if spec is None:
        raise ValueError(
            "peft_personalize requires peft='lora': without adapters "
            "there is no private subtree to personalize")
    if getattr(fed, "compress", "none") not in ("none", "", None):
        raise ValueError(
            "peft_personalize is incompatible with compress: the wire "
            "codec's per-slot error-feedback residual assumes the "
            "aggregated subtree is the whole client update, but a "
            "personalized client also carries private adapters that never "
            "ride the wire. Compress composes with non-personalized "
            "peft='lora'.")
    if getattr(fed, "robust_method", "mean") not in ("mean", "", None):
        raise ValueError(
            "peft_personalize supports robust_method='mean' only: the "
            "defended selection rules are untested against the head-only "
            "shared aggregate and are refused rather than run unvalidated")
    if adversary is not None and adversary.enabled():
        raise ValueError(
            "peft_personalize is incompatible with adversary injection: "
            "the injection rewrites the aggregated stacked variables and "
            "has no private-bank seam; run Byzantine scenarios on "
            "non-personalized peft='lora'")


def build_peft(model, cfg):
    """``(model, None)`` when PEFT is off, else ``(the LoRA-injected
    model, its PeftPlan)``; the whole compatibility table is checked
    first, so a bad combination fails at construction."""
    fed = cfg.fed
    spec = LoRASpec.from_fed(fed)
    check_peft_compat(fed, cfg.adversary)
    if spec is None:
        return model, None
    lora = apply_lora(model, spec)
    return lora, PeftPlan(part=adapter_partition(),
                          personalized=bool(fed.peft_personalize),
                          stat_names=lora.stat_names)


def compound_wire_ratio(plan: PeftPlan, cspec, variables) -> float:
    """The full-model-equivalent wire reduction: dense bytes of the
    full-delta baseline (:meth:`PeftPlan.full_wire_bytes`) over the
    (codec-compressed, when ``cspec`` is enabled) bytes of the aggregated
    leaves; the ``peft.wire_ratio`` counter and the
    ``lora_wire_reduction_x`` record."""
    from fedml_tpu_torch.core import compress as C

    params = {k: v for k, v in variables.items() if k not in plan.stat_names}
    agg = plan.agg_part.trainable(params)
    codec = (C.wire_ratio(cspec, agg)
             if cspec is not None and cspec.enabled() else 1.0)
    return plan.full_wire_bytes(params) / max(1, tree_bytes(agg)) * codec
