"""The trainable/frozen split every PEFT path rides (the JAX package's
``fedml_tpu/peft/partition.py``, on the port's flat variables).

A PEFT run trains a small part of the model, the LoRA adapters
(:mod:`fedml_tpu_torch.peft.lora`) and the LM head, and builds no delta,
optimizer state or wire payload for the frozen base. The split is a
predicate over a variable's dotted name (``blocks.0.q_proj.lora_a``,
``lm_head.weight``), so it needs no tensors to construct, and the same
rule prunes one client's variables, a stacked ``[C, ...]`` tree or an
error-feedback residual alike.

- :meth:`ParamPartition.trainable` keeps the selected names;
- :meth:`ParamPartition.frozen` keeps the others;
- :meth:`ParamPartition.merge` puts the two back together (the exact
  inverse; a name on both sides raises).

:class:`PeftPlan` holds the partitions a run needs (the trainable split
and, under ``peft_personalize``, the shared/private split of it) and the
``view_state``/``merge_state`` pair that :class:`~fedml_tpu_torch.
algorithms.fedavg.FedAvgSim` wraps around its server step: the server
sees, and keeps optimizer state and momentum for, the aggregated names
only; the frozen leaves ride the state untouched.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Tree = dict[str, torch.Tensor]

#: leaf names the LoRA injection creates (peft/lora.py LoRALinear)
ADAPTER_LEAVES = ("lora_a", "lora_b")


def is_adapter(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in ADAPTER_LEAVES


@dataclasses.dataclass(frozen=True)
class ParamPartition:
    """A split of flat variables by name: ``select(name)`` is True on
    the trainable side."""

    select: Callable[[str], bool]

    def trainable(self, params: Tree) -> Tree:
        out = {k: v for k, v in params.items() if self.select(k)}
        if not out:
            raise ValueError(
                "partition selects no trainable leaves in these variables: "
                "nothing to train or aggregate")
        return out

    def frozen(self, params: Tree) -> Tree:
        return {k: v for k, v in params.items() if not self.select(k)}

    def merge(self, trainable: Tree, frozen: Tree) -> Tree:
        both = trainable.keys() & frozen.keys()
        if both:
            raise ValueError(
                f"partition merge collision: both sides carry "
                f"{sorted(both)}; the two trees are not complementary "
                "prunings")
        return {**trainable, **frozen}

    def mask(self, params: Tree) -> dict[str, bool]:
        """``{name: True if trainable}``."""
        return {k: bool(self.select(k)) for k in params}


def tree_count(tree: Tree) -> int:
    return sum(v.numel() for v in tree.values())


def tree_bytes(tree: Tree) -> int:
    return sum(v.numel() * v.element_size() for v in tree.values())


def adapter_partition(head_modules: tuple[str, ...] = ("lm_head",)
                      ) -> ParamPartition:
    """The LoRA run's trainable split: the adapter leaves and every leaf
    of a top-level module in ``head_modules`` (the LM head trains densely
    without being low-rank). An adapter leaf exists only where injection
    put one, so the leaf-name rule is exact for any targets."""

    def select(name: str) -> bool:
        return is_adapter(name) or name.split(".", 1)[0] in head_modules

    return ParamPartition(select)


def private_partition() -> ParamPartition:
    """The personalization split within the trainable leaves: the
    adapters are each client's own; the rest (the head) is shared and
    aggregates."""
    return ParamPartition(is_adapter)


@dataclasses.dataclass(frozen=True)
class PeftPlan:
    """What a configured PEFT run gives the simulation.

    ``part`` is the trainable/frozen split; under ``personalized`` the
    aggregated names shrink to the trainable ones that are not private
    (``agg_part``). ``stat_names`` are the model's batch statistics,
    which are not parameters and pass through every view."""

    part: ParamPartition
    personalized: bool = False
    stat_names: tuple[str, ...] = ()

    @property
    def private(self) -> ParamPartition:
        return private_partition()

    @property
    def agg_part(self) -> ParamPartition:
        """The partition selecting what the server aggregates."""
        if not self.personalized:
            return self.part
        part, priv = self.part, self.private
        return ParamPartition(lambda k: part.select(k)
                              and not priv.select(k))

    def _params(self, variables: Tree) -> Tree:
        return {k: v for k, v in variables.items()
                if k not in self.stat_names}

    # -- the view and merge the rounds wrap --------------------------------

    def agg_variables(self, variables: Tree) -> Tree:
        """The variables pruned to the aggregated names, the statistics
        kept, in the variables' order."""
        keep = self.agg_part.trainable(self._params(variables))
        return {k: v for k, v in variables.items()
                if k in keep or k in self.stat_names}

    def view_state(self, state):
        """The :class:`~fedml_tpu_torch.algorithms.fedavg.ServerState` the
        server step takes: the aggregated variables only (the optimizer
        state and momentum are built at this shape)."""
        return state._replace(variables=self.agg_variables(state.variables))

    def merge_state(self, new_view, old_state):
        """The server step's output view with the old state's other
        leaves, in the full variables' order: the frozen leaves of the
        new state are the old state's tensors."""
        new = new_view.variables
        return new_view._replace(variables={
            k: new[k] if k in new else v
            for k, v in old_state.variables.items()})

    # -- accounting (the peft.* counters) -----------------------------------

    def counts(self, variables: Tree) -> tuple[int, int]:
        """(trainable, frozen) scalar parameter counts."""
        params = self._params(variables)
        return (tree_count(self.part.trainable(params)),
                tree_count(self.part.frozen(params)))

    def adapter_wire_bytes(self, variables: Tree) -> int:
        """Dense bytes of one client's round update (the aggregated
        parameters), before any codec."""
        return tree_bytes(self.agg_part.trainable(self._params(variables)))

    def full_wire_bytes(self, variables: Tree) -> int:
        """Dense bytes of the full-delta baseline: what full fine-tuning
        of the base model ships per client per round. The adapter leaves
        belong to neither baseline and are left out."""
        return tree_bytes(private_partition().frozen(
            self._params(variables)))
