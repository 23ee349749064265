"""Private per-client adapter banks (``peft_personalize``), the JAX
package's ``fedml_tpu/peft/personal.py``.

Personalized PEFT keeps each client's LoRA adapters private: a bank holds
one ``[num_clients, ...]`` row of adapter leaves per client, and only the
shared trainable leaves (the LM head) aggregate. Each round the cohort's
rows are gathered, start the clients' local training, and the trained
rows are scattered back; the other rows are not touched. In the
simulation the rows live in a :class:`~fedml_tpu_torch.core.statebank.
ClientStateBank` named ``"adapter"`` (``FedAvgSim.adapter_bank``).

The no-leak contract:

- the server state's adapter leaves stay at their init values: the
  aggregated view does not contain them;
- client ``i``'s row is written only from client ``i``'s own update.

The global model under personalization is the base with the aggregated
head and inert adapters (``lora_b`` zero), so global evaluation measures
the shared model; :func:`personal_variables` gives a client's own model.
"""

from __future__ import annotations

from typing import Sequence

import torch

from fedml_tpu_torch.peft.partition import PeftPlan, tree_bytes

Tree = dict[str, torch.Tensor]


def init_bank(plan: PeftPlan, variables: Tree, num_clients: int) -> Tree:
    """``[num_clients, ...]`` private rows, each the init adapters (with
    ``lora_b`` zero every client starts as the base model)."""
    private = plan.private.trainable(plan.part.trainable(
        {k: v for k, v in variables.items() if k not in plan.stat_names}))
    return {k: v[None].expand((num_clients,) + tuple(v.shape)).clone()
            for k, v in private.items()}


def gather_rows(bank: Tree, cohort: torch.Tensor) -> Tree:
    """The cohort's rows, stacked ``[C, ...]``."""
    return {k: v.index_select(0, cohort) for k, v in bank.items()}


def scatter_rows(bank: Tree, cohort: torch.Tensor, rows: Tree) -> Tree:
    """The bank with the cohort's rows replaced (the cohort is drawn
    without replacement, so no row is written twice); a new tree."""
    return {k: b.index_copy(0, cohort, rows[k].to(b.dtype))
            for k, b in bank.items()}


def bank_bytes(bank: Tree) -> int:
    return tree_bytes(bank)


def personal_variables(plan: PeftPlan, variables: Tree, bank: Tree,
                       client_id: int | Sequence[int]) -> Tree:
    """Client ``client_id``'s personalized model: the shared variables
    with the client's private row in place of the adapters."""
    row = {k: v[client_id] for k, v in bank.items()}
    merged = plan.private.merge(row, plan.private.frozen(variables))
    return {k: merged[k] for k in variables}
