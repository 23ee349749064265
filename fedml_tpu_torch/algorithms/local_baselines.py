"""The non-federated baselines: local-only training and pooled
centralized training (``fedml_tpu.algorithms.local_baselines``).

- :class:`BaselineSim`: every client trains its own model on its own
  data every round and nothing is communicated (the lower bound of the
  FL comparisons). All clients are one cohort of lanes, each from its own
  variables (``CohortUpdate(starts=)``), in size-sorted groups, one CUDA
  graph replay a group-step on the card.
- :class:`CentralizedTrainer`: one model on the pooled data, a single
  client that owns every sample (:func:`pooled_data`); ``run_round(
  variables, round_idx)`` is ``train.epochs`` epochs of minibatch SGD,
  the same local update as a FedAvg client's (the upper bound, and the
  oracle partner of full-batch FedAvg).

Both take :class:`~fedml_tpu_torch.algorithms.client_sim.ClientSim`'s
hooks: ``batch_orders(round, client)`` (the JAX package keys a round by
``fold_in(root, round)`` and a client by ``fold_in(round key, client)``)
and ``draws`` (the ``"dropout"`` masks of a model with dropout, drawn at
the round by host id).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from fedml_tpu_torch.algorithms.base import (
    CohortUpdate,
    build_evaluator,
    finalize_sums,
)
from fedml_tpu_torch.algorithms.client_sim import ClientSim
from fedml_tpu_torch.algorithms.hierarchical import INIT
from fedml_tpu_torch.algorithms.stack_utils import evaluate_stack, vmap_init
from fedml_tpu_torch.config import ExperimentConfig
from fedml_tpu_torch.core import random as R
from fedml_tpu_torch.data.federated import FederatedData
from fedml_tpu_torch.models.base import FedModel, Params


class _LocalSim(ClientSim):
    """A model's lanes trained each from its own variables."""

    def __init__(self, model: FedModel, data: FederatedData,
                 cfg: ExperimentConfig, device, batch_orders, draws):
        super().__init__({"model": model}, data, cfg, device, None,
                         batch_orders, draws, {"dropout": cfg.seed},
                         p={"dropout": model.mask_keep})
        self.model = model
        self.cohort_update = CohortUpdate(model, self.task, cfg.train,
                                          self.batch_size, self.graphed)
        self.evaluator = build_evaluator(model, self.task)

    def _train(self, round_idx: int, hosts: np.ndarray, lane_vars: Params):
        """The lanes of ``hosts`` from ``lane_vars``: their variables and
        the finalized metrics (tensors)."""
        stacked, _, sums = self._train_lanes(
            self.cohort_update, self.model, hosts, lane_vars,
            self._stack_orders(hosts, lambda c: self.batch_orders(
                round_idx, c)), round_idx)
        fin = finalize_sums({k: v.sum() for k, v in sums.items()})
        return stacked, {"train_loss": fin["loss"], "train_acc": fin["acc"]}


class BaselineState(NamedTuple):
    model_stack: Params  # [N, ...] the clients' independent models
    round: int


class BaselineSim(_LocalSim):
    """Local-only training: every client, every round, its own model."""

    def __init__(self, model: FedModel, data: FederatedData,
                 cfg: ExperimentConfig, device: str | torch.device = "cuda",
                 batch_orders: Callable | None = None,
                 draws: R.Draws | None = None):
        super().__init__(model, data, cfg, device, batch_orders, draws)

    def init(self) -> BaselineState:
        return BaselineState(vmap_init(self.model.init,
                                       self.arrays.num_clients,
                                       self.cfg.seed, INIT), 0)

    def run_round(self, state: BaselineState):
        hosts = np.arange(self.arrays.num_clients)
        stack, metrics = self._train(state.round, hosts, state.model_stack)
        return BaselineState(stack, state.round + 1), metrics

    def evaluate_clients(self, state: BaselineState) -> dict:
        """Every client's model on the global test set, averaged over the
        clients."""
        a = self.arrays
        return evaluate_stack(self.evaluator, state.model_stack, a.test_x,
                              a.test_y, a.num_clients)


def pooled_data(data: FederatedData) -> FederatedData:
    """The federated set as one client that owns every train and test
    sample, in client order."""
    all_train = np.concatenate(
        [data.train_idx_map[i] for i in range(data.num_clients)])
    all_test = np.concatenate(
        [data.test_idx_map[i] for i in range(data.num_clients)])
    return FederatedData(data.x_train, data.y_train, data.x_test,
                         data.y_test, {0: all_train}, {0: all_test},
                         data.num_classes, data.task)


class CentralizedTrainer(_LocalSim):
    """One model on the pooled data: ``run_round(variables, round_idx)``
    trains it ``train.epochs`` epochs (the pooled client's batch orders
    at ``round_idx``) and returns it with the round's train loss and
    accuracy as floats."""

    def __init__(self, model: FedModel, data: FederatedData,
                 cfg: ExperimentConfig, device: str | torch.device = "cuda",
                 batch_orders: Callable | None = None,
                 draws: R.Draws | None = None):
        super().__init__(model, pooled_data(data), cfg, device,
                         batch_orders, draws)

    def init(self) -> Params:
        return self.model.init(R.generator(self.cfg.seed, INIT))

    def run_round(self, variables: Params, round_idx: int):
        lanes = {k: v.detach()[None] for k, v in variables.items()}
        stacked, m = self._train(round_idx, np.zeros(1, np.int64), lanes)
        return ({k: v[0] for k, v in stacked.items()},
                {k: float(v) for k, v in m.items()})

    def evaluate(self, variables: Params) -> dict:
        m = self.evaluator(variables, self.arrays.test_x, self.arrays.test_y)
        return {k: float(v) for k, v in m.items()}

    def evaluate_train(self, variables: Params) -> dict:
        m = self.evaluator(variables, self.arrays.x, self.arrays.y)
        return {k: float(v) for k, v in m.items()}
