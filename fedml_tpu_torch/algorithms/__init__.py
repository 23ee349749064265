"""Federated algorithms: the FedAvg and FedGDKD simulations and their
building blocks."""

from fedml_tpu_torch.algorithms.base import (
    build_evaluator,
    build_local_update,
    make_task,
)
from fedml_tpu_torch.algorithms.fedavg import FedAvgSim, ServerState
from fedml_tpu_torch.algorithms.gan_family import FedGDKDSim, FedGDKDState

__all__ = [
    "FedAvgSim",
    "FedGDKDSim",
    "FedGDKDState",
    "ServerState",
    "build_evaluator",
    "build_local_update",
    "make_task",
]
