"""Federated algorithms: the FedAvg simulation and its building blocks."""

from fedml_tpu_torch.algorithms.base import (
    build_evaluator,
    build_local_update,
    make_task,
)
from fedml_tpu_torch.algorithms.fedavg import FedAvgSim, ServerState

__all__ = [
    "FedAvgSim",
    "ServerState",
    "build_evaluator",
    "build_local_update",
    "make_task",
]
