"""Federated algorithms: the FedAvg simulation, the GAN family's (FedGAN,
FedGDKD, FedDTG, FedSSGAN, FedUAGAN), the distillation family's (FedMD,
FD+FAug, FedArjun) and their building blocks."""

from fedml_tpu_torch.algorithms.base import (
    build_evaluator,
    build_local_update,
    make_task,
)
from fedml_tpu_torch.algorithms.distill import FDSim, FedArjunSim, FedMDSim
from fedml_tpu_torch.algorithms.fedavg import FedAvgSim, ServerState
from fedml_tpu_torch.algorithms.gan_family import (
    FedDTGSim,
    FedGANSim,
    FedGDKDSim,
    FedGDKDState,
)
from fedml_tpu_torch.algorithms.sgan import FedSSGANSim, FedUAGANSim

__all__ = [
    "FDSim",
    "FedArjunSim",
    "FedAvgSim",
    "FedDTGSim",
    "FedGANSim",
    "FedGDKDSim",
    "FedGDKDState",
    "FedMDSim",
    "FedSSGANSim",
    "FedUAGANSim",
    "ServerState",
    "build_evaluator",
    "build_local_update",
    "make_task",
]
