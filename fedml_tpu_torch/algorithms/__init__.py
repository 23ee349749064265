"""Federated algorithms: the FedAvg simulation, the GAN family's (FedGAN,
FedGDKD, FedDTG, FedSSGAN, FedUAGAN, and FedGDKD over heterogeneous
client models), the distillation family's (FedMD,
FD+FAug, FedArjun), the topologies' (hierarchical FedAvg, decentralized
DSGD and push-sum, decentralized online learning) and their building
blocks."""

from fedml_tpu_torch.algorithms.base import (
    build_evaluator,
    build_local_update,
    make_task,
)
from fedml_tpu_torch.algorithms.decentralized import (
    DecentralizedSim,
    OnlineDecentralizedSim,
)
from fedml_tpu_torch.algorithms.distill import FDSim, FedArjunSim, FedMDSim
from fedml_tpu_torch.algorithms.fedavg import FedAvgSim, ServerState
from fedml_tpu_torch.algorithms.gan_family import (
    FedDTGSim,
    FedGANSim,
    FedGDKDSim,
    FedGDKDState,
)
from fedml_tpu_torch.algorithms.hetero import HeteroFedGDKD
from fedml_tpu_torch.algorithms.hierarchical import HierarchicalFedAvg
from fedml_tpu_torch.algorithms.sgan import FedSSGANSim, FedUAGANSim

__all__ = [
    "DecentralizedSim",
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
    "HeteroFedGDKD",
    "HierarchicalFedAvg",
    "OnlineDecentralizedSim",
    "ServerState",
    "build_evaluator",
    "build_local_update",
    "make_task",
]
