"""fedml_tpu_torch — the PyTorch port of fedml_tpu, for NVIDIA Hopper.

It mirrors the layout of the JAX package (``config``, ``data``,
``models``, ``ops``, ``algorithms``, ``core``, ``metrics``) and imports
neither JAX nor ``fedml_tpu``. Entry points run on ``device="cuda"``
unless the caller asks for ``"cpu"``. Every Pallas kernel of the JAX
package becomes a hand-written CUDA kernel here (``csrc/``), built at
first use.
"""

__version__ = "0.1.0"

from fedml_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    FedConfig,
    GanConfig,
    ModelConfig,
    TrainConfig,
)

__all__ = [
    "DataConfig",
    "ExperimentConfig",
    "FedConfig",
    "GanConfig",
    "ModelConfig",
    "TrainConfig",
]
