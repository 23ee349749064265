"""Federated datasets: host-side containers and the offline loaders."""

from fedml_tpu_torch.data.federated import (
    FederatedArrays,
    FederatedData,
    arrays_and_batch,
)
from fedml_tpu_torch.data.loaders import load_dataset, make_fake_text_dataset

__all__ = [
    "FederatedArrays",
    "FederatedData",
    "arrays_and_batch",
    "load_dataset",
    "make_fake_text_dataset",
]
