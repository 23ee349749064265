"""Federated datasets: host-side containers and the offline loaders."""

from fedml_tpu_torch.data.federated import (
    FederatedArrays,
    FederatedData,
    arrays_and_batch,
    build_federated_data,
)
from fedml_tpu_torch.data.loaders import (
    load_dataset,
    make_fake_image_dataset,
    make_fake_text_dataset,
    make_synthetic,
)

__all__ = [
    "FederatedArrays",
    "FederatedData",
    "arrays_and_batch",
    "build_federated_data",
    "load_dataset",
    "make_fake_image_dataset",
    "make_fake_text_dataset",
    "make_synthetic",
]
