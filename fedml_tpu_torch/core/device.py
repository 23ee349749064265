"""Device selection for the port's entry points.

Entry points default to ``"cuda"`` and run on the CPU only when the caller
asks for it: a missing card is an error, never a silent switch to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def to_device(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device``. To a card it goes through pinned memory
    without blocking: the host does not wait for the device, and a CUDA
    stream is not synchronized (a pageable copy would be)."""
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)
