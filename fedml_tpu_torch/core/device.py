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
