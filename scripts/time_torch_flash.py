#!/usr/bin/env python3
"""Checks and times the port's flash-attention kernels on one NVIDIA card.

    python3 scripts/time_torch_flash.py

Runs phases 1-3 of chip_smoke.py and nothing else: the card and versions,
the build of every kernel with ptxas's report (registers, spills) and the
SASS check (HMMA in every bf16/fp16 instance), the kernels against their
plain version at chip_smoke's edge shapes, and the kernel, SDPA and the
bound at chip_smoke's timed shapes (float32, and bf16/fp16 on the tensor
cores). It calls
chip_smoke's own functions, so the timing and the bound are computed in
one place, and prints the same JSON lines. It leaves out what makes a
chip_smoke run long: the plain version's timing (``plain_ms`` is null) and
the FedAvg rounds. Exits 1 without a CUDA card.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("time_torch_flash: no CUDA device; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 1
    card = chip_smoke.environment()
    chip_smoke.build_kernels()
    chip_smoke.kernel_checks(time_plain=False)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
