#!/usr/bin/env python3
"""Runs the port's observability planes on one NVIDIA card.

    python3 scripts/observability_smoke.py

Runs phases 1 and 15 of chip_smoke.py and nothing else: the card and
versions, then (a) the headline ResNet-56 through the CLI with every
plane on (capture windows, anatomy, the listener, an SLO, the memory
monitor and a breach capture), (b) the anatomy plane's bench records and
the planes' inertness, bit for bit, (c) FedUAGAN through the harness
with a captured round. It calls chip_smoke's own functions and prints
the same JSON lines; no kernel is built (neither path runs one). Exits 1
without a CUDA card.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("observability_smoke: no CUDA device; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 1
    card = chip_smoke.environment()
    chip_smoke.observability_phase(card)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
