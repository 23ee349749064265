#!/usr/bin/env python3
"""How far two float32 runs of one ResNet-56 local update can drift apart,
on one NVIDIA card and its host's CPU.

    python3 scripts/resnet_parity_spread.py

For every client of round 0's cohort at chip_smoke.py's ResNet-56
configuration (float32, TF32 off, the same random initial weights), it
runs the client's local update, all its real steps in round 0's batch
order, four ways: on the card and on the CPU from the initial weights,
and on each from the weights perturbed by one float32 rounding
(chip_smoke's PERTURB). It prints one JSON line per client: its samples
and steps, the largest parameter and statistic differences card vs CPU,
CPU vs perturbed CPU and card vs perturbed card, and the largest
parameter change of the update itself. These are the numbers behind
chip_smoke's card-vs-CPU bands (RESNET_PARITY for one step,
SPREAD_FACTOR past it). Exits 1 without a CUDA card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    if not torch.cuda.is_available():
        print("resnet_parity_spread: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import UpdateRig, environment, resnet_config
    from fedml_tpu_torch.data import load_dataset

    environment()
    cfg = resnet_config()
    rig = UpdateRig(cfg, load_dataset(cfg.data))
    start = rig.sims["cuda"].init().variables
    moved = rig.perturbed(start)
    for c in sorted(rig.cohort, key=lambda i: int(rig.counts[i])):
        card, cpu = rig.update("cuda", start, c), rig.update("cpu", start, c)
        print(json.dumps({"client": c, "samples": int(rig.counts[c]),
            "steps": rig.steps(c),
            "card_vs_cpu": rig.max_err(card, cpu),
            "cpu_vs_perturbed_cpu": rig.max_err(
                cpu, rig.update("cpu", moved, c)),
            "card_vs_perturbed_card": rig.max_err(
                card, rig.update("cuda", moved, c)),
            "largest_param_change": max(
                (cpu[k] - start[k].cpu()).abs().max().item()
                for k in cpu if k not in rig.stat_names)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
