#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's main path, on one NVIDIA card.

    python3 scripts/profile_torch_round.py [--trace PATH]

Builds chip_smoke.py's configuration (transformer_lm on fake_shakespeare),
runs one warm-up round, then traces with torch.profiler one FedAvg round
and one evaluation of the global model through the flash-attention kernel.
For each it prints one JSON line: the wall time (host clock ending in a
synchronize), the device's busy time (the union of the traced kernels'
intervals), the idle share, the kernel count, and the kernels that take
the most device time. ``--trace`` also writes the Chrome trace.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def device_summary(prof, wall_s: float, top: int = 8) -> dict:
    """Busy time, idle share and the heaviest kernels of one trace."""
    spans, per_name = [], defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            per_name[e.name] += e.time_range.elapsed_us()
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted(spans):  # union of the kernel intervals
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    if not spans:
        return {"wall_s": wall_s, "device_busy_s": "not measured"}
    heavy = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "wall_s": wall_s,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
        "kernels": len(spans),
        "top_kernels_us": {name[:80]: us for name, us in heavy},
    }


def traced(fn, trace_path: str | None):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if trace_path:
        prof.export_chrome_trace(trace_path)
    return out, device_summary(prof, wall)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default=None,
                    help="write the round's Chrome trace to this path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_round: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import flash_twin, smoke_config
    from fedml_tpu_torch.algorithms.base import build_evaluator
    from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
    from fedml_tpu_torch.data import load_dataset
    from fedml_tpu_torch.models import create_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = smoke_config()
    model = create_model(cfg.model)
    sim = FedAvgSim(model, load_dataset(cfg.data), cfg)
    state, _ = sim.run_round(sim.init())  # warm-up: kernels, allocator
    flash_eval = build_evaluator(flash_twin(model), sim.task)
    a = sim.arrays
    flash_eval(state.variables, a.test_x, a.test_y)

    (state, _), round_row = traced(lambda: sim.run_round(state), args.trace)
    _, eval_row = traced(
        lambda: flash_eval(state.variables, a.test_x, a.test_y), None)
    print(json.dumps({"profile_round": round_row}), flush=True)
    print(json.dumps({"profile_flash_eval": eval_row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
