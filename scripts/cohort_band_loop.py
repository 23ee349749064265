#!/usr/bin/env python3
"""Repeats tests/test_torch_cohort.py::test_graphed_cohort_matches_cpu on
one NVIDIA card and logs, for every run, the worst leaf of the card's
graphed rounds against the CPU's eager ones.

    python3 scripts/cohort_band_loop.py [--runs 24] [--kernels]
        [--deterministic]

Each run builds fresh simulations, as the test's ``sgd_momentum`` case
does: two rounds of ResNet-8 in 2 groups on the card (each local step
one CUDA graph replay) and on the CPU, float32 with TF32 off. A run
prints one JSON line: the largest absolute difference over every
variable, the leaf it is in, and the band's use, max |card - cpu| /
(atol + rtol |cpu|) over every element (above 1 the test's band of 1e-4
is missed), and the largest difference of the card's and of the CPU's
variables from the first run's (each side's own spread from run to
run). ``--deterministic`` sets ``torch.backends.cudnn.deterministic``.
With ``--kernels`` each run
is traced with torch.profiler, and its line also names the CUDA kernels
it ran that the first run did not, and those of the first run it did not
run (the first run's line lists them all). The last line sums the runs.
Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
ATOL = RTOL = 1e-4  # the test's band


def _cohort_test():
    # by path: on a machine where another installed package is named
    # "tests", ``import tests`` would not find this repository's
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location(
        "cohort_test", ROOT / "tests" / "test_torch_cohort.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kernel_names(prof) -> set:
    """The CUDA kernels a trace ran, by name."""
    names = set()
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            names.add(evt.name)
    return names


def one_run(test, train: dict, trace: bool = False):
    sims = {d: test._sim(train, 2, d) for d in ("cpu", "cuda")}
    states = {d: s.init() for d, s in sims.items()}
    prof = None
    if trace:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    try:
        for _ in range(2):
            for d, s in sims.items():
                states[d], _ = s.run_round(states[d])
        torch.cuda.synchronize()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    worst = {"max_abs_err": 0.0, "leaf": None, "band_use": 0.0,
             "band_leaf": None}
    for k, want in states["cpu"].variables.items():
        got = states["cuda"].variables[k].cpu()
        err = (got - want).abs()
        use = (err / (ATOL + RTOL * want.abs())).max().item()
        if err.max().item() > worst["max_abs_err"]:
            worst.update(max_abs_err=err.max().item(), leaf=k)
        if use > worst["band_use"]:
            worst.update(band_use=use, band_leaf=k)
    if prof is not None:
        worst["kernels"] = kernel_names(prof)
    return worst, {d: {k: v.cpu() for k, v in s.variables.items()}
                   for d, s in states.items()}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--runs", type=int, default=24)
    p.add_argument("--kernels", action="store_true",
                   help="trace each run and name the kernels that differ "
                        "from the first run's")
    p.add_argument("--deterministic", action="store_true",
                   help="cuDNN's deterministic algorithms")
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("cohort_band_loop: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = a.deterministic
    test = _cohort_test()
    runs, first, first_vars = [], None, None
    for i in range(a.runs):
        worst, variables = one_run(test, test.SGD, a.kernels)
        first_vars = first_vars or variables
        row = {"run": i, "deterministic": a.deterministic, **worst}
        for d, v in variables.items():
            row[f"{d}_vs_first_run"] = max(
                (v[k] - first_vars[d][k]).abs().max().item() for k in v)
        if a.kernels:
            names = row.pop("kernels")
            if first is None:
                first = names
                row["kernels"] = sorted(names)
            else:
                row["kernels_new"] = sorted(names - first)
                row["kernels_missing"] = sorted(first - names)
        runs.append(row)
        print(json.dumps(row), flush=True)
    uses = [r["band_use"] for r in runs]
    print(json.dumps({"runs": len(runs), "misses": sum(u > 1 for u in uses),
                      "deterministic": a.deterministic,
                      "card_spread_max": max(r["cuda_vs_first_run"]
                                             for r in runs),
                      "cpu_spread_max": max(r["cpu_vs_first_run"]
                                            for r in runs),
                      "band_use_max": max(uses),
                      "band_use_median": sorted(uses)[len(uses) // 2],
                      "max_abs_err_max": max(r["max_abs_err"]
                                             for r in runs),
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
