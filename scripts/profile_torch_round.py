#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's main paths, on one NVIDIA card.

    python3 scripts/profile_torch_round.py [--model resnet56|transformer_lm]
        [--family NAME] [--trace PATH]

Builds one of chip_smoke.py's configurations: ``resnet56`` (the default:
bench.py's headline, ResNet-56 with BatchNorm and bf16 compute on
fake_cifar10, 100 clients, 10 a round, batch 32, 5 groups of 2 clients)
or ``transformer_lm`` (on fake_shakespeare), or with ``--family`` one of
the bench's FedAvg families (chip_smoke.py FAMILY_SPECS: mnist_lr,
femnist_cnn, cifar_mobilenet, fedopt_resnet18gn, shakespeare_lstm,
stackoverflow_lstm) at its published shape. It runs one warm-up round
(which captures the cohort's CUDA graph), times the next round untraced,
then traces with torch.profiler that same round again from the same
state, and for the transformer one evaluation of the global model
through the flash-attention kernel. For each it prints one JSON line: the
wall time (host clock ending in a synchronize; for the round also the
untraced wall time and the idle share estimated from it), the device's
busy time (the union of the traced kernels' intervals), the idle share,
the kernels that take the most device time, the device time by kernel
family, the host ops that take the most CPU time, and for the
convolutions which memory layout cuDNN's kernels use.

How kernels are counted: ``kernels`` is every device activity CUPTI
records in the window (kernels, memcpys and memsets), and a kernel that
runs as a node of a CUDA graph is recorded like any other, once per
replay; ``host_launches`` counts the host's launch calls by CUDA runtime
or driver function (``cudaLaunchKernel``, ``cudaGraphLaunch``,
``cudaMemcpyAsync``, ...), so kernels launched one by one and graph
launches are told apart. The round's row adds its groups (clients and
steps per epoch of each), its graph replays, and the device activities
per replay: the window's activities less the host-launched kernels and
copies, over the replays. ``--trace`` also writes the round's Chrome
trace.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


# device-time families, by kernel name (first match wins)
FAMILIES = (
    ("layout transpose", re.compile(r"nchwToNhwc|nhwcToNchw|transpose",
                                    re.I)),
    ("convolution", re.compile(r"conv|fprop|dgrad|wgrad|implicit_gemm",
                               re.I)),
    ("gemm", re.compile(r"gemm|cutlass|xmma", re.I)),
    ("reduction", re.compile(r"reduce", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized", re.I)),
    ("copy", re.compile(r"memcpy|memset|copy", re.I)),
)


# host calls that put work on the device: one kernel or copy each, or one
# whole graph (cudaGraphLaunch)
HOST_LAUNCH = re.compile(r"^(cuda|cu)(Launch|GraphLaunch|Memcpy|Memset)")


def family(name: str) -> str:
    return next((f for f, pat in FAMILIES if pat.search(name)), "other")


def conv_layouts(per_name: dict, top: int = 6) -> dict:
    """Device time of the convolution kernels by the layout their name
    states (cuDNN names its NHWC kernels ``...nhwc...``), and the
    heaviest convolution kernels by name."""
    out, convs = defaultdict(float), []
    for name, us in per_name.items():
        if family(name) == "convolution":
            low = name.lower()
            out["nhwc" if "nhwc" in low else
                "nchw" if "nchw" in low else "unstated"] += us
            convs.append((us, name[:120]))
    return {**out, "heaviest": {n: us for us, n in sorted(convs)[::-1][:top]}}


def device_summary(prof, wall_s: float, top: int = 12) -> dict:
    """Busy time, idle share, the heaviest kernels and kernel families,
    and the heaviest host ops of one trace."""
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
    families = defaultdict(float)
    for name, us in per_name.items():
        families[family(name)] += us
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    launches = {a.key: a.count for a in host if HOST_LAUNCH.match(a.key)}
    return {
        "wall_s": wall_s,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
        "kernels": len(spans),
        "host_launches": launches,
        "top_kernels_us": {name[:100]: us for name, us in heavy},
        "device_us_by_family": dict(families),
        "conv_device_us_by_layout": conv_layouts(per_name),
        "top_host_ops_self_cpu_us": {
            a.key[:60]: a.self_cpu_time_total for a in host[:top]},
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
    ap.add_argument("--model", default="resnet56",
                    choices=["resnet56", "transformer_lm"],
                    help="which of chip_smoke.py's configurations to trace")
    ap.add_argument("--family", default=None,
                    help="trace one of chip_smoke.py's FAMILY_SPECS "
                         "instead of --model")
    ap.add_argument("--trace", default=None,
                    help="write the round's Chrome trace to this path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_round: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import (
        FAMILY_SPECS,
        card_line,
        family_setup,
        flash_twin,
        resnet_config,
        smoke_config,
    )
    from fedml_tpu_torch.algorithms.base import build_evaluator
    from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
    from fedml_tpu_torch.data import load_dataset
    from fedml_tpu_torch.models import create_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(), flush=True)
    if args.family is not None:
        if args.family not in FAMILY_SPECS:
            ap.error(f"--family: one of {sorted(FAMILY_SPECS)}")
        cfg, data = family_setup(args.family)
    else:
        cfg = resnet_config() if args.model == "resnet56" else smoke_config()
        data = load_dataset(cfg.data)
    model = create_model(cfg.model)
    sim = FedAvgSim(model, data, cfg)
    # warm-up: the graph's capture, kernels, allocator
    state, _ = sim.run_round(sim.init())
    torch.cuda.synchronize()
    cohort = sim.sampler(state.round, sim.arrays.num_clients,
                         cfg.fed.clients_per_round)
    counts = sim.arrays.counts[torch.as_tensor(cohort)]
    # the clients' own real steps, summed (a per-client loop runs exactly
    # these), and the steps of the groups the batched cohort runs
    client_steps = cfg.train.epochs * int(
        torch.sum((counts + sim.batch_size - 1) // sim.batch_size))
    # the same round untraced, from the same state: the trace slows the
    # host, so the idle share of an untraced round is estimated from this
    # wall time and the traced busy time
    graph = sim.cohort_update.graph
    t0 = time.perf_counter()
    sim.run_round(state)
    torch.cuda.synchronize()
    wall_untraced = time.perf_counter() - t0
    before = graph.replays
    (state, _), round_row = traced(lambda: sim.run_round(state), args.trace)
    replays = graph.replays - before
    busy = round_row.get("device_busy_s")
    host = round_row.get("host_launches", {})
    one_by_one = sum(n for k, n in host.items() if "Graph" not in k)
    round_row = {"model": cfg.model.name, "family": args.family,
                 "client_steps": client_steps,
                 "groups": [{"clients": n, "steps_per_epoch": s}
                            for n, s in sim.last_groups],
                 "group_steps": cfg.train.epochs * sum(
                     s for _, s in sim.last_groups),
                 "graph_replays": replays,
                 "device_activities_per_replay": (
                     (round_row.get("kernels", 0) - one_by_one) / replays
                     if replays else "not measured"),
                 "wall_untraced_s": wall_untraced,
                 "idle_share_untraced_estimate": (
                     1.0 - busy / wall_untraced
                     if isinstance(busy, float) else "not measured"),
                 **round_row}
    print(json.dumps({"profile_round": round_row}), flush=True)
    if args.family is None and args.model == "transformer_lm":
        flash_eval = build_evaluator(flash_twin(model), sim.task)
        a = sim.arrays
        flash_eval(state.variables, a.test_x, a.test_y)
        _, eval_row = traced(
            lambda: flash_eval(state.variables, a.test_x, a.test_y), None)
        print(json.dumps({"profile_flash_eval": eval_row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
