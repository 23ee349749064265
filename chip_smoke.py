#!/usr/bin/env python3
"""Drives the PyTorch port (fedml_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure is an uncaught exception and a non-zero exit:

1. Environment: the card's name and power limit, torch and CUDA versions;
   TF32 is switched off for float32 matrix products and convolutions.
2. Build: every CUDA kernel of the port, from fedml_tpu_torch/csrc, for
   sm_90a (one nvcc per source, all started together), with ptxas's
   registers and spills for every instance; then cuobjdump's SASS must
   show tensor-core instructions (HMMA) in each bf16 and fp16 instance of
   flash_fwd_mma_kernel, and flash_fwd_kernel (the FP32-core body) must
   exist for float32 only.
3. Kernel vs plain: the flash-attention kernels against their plain
   PyTorch version, causal and not. First, for correctness only, at their
   edges (EDGE_CASES): T of 1, 17, 77 and 80, T past one block (130, 200,
   300), D of 32 (float32), 32, 64 and 128 (bfloat16) and 64 and 128
   (float16), a strided k, a k whose head dim is not contiguous, and q,
   k, v sliced from one packed QKV tensor, aligned and not. Then, timed,
   at the transformer FedAvg path's shape ([256, 80, 4, 32] float32,
   atol = rtol = 2e-5, and bfloat16) and at long context ([4, 2048, 8,
   64] bfloat16 and float16, [4, 2048, 8, 128] bfloat16), each 16-bit row
   against the plain version in float32 from the same inputs (bfloat16
   atol 2e-2, rtol 0; float16 atol = rtol = 2e-3), with median CUDA-event
   times of the kernel, the plain version and torch's
   scaled_dot_product_attention (a yardstick only; the port never calls
   it), their ratio, and the kernel's bound. scripts/time_torch_flash.py
   runs phases 1-3 alone.
4. Main path: FedAvgSim over transformer_lm at create_model's widths on
   fake_shakespeare (20 clients, 10 a round, batch 32, SGD, 3 rounds);
   every train loss must be finite and the last test loss below the
   initial model's. The cohort runs batched: the local step vmapped over
   each size-sorted group of clients, one CUDA graph replay per step;
   the phase prints the groups, their steps and the graph's replays.
5. The kernel on the main path: the final global model is evaluated with
   build_evaluator twice, with full attention and with flash attention on
   the same weights; the losses must agree within 1e-4 relative and the
   accuracies within 1e-4, and the kernel's launch count over phases 4-5
   must be above 0. The main path runs float32 only, so the tensor-core
   kernel's launch count there is 0, and the report says so.
6. The ResNet-56 main path, the reference's headline (bench.py
   build_sim): FedAvgSim over resnet56 (BatchNorm, bf16 compute, float32
   master weights and statistics) on fake_cifar10, 100 clients, hetero
   LDA alpha 0.5, batch 32, SGD lr 0.03, 1 epoch, 10 clients a round, 3
   rounds with a global evaluation after each. Every loss must be finite,
   the returned parameters and statistics float32, and the last test loss
   below the initial model's. The cohort runs batched, as in phase 4
   (5 groups of 2 clients), and the phase prints the groups, their steps
   and the graph's replays; then one more round runs under
   torch.cuda.set_sync_debug_mode("error"), so any host sync in a round
   raises. It launches no hand-written kernel (its convolutions,
   BatchNorm and GEMMs are torch ops on cuDNN and cuBLAS), and the flash
   counters, set to 0 before it, must read 0 after it. Then float32 local
   updates (real steps, in the batch order round 0 gave them) run on the
   card, through the batched, graphed cohort on the group of the cohort's
   largest client, and on the CPU, one client at a time, from the same
   weights, TF32 off: the largest client's first step must agree within
   RESNET_PARITY (atol = rtol = 1e-3) in parameters and statistics, and
   all its steps, chaotic in float32 past the first, within SPREAD_FACTOR
   times the CPU's own spread under a one-rounding perturbation of the
   start.
   It prints a "resnet56_main_path" line (its seconds are a one-sample
   smoke figure, not a metric).
7. A "kernels" JSON line with one entry per kernel (flash_attention, the
   float32 body, and flash_attention_mma, the bf16/fp16 body), with each
   kernel's launches on the transformer path and on the ResNet-56 path
   (the batched cohort runs no hand-written kernel), the card's name and
   power limit, and last the result line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_FLOPS = {  # H100 SXM dense peaks
    torch.float32: 67e12,  # FP32 cores (the kernel's products run there)
    torch.bfloat16: 989e12,
    torch.float16: 989e12,
}
MAIN_SHAPE = (256, 80, 4, 32)  # eval batch 256, T 80, 4 heads of 32
LONG_SHAPE = (4, 2048, 8, 64)
WIDE_SHAPE = (4, 2048, 8, 128)  # the register-hungry 16-bit instance
# card vs CPU, float32 local updates of ResNet-56 (TF32 off). One step
# from the same weights: only the order of the sums differs, held at
# RESNET_PARITY. Past one step at lr 0.03 from a random init the update
# is chaotic in float32: perturbing the starting weights by PERTURB (one
# float32 rounding) moves the parameters after 2-3 steps by as much as
# the update itself, on the CPU as on the card. A multi-step update is
# therefore held against the CPU's own spread under that perturbation:
# card vs CPU at most SPREAD_FACTOR times CPU vs perturbed CPU.
RESNET_PARITY = dict(atol=1e-3, rtol=1e-3)
PERTURB = 1e-7
SPREAD_FACTOR = 4.0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 15, inner: int = 10) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner``
    back-to-back calls, per call, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def attention_bound(shape, dtype, causal) -> tuple[float, str]:
    """The least time the card could take: q, k, v read once and o written
    once at the memory rate, or the two products at the type's peak."""
    b, t, h, d = shape
    elem = torch.empty((), dtype=dtype).element_size()
    bytes_moved = 4 * b * t * h * d * elem
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 4 * b * h * d * pairs  # q k^T and p v, 2 flops per multiply-add
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# The kernel's edges, checked for correctness only, causal and not:
# (shape [B, T, H, D], dtype, atol = rtol, layout of q, k, v). The
# tolerances are the timed shapes' bands for each type.
EDGE_CASES = (
    ((2, 1, 3, 32), torch.float32, 2e-5, "contiguous"),
    ((2, 17, 3, 32), torch.float32, 2e-5, "contiguous"),
    ((2, 77, 3, 32), torch.float32, 2e-5, "contiguous"),
    ((2, 77, 3, 32), torch.float32, 2e-5, "k_strided"),
    ((2, 77, 3, 32), torch.float32, 2e-5, "k_dim_strided"),
    ((2, 77, 3, 32), torch.float32, 2e-5, "packed_qkv"),
    ((2, 77, 3, 32), torch.float32, 2e-5, "packed_qkv_misaligned"),
    ((1, 200, 2, 64), torch.bfloat16, 2e-2, "k_strided"),
    ((2, 130, 2, 128), torch.float16, 2e-3, "contiguous"),
    ((2, 130, 2, 128), torch.float16, 2e-3, "packed_qkv_misaligned"),
    # the tensor-core body: T that fills no tile, T past one and two tiles,
    # and the scalar load path (a head dim with a stride, rows off 16 bytes)
    ((2, 80, 3, 32), torch.bfloat16, 2e-2, "contiguous"),
    ((1, 200, 2, 32), torch.bfloat16, 2e-2, "contiguous"),
    ((2, 1, 3, 64), torch.float16, 2e-3, "contiguous"),
    ((2, 77, 3, 64), torch.float16, 2e-3, "contiguous"),
    ((1, 300, 2, 128), torch.bfloat16, 2e-2, "contiguous"),
    ((2, 77, 3, 64), torch.bfloat16, 2e-2, "k_dim_strided"),
    ((2, 77, 3, 64), torch.bfloat16, 2e-2, "packed_qkv_misaligned"),
)


def edge_inputs(shape, dtype, layout, seed=0, device="cuda"):
    """q, k, v of ``shape`` in one of EDGE_CASES' layouts:

    - ``contiguous``: three [B, T, H, D] tensors;
    - ``k_strided``: k stored as [B, H, T, D] and viewed as [B, T, H, D];
    - ``k_dim_strided``: k stored as [B, T, D, H], so its head dim is not
      contiguous;
    - ``packed_qkv``: slices of one [B, T, 3, H, D] tensor, as a fused QKV
      projection gives them;
    - ``packed_qkv_misaligned``: the same, one element into its storage, so
      no row starts on a 16-byte boundary.
    """
    b, t, h, d = shape
    gen = torch.Generator().manual_seed(seed)

    def rand(*dims):
        return torch.randn(dims, generator=gen).to(device, dtype)

    if layout.startswith("packed_qkv"):
        off = int(layout == "packed_qkv_misaligned")
        packed = rand(b, t, 3 * h * d + off)[..., off:]
        return packed.reshape(b, t, 3, h, d).unbind(2)
    q, k, v = rand(*shape), rand(*shape), rand(*shape)
    if layout == "k_strided":
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
    elif layout == "k_dim_strided":
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    elif layout != "contiguous":
        raise ValueError(f"unknown layout {layout!r}")
    return q, k, v


def check_kernel(q, k, v, causal, atol, rtol) -> float:
    """The kernel against its plain version in float32 from the same
    inputs; returns the largest absolute error and raises outside the
    band."""
    from fedml_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if got.shape != q.shape or got.dtype != q.dtype:
        raise RuntimeError(f"kernel output {got.shape} {got.dtype} for "
                           f"input {q.shape} {q.dtype}")
    want = flash_attention_reference(q.float(), k.float(), v.float(), causal)
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)
    return (got.float() - want).abs().max().item()


def edge_checks():
    for shape, dtype, atol, layout in EDGE_CASES:
        q, k, v = edge_inputs(shape, dtype, layout)
        for causal in (False, True):
            err = check_kernel(q, k, v, causal, atol, atol)
            print(json.dumps({"flash_attention_edge": {
                "shape": list(shape),
                "dtype": str(dtype).replace("torch.", ""), "layout": layout,
                "causal": causal, "max_abs_err": err, "atol": atol}}),
                flush=True)


def kernel_vs_plain(shape, dtype, causal, atol, rtol, seed,
                    time_plain: bool = True, plain_reps: int = 5,
                    plain_inner: int = 2):
    from fedml_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen).to("cuda", dtype)
               for _ in range(3))
    err = check_kernel(q, k, v, causal, atol, rtol)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bound, bound_by = attention_bound(shape, dtype, causal)
    ms = median_ms(lambda: flash_attention(q, k, v, causal=causal))
    library_ms = median_ms(lambda: sdpa(qt, kt, vt, is_causal=causal))
    row = {
        "shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
        "causal": causal, "max_abs_err": err, "ms": ms,
        "plain_ms": median_ms(
            lambda: flash_attention_reference(q, k, v, causal),
            reps=plain_reps, inner=plain_inner) if time_plain else None,
        "library_ms": library_ms, "library_ratio": ms / library_ms,
        "bound_ms": bound, "bound_by": bound_by,
    }
    print(json.dumps({"flash_attention_check": row}), flush=True)
    return row


def environment() -> str:
    """Phase 1: prints the card, the versions and the TF32 setting;
    returns the card's name and power limit."""
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for float32 matmul and cuDNN", flush=True)
    return card


def build_kernels():
    """Phase 2: builds every kernel, prints ptxas's report and checks the
    flash library's SASS."""
    from fedml_tpu_torch.ops import build

    t0 = time.perf_counter()
    reports = build.build_all()
    print(f"built {sorted(reports)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, report in reports.items():
        lines = [ln for ln in report.splitlines() if "ptxas info" in ln
                 or "spill" in ln]
        print(f"{name} ptxas:\n" + "\n".join(lines), flush=True)
    check_sass(build)


# a flash kernel's mangled name: body, element type, head dim
_KERNEL_NAME = re.compile(
    r"(flash_fwd_(?:mma_)?kernel)I(f|13__nv_bfloat16|6__half)Li(\d+)E")
_TYPE_NAMES = {"f": "float", "13__nv_bfloat16": "bf16", "6__half": "fp16"}


def check_sass(build):
    """Counts the tensor-core instructions (HMMA) of each flash kernel
    instance in the built library; raises unless every bf16 and fp16
    instance is flash_fwd_mma_kernel with HMMA in it and flash_fwd_kernel
    is instantiated for float32 alone."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run(
        [tool, "-sass", str(build._target("flash_attention"))],
        capture_output=True, text=True, timeout=120, check=True).stdout
    hmma, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            found = _KERNEL_NAME.search(line)
            current = (f"{found[1]}<{_TYPE_NAMES[found[2]]}, {found[3]}>"
                       if found else None)
            if current:
                hmma[current] = 0
        elif current and "HMMA" in line:
            hmma[current] += 1
    print(json.dumps({"flash_attention_sass_hmma": hmma}), flush=True)
    want = {f"flash_fwd_kernel<float, {d}>" for d in (32, 64, 128)} | {
        f"flash_fwd_mma_kernel<{t}, {d}>" for t in ("bf16", "fp16")
        for d in (32, 64, 128)}
    if set(hmma) != want:
        raise RuntimeError(f"flash kernel instances {sorted(hmma)}, "
                           f"expected {sorted(want)}")
    idle = [k for k, n in hmma.items() if "mma" in k and n == 0]
    if idle:
        raise RuntimeError(f"no HMMA instruction in {idle}")


def kernel_checks(time_plain: bool = True) -> list[dict]:
    """Phase 3: the edges, then the timed shapes; returns the timed rows.
    The rows added for the tensor-core kernel time the plain version with
    3 single calls, to keep the phase short."""
    edge_checks()
    rows = []
    for causal in (False, True):
        rows.append(kernel_vs_plain(MAIN_SHAPE, torch.float32, causal,
                                    2e-5, 2e-5, seed=0,
                                    time_plain=time_plain))
        rows.append(kernel_vs_plain(LONG_SHAPE, torch.bfloat16, causal,
                                    2e-2, 0.0, seed=1,
                                    time_plain=time_plain))
    for shape, dtype, atol, rtol in (
            (LONG_SHAPE, torch.float16, 2e-3, 2e-3),
            (WIDE_SHAPE, torch.bfloat16, 2e-2, 0.0),
            (MAIN_SHAPE, torch.bfloat16, 2e-2, 0.0)):
        for causal in (False, True):
            rows.append(kernel_vs_plain(shape, dtype, causal, atol, rtol,
                                        seed=2, time_plain=time_plain,
                                        plain_reps=3, plain_inner=1))
    return rows


def smoke_config():
    """transformer_lm at create_model's widths on fake_shakespeare: 20
    clients, 10 a round, batch 32, SGD, 3 rounds, eval every round."""
    from fedml_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        FedConfig,
        ModelConfig,
        TrainConfig,
    )

    return ExperimentConfig(
        data=DataConfig(dataset="fake_shakespeare", num_clients=20,
                        batch_size=32),
        model=ModelConfig(name="transformer_lm", num_classes=90,
                          input_shape=(80,)),
        train=TrainConfig(optimizer="sgd", lr=0.5, epochs=1),
        fed=FedConfig(num_rounds=3, clients_per_round=10, eval_every=1),
        seed=0,
    )


def flash_twin(model):
    """The same architecture as ``model`` with flash attention, for
    evaluating ``model``'s weights through the kernel."""
    from fedml_tpu_torch.models.base import FedModel, weightless
    from fedml_tpu_torch.models.transformer import TransformerLM
    from fedml_tpu_torch.ops.flash_attention import flash_attention

    lm = model.module
    return FedModel(
        weightless(lambda: TransformerLM(
            lm.vocab_size, lm.num_layers, lm.num_heads, lm.embed_dim,
            lm.max_len, attn_fn=flash_attention)),
        model.input_shape, model.device, model.input_dtype)


def main_path(device: str = "cuda"):
    """FedAvg rounds of transformer_lm on fake_shakespeare, then the
    global model evaluated with full and with flash attention."""
    from fedml_tpu_torch.algorithms.base import build_evaluator
    from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
    from fedml_tpu_torch.data import load_dataset
    from fedml_tpu_torch.metrics import MetricsSink
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops.flash_attention import flash_attention

    cfg = smoke_config()
    model = create_model(cfg.model, device)
    sim = FedAvgSim(model, load_dataset(cfg.data), cfg, device)
    init_eval = sim.evaluate_global(sim.init())

    flash_attention.launches = 0
    flash_attention.mma_launches = 0
    t0 = time.perf_counter()
    sink = MetricsSink()
    state = sim.run(metrics_sink=sink)
    torch.cuda.synchronize()
    t_rounds = time.perf_counter() - t0
    cohort = cohort_report(sim)
    flash_model = flash_twin(model)
    t1 = time.perf_counter()
    flash_eval = build_evaluator(flash_model, sim.task)(
        state.variables, sim.arrays.test_x, sim.arrays.test_y)
    flash_eval = {k: float(v) for k, v in flash_eval.items()}
    t_flash_eval = time.perf_counter() - t1
    launches = flash_attention.launches - flash_attention.mma_launches
    mma_launches = flash_attention.mma_launches

    t2 = time.perf_counter()
    full_eval = sim.evaluate_global(state)
    t_full_eval = time.perf_counter() - t2
    for rec in sink.history:
        print(json.dumps({"round": {k: v for k, v in rec.items()
                                    if not k.startswith("_")}}), flush=True)
    print(json.dumps({"main_path": {
        "rounds": cfg.fed.num_rounds, "seconds_rounds_with_eval": t_rounds,
        "init_test_loss": init_eval["loss"], "full_eval": full_eval,
        "flash_eval": flash_eval, "seconds_flash_eval": t_flash_eval,
        "seconds_full_eval": t_full_eval, "flash_launches": launches,
        "flash_mma_launches": mma_launches, "cohort": cohort,
    }}), flush=True)

    losses = [rec["train_loss"] for rec in sink.history]
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"non-finite train loss: {losses}")
    if not sink.history[-1]["test_loss"] < init_eval["loss"]:
        raise RuntimeError(
            f"test loss did not fall: {init_eval['loss']} -> "
            f"{sink.history[-1]['test_loss']}")
    if launches <= 0:
        raise RuntimeError("the main path never launched the flash kernel")
    if mma_launches != 0:
        raise RuntimeError(f"the float32 main path launched the 16-bit "
                           f"kernel {mma_launches} times")
    if abs(flash_eval["loss"] - full_eval["loss"]) > 1e-4 * abs(
            full_eval["loss"]):
        raise RuntimeError(f"flash eval {flash_eval} != full {full_eval}")
    if abs(flash_eval["acc"] - full_eval["acc"]) > 1e-4:
        raise RuntimeError(f"flash eval {flash_eval} != full {full_eval}")
    return launches, mma_launches


def cohort_report(sim, replays_before: int = 0) -> dict:
    """The batched cohort of ``sim``'s last round (clients and steps per
    epoch of each group) and its CUDA graph's replays since
    ``replays_before``; raises unless the rounds ran as graph replays."""
    graph = sim.cohort_update.graph
    report = {"groups": [{"clients": n, "steps_per_epoch": s}
                         for n, s in sim.last_groups],
              "graph_replays": graph.replays - replays_before,
              "group_steps_last_round": sim.cfg.train.epochs * sum(
                  s for _, s in sim.last_groups)}
    print(json.dumps({"cohort": report}), flush=True)
    if graph.graph is None or report["graph_replays"] <= 0:
        raise RuntimeError(f"the cohort did not run as CUDA graph replays: "
                           f"{report}")
    return report


def resnet_config():
    """bench.py's headline configuration (build_sim), cut to 3 rounds with
    an evaluation after each."""
    from fedml_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        FedConfig,
        ModelConfig,
        TrainConfig,
    )

    return ExperimentConfig(
        data=DataConfig(dataset="fake_cifar10", num_clients=100,
                        partition_method="hetero", partition_alpha=0.5,
                        batch_size=32, seed=0),
        model=ModelConfig(name="resnet56", num_classes=10,
                          input_shape=(32, 32, 3)),
        train=TrainConfig(lr=0.03, epochs=1, compute_dtype="bfloat16",
                          scan_unroll=64, cohort_groups=5),
        fed=FedConfig(num_rounds=3, clients_per_round=10, eval_every=1),
        seed=0,
    )


class UpdateRig:
    """Float32 local updates of ``cfg``'s model on the card and on the
    CPU (TF32 off), from start variables the caller gives, each client in
    the batch order round 0 drew for it: on the card through the batched
    cohort (the client's size-sorted group of round 0, one CUDA graph
    replay per step), on the CPU one client at a time."""

    def __init__(self, cfg, data):
        import dataclasses

        import numpy as np

        from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
        from fedml_tpu_torch.algorithms.stack_utils import (
            resolve_cohort_groups,
        )
        from fedml_tpu_torch.models import create_model

        f32 = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, compute_dtype="float32"))
        self.sims = {dev: FedAvgSim(create_model(f32.model, dev), data, f32,
                                    dev) for dev in ("cuda", "cpu")}
        self.stat_names = set(self.sims["cpu"].model.stat_names)
        self.batch_size = f32.data.batch_size
        self.epochs = f32.train.epochs
        self.counts = self.sims["cpu"].arrays.counts
        self.cohort = self.sims["cuda"].sampler(
            0, len(self.counts), f32.fed.clients_per_round).tolist()
        # the round's groups: the cohort sorted by size, descending
        order = np.argsort(-self.counts[self.cohort].numpy(), kind="stable")
        sub = len(self.cohort) // resolve_cohort_groups(
            f32.train.cohort_groups, len(self.cohort))
        ranked = [self.cohort[i] for i in order]
        self.groups = [ranked[i:i + sub] for i in range(0, len(ranked), sub)]

    def steps(self, c: int) -> int:
        return -(-int(self.counts[c]) // self.batch_size) * self.epochs

    def update(self, dev, start, c, first_step_only=False) -> dict:
        """Client ``c``'s local update on ``dev`` from ``start``, all its
        real steps or only its first one; the result on the CPU. On the
        card ``c``'s whole group runs, as many steps as its largest
        client (gated no-op steps for the others)."""
        cpu = self.sims["cpu"].arrays
        lanes = next(g for g in self.groups if c in g) if dev == "cuda" \
            else [c]
        orders = torch.stack([torch.stack(list(
            self.sims["cpu"].batch_orders(0, i))[:self.epochs])
            for i in lanes]).long()
        mask = cpu.mask[lanes]
        steps = max(self.steps(i) for i in lanes) // self.epochs
        if first_step_only:  # only the first batch's rows are real
            first = orders[:, 0, :self.batch_size]
            mask = torch.zeros_like(mask).scatter(1, first,
                                                  mask.gather(1, first))
            orders, steps = orders[:, :1], 1
        sim = self.sims[dev]
        start = {k: v.to(dev) for k, v in start.items()}
        if dev == "cuda":
            out, _, _ = sim.cohort_update(
                start, cpu.idx[lanes].to(dev), mask.to(dev), sim.arrays.x,
                sim.arrays.y, orders.to(dev), steps)
            out = {k: v[lanes.index(c)] for k, v in out.items()}
        else:
            out, _, _ = sim.local_update(start, cpu.idx[c], mask[0], cpu.x,
                                         cpu.y, list(orders[0]), steps=steps)
        return {k: v.cpu() for k, v in out.items()}

    def perturbed(self, variables) -> dict:
        """``variables`` with every parameter scaled by 1 + PERTURB x a
        standard normal draw (about one float32 rounding), seeded."""
        gen = torch.Generator().manual_seed(0)
        return {k: v if k in self.stat_names else v.cpu() * (
            1 + PERTURB * torch.randn(v.shape, generator=gen))
            for k, v in variables.items()}

    def max_err(self, x, y) -> dict:
        err = {"params": 0.0, "stats": 0.0}
        for k in x:
            kind = "stats" if k in self.stat_names else "params"
            err[kind] = max(err[kind], (x[k] - y[k]).abs().max().item())
        return err


def resnet_cpu_parity(cfg, data, variables) -> dict:
    """Float32 local updates of ResNet-56 from the same ``variables`` for
    the largest client of round 0's cohort, on the card in its group
    through the batched, graphed cohort and on the CPU alone: its first
    step alone must agree within RESNET_PARITY, and all its real steps
    within SPREAD_FACTOR times the CPU's own spread under a PERTURB
    relative change of the starting parameters. Raises otherwise."""
    rig = UpdateRig(cfg, data)
    c = rig.groups[0][0]
    t0 = time.perf_counter()
    got, want = (rig.update(dev, variables, c, first_step_only=True)
                 for dev in ("cuda", "cpu"))
    for k in want:
        torch.testing.assert_close(got[k], want[k], **RESNET_PARITY)
    report = {"client": c, "samples": int(rig.counts[c]),
              "card_group": rig.groups[0], "first_step": {
                  "card_vs_cpu": rig.max_err(got, want), **RESNET_PARITY}}
    got, want = rig.update("cuda", variables, c), rig.update("cpu",
                                                             variables, c)
    row = {"steps": rig.steps(c), "card_vs_cpu": rig.max_err(got, want),
           "cpu_vs_perturbed_cpu": rig.max_err(
               want, rig.update("cpu", rig.perturbed(variables), c)),
           "spread_factor": SPREAD_FACTOR}
    for kind, err in row["card_vs_cpu"].items():
        if err > SPREAD_FACTOR * row["cpu_vs_perturbed_cpu"][kind]:
            raise RuntimeError(f"card vs CPU {kind} error {err} is past "
                               f"{SPREAD_FACTOR}x the CPU's spread: {row}")
    report["all_steps"] = row
    report["seconds"] = time.perf_counter() - t0
    return report


def resnet_main_path(card: str) -> int:
    """Phase 6: FedAvg rounds of ResNet-56 at the headline configuration,
    then the card-vs-CPU parity of one local update. Returns the flash
    kernels' launches in this phase (0: the path has no attention)."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
    from fedml_tpu_torch.data import load_dataset
    from fedml_tpu_torch.metrics import MetricsSink
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops.flash_attention import flash_attention

    cfg = resnet_config()
    data = load_dataset(cfg.data)
    sim = FedAvgSim(create_model(cfg.model), data, cfg)
    init_state = sim.init()
    init_eval = sim.evaluate_global(init_state)

    flash_attention.launches = 0
    flash_attention.mma_launches = 0
    t0 = time.perf_counter()
    sink = MetricsSink()
    state = sim.run(metrics_sink=sink)
    torch.cuda.synchronize()
    t_rounds = time.perf_counter() - t0
    cohort = cohort_report(sim)
    # one more round with every host sync an error: the round reads
    # nothing back from the device, and its graph replays one per step
    before = sim.cohort_update.graph.replays
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, synced = sim.run_round(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    synced = {"train_loss": float(synced["train_loss"]),
              "cohort": cohort_report(sim, before)}
    if synced["cohort"]["graph_replays"] != synced["cohort"][
            "group_steps_last_round"]:
        raise RuntimeError(f"replays are not one per group-step: {synced}")
    launches = flash_attention.launches

    rounds = [{k: v for k, v in rec.items() if not k.startswith("_")}
              for rec in sink.history]
    losses = [r[k] for r in rounds for k in ("train_loss", "test_loss")]
    losses.append(synced["train_loss"])
    not_f32 = sorted(k for k, v in state.variables.items()
                     if v.dtype != torch.float32)
    parity = resnet_cpu_parity(cfg, data, init_state.variables)
    print(json.dumps({"resnet56_main_path": {
        "rounds": cfg.fed.num_rounds, "seconds_rounds_with_eval": t_rounds,
        "init_test_loss": init_eval["loss"], "init_test_acc": init_eval["acc"],
        "per_round": rounds, "flash_launches": launches, "cohort": cohort,
        "round_under_sync_debug_error": synced,
        "cpu_parity_float32": parity, "card": card,
    }}), flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"non-finite loss: {rounds}")
    if not_f32:
        raise RuntimeError(f"variables not float32: {not_f32}")
    if not rounds[-1]["test_loss"] < init_eval["loss"]:
        raise RuntimeError(f"test loss did not fall: {init_eval['loss']} -> "
                           f"{rounds[-1]['test_loss']}")
    if launches != 0:
        raise RuntimeError(f"the ResNet-56 path launched flash attention "
                           f"{launches} times")
    return launches


def kernel_entry(name, source, launches, resnet_launches, rows, row,
                 note=None) -> dict:
    """One entry of the "kernels" line: the timed ``row``'s numbers, the
    largest error over ``rows``, and the launches on each main path
    (``launches``: the transformer's)."""
    entry = {
        "name": name, "route": "cuda", "source": source,
        "replaces": "fedml_tpu/ops/flash_attention.py:119",
        "launches": launches,
        "launches_by_path": {"transformer_lm": launches,
                             "resnet56": resnet_launches},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "library_ratio", "shape",
                               "dtype", "causal")},
    }
    if note:
        entry["note"] = note
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA card",
              file=sys.stderr)
        return 1
    card = environment()
    build_kernels()
    rows = kernel_checks()

    # 4-5. the transformer path, and the kernels' launches on it
    launches, mma_launches = main_path()
    # 6. the ResNet-56 path (no hand-written kernel on it)
    resnet_launches = resnet_main_path(card)

    # 7. report: the float32 entry's times are at the transformer path's
    # shape, the tensor-core entry's at long context in bf16
    source = "fedml_tpu_torch/csrc/flash_attention.cu"
    f32 = [r for r in rows if r["dtype"] == "float32"]
    half = [r for r in rows if r["dtype"] != "float32"]
    print(json.dumps({"kernels": [
        kernel_entry("flash_attention", source, launches, resnet_launches,
                     f32, next(r for r in f32 if r["causal"]
                               and r["shape"] == list(MAIN_SHAPE))),
        kernel_entry(
            "flash_attention_mma", source, mma_launches, resnet_launches,
            half, next(
                r for r in half if r["causal"] and r["dtype"] == "bfloat16"
                and r["shape"] == list(LONG_SHAPE)),
            note="bf16/fp16 only: the transformer path evaluates in "
                 "float32 and the ResNet-56 path has no attention, so "
                 "neither launches this kernel"),
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
