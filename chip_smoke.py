#!/usr/bin/env python3
"""Drives the PyTorch port (fedml_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure is an uncaught exception and a non-zero exit:

1. Environment: the card's name and power limit, torch and CUDA versions;
   TF32 is switched off for float32 matrix products and convolutions.
2. Build: every CUDA kernel of the port, from fedml_tpu_torch/csrc, for
   sm_90a (one nvcc per source, all started together).
3. Kernel vs plain: the flash-attention kernel against its plain PyTorch
   version, causal and not. First, for correctness only, at its edges
   (EDGE_CASES): T of 1, 17 and 77, T past one block (130, 200), D of 32
   (float32), 64 (bfloat16) and 128 (float16), a strided k, a k whose head
   dim is not contiguous, and q, k, v sliced from one packed QKV tensor,
   aligned and not. Then, timed, at the transformer FedAvg path's shape
   ([256, 80, 4, 32] float32, atol = rtol = 2e-5) and at a long-context
   shape ([4, 2048, 8, 64] bfloat16, atol 2e-2 against the plain version in
   float32 from the same inputs), with median CUDA-event times of the
   kernel, the plain version and torch's scaled_dot_product_attention (a
   yardstick only; the port never calls it), their ratio, and the kernel's
   bound. scripts/time_torch_flash.py runs phases 1-3 alone.
4. Main path: FedAvgSim over transformer_lm at create_model's widths on
   fake_shakespeare (20 clients, 10 a round, batch 32, SGD, 3 rounds);
   every train loss must be finite and the last test loss below the
   initial model's.
5. The kernel on the main path: the final global model is evaluated with
   build_evaluator twice, with full attention and with flash attention on
   the same weights; the losses must agree within 1e-4 relative and the
   accuracies within 1e-4, and the kernel's launch count over phases 4-5
   must be above 0.
6. A "kernels" JSON line, the card's name and power limit, and last the
   result line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
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
                    time_plain: bool = True):
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
            lambda: flash_attention_reference(q, k, v, causal), reps=5,
            inner=2) if time_plain else None,
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
    """Phase 2: builds every kernel and prints ptxas's report."""
    from fedml_tpu_torch.ops import build

    t0 = time.perf_counter()
    reports = build.build_all()
    print(f"built {sorted(reports)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, report in reports.items():
        lines = [ln for ln in report.splitlines() if "ptxas info" in ln
                 or "spill" in ln]
        print(f"{name} ptxas:\n" + "\n".join(lines), flush=True)


def kernel_checks(time_plain: bool = True) -> list[dict]:
    """Phase 3: the edges, then the timed shapes; returns the timed rows."""
    edge_checks()
    rows = []
    for causal in (False, True):
        rows.append(kernel_vs_plain(MAIN_SHAPE, torch.float32, causal,
                                    2e-5, 2e-5, seed=0,
                                    time_plain=time_plain))
        rows.append(kernel_vs_plain(LONG_SHAPE, torch.bfloat16, causal,
                                    2e-2, 0.0, seed=1,
                                    time_plain=time_plain))
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
    t0 = time.perf_counter()
    sink = MetricsSink()
    state = sim.run(metrics_sink=sink)
    torch.cuda.synchronize()
    t_rounds = time.perf_counter() - t0
    flash_model = flash_twin(model)
    t1 = time.perf_counter()
    flash_eval = build_evaluator(flash_model, sim.task)(
        state.variables, sim.arrays.test_x, sim.arrays.test_y)
    flash_eval = {k: float(v) for k, v in flash_eval.items()}
    t_flash_eval = time.perf_counter() - t1
    launches = flash_attention.launches

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
    if abs(flash_eval["loss"] - full_eval["loss"]) > 1e-4 * abs(
            full_eval["loss"]):
        raise RuntimeError(f"flash eval {flash_eval} != full {full_eval}")
    if abs(flash_eval["acc"] - full_eval["acc"]) > 1e-4:
        raise RuntimeError(f"flash eval {flash_eval} != full {full_eval}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA card",
              file=sys.stderr)
        return 1
    card = environment()
    build_kernels()
    rows = kernel_checks()

    # 4-5. the main path, and the kernel's launches on it
    launches = main_path()

    # 6. report: the entry's times are at the main path's own shape
    main_row = next(r for r in rows if r["causal"]
                    and r["shape"] == list(MAIN_SHAPE))
    entry = {
        "name": "flash_attention", "route": "cuda",
        "source": "fedml_tpu_torch/csrc/flash_attention.cu",
        "replaces": "fedml_tpu/ops/flash_attention.py:119",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r["dtype"] == "float32"),
        **{k: main_row[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms",
                                    "library_ratio", "shape", "dtype",
                                    "causal")},
    }
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
