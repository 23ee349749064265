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
   edges (EDGE_CASES): T of 1, 17, 20, 77 and 80, T past one block (130,
   200, 300), D of 16 and 32 (float32), 16, 32, 64 and 128 (bfloat16) and
   16, 64 and 128 (float16), a strided k, a k whose head dim is not
   contiguous, and q, k, v sliced from one packed QKV tensor, aligned and
   not. Then, timed, at the transformer FedAvg path's shape ([256, 80, 4,
   32] float32, atol = rtol = 2e-5, and bfloat16), at the LoRA path's
   ([256, 20, 4, 16] float32, causal) and at long context ([4, 2048, 8,
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
7. The reference bench's FedAvg families (bench.py FAMILY_SPECS, copied
   here as FAMILY_SPECS): mnist_lr, femnist_cnn, cifar_mobilenet,
   fedopt_resnet18gn (server adam), shakespeare_lstm and
   stackoverflow_lstm, each at its published shape (clients, cohort,
   batch, widths) with bf16 compute on the graphed, batched cohort. Each
   runs 2 FedAvgSim rounds and prints a "family" line: its clients, the
   group steps and graph replays of round 2, the test loss at init and
   after round 2, and round 2's wall time (host clock ending in a
   synchronize; one sample, a smoke figure). Losses must be finite and
   the variables float32, the cohort must run as graph replays, and the
   flash counters, set to 0 before each family, must read 0 after it.
   Then the first local step of round 1's largest client, in float32
   with TF32 off, through its graphed group on the card and alone on the
   CPU, must agree within the family's band (FAMILY_PARITY).
8. The defended, attacked and compressed round at phase 6's
   configuration (DEFENDED), 30 of the 100 clients seeded adversaries
   (about 3 a cohort): (a) krum (f = 3) against sign_flip, (b) median
   against gauss, (c) multikrum (f = 3) against collude, (d)
   trimmed_mean with norm clipping and noise against scale_boost, (e)
   fltrust against constant, (f) topk_int8 compression with error
   feedback under krum against sign_flip. Each runs 2 rounds, sharing the
   card's copy of the data and the captured cohort graph, and prints a
   "defended_round" line: the adversaries in each cohort, the rule's
   excluded count, the train losses, round 2's wall time (host clock
   ending in a synchronize; one sample), the test loss after it, and for
   (f) the error-feedback residual's norm, the analytic wire ratio, a
   third round run under torch.cuda.set_sync_debug_mode("error") and the
   cost of top-k's stable sort against torch.topk. Every loss must be
   finite, and the flash counters, set to 0 before the phase, must read
   0 after it. On round 1's stacked client results of (a), each rule on
   the card and on the CPU in float64 (TF32 off): krum and multikrum
   select the same client and mask, the median agrees within 1e-6
   relative, the mean, trimmed mean and fltrust within 1e-5 of each
   leaf's largest value; the deterministic int8 and topk payloads of
   every client are equal bit for bit ("defended_card_vs_cpu"). Then
   bench.py's defense_overhead_records on the card: each rule's median
   CUDA-event time on a ResNet-56-sized stack of 10 and of 50 clients,
   printed as "defense_agg_overhead_ms_c10" and "_c50" lines.
9. The bulk engine and elastic buckets, at bench.py's bulk records'
   configurations, each record a JSON line with the card's name and power
   limit: (a) the headline streamed in blocks of 4 (10 clients, 3 blocks,
   the last partial), 2 rounds in bf16 with one graph capture for 4
   lanes, a third round profiled for its host launches a block, and the
   fold check (round-0 float32 client results folded block by block
   through fold_block_partials and server_update_from_partials against
   server_update, FOLD_BAND); (b) a bulk round with int8, the residual
   bank and the streamed median under set_sync_debug_mode("error"), the
   bank's gathers and scatters, and the time of a round's projection
   draw at ResNet-56's size; (c) fedavg_rounds_per_sec_10kc_mnist_lr
   (10,000 clients all sampled in 313 blocks of 32, the median of 3
   rounds after a warm-up); (d) peak_round_hbm_mb_c{64,256,1024}_b32_bulk
   (lr on synthetic_1_1) and ResNet-56's bulk peaks at cohorts 16, 32 and
   64 beside the stacked round's, each torch.cuda.max_memory_allocated
   over one round ("analytic": false), the bulk peaks at most
   BULK_MEM_LAW times apart; (e) peak_round_hbm_mb_c{1k,10k}_defended_
   compressed at a population of 10,000 under the same law, and
   defense_stream_overhead_ms; (f) elastic_compile_cache_hit_rate_c16
   over a seeded 24-round churn schedule: one capture, 23 hits. The flash
   counters, set to 0 before the phase, must read 0 after it.
10. The space-to-depth ResNets, fused blocks and the experiment
   harness, each record a JSON line with the card's name and power limit:
   (a) resnet56_s2d at phase 6's configuration, bf16, 3 rounds (finite
   losses, the test loss below the initial model's, the cohort as graph
   replays, one more round under set_sync_debug_mode("error")); (b)
   resnet56_s2d_exact in float32 (TF32 off), its weights converted from a
   resnet56 initialisation: eval logits within atol = rtol = 1e-4 of the
   standard model's, train-mode logits within 2e-4 and batch statistics
   within 1e-5, one local step within RESNET_PARITY on every variable the
   converter carries and every statistic; (c) the headline resnet56, 16
   rounds in blocks of 8 (fuse_rounds, evaluation every 8) against the
   per-round loop from the same initialisation: equal bit for bit, or
   within SPREAD_FACTOR times the spread of two per-round runs, in which
   case the pair runs again with cuDNN's deterministic algorithms and must
   be bit for bit equal, and the convolution kernels only the default
   algorithms run are printed; a whole block and its push under
   set_sync_debug_mode("error"), the flush its one sync; rounds/s of the
   per-round loop and of fused blocks in turns for resnet56, resnet56_s2d
   and mnist_lr (fedavg_rounds_per_sec_100c_cifar10_{resnet56,
   resnet56_s2d}[_fused], smoke figures) and the traced idle share of a
   mnist_lr block each way; (d) python -m fedml_tpu_torch.experiments.run
   on the card in child processes (lr, 400 clients, all sampled, 6
   rounds, a checkpoint every 2; and the same in blocks of 100 with int8
   and its residual bank), started with the phase and SIGKILLed once the
   checkpoint of round 3 exists (while (a) and (b) run, before (c)'s
   timed work), then run again: rounds 0-5 logged, the resumed rows
   stamped, the
   final checkpoint equal to an uninterrupted run's, bit for bit or within
   (c)'s spread. The flash counters, set to 0 before the phase, must read
   0 after it.
11. A "kernels" JSON line, printed after phase 14, with one entry per
   kernel instance the paths run (flash_attention, the float32 body at
   head dim 32; flash_attention_d16, its head-dim-16 instance; and
   flash_attention_mma, the bf16/fp16 body), each with its launches on
   the transformer path, on the LoRA path, on the ResNet-56 path, on each
   family, in the defended rounds, in the bulk phase, in phase 10 and on
   the FedGDKD path and on the rest of the GAN family (none of them but
   the transformer and LoRA paths runs a hand-written kernel), the card's
   name and power limit, and last the result line
   {"ok": true, "device": {...}}.
12. Federated LoRA fine-tuning at the shape of bench.py's --lora-bench
   stage (synthetic_stackoverflow_nwp, 64 clients, vocab 2000 + 4;
   transformer_lm embed 64, 4 heads of 16, 2 layers; 16 clients a round,
   batch 16, SGD lr 0.3; rank 8, alpha 16 on q_proj and v_proj; float32),
   each record a JSON line with the card's name and power limit: (a) 3
   rounds: finite losses, the test loss below the initial model's, the
   cohort as graph replays, every frozen leaf of the server state equal
   to its init bit for bit, the graph's carry and the server's momentum
   over the trainable names only; the global model evaluated with full
   and with flash attention (loss within 1e-4 relative, accuracy within
   1e-4; float32 launches above 0, 16-bit 0); one more round under
   set_sync_debug_mode("error"); (b) 3 personalized rounds: the server's
   adapters and the bank rows of clients never sampled bit for bit as
   they were, and one client's own model (personal_variables) evaluated
   through the flash kernel against full attention in the same bands;
   (c) torch.cuda.max_memory_allocated over a LoRA round and over a full
   fine-tuning round at the same shape: the LoRA peak must be the lower;
   (d) bench.py's records under its names: wire_mb_per_round_16c_
   transformer_{full,lora} and lora_wire_reduction_x (analytic),
   fedavg_rounds_per_sec_64c_stackoverflow_transformer_lora (the median
   of 6 rounds after a warm-up; a smoke figure) and
   rounds_to_match_full_transformer_lora (16 full rounds, then at most
   48 LoRA rounds). The flash counters, set to 0 before (c) and (d), must
   read 0 after them.
13. FedGDKD at bench.py's --fedgdkd configuration (cnn_medium and the
   conditional generator at GanConfig's defaults on fake_mnist, 10
   clients, hetero 0.1, all sampled, batch 32, SGD lr 0.03, 5 epochs,
   cohort_groups 5, float32), each record a JSON line with the card's name
   and power limit: (a) 3 rounds (finite g_loss, d_loss and kd_loss; the
   groups, their steps and the adversarial and distillation graphs'
   replays), one more round under set_sync_debug_mode("error") (one
   replay per group-step and per distillation step), every client's
   accuracy in [0, 1], and fedgdkd_rounds_per_sec_10c_mnist_cnn_medium
   over 6 more rounds (a smoke figure); (b) the --fedgdkd-scale stage (50
   clients, 25 a round, 30,000 samples), 3 rounds: the drift-corrected
   new joiners counted, the classifiers of the clients a round did not
   sample equal to their previous values bit for bit, and
   fedgdkd_rounds_per_sec_50c_sampled25_mnist_cnn_medium; (c) two rounds
   at the CPU parity test's tiny configuration on the card and on the CPU
   from the same variables and draws (TF32 off, cuDNN deterministic):
   every leaf within atol 1e-5, rtol 1e-4, or else the first step within
   1e-3 and the rounds within SPREAD_FACTOR times the CPU's own spread;
   (d) the phase's seconds. The flash counters, set to 0 before the
   phase, must read 0 after it.
14. The rest of the GAN family, FedGAN, FedDTG, FedSSGAN and FedUAGAN,
   at phase 13's data configuration (fake_mnist, 6,000 samples, 10
   clients, hetero 0.1, all sampled, batch 32, SGD lr 0.03, 5 epochs,
   cohort_groups 5, float32; the generator at GanConfig's defaults, the
   ACGAN discriminator at its defaults (features 32/64/128, dropout 0.25;
   FedSSGAN's without the validity head), FedDTG's classifier
   cnn_medium), each record a JSON line with the card's name and power
   limit: (a) for each, 3 rounds (finite losses; the groups, their steps
   and each graph's replays), one more under set_sync_debug_mode("error")
   with one replay per group-step (and per distillation step for
   FedDTG), the clients' accuracies in [0, 1] (FedDTG), the image grid
   (FedGAN, FedUAGAN) or the confidence-filtered synthetic set
   (FedSSGAN), then <algo>_rounds_per_sec_10c_mnist_<disc> over 4 more
   rounds (a smoke figure); (b) torch.cuda.max_memory_allocated over a
   FedGAN round beside a FedGDKD round's
   (peak_round_hbm_mb_10c_mnist_fedgan): at most GAN_MASK_HEADROOM_MB
   more; (c) for each, two rounds at the CPU parity test's configuration
   (tests/test_torch_gan_family.py) on the card and on the CPU from the
   same variables, draws and dropout masks (TF32 off, cuDNN
   deterministic): every leaf within atol 1e-5, rtol 1e-4, or else a round
   of one step a client within 1e-3 and the rounds within SPREAD_FACTOR
   times the CPU's own spread; (d) the phase's seconds. The flash
   counters, set to 0 before the phase, must read 0 after it. The
   "kernels" line comes after it.
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
PEFT_SHAPE = (256, 20, 4, 16)  # the LoRA path: T 20, 4 heads of 16
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
    # head dim 16 (the LoRA transformer's): both bodies, one row group, a
    # ragged T, T past a tile, and the scalar load paths
    ((2, 20, 4, 16), torch.float32, 2e-5, "contiguous"),
    ((2, 1, 3, 16), torch.float32, 2e-5, "contiguous"),
    ((2, 77, 3, 16), torch.float32, 2e-5, "k_dim_strided"),
    ((1, 200, 2, 16), torch.float32, 2e-5, "packed_qkv_misaligned"),
    ((2, 20, 4, 16), torch.bfloat16, 2e-2, "contiguous"),
    ((1, 200, 2, 16), torch.bfloat16, 2e-2, "k_strided"),
    ((2, 77, 3, 16), torch.float16, 2e-3, "contiguous"),
    ((2, 77, 3, 16), torch.float16, 2e-3, "packed_qkv_misaligned"),
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


HEAD_DIMS = (16, 32, 64, 128)  # the flash kernels' instances
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
    want = {f"flash_fwd_kernel<float, {d}>" for d in HEAD_DIMS} | {
        f"flash_fwd_mma_kernel<{t}, {d}>" for t in ("bf16", "fp16")
        for d in HEAD_DIMS}
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
    rows.append(kernel_vs_plain(PEFT_SHAPE, torch.float32, True, 2e-5, 2e-5,
                                seed=3, time_plain=time_plain))
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
    """The same architecture as ``model`` (its LoRA projections included)
    with flash attention, for evaluating ``model``'s weights through the
    kernel."""
    from fedml_tpu_torch.models.base import FedModel, weightless
    from fedml_tpu_torch.models.transformer import TransformerLM
    from fedml_tpu_torch.ops.flash_attention import flash_attention

    lm = model.module
    return FedModel(
        weightless(lambda: TransformerLM(
            **{**lm.config(), "attn_fn": flash_attention})),
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


# bench.py's FAMILY_SPECS (the reference bench's config families, each
# one of the reference FedML benchmark's published shapes), without the
# bench's metric names and torch baselines
FAMILY_SPECS = {
    # 1000-client cross-device MNIST + LR
    "mnist_lr": dict(
        dataset="mnist", n_train=60000, num_clients=1000,
        model=("lr", 10, (28, 28, 1)), batch=10, lr=0.03, cpr=10),
    # FEMNIST + the FedAvg CNN, non-IID, 3400 clients
    "femnist_cnn": dict(
        dataset="femnist", n_train=170000, num_clients=3400,
        model=("cnn_fedavg", 62, (28, 28, 1)), batch=20, lr=0.1, cpr=10),
    # CIFAR-10 + MobileNet, cross-silo
    "cifar_mobilenet": dict(
        dataset="cifar10", n_train=6000, num_clients=100,
        model=("mobilenet", 10, (32, 32, 3)), batch=32, lr=0.03, cpr=10),
    # FedOpt (server adam) on ResNet-18-GN, fed_cifar100
    "fedopt_resnet18gn": dict(
        dataset="fed_cifar100", n_train=50000, num_clients=500,
        model=("resnet18_gn", 100, (32, 32, 3)), batch=20, lr=0.1, cpr=10,
        server_optimizer="adam", server_lr=1e-3),
    # Shakespeare next-char LSTM: 715 clients, batch 4, lr 1.0
    "shakespeare_lstm": dict(
        dataset="shakespeare", n_train=14300, num_clients=715,
        model=("rnn", 90, (80,)), batch=4, lr=1.0, cpr=10),
    # StackOverflow next-word LSTM(670), vocab 2000, 50 clients a round;
    # population 342,477 scaled to 3,424 (only the sampling changes)
    "stackoverflow_lstm": dict(
        dataset="stackoverflow_nwp", n_train=68480, num_clients=3424,
        model=("rnn_stackoverflow", 2000, (20,)), batch=16,
        lr=10 ** -0.5, cpr=50, model_extra=(("vocab_size", 2000),)),
}
# card vs CPU, the first float32 local step of each family's largest
# client (TF32 off): the convolution families at ResNet-56's band, the
# dense and LSTM families at a tighter one, about 100 times what an H100
# measured (at most 6e-8: only the order of the sums differs in their
# matmuls)
DENSE_PARITY = dict(atol=1e-5, rtol=1e-5)
FAMILY_PARITY = {
    "mnist_lr": DENSE_PARITY,
    "femnist_cnn": RESNET_PARITY,
    "cifar_mobilenet": RESNET_PARITY,
    "fedopt_resnet18gn": RESNET_PARITY,
    "shakespeare_lstm": DENSE_PARITY,
    "stackoverflow_lstm": DENSE_PARITY,
}


def family_setup(name: str):
    """(config, federated data) of one of FAMILY_SPECS, as bench.py's
    build_family_sim makes them: hetero LDA alpha 0.5, 1 epoch, bf16
    compute, the bench's procedural data at the family's sizes."""
    from fedml_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        FedConfig,
        ModelConfig,
        TrainConfig,
    )
    from fedml_tpu_torch.data import (
        make_fake_image_dataset,
        make_fake_text_dataset,
    )

    spec = FAMILY_SPECS[name]
    model, num_classes, shape = spec["model"]
    dcfg = DataConfig(dataset=spec["dataset"],
                      num_clients=spec["num_clients"],
                      partition_method="hetero", partition_alpha=0.5,
                      batch_size=spec["batch"], seed=0)
    cfg = ExperimentConfig(
        data=dcfg,
        model=ModelConfig(name=model, num_classes=num_classes,
                          input_shape=shape,
                          extra=spec.get("model_extra", ())),
        train=TrainConfig(lr=spec["lr"], epochs=1, compute_dtype="bfloat16",
                          scan_unroll=8),
        fed=FedConfig(num_rounds=2, clients_per_round=spec["cpr"],
                      eval_every=10 ** 9,
                      server_optimizer=spec.get("server_optimizer", "sgd"),
                      server_lr=spec.get("server_lr", 1.0)),
        seed=0)
    text = spec["dataset"] in ("shakespeare", "stackoverflow_nwp")
    n_test = max(500 if text else 1000, spec["n_train"] // 10)
    if spec["dataset"] == "shakespeare":
        data = make_fake_text_dataset(dcfg, n_train=spec["n_train"],
                                      n_test=n_test)
    elif spec["dataset"] == "stackoverflow_nwp":
        data = make_fake_text_dataset(dcfg, seq_len=20, vocab=2000,
                                      n_train=spec["n_train"], n_test=n_test)
    else:
        data = make_fake_image_dataset(spec["dataset"], dcfg,
                                       n_train=spec["n_train"], n_test=n_test)
    return cfg, data


def family_parity(name, cfg, data, variables) -> dict:
    """The first float32 local step of round 1's largest client, on the
    card through its graphed group and on the CPU alone, from the same
    ``variables``; raises outside FAMILY_PARITY."""
    rig = UpdateRig(cfg, data)
    c = rig.groups[0][0]
    got, want = (rig.update(dev, variables, c, first_step_only=True)
                 for dev in ("cuda", "cpu"))
    band = FAMILY_PARITY[name]
    for k in want:
        torch.testing.assert_close(got[k], want[k], **band)
    # the largest share of the band an element takes (1: at its edge)
    used = max(((got[k] - want[k]).abs()
                / (band["atol"] + band["rtol"] * want[k].abs())).max().item()
               for k in want)
    return {"client": c, "samples": int(rig.counts[c]),
            "card_group": rig.groups[0], "card_vs_cpu": rig.max_err(got, want),
            "band_used": used, **band}


def family_path(name: str, card: str) -> int:
    """Phase 7 for one family: 2 FedAvgSim rounds at its published shape,
    then the card-vs-CPU first step. Returns the flash kernels' launches
    in the rounds (0: no family has attention)."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops.flash_attention import flash_attention

    t_setup = time.perf_counter()
    cfg, data = family_setup(name)
    sim = FedAvgSim(create_model(cfg.model), data, cfg)
    init_state = sim.init()
    init_eval = sim.evaluate_global(init_state)
    t_setup = time.perf_counter() - t_setup

    flash_attention.launches = 0
    flash_attention.mma_launches = 0
    state, m1 = sim.run_round(init_state)  # captures the cohort's graph
    torch.cuda.synchronize()
    before = sim.cohort_update.graph.replays
    t0 = time.perf_counter()
    state, m2 = sim.run_round(state)
    torch.cuda.synchronize()
    t_round2 = time.perf_counter() - t0
    launches = flash_attention.launches
    cohort = cohort_report(sim, before)
    final = sim.evaluate_global(state)
    not_f32 = sorted(k for k, v in state.variables.items()
                     if v.dtype != torch.float32)
    losses = [float(m1["train_loss"]), float(m2["train_loss"]),
              init_eval["loss"], final["loss"]]
    parity = family_parity(name, cfg, data, init_state.variables)
    print(json.dumps({"family": {
        "name": name, "model": cfg.model.name,
        "clients": cfg.data.num_clients,
        "clients_per_round": cfg.fed.clients_per_round,
        "batch": cfg.data.batch_size,
        "server_optimizer": cfg.fed.server_optimizer,
        "parameters": sum(v.numel() for k, v in state.variables.items()
                          if k not in sim.model.stat_names),
        "group_steps_round2": cohort["group_steps_last_round"],
        "graph_replays_round2": cohort["graph_replays"],
        "groups_round2": cohort["groups"],
        "train_loss": losses[:2], "init_test_loss": init_eval["loss"],
        "test_loss_round2": final["loss"], "test_acc_round2": final["acc"],
        "round2_wall_s": t_round2, "setup_s": t_setup,
        "flash_launches": launches, "first_step_float32": parity,
        "card": card,
    }}), flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"{name}: non-finite loss {losses}")
    if not_f32:
        raise RuntimeError(f"{name}: variables not float32: {not_f32}")
    if cohort["graph_replays"] != cohort["group_steps_last_round"]:
        raise RuntimeError(f"{name}: replays are not one per group-step: "
                           f"{cohort}")
    if launches != 0:
        raise RuntimeError(f"{name} launched flash attention {launches} "
                           "times")
    del sim
    torch.cuda.empty_cache()
    return launches


# Phase 8: the defended, attacked and compressed round at the headline
# configuration, 30 of the 100 clients adversaries (about 3 a cohort):
# name -> (FedConfig settings, adversary mode)
DEFENDED = {
    "a_krum_sign_flip": (dict(robust_method="krum",
                              robust_num_adversaries=3), "sign_flip"),
    "b_median_gauss": (dict(robust_method="median"), "gauss"),
    "c_multikrum_collude": (dict(robust_method="multikrum",
                                 robust_num_adversaries=3), "collude"),
    "d_trimmed_mean_scale_boost": (dict(
        robust_method="trimmed_mean", robust_norm_clip=1.0,
        robust_noise_stddev=1e-4), "scale_boost"),
    "e_fltrust_constant": (dict(robust_method="fltrust"), "constant"),
    "f_krum_sign_flip_topk_int8": (dict(
        robust_method="krum", robust_num_adversaries=3,
        compress="topk_int8"), "sign_flip"),
}
ADVERSARIES = 30
# card vs CPU (float64, TF32 off) on round 1's stacked client results:
# the median within 1e-6 relative, the averaging rules within 1e-5 of
# the largest value of each leaf
MEDIAN_RTOL = 1e-6
MEAN_BAND = 1e-5
# bench.py defense_overhead_records' stack: ResNet-56's 0.86M parameters
OVERHEAD_SHAPES = {"w": (860, 1000), "b": (1210,)}


def defended_config(name: str):
    import dataclasses

    from fedml_tpu_torch.config import AdversaryPolicy

    fed_kw, mode = DEFENDED[name]
    cfg = resnet_config()
    return dataclasses.replace(
        cfg, fed=dataclasses.replace(cfg.fed, num_rounds=2, **fed_kw),
        adversary=AdversaryPolicy(mode=mode, num_adversaries=ADVERSARIES,
                                  seed=0))


def card_vs_cpu_aggregation(sim, state, stacked, n_k, cohort) -> dict:
    """Each rule, and the deterministic int8 and topk payloads, on round
    1's stacked client results (the adversaries' rows attacked) on the
    card and on the CPU: the rules in float64 there, the payloads in
    float32. Raises outside the bands."""
    from fedml_tpu_torch.algorithms.fedavg import local_reducer
    from fedml_tpu_torch.core import compress as C
    from fedml_tpu_torch.core import robust

    attacked = sim._inject_adversaries(state, stacked, cohort)
    params = [k for k in state.variables if k not in sim.model.stat_names]
    card = {k: attacked[k] - state.variables[k][None] for k in params}
    cpu = {k: v.cpu().double() for k, v in card.items()}
    w_card, w_cpu = n_k, n_k.cpu().double()
    f = sim.cfg.fed.robust_num_adversaries
    report = {}
    best = [int(robust.krum(d, f, w)[2]) for d, w in ((card, w_card),
                                                     (cpu, w_cpu))]
    masks = [robust.multi_krum(d, w, f)[2].cpu().tolist()
             for d, w in ((card, w_card), (cpu, w_cpu))]
    report["krum"] = {"card": best[0], "cpu_float64": best[1]}
    report["multikrum"] = {"card": masks[0], "cpu_float64": masks[1]}
    if best[0] != best[1] or masks[0] != masks[1]:
        raise RuntimeError(f"selections differ card vs CPU: {report}")
    for method in ("mean", "median", "trimmed_mean", "fltrust"):
        pipe = robust.DefensePipeline(method=method)
        got = pipe.reduce(card, w_card, local_reducer())
        want = pipe.reduce(cpu, w_cpu, local_reducer())
        worst = 0.0
        for k in want:
            g, x = got[k].cpu().double(), want[k]
            if method == "median":
                band = dict(rtol=MEDIAN_RTOL, atol=0.0)
            else:
                band = dict(rtol=MEAN_BAND,
                            atol=MEAN_BAND * float(x.abs().max()))
            torch.testing.assert_close(g, x, **band)
            worst = max(worst, float(((g - x).abs() / (
                band["atol"] + band["rtol"] * x.abs()).clamp(
                    min=1e-300)).max()))
        report[method] = {"band_used": worst}
    for method in ("int8", "topk"):
        spec = C.CompressionSpec(method=method, stochastic=False)
        for slot in range(n_k.shape[0]):
            one = {k: v[slot] for k, v in card.items()}
            got = C.compress_tree(spec, one)
            want = C.compress_tree(spec, {k: v.cpu() for k, v in one.items()})
            for k in want:
                for part, x in want[k].items():
                    if not torch.equal(got[k][part].cpu(), x):
                        raise RuntimeError(f"{method} payload {k}.{part} "
                                           f"of slot {slot} differs")
        report[f"{method}_payloads"] = "bitwise equal, every slot and leaf"
    return report


def topk_cost(deltas, spec) -> dict:
    """The stable descending sort the port selects top-k with (ties to
    the lower index, as lax.top_k) against torch.topk (no order among
    ties; a yardstick), over every leaf of a stacked delta, and the whole
    wire roundtrip: median CUDA-event ms."""
    from fedml_tpu_torch.core import compress as C
    from fedml_tpu_torch.core import tree as T

    leaves = [T.rows(v) for v in deltas.values() if v[0].numel()]
    ks = [spec.leaf_k(x.shape[1]) for x in leaves]
    return {
        "stable_sort_ms": median_ms(lambda: [
            C._top_idx(x, k) for x, k in zip(leaves, ks)], reps=7, inner=3),
        "torch_topk_ms": median_ms(lambda: [
            torch.topk(x.abs(), k, dim=1).indices
            for x, k in zip(leaves, ks)], reps=7, inner=3),
        "roundtrip_stacked_ms": median_ms(lambda: C.roundtrip_stacked(
            spec, deltas, None), reps=7, inner=3),
        "leaves": len(leaves),
    }


def defense_overhead(card: str, device: str = "cuda") -> None:
    """bench.py defense_overhead_records on the card: each rule's
    aggregation of a ResNet-56-sized stack of c = 10 and 50 clients
    (krum's f = c // 5), median CUDA-event ms, and its overhead over the
    weighted mean."""
    from fedml_tpu_torch.core import robust
    from fedml_tpu_torch.core import tree as T

    for c in (10, 50):
        gen = torch.Generator(device=device).manual_seed(0)
        stacked = {k: torch.randn((c,) + s, generator=gen, device=device)
                   for k, s in OVERHEAD_SHAPES.items()}
        w = torch.ones(c, device=device)
        f = max(1, c // 5)
        methods = {
            "mean": lambda: T.tree_weighted_mean(stacked, w),
            "median": lambda: robust.coordinate_median(stacked),
            "trimmed_mean": lambda: robust.trimmed_mean(stacked),
            "krum": lambda: robust.krum(stacked, f)[0],
            "multikrum": lambda: robust.multi_krum(stacked, w, f)[0],
            "fltrust": lambda: robust.fltrust(
                stacked, robust.coordinate_median(stacked))[0],
        }
        ms = {k: median_ms(fn, reps=9, inner=3) for k, fn in methods.items()}
        overhead = {k: ms[k] - ms["mean"] for k in ms if k != "mean"}
        print(json.dumps({
            "metric": f"defense_agg_overhead_ms_c{c}",
            "value": max(overhead.values()), "unit": "ms/round",
            "cohort": c, "params": sum(math.prod(s)
                                       for s in OVERHEAD_SHAPES.values()),
            "agg_ms": ms, "overhead_vs_mean_ms": overhead, "card": card}),
            flush=True)
        del stacked
        torch.cuda.empty_cache()


def defended_rounds(card: str, device: str = "cuda") -> int:
    """Phase 8: 2 FedAvgSim rounds of each of DEFENDED at the headline
    configuration, sharing the card's copy of the data and the captured
    cohort graph; one more round of (f) under sync-debug "error"; the
    card-vs-CPU check of every rule and codec on round 1's results of
    (a); the cost of top-k's stable sort; the defense overhead. Returns
    the flash kernels' launches in the rounds (0)."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
    from fedml_tpu_torch.core import adversary as A
    from fedml_tpu_torch.core import compress as C
    from fedml_tpu_torch.data import load_dataset
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops.flash_attention import flash_attention

    first = defended_config(next(iter(DEFENDED)))
    data = load_dataset(first.data)
    model = create_model(first.model, device)
    flash_attention.launches = 0
    flash_attention.mma_launches = 0
    base, start, parity = None, None, None
    for name in DEFENDED:
        cfg = defended_config(name)
        sim = FedAvgSim(model, data, cfg, device)
        if base is None:
            base, start = sim, sim.init()
        else:  # the same model, data and training: one cohort graph
            sim.arrays, sim.cohort_update = base.arrays, base.cohort_update
        seen = {}
        port_locals = sim._locals

        def recording_locals(state, cohort=None, port_locals=port_locals,
                             seen=seen):
            seen["cohort"] = cohort
            seen["out"] = port_locals(state, cohort)
            return seen["out"]

        sim._locals = recording_locals
        cohorts = [sim._cohort(start._replace(round=r)) for r in (0, 1)]
        state1, m1 = sim.run_round(start)
        if name.startswith("a_"):
            stacked, n_k, _ = seen["out"]
            parity = card_vs_cpu_aggregation(sim, start, stacked, n_k,
                                             seen["cohort"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m2 = sim.run_round(state1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        test = sim.evaluate_global(state)
        row = {
            "name": name, "rule": cfg.fed.robust_method,
            "attack": cfg.adversary.mode, "compress": cfg.fed.compress,
            "clip": cfg.fed.robust_norm_clip,
            "noise": cfg.fed.robust_noise_stddev,
            "adversaries_in_cohort": [int(A.cohort_mask(
                cfg.adversary, c, 100).sum()) for c in cohorts],
            "excluded_count": sim.defense.excluded_count(len(cohorts[0])),
            "train_loss": [float(m1["train_loss"]),
                           float(m2["train_loss"])],
            "round2_wall_s": wall, "test_loss": test["loss"],
            "test_acc": test["acc"], "card": card,
        }
        if sim.cspec.enabled():
            round2 = seen["out"][0]
            round2 = {k: v - state1.variables[k][None]
                      for k, v in round2.items()}
            row["compress_residual_norm"] = float(
                m2["compress_residual_norm"])
            row["wire_ratio"] = C.wire_ratio(sim.cspec, state.variables)
            torch.cuda.set_sync_debug_mode("error")
            try:
                state, m3 = sim.run_round(state)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            row["round3_under_sync_debug_error"] = {
                "train_loss": float(m3["train_loss"]),
                "compress_residual_norm": float(
                    m3["compress_residual_norm"])}
            row["topk_int8_cost"] = topk_cost(round2, sim.cspec)
        print(json.dumps({"defended_round": row}), flush=True)
        losses = row["train_loss"] + [row["test_loss"]]
        if not all(math.isfinite(x) for x in losses):
            raise RuntimeError(f"{name}: non-finite loss {row}")
    print(json.dumps({"defended_card_vs_cpu": parity}), flush=True)
    launches = flash_attention.launches
    if launches != 0:
        raise RuntimeError(f"the defended rounds launched flash attention "
                           f"{launches} times")
    del base, sim
    torch.cuda.empty_cache()
    defense_overhead(card, device)
    return launches


# Phase 9: the bulk engine and elastic buckets, at the configurations of
# bench.py's bulk records. Memory law: the largest bulk peak of a cohort
# sweep at most BULK_MEM_LAW times the smallest
BULK_MEM_LAW = 1.5
# the fold check: the reference's bulk-vs-stacked band (tests/test_bulk.py)
FOLD_BAND = dict(rtol=2e-5, atol=1e-7)
# the sweeps' sizes (bench.py's): (c)'s population, (d)'s lr cohorts of a
# population of 1024 and ResNet-56 cohorts of the headline's 100 clients,
# (e)'s population and cohorts
RATE_CLIENTS = 10_000
LR_MEM_COHORTS = (64, 256, 1024)
RESNET_MEM_COHORTS = (16, 32, 64)
BANK_POPULATION = 10_000
BANK_COHORTS = (1000, 10_000)


def record_line(card: str, **rec) -> None:
    print(json.dumps({**rec, "device": card}), flush=True)


def resnet_bulk_config(block: int = 4, rounds: int = 2, **fed):
    """Phase 6's headline configuration streamed in blocks of ``block``."""
    import dataclasses

    cfg = resnet_config()
    return dataclasses.replace(cfg, fed=dataclasses.replace(
        cfg.fed, num_rounds=rounds, client_block_size=block, **fed))


def timed_round(sim, state):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = sim.run_round(state)
    torch.cuda.synchronize()
    return state, m, time.perf_counter() - t0


def fold_check(sim, state, block: int) -> dict:
    """Stacked float32 client results of the round's cohort, computed on
    the card, folded through fold_block_partials in blocks of ``block``
    and server_update_from_partials, against server_update on the whole
    stack (the same results, the same draws)."""
    import numpy as np

    from fedml_tpu_torch.algorithms import fedavg as F
    from fedml_tpu_torch.core import tree as T

    cohort = sim._cohort(state)
    stacked, n_k, sums = sim._locals(state, cohort)
    fed, names = sim.cfg.fed, sim.model.stat_names
    want = F.server_update(fed, state, stacked, n_k, F.local_reducer(),
                           names, sim.local_steps)
    parts = []
    for i in range(0, len(cohort), block):
        sl = slice(i, i + block)
        parts.append(F.fold_block_partials(
            fed, sim.local_steps, state, {k: v[sl] for k, v in
                                          stacked.items()},
            n_k[sl], {k: v[sl] for k, v in sums.items()},
            torch.zeros((), device=n_k.device), names))
    total = parts[0]
    for p in parts[1:]:
        total = T.tree_map(torch.add, total, p)
    got = F.server_update_from_partials(fed, state, total, names)
    worst, ok = 0.0, True
    for k, w in want.variables.items():
        g, w = got.variables[k].cpu().numpy(), w.cpu().numpy()
        err = np.abs(g - w)
        ok &= bool(np.all(err <= FOLD_BAND["atol"]
                          + FOLD_BAND["rtol"] * np.abs(w)))
        worst = max(worst, float(err.max()))
    out = {"blocks": len(parts), "clients": len(cohort),
           "max_abs_err": worst, "band": FOLD_BAND, "ok": ok}
    if not ok:
        raise RuntimeError(f"fold_block_partials disagrees with "
                           f"server_update: {out}")
    return out


def bulk_headline(card: str, device: str = "cuda"):
    """(a) the headline under bulk: 10 clients in blocks of 4, 2 rounds,
    one graph capture for 4 lanes; a third round profiled for its host
    launches a block; the fold check. Returns the sim, its state and its
    dataset."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
    from fedml_tpu_torch.data import load_dataset
    from fedml_tpu_torch.models import create_model
    from scripts.profile_torch_round import traced

    cfg = resnet_bulk_config()
    data = load_dataset(cfg.data)
    sim = FedAvgSim(create_model(cfg.model, device), data, cfg, device)
    state = sim.init()
    losses, walls = [], []
    for _ in range(2):
        state, m, wall = timed_round(sim, state)
        losses.append(float(m["train_loss"]))
        walls.append(wall)
    programs = sim.cohort_update.programs
    blocks = [{"clients": n, "steps_per_epoch": s} for n, s in
              sim.last_groups]
    if programs.stats["misses"] != 1 or len(blocks) != 3 or not all(
            math.isfinite(x) for x in losses):
        raise RuntimeError(f"bulk headline: captures {programs.stats}, "
                           f"blocks {blocks}, losses {losses}")
    _, prof = traced(lambda: sim.run_round(state), None)
    launches = sum(prof["host_launches"].values())
    test = sim.evaluate_global(state)
    record_line(card, metric="bulk_headline_resnet56", cohort=10,
                block_size=4, blocks=blocks, train_loss=losses,
                round_wall_s=walls, test_loss=test["loss"],
                graph_captures=programs.stats["misses"],
                graph_replays=(sim.cohort_update.graph.replays
                               if sim.cohort_update.graph else 0),
                profiled_round={
                    "wall_s": prof["wall_s"],
                    "device_busy_s": prof["device_busy_s"],
                    "device_idle_share": prof["device_idle_share"],
                    "host_launches": prof["host_launches"],
                    "host_launches_per_block": launches / len(blocks)},
                fold_check=fold_check(sim, state, 4))
    return sim, state, data


def bulk_sync_round(card: str, base, state, data,
                    device: str = "cuda") -> None:
    """(b) a bulk round of the headline with int8 compression, the
    client-keyed residual bank and the streamed median, under
    set_sync_debug_mode("error") after a warm-up round; then the
    projection's draw for a streamed selection rule, timed."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
    from fedml_tpu_torch.core import streamdef as SD

    cfg = resnet_bulk_config(compress="int8", robust_method="median")
    sim = FedAvgSim(base.model, data, cfg, device)
    sim.arrays, sim.cohort_update = base.arrays, base.cohort_update
    state, _, warm = timed_round(sim, state)
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = sim.run_round(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if not math.isfinite(float(m["train_loss"])):
        raise RuntimeError(f"sync-debug bulk round: {m}")
    params = {k: v for k, v in state.variables.items()
              if k not in sim.model.stat_names}
    shapes = SD.proj_shapes(params)
    proj_ms = median_ms(lambda: sim.draws("proj", 0, [0], shapes), reps=5,
                        inner=1)
    record_line(card, metric="bulk_sync_debug_round_resnet56",
                compress="int8", defense="median", block_size=4,
                train_loss=float(m["train_loss"]), warm_round_wall_s=warm,
                bank={k: sim.counters[k] for k in (
                    "bank.rows", "bank.resident_mb", "bank.gathers",
                    "bank.scatters")},
                projection={"params": sum(v.numel() for v in params.values()),
                            "proj_dim": SD.PROJ_DIM,
                            "bytes": 4 * SD.PROJ_DIM * sum(
                                v.numel() for v in params.values()),
                            "draw_ms": proj_ms, "held_for_the_round": True})


def bulk_10k_rate(card: str, device: str = "cuda") -> None:
    """(c) fedavg_rounds_per_sec_10kc_mnist_lr: bench.py
    bulk_10k_rate_record's configuration, the median of 3 rounds after a
    warm-up round."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
    from fedml_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        FedConfig,
        ModelConfig,
        TrainConfig,
    )
    from fedml_tpu_torch.data import make_fake_image_dataset
    from fedml_tpu_torch.models import create_model

    n = RATE_CLIENTS
    dcfg = DataConfig(dataset="mnist", num_clients=n, batch_size=10, seed=0)
    cfg = ExperimentConfig(
        data=dcfg, model=ModelConfig(name="lr", num_classes=10,
                                     input_shape=(28, 28, 1)),
        train=TrainConfig(lr=0.03, epochs=1),
        fed=FedConfig(num_rounds=4, clients_per_round=n, eval_every=10**9,
                      client_block_size=32), seed=0)
    t0 = time.perf_counter()
    data = make_fake_image_dataset("mnist", dcfg, n_train=60000)
    sim = FedAvgSim(create_model(cfg.model, device), data, cfg, device)
    setup = time.perf_counter() - t0
    state = sim.init()
    walls, losses = [], []
    for _ in range(4):
        state, m, wall = timed_round(sim, state)
        walls.append(wall)
        losses.append(float(m["train_loss"]))
    med = statistics.median(walls[1:])
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"10k-client bulk rounds: {losses}")
    record_line(card, metric="fedavg_rounds_per_sec_10kc_mnist_lr",
                value=1.0 / med, unit="rounds/s", round_wall_s=walls,
                clients_trained_per_round=n, block_size=32,
                blocks_per_round=sim._n_blocks, train_loss=losses,
                setup_s=setup, graph_captures=sim.cohort_update.programs
                .stats["misses"], note="median of rounds 2-4; a smoke "
                "figure (host clock ending in a synchronize)")
    del sim, data


def peak_round_mb(sim, state):
    """``torch.cuda.max_memory_allocated`` over one round, in MB, after a
    warm-up round (the capture)."""
    state, _ = sim.run_round(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, m = sim.run_round(state)
    torch.cuda.synchronize()
    if not math.isfinite(float(m["train_loss"])):
        raise RuntimeError(f"memory round: {m}")
    return torch.cuda.max_memory_allocated() / 1e6, state


def free_card() -> None:
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def law(name: str, peaks: dict) -> float:
    ratio = max(peaks.values()) / min(peaks.values())
    if ratio > BULK_MEM_LAW:
        raise RuntimeError(f"{name}: bulk peak grows with the cohort: "
                           f"{peaks} (ratio {ratio} > {BULK_MEM_LAW})")
    return ratio


def bulk_memory(card: str, device: str = "cuda") -> None:
    """(d) peak_round_hbm_mb_c{64,256,1024}_b32_bulk at bench.py
    bulk_mem_bench_records' configuration (synthetic_1_1, population
    1024, lr on 60 inputs, batch 32, block 32), then ResNet-56 (the
    headline's data, cohorts 16, 32 and 64 of 100, block 8) bulk against
    stacked, sharing one graph of 8 lanes."""
    import dataclasses

    from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
    from fedml_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        FedConfig,
        ModelConfig,
        TrainConfig,
    )
    from fedml_tpu_torch.data import load_dataset
    from fedml_tpu_torch.models import create_model

    dcfg = DataConfig(dataset="synthetic_1_1",
                      num_clients=max(LR_MEM_COHORTS), batch_size=32, seed=0)
    data = load_dataset(dcfg)
    peaks = {}
    for c in LR_MEM_COHORTS:
        cfg = ExperimentConfig(
            data=dcfg, model=ModelConfig(name="lr", num_classes=10,
                                         input_shape=(60,)),
            train=TrainConfig(lr=0.1, epochs=1),
            fed=FedConfig(num_rounds=2, clients_per_round=c,
                          eval_every=10**9, client_block_size=32), seed=0)
        free_card()
        sim = FedAvgSim(create_model(cfg.model, device), data, cfg, device)
        peaks[c], _ = peak_round_mb(sim, sim.init())
        record_line(card, metric=f"peak_round_hbm_mb_c{c}_b32_bulk",
                    value=peaks[c], unit="MB peak", analytic=False,
                    source="torch.cuda.max_memory_allocated over one round",
                    cohort=c, block_size=32, blocks=sim._n_blocks)
        del sim
    ratio = law("lr bulk", peaks)
    cfg0 = resnet_config()
    rdata = load_dataset(cfg0.data)
    model = create_model(cfg0.model, device)
    base, rows = None, {}
    for mode in ("bulk", "stacked"):
        for c in RESNET_MEM_COHORTS:
            # the stacked round in groups of 8 lanes, the bulk round's
            # block: the same graph, and only the stacking differs
            cfg = dataclasses.replace(
                cfg0, train=dataclasses.replace(cfg0.train,
                                                cohort_groups=c // 8),
                fed=dataclasses.replace(
                    cfg0.fed, clients_per_round=c, num_rounds=2,
                    client_block_size=8 if mode == "bulk" else 0))
            free_card()
            sim = FedAvgSim(model, rdata, cfg, device)
            if base is None:
                base = sim
            else:  # one dataset copy and one graph of 8 lanes
                sim.arrays, sim.cohort_update = base.arrays, \
                    base.cohort_update
                free_card()
            rows.setdefault(mode, {})[c], _ = peak_round_mb(sim, sim.init())
            if mode == "stacked" and sim.last_groups[0][0] != 8:
                raise RuntimeError(f"stacked groups {sim.last_groups}")
            if sim is not base:
                del sim
    r_ratio = law("ResNet-56 bulk", rows["bulk"])
    record_line(card, metric="peak_round_hbm_mb_resnet56_bulk_vs_stacked",
                unit="MB peak", analytic=False, block_size=8,
                bulk=rows["bulk"], stacked=rows["stacked"],
                bulk_max_over_min=r_ratio,
                stacked_max_over_min=max(rows["stacked"].values())
                / min(rows["stacked"].values()),
                lr_bulk_max_over_min=ratio,
                graph_captures=base.cohort_update.programs.stats["misses"])
    del base, model, rdata, data
    free_card()


def bank_memory(card: str, device: str = "cuda") -> None:
    """(e) peak_round_hbm_mb_c{1k,10k}_defended_compressed and
    defense_stream_overhead_ms: bench.py bank_bench_records' round (int8
    with the residual bank and the streamed median, make_synthetic with
    16-32 samples a client, batch 8, block 32) at a population of
    10,000."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
    from fedml_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        FedConfig,
        ModelConfig,
        TrainConfig,
    )
    from fedml_tpu_torch.data import make_synthetic
    from fedml_tpu_torch.models import create_model

    population = BANK_POPULATION
    t0 = time.perf_counter()
    data = make_synthetic(population, 1.0, 1.0, seed=0, samples_low=16,
                          samples_high=32)
    gen_s = time.perf_counter() - t0

    def build(cohort, defended):
        fed = dict(compress="int8", robust_method="median") if defended \
            else {}
        cfg = ExperimentConfig(
            data=DataConfig(dataset="synthetic_1_1", num_clients=population,
                            batch_size=8, seed=0),
            model=ModelConfig(name="lr", num_classes=10, input_shape=(60,)),
            train=TrainConfig(lr=0.1, epochs=1),
            fed=FedConfig(num_rounds=1000, clients_per_round=cohort,
                          eval_every=10**9, client_block_size=32, **fed),
            seed=0)
        free_card()
        return FedAvgSim(create_model(cfg.model, device), data, cfg, device)

    peaks = {}
    for c in BANK_COHORTS:
        label = f"{c // 1000}k" if c % 1000 == 0 else str(c)
        sim = build(c, True)
        peaks[c], _ = peak_round_mb(sim, sim.init())
        record_line(card, metric=f"peak_round_hbm_mb_c{label}"
                    "_defended_compressed", value=peaks[c], unit="MB peak",
                    analytic=False, cohort=c, population=population,
                    block_size=32, blocks=sim._n_blocks, defense="median",
                    compress="int8", bank_resident_mb=sim.ef_bank
                    .resident_bytes() / 1e6, data_gen_s=gen_s)
        del sim
    ratio = law("defended-compressed bulk", peaks)
    means = {}
    c0 = min(BANK_COHORTS)
    for defended in (True, False):
        sim = build(c0, defended)
        state, _ = sim.run_round(sim.init())
        walls = []
        for _ in range(3):
            state, _, wall = timed_round(sim, state)
            walls.append(wall)
        means[defended] = statistics.mean(walls) * 1e3
        del sim
    record_line(card, metric="defense_stream_overhead_ms",
                value=means[True] - means[False], unit="ms/round",
                cohort=c0, defended_round_ms=means[True],
                plain_round_ms=means[False], peak_max_over_min=ratio)
    del data
    free_card()


def elastic_churn(card: str, device: str = "cuda") -> None:
    """(f) elastic_compile_cache_hit_rate_c16: bench.py
    elastic_churn_record's schedule (fake_mnist, 32 clients, cohort 16,
    lr, 24 rounds, live sizes seeded in [4, 16])."""
    import random

    from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
    from fedml_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        FedConfig,
        ModelConfig,
        TrainConfig,
    )
    from fedml_tpu_torch.data import load_dataset
    from fedml_tpu_torch.models import create_model

    cfg = ExperimentConfig(
        data=DataConfig(dataset="fake_mnist", num_clients=32, batch_size=32,
                        seed=0),
        model=ModelConfig(name="lr", num_classes=10,
                          input_shape=(28, 28, 1)),
        train=TrainConfig(lr=0.1, epochs=1),
        fed=FedConfig(num_rounds=24, clients_per_round=16,
                      eval_every=10**9, elastic_buckets=True), seed=0)
    sim = FedAvgSim(create_model(cfg.model, device), load_dataset(cfg.data),
                    cfg, device)
    rng = random.Random(0)
    schedule = [rng.randint(4, 16) for _ in range(24)]
    state = sim.init()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for n in schedule:
        sim.set_cohort_size(n)
        state, m = sim.run_round(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hits = sim.counters.get("elastic.compile_cache_hits", 0)
    misses = sim.counters.get("elastic.compile_cache_misses", 0)
    if misses != 1 or hits != 23 or not math.isfinite(
            float(m["train_loss"])):
        raise RuntimeError(f"elastic churn: {misses} captures, {hits} "
                           f"hits, loss {float(m['train_loss'])}")
    record_line(card, metric="elastic_compile_cache_hit_rate_c16",
                value=hits / (hits + misses), unit="hit_rate", rounds=24,
                cohort_schedule=schedule, compiles=misses,
                compile_means="CUDA graph captures",
                static_runtime_compiles=len(set(schedule)), wall_s=wall)


def bulk_phase(card: str, device: str = "cuda") -> int:
    """Phase 9: (a)-(f). Returns the flash kernels' launches in it (0)."""
    from fedml_tpu_torch.ops.flash_attention import flash_attention

    flash_attention.launches = 0
    flash_attention.mma_launches = 0
    t0 = time.perf_counter()
    sim, state, data = bulk_headline(card, device)
    bulk_sync_round(card, sim, state, data, device)
    del sim, state, data
    free_card()
    bulk_10k_rate(card, device)
    free_card()
    bulk_memory(card, device)
    bank_memory(card, device)
    elastic_churn(card, device)
    launches = flash_attention.launches + flash_attention.mma_launches
    if launches != 0:
        raise RuntimeError(f"the bulk phase launched flash attention "
                           f"{launches} times")
    print(json.dumps({"bulk_phase_s": time.perf_counter() - t0,
                      "device": card}), flush=True)
    return launches


# Phase 10: the space-to-depth ResNets, fused blocks and the experiment
# harness's checkpoints and resume
FUSE = 8  # bench.py's --fuse-rounds default
FUSED_ROUNDS = 16
# the exact s2d layout against the standard ResNet-56 on the card, float32
# with TF32 off: eval logits in the JAX package's own band
# (tests/test_models.py), train-mode logits and batch statistics in its
# train-mode bands
EXACT_EVAL = dict(atol=1e-4, rtol=1e-4)
EXACT_TRAIN = dict(atol=2e-4, rtol=2e-4)
EXACT_STATS = dict(atol=1e-5, rtol=1e-4)
# rounds per timed window (one window: FUSE rounds a block): the ResNets
# one block, mnist_lr (about 4 ms a round) five
RATE_BLOCKS = {"resnet56": 1, "resnet56_s2d": 1, "mnist_lr": 5}
# (d): the CLI on lr at a population of 400, every client a round (80
# groups of 5: the per-client host work makes a round last long enough
# that the kill after the checkpoint of round 3 lands inside the run),
# and the same streamed in blocks of 100 with int8 and its client-keyed
# residual bank
RESUME_ARGS = ["--algorithm", "fedavg", "--dataset", "fake_mnist",
               "--model", "lr", "--num_classes", "10", "--input_shape", "28",
               "28", "1", "--client_num_in_total", "400",
               "--client_num_per_round", "400", "--comm_round", "6",
               "--batch_size", "32", "--checkpoint_every", "2"]
RESUME_PAIRS = {"stacked": [],
                "bulk_int8": ["--client_block_size", "100", "--compress",
                              "int8"]}
KILL_AFTER = "round_00000003.pt"  # the checkpoint of round 3
RESUME_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "phase10")


def model_config(suffix: str = "", **fed):
    """Phase 6's headline configuration, its model's name (resnet56)
    with ``suffix`` ("_s2d", "_s2d_exact")."""
    import dataclasses

    cfg = resnet_config()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model,
                                       name=cfg.model.name + suffix),
        fed=dataclasses.replace(cfg.fed, **fed))


def host_vars(state) -> dict:
    return {k: v.detach().cpu() for k, v in state.variables.items()}


def max_abs_err(x: dict, y: dict) -> float:
    """The largest elementwise difference of two trees of tensors (nested
    dicts), which must hold the same keys."""
    if set(x) != set(y):
        raise RuntimeError(f"different keys: {sorted(set(x) ^ set(y))}")
    err = 0.0
    for k in x:
        if isinstance(x[k], dict):
            err = max(err, max_abs_err(x[k], y[k]))
        elif isinstance(x[k], torch.Tensor):
            d = (x[k].double() - y[k].double()).abs()
            err = max(err, float(d.max()) if d.numel() else 0.0)
        elif x[k] != y[k]:
            raise RuntimeError(f"{k}: {x[k]} != {y[k]}")
    return err


def s2d_headline(card: str, data):
    """(a) resnet56_s2d at the headline configuration, bf16, 3 rounds with
    an evaluation after each; one more round under
    set_sync_debug_mode("error"). Returns the sim (its data and graph)."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
    from fedml_tpu_torch.metrics import MetricsSink
    from fedml_tpu_torch.models import create_model

    cfg = model_config("_s2d")
    sim = FedAvgSim(create_model(cfg.model), data, cfg)
    init_eval = sim.evaluate_global(sim.init())
    sink = MetricsSink()
    t0 = time.perf_counter()
    state = sim.run(metrics_sink=sink)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cohort = cohort_report(sim)
    before = sim.cohort_update.graph.replays
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, synced = sim.run_round(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    synced = {"train_loss": float(synced["train_loss"]),
              "cohort": cohort_report(sim, before)}
    rounds = [{k: v for k, v in r.items() if not k.startswith("_")}
              for r in sink.history]
    losses = [r[k] for r in rounds for k in ("train_loss", "test_loss")]
    not_f32 = sorted(k for k, v in state.variables.items()
                     if v.dtype != torch.float32)
    record_line(card, metric="resnet56_s2d_main_path",
                note="seconds beside phase 10 (d)'s starting children",
                parameters=sum(v.numel() for k, v in state.variables.items()
                               if k not in sim.model.stat_names),
                init_test_loss=init_eval["loss"], per_round=rounds,
                seconds_rounds_with_eval=wall, cohort=cohort,
                round_under_sync_debug_error=synced)
    if not all(math.isfinite(x) for x in losses + [synced["train_loss"]]):
        raise RuntimeError(f"resnet56_s2d: non-finite loss {rounds}")
    if not rounds[-1]["test_loss"] < init_eval["loss"]:
        raise RuntimeError(f"resnet56_s2d: test loss did not fall: "
                           f"{init_eval['loss']} -> {rounds[-1]}")
    if not_f32 or synced["cohort"]["graph_replays"] != synced["cohort"][
            "group_steps_last_round"]:
        raise RuntimeError(f"resnet56_s2d: {not_f32} not float32, or "
                           f"replays not one per group-step: {synced}")
    return sim


def s2d_exact_parity(card: str, data) -> None:
    """(b) resnet56_s2d_exact in float32 (TF32 off), its weights converted
    from a resnet56 initialisation: eval logits, train-mode logits and
    batch statistics against the standard model's on the card; then one
    local step of each from the same weights (the largest client of round
    0's cohort, its first batch): the metric sums, every variable the
    converter carries unchanged (stages 2 and 3 past the transition's
    converted kernels, the head) and every running statistic (stage 1's
    tiled) within RESNET_PARITY. The converted parameters (stage 1's
    kernels and norm scales, the transition's 2x2 and 1x1 kernels) are
    another parameterization: a tap of the standard kernel is one or
    more entries of the converted one, which also has gradients where
    the standard has no tap, so their steps are not elementwise the
    same."""
    import dataclasses

    from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.models.s2d_exact import (
        convert_resnet_checkpoint_to_s2d,
    )

    cfg = resnet_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, compute_dtype="float32"))
    depth = int(cfg.model.name[len("resnet"):])
    std = FedAvgSim(create_model(cfg.model), data, cfg)
    exact = FedAvgSim(create_model(dataclasses.replace(
        cfg.model, name=cfg.model.name + "_s2d_exact")), data, cfg)
    v_std = std.init().variables
    v_exact = {k: v.cuda() for k, v in
               convert_resnet_checkpoint_to_s2d(v_std, depth).items()}
    x = torch.randn((64, 32, 32, 3),
                    generator=torch.Generator().manual_seed(1)).cuda()
    out = {}
    got = exact.model.apply_eval(v_exact, x)
    want = std.model.apply_eval(v_std, x)
    torch.testing.assert_close(got, want, **EXACT_EVAL)
    out["eval_logits_err"] = float((got - want).abs().max())
    got, g_vars = exact.model.apply_train(v_exact, x)
    want, w_vars = std.model.apply_train(v_std, x)
    torch.testing.assert_close(got, want, **EXACT_TRAIN)
    out["train_logits_err"] = float((got - want).abs().max())
    w_conv = convert_resnet_checkpoint_to_s2d(w_vars, depth)
    names = exact.model.stat_names
    for k in names:
        torch.testing.assert_close(g_vars[k].cpu(), w_conv[k],
                                   **EXACT_STATS)
    out["train_stats_err"] = max_abs_err(
        {k: g_vars[k].cpu() for k in names}, {k: w_conv[k] for k in names})

    cohort = std.sampler(0, std.arrays.num_clients,
                         cfg.fed.clients_per_round).tolist()
    c = max(cohort, key=lambda i: int(std._host_counts[i]))
    orders = [o.cuda() for o in list(std.batch_orders(0, c))[
        :cfg.train.epochs]]
    steps = {}
    for name, sim, start in (("standard", std, v_std),
                             ("exact", exact, v_exact)):
        a = sim.arrays
        steps[name] = sim.local_update(start, a.idx[c], a.mask[c], a.x, a.y,
                                       orders, steps=1)
    s_vars, s_n, s_sums = steps["standard"]
    e_vars, e_n, e_sums = steps["exact"]
    s_conv = convert_resnet_checkpoint_to_s2d(s_vars, depth)
    n = (depth - 2) // 6
    converted = ("conv.", "bn.", *(f"blocks.{i}." for i in range(n)),
                 f"blocks.{n}.conv1.", f"blocks.{n}.proj.")
    compared = [k for k in e_vars
                if k in names or not k.startswith(converted)]
    for k in compared:
        torch.testing.assert_close(e_vars[k].cpu(), s_conv[k],
                                   **RESNET_PARITY)
    for k in s_sums:
        torch.testing.assert_close(e_sums[k], s_sums[k], **RESNET_PARITY)
    out["one_step"] = {
        "client": c, "samples": int(std._host_counts[c]),
        "compared_variables": len(compared),
        "skipped_converted_params": len(e_vars) - len(compared),
        "max_abs_err": max_abs_err({k: e_vars[k].cpu() for k in compared},
                                   {k: s_conv[k] for k in compared}),
        "loss_sum": [float(s_sums["loss_sum"]), float(e_sums["loss_sum"])],
        **RESNET_PARITY}
    record_line(card, metric="resnet56_s2d_exact_vs_resnet56",
                dtype="float32", tf32=False, batch=64, bands={
                    "eval": EXACT_EVAL, "train": EXACT_TRAIN,
                    "stats": EXACT_STATS}, **out)
    del std, exact
    free_card()


def run_fused(data, fuse: int):
    """FedAvgSim.run of FUSED_ROUNDS rounds of the headline, evaluating
    every FUSE rounds, in blocks of ``fuse``: (sim, final state, records,
    wall seconds)."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
    from fedml_tpu_torch.metrics import MetricsSink
    from fedml_tpu_torch.models import create_model

    cfg = model_config(num_rounds=FUSED_ROUNDS, eval_every=FUSE,
                       fuse_rounds=fuse)
    sim = FedAvgSim(create_model(cfg.model), data, cfg)
    sink = MetricsSink()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = sim.run(metrics_sink=sink)
    torch.cuda.synchronize()
    records = [{k: v for k, v in r.items() if k != "_ts"}
               for r in sink.history]
    return sim, state, records, time.perf_counter() - t0


def conv_kernels(sim, state) -> set:
    """The names of the convolution kernels of one traced round."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sim.run_round(state)
        torch.cuda.synchronize()
    return {e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and re.search(r"conv|wgrad|dgrad|implicit|xmma|cudnn", e.name,
                          re.I)}


def fused_equals_unfused(card: str, data):
    """(c), first half: the headline ResNet-56, FUSED_ROUNDS rounds in
    blocks of FUSE against the per-round loop, from the same
    initialisation. Equal variables bit for bit, or, where a second
    per-round run already differs from the first (a nondeterministic
    kernel), the fused run within SPREAD_FACTOR times that spread; then
    the pair again with cuDNN's deterministic algorithms, which must be
    equal bit for bit, and the convolution kernels that only the default
    algorithms run. Returns (the fused sim, its state, the spread)."""
    _, a_state, a_rec, a_wall = run_fused(data, 1)
    sim, f_state, f_rec, f_wall = run_fused(data, FUSE)
    a_vars = host_vars(a_state)
    err = max_abs_err(a_vars, host_vars(f_state))
    report = {"rounds": FUSED_ROUNDS, "fuse_rounds": FUSE,
              "unfused_run_wall_s": a_wall, "fused_run_wall_s": f_wall,
              "blocks": [[b.start, b.length, b.compiled]
                         for b in sim.last_blocks],
              "records_equal": a_rec == f_rec,
              "fused_vs_unfused_max_abs_err": err}
    spread = 0.0
    if err == 0.0 and a_rec == f_rec:
        report["bitwise"] = True
    else:
        _, b_state, b_rec, _ = run_fused(data, 1)
        spread = max_abs_err(a_vars, host_vars(b_state))
        report.update(bitwise=False, unfused_vs_unfused_max_abs_err=spread,
                      spread_factor=SPREAD_FACTOR)
        torch.backends.cudnn.deterministic = True
        try:
            _, d_state, d_rec, _ = run_fused(data, 1)
            d_sim, df_state, df_rec, _ = run_fused(data, FUSE)
            report["deterministic_cudnn_bitwise"] = (
                max_abs_err(host_vars(d_state), host_vars(df_state)) == 0.0
                and d_rec == df_rec)
            det = conv_kernels(d_sim, df_state)
        finally:
            torch.backends.cudnn.deterministic = False
        report["conv_kernels_only_nondeterministic"] = sorted(
            k[:120] for k in conv_kernels(sim, f_state) - det)
        if (spread == 0.0 or err > SPREAD_FACTOR * spread
                or not report["deterministic_cudnn_bitwise"]):
            record_line(card, metric="fused_vs_unfused_resnet56", **report)
            raise RuntimeError(f"fused run outside the unfused spread: "
                               f"{report}")
    record_line(card, metric="fused_vs_unfused_resnet56", **report)
    if [b[2] for b in report["blocks"]] != [True, False]:
        raise RuntimeError(f"compiled flags: {report['blocks']}")
    return sim, f_state, spread


def sync_free_block(card: str, sim, state):
    """(c): one whole block (FUSE rounds) and its push under
    set_sync_debug_mode("error"); the flush is the block's one sync."""
    from fedml_tpu_torch.core import fuse as FU

    pipeline = FU.BlockPipeline()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        state, metrics = sim.run_block(state, FUSE)
        if pipeline.push(state.round - FUSE, FUSE, metrics, t0) is not None:
            raise RuntimeError("an empty pipeline flushed a block")
        pushed = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    flushed = pipeline.flush()
    losses = [r["train_loss"] for r in flushed.rows]
    record_line(card, metric="fused_block_under_sync_debug_error",
                rounds=FUSE, enqueue_s=pushed, block_wall_s=flushed.wall_s,
                flush_wait_s=flushed.get_wait_s, train_loss=losses)
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"sync-free block: {losses}")
    return state


def rate_windows(sim, state, blocks: int):
    """Rounds per second of the per-round loop (each round's metrics
    converted to floats, as FedAvgSim.run does) and of fused blocks
    (blocks of FUSE enqueued, each flushed once, one deep), in turns:
    unfused, fused, fused, unfused; each window ``blocks`` x FUSE rounds,
    a host clock ending in a synchronize."""
    from fedml_tpu_torch.algorithms.fedavg import consume_round_counters
    from fedml_tpu_torch.core import fuse as FU

    rates = {"unfused": [], "fused": []}
    n = blocks * FUSE
    for kind in ("unfused", "fused", "fused", "unfused"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "unfused":
            for _ in range(n):
                state, m = sim.run_round(state)
                consume_round_counters(m, sim.counters)
        else:
            pipeline = FU.BlockPipeline()
            for _ in range(blocks):
                state, m = sim.run_block(state, FUSE)
                pipeline.push(state.round - FUSE, FUSE, m, t0)
            pipeline.flush()
        torch.cuda.synchronize()
        rates[kind].append(n / (time.perf_counter() - t0))
    return rates, state


def fused_rates(card: str, r56, r56_state, s2d_base, data) -> None:
    """(c): fedavg_rounds_per_sec_100c_cifar10_{resnet56,resnet56_s2d}
    and mnist_lr, per-round loop against fused blocks in turns; the
    unfused resnet56_s2d rate is (a)'s beside resnet56's. Then one fused
    mnist_lr block and its 8 rounds unfused, traced: their device idle
    shares."""
    import dataclasses

    from fedml_tpu_torch.algorithms.fedavg import (
        FedAvgSim,
        consume_round_counters,
    )
    from fedml_tpu_torch.models import create_model
    from scripts.profile_torch_round import traced

    cfg = model_config("_s2d", fuse_rounds=FUSE)
    s2d = FedAvgSim(s2d_base.model, data, cfg)
    s2d.arrays, s2d.cohort_update = s2d_base.arrays, s2d_base.cohort_update
    lr_cfg, lr_data = family_setup("mnist_lr")
    lr_cfg = dataclasses.replace(lr_cfg, fed=dataclasses.replace(
        lr_cfg.fed, fuse_rounds=FUSE))
    lr = FedAvgSim(create_model(lr_cfg.model), lr_data, lr_cfg)
    lr_state, _ = lr.run_round(lr.init())  # the capture
    s2d_state, _ = s2d.run_round(s2d.init())
    runs = {"resnet56": (r56, r56_state), "resnet56_s2d": (s2d, s2d_state),
            "mnist_lr": (lr, lr_state)}
    rates = {}
    for name, (sim, state) in runs.items():
        rates[name], state = rate_windows(sim, state, RATE_BLOCKS[name])
        runs[name] = (sim, state)
    for name, r in rates.items():
        prefix = ("fedavg_rounds_per_sec_100c_cifar10_" if name != "mnist_lr"
                  else "fedavg_rounds_per_sec_")
        for kind, suffix in (("unfused", ""), ("fused", "_fused")):
            record_line(card, metric=prefix + name + suffix,
                        value=statistics.mean(r[kind]), unit="rounds/s",
                        windows=r[kind], rounds_per_window=RATE_BLOCKS[
                            name] * FUSE, fuse_rounds=FUSE if suffix else 1,
                        note="a smoke figure: windows in turns unfused, "
                             "fused, fused, unfused; host clock ending in a "
                             "synchronize")

    sim, state = runs["mnist_lr"]

    def unfused():
        nonlocal state
        for _ in range(FUSE):
            state, m = sim.run_round(state)
            consume_round_counters(m, sim.counters)

    def fused():
        nonlocal state
        from fedml_tpu_torch.core import fuse as FU

        pipeline = FU.BlockPipeline()
        state, m = sim.run_block(state, FUSE)
        pipeline.push(0, FUSE, m, time.perf_counter())
        pipeline.flush()

    shares = {}
    for kind, fn in (("unfused", unfused), ("fused", fused)):
        _, prof = traced(fn, None)
        shares[kind] = {k: prof[k] for k in (
            "wall_s", "device_busy_s", "device_idle_share", "kernels",
            "host_launches")}
    record_line(card, metric="mnist_lr_traced_block", rounds=FUSE, **shares)
    del s2d, lr, runs
    free_card()


def child(args: list[str], out_dir: str) -> subprocess.Popen:
    """The CLI on the card as a child process, writing under ``out_dir``
    (its standard error appended to ``<out_dir>.stderr``)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(out_dir + ".stderr", "a") as err:
        return subprocess.Popen(
            [sys.executable, "-m", "fedml_tpu_torch.experiments.run", *args,
             "--out_dir", out_dir],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.DEVNULL, stderr=err)


def child_error(out_dir: str) -> str:
    with open(out_dir + ".stderr") as f:
        return f.read()[-2000:]


def read_rows(run_dir: str) -> list[dict]:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


class KilledRuns:
    """(d), first half: each RESUME_PAIRS run through the CLI on the card
    in a child process, both at once, SIGKILLed by a watcher thread once
    its checkpoint of round 3 exists. The children start up while this
    process runs (a) and (b), which time nothing; :meth:`finish` waits
    for both kills before (c)'s timed work."""

    def __init__(self):
        import threading

        shutil.rmtree(RESUME_DIR, ignore_errors=True)
        self.dirs = {p: os.path.join(RESUME_DIR, p) for p in RESUME_PAIRS}
        self.kills: dict[str, float] = {}
        self.error: BaseException | None = None
        self.t0 = time.perf_counter()
        self.procs = {p: child(RESUME_ARGS + extra, self.dirs[p])
                      for p, extra in RESUME_PAIRS.items()}
        self.watcher = threading.Thread(target=self._watch, daemon=True)
        self.watcher.start()

    def _watch(self) -> None:
        import signal

        marks = {p: os.path.join(d, "run_rep0", "ckpt", KILL_AFTER)
                 for p, d in self.dirs.items()}
        try:
            while len(self.kills) < len(self.procs):
                for p, proc in self.procs.items():
                    if p in self.kills:
                        continue
                    if os.path.exists(marks[p]):
                        proc.send_signal(signal.SIGKILL)
                        self.kills[p] = time.perf_counter() - self.t0
                    elif proc.poll() is not None:
                        raise RuntimeError(
                            f"{p}: the child ended (rc {proc.returncode}) "
                            "before the checkpoint of round 3: "
                            f"{child_error(self.dirs[p])}")
                time.sleep(0.0005)
        except RuntimeError as err:  # raised again by finish()
            self.error = err

    def finish(self) -> dict:
        """Both children killed and reaped: the rows each had logged."""
        import signal

        self.watcher.join(timeout=300)
        if self.watcher.is_alive():
            raise RuntimeError("no checkpoint of round 3 in 300 s")
        if self.error is not None:
            raise self.error
        report = {}
        for p, proc in self.procs.items():
            if proc.wait(timeout=60) != -signal.SIGKILL:
                raise RuntimeError(f"{p}: rc {proc.returncode}, not killed")
            report[p] = {"killed_at_s": self.kills[p], "rows_before_resume": [
                r["round"] for r in read_rows(
                    os.path.join(self.dirs[p], "run_rep0")) if "round" in r]}
        return report

    def stop(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)


def crash_and_resume(card: str, spread: float, killed: KilledRuns,
                     report: dict) -> None:
    """(d), second half: the killed runs started again with the same
    flags, and meanwhile each run uninterrupted (the harness in this
    process, the same config); metrics.jsonl must hold rounds 0-5, every
    round from the resume on in a row stamped "resumed", and the final
    checkpoint must equal the uninterrupted run's, bit for bit or within
    (c)'s spread."""
    from fedml_tpu_torch.experiments import run as cli
    from fedml_tpu_torch.experiments.harness import Experiment
    from fedml_tpu_torch.utils.checkpoint import RoundCheckpointer

    dirs = killed.dirs
    t0 = time.perf_counter()
    killed.procs = {p: child(RESUME_ARGS + extra, dirs[p])
                    for p, extra in RESUME_PAIRS.items()}
    for p, extra in RESUME_PAIRS.items():
        cfg, _ = cli.parse_args(RESUME_ARGS + extra + [
            "--out_dir", dirs[p] + "_uninterrupted"])
        Experiment(cfg, device="cuda").run()
    for p, proc in killed.procs.items():
        if proc.wait(timeout=300) != 0:
            raise RuntimeError(f"{p}: resumed run rc {proc.returncode}: "
                               f"{child_error(dirs[p])}")
    report["resume_wall_s"] = time.perf_counter() - t0
    for p in RESUME_PAIRS:
        rows = read_rows(os.path.join(dirs[p], "run_rep0"))
        resumed_from = [r["resumed_from"] for r in rows
                        if "resumed_from" in r]
        stamped = sorted({r["round"] for r in rows if r.get("resumed")})
        got, nxt = RoundCheckpointer(os.path.join(
            dirs[p], "run_rep0", "ckpt")).restore_raw()
        want, _ = RoundCheckpointer(os.path.join(
            dirs[p] + "_uninterrupted", "run_rep0", "ckpt")).restore_raw()
        err = max_abs_err(got, want)
        report[p].update(resumed_from=resumed_from, stamped_rounds=stamped,
                         final_checkpoint_round=nxt - 1,
                         composite=sorted(got), banks=sorted(got.get(
                             "bank", {})), max_abs_err_vs_uninterrupted=err,
                         allowed=spread)
        ok = (len(resumed_from) == 1 and 4 <= resumed_from[0] < 6
              and {r["round"] for r in rows if "round" in r} == set(range(6))
              and stamped == list(range(resumed_from[0], 6)) and nxt == 6
              and err <= spread
              and (p != "bulk_int8" or "ef_residual" in got.get("bank", {})))
        if not ok:
            record_line(card, metric="crash_and_resume", **report)
            raise RuntimeError(f"crash and resume, {p}: {report[p]}")
    record_line(card, metric="crash_and_resume", **report)


def harness_phase(card: str) -> int:
    """Phase 10: (a)-(d), (d)'s first half beside (a) and (b). Returns
    the flash kernels' launches in it (0)."""
    from fedml_tpu_torch.data import load_dataset
    from fedml_tpu_torch.ops.flash_attention import flash_attention

    flash_attention.launches = 0
    flash_attention.mma_launches = 0
    t0 = time.perf_counter()
    killed = KilledRuns()
    try:
        data = load_dataset(resnet_config().data)
        s2d = s2d_headline(card, data)
        s2d_exact_parity(card, data)
        report = killed.finish()
        r56, state, spread = fused_equals_unfused(card, data)
        state = sync_free_block(card, r56, state)
        fused_rates(card, r56, state, s2d, data)
        del r56, s2d, state, data
        free_card()
        crash_and_resume(card, spread, killed, report)
    finally:
        killed.stop()
    launches = flash_attention.launches + flash_attention.mma_launches
    if launches != 0:
        raise RuntimeError(f"phase 10 launched flash attention {launches} "
                           "times")
    record_line(card, metric="phase10_s", value=time.perf_counter() - t0)
    return launches


# Phase 12: federated LoRA fine-tuning at the shape of bench.py's
# --lora-bench stage (_lora_sims): synthetic_stackoverflow_nwp, 64
# clients, vocab 2000 + 4, T 20; transformer_lm embed 64, 4 heads (D =
# 16), 2 layers, max_len 32; 16 clients a round, batch 16, SGD lr 0.3, 1
# epoch; LoRA rank 8, alpha 16 on q_proj and v_proj, float32.
LORA_VOCAB = 2000
LORA_RANK = 8
LORA_ROUNDS = 3
LORA_RATE_ROUNDS = 6  # the rate's samples, after a warm-up round
LORA_FULL_ROUNDS = 16  # bench.py lora_convergence_record's defaults
LORA_MAX_ROUNDS = 48
LORA_EVAL = 1e-4  # flash against full attention: loss rel., acc abs.


def lora_config(peft: str = "lora", personalize: bool = False):
    from fedml_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        FedConfig,
        ModelConfig,
        TrainConfig,
    )

    vocab = LORA_VOCAB + 4
    return ExperimentConfig(
        data=DataConfig(dataset="synthetic_stackoverflow_nwp",
                        num_clients=64, batch_size=16, seed=0),
        model=ModelConfig(
            name="transformer_lm", num_classes=vocab, input_shape=(20,),
            extra=(("embed_dim", 64), ("max_len", 32), ("num_heads", 4),
                   ("num_layers", 2), ("vocab_size", vocab))),
        train=TrainConfig(lr=0.3, epochs=1),
        fed=FedConfig(num_rounds=LORA_ROUNDS, clients_per_round=16,
                      eval_every=1, peft=peft, lora_rank=LORA_RANK,
                      lora_alpha=float(2 * LORA_RANK),
                      lora_targets=("q_proj", "v_proj"),
                      peft_personalize=personalize),
        seed=0)


def lora_sim(data, device: str = "cuda", **kw):
    """A FedAvgSim of lora_config(**kw) on ``data`` (bench.py builds the
    data once, with the 2000-word vocabulary, and hands it to each sim)."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
    from fedml_tpu_torch.models import create_model

    cfg = lora_config(**kw)
    return FedAvgSim(create_model(cfg.model, device), data, cfg, device)


def lora_wire_records(plan, variables, cohort: int = 16,
                      topk_frac: float = 0.01) -> list[dict]:
    """bench.py's lora_wire_records, analytic: the dense full-model delta
    of ``cohort`` clients a round against the adapters and head under
    topk_int8, and the compound reduction (partition times codec)."""
    from fedml_tpu_torch import peft as PF
    from fedml_tpu_torch.core.compress import CompressionSpec, wire_ratio

    cspec = CompressionSpec(method="topk_int8", topk_frac=topk_frac)
    full_mb = plan.full_wire_bytes(variables) / 1e6
    agg = plan.agg_part.trainable(variables)
    lora_mb = plan.adapter_wire_bytes(variables) / wire_ratio(cspec, agg) / 1e6
    base = {"unit": "MB/round", "analytic": True, "cohort": cohort}
    return [
        {"metric": f"wire_mb_per_round_{cohort}c_transformer_full",
         "value": round(cohort * full_mb, 4), **base, "codec": "none"},
        {"metric": f"wire_mb_per_round_{cohort}c_transformer_lora",
         "value": round(cohort * lora_mb, 4), **base,
         "codec": "topk_int8", "topk_frac": topk_frac},
        {"metric": "lora_wire_reduction_x",
         "value": round(PF.compound_wire_ratio(plan, cspec, variables), 1),
         "unit": "ratio", "analytic": True, "codec": "topk_int8",
         "topk_frac": topk_frac},
    ]


def flash_eval(model, task, variables, x, y) -> dict:
    """``variables`` evaluated through ``model``'s flash twin."""
    from fedml_tpu_torch.algorithms.base import build_evaluator

    out = build_evaluator(flash_twin(model), task)(variables, x, y)
    return {k: float(v) for k, v in out.items()}


def check_eval_agrees(name: str, flash: dict, full: dict) -> None:
    if (abs(flash["loss"] - full["loss"]) > LORA_EVAL * abs(full["loss"])
            or abs(flash["acc"] - full["acc"]) > LORA_EVAL):
        raise RuntimeError(f"{name}: flash eval {flash} != full {full}")


def lora_aggregated(card: str, data) -> tuple[int, object]:
    """(a): 3 LoRA rounds, the checks, the flash evaluation and a
    sync-debug round. Returns the float32 flash launches and the sim."""
    from fedml_tpu_torch.ops.flash_attention import flash_attention

    sim = lora_sim(data)
    state0 = sim.init()
    init_eval = sim.evaluate_global(state0)
    state, losses = state0, []
    for _ in range(LORA_ROUNDS):
        state, m = sim.run_round(state)
        losses.append(float(m["train_loss"]))
    cohort = cohort_report(sim)
    full = sim.evaluate_global(state)
    plan = sim.peft
    trainable = list(plan.part.trainable(state.variables))
    frozen0 = plan.part.frozen(state0.variables)
    frozen_same = all(torch.equal(state.variables[k], v)
                      for k, v in frozen0.items())
    carry = sorted(sim.cohort_update.graph.carry["params"])
    server_names = sorted(state.momentum)
    flash_attention.launches = 0
    flash_attention.mma_launches = 0
    flash = flash_eval(sim.model, sim.task, state.variables,
                       sim.arrays.test_x, sim.arrays.test_y)
    launches = flash_attention.launches - flash_attention.mma_launches
    mma = flash_attention.mma_launches
    before = sim.cohort_update.graph.replays
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, synced = sim.run_round(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    synced = {"train_loss": float(synced["train_loss"]),
              "cohort": cohort_report(sim, before)}
    record_line(card, metric="lora_aggregated", train_losses=losses,
                init_test_loss=init_eval["loss"], full_eval=full,
                flash_eval=flash, flash_launches=launches,
                flash_mma_launches=mma, cohort=cohort,
                frozen_leaves_at_init=frozen_same, carry_params=carry,
                server_state_params=server_names,
                round_under_sync_debug_error=synced,
                counters={k: v for k, v in sim.counters.items()
                          if k.startswith("peft.")})
    if not all(math.isfinite(x) for x in losses + [synced["train_loss"]]):
        raise RuntimeError(f"non-finite LoRA train loss: {losses}")
    if not full["loss"] < init_eval["loss"]:
        raise RuntimeError(f"LoRA test loss did not fall: "
                           f"{init_eval['loss']} -> {full['loss']}")
    if not frozen_same:
        raise RuntimeError("a frozen leaf of the server state moved")
    if carry != sorted(trainable) or server_names != sorted(trainable):
        raise RuntimeError(f"the carry {carry} or the server state "
                           f"{server_names} holds more than {trainable}")
    if launches <= 0 or mma != 0:
        raise RuntimeError(f"flash launches on the LoRA path: {launches} "
                           f"float32, {mma} 16-bit")
    check_eval_agrees("LoRA global model", flash, full)
    return launches, sim


def lora_personalized(card: str, data) -> int:
    """(b): 3 personalized rounds; the server's adapters and the rows of
    unsampled clients bit for bit as they were, one client's own model
    through the flash kernel. Returns the float32 flash launches."""
    from fedml_tpu_torch.ops.flash_attention import flash_attention
    from fedml_tpu_torch.peft import personal as PP

    sim = lora_sim(data, personalize=True)
    state = sim.init()
    plan = sim.peft
    adapters0 = plan.private.trainable(state.variables)
    rows0 = PP.init_bank(plan, state.variables, sim.arrays.num_clients)
    sampled, losses = set(), []
    for _ in range(LORA_ROUNDS):
        sampled |= set(sim._cohort(state))
        state, m = sim.run_round(state)
        losses.append(float(m["train_loss"]))
    cohort = cohort_report(sim)
    rows = sim.adapter_bank.rows
    unsampled = sorted(set(range(sim.arrays.num_clients)) - sampled)
    idle = torch.tensor(unsampled, device=sim.device)
    rows_kept = all(torch.equal(rows[k][idle], rows0[k][idle]) for k in rows)
    adapters_kept = all(torch.equal(state.variables[k], v)
                        for k, v in adapters0.items())
    client = min(sampled)
    mine = PP.personal_variables(plan, state.variables, rows, client)
    full = {k: float(v) for k, v in sim.evaluator(
        mine, sim.arrays.test_x, sim.arrays.test_y).items()}
    flash_attention.launches = 0
    flash_attention.mma_launches = 0
    flash = flash_eval(sim.model, sim.task, mine, sim.arrays.test_x,
                       sim.arrays.test_y)
    launches = flash_attention.launches - flash_attention.mma_launches
    record_line(card, metric="lora_personalized", train_losses=losses,
                cohort=cohort, sampled_clients=len(sampled),
                unsampled_rows_kept=rows_kept,
                server_adapters_at_init=adapters_kept, client=client,
                client_full_eval=full, client_flash_eval=flash,
                flash_launches=launches,
                global_eval=sim.evaluate_global(state))
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"non-finite personalized loss: {losses}")
    if not rows_kept or not unsampled:
        raise RuntimeError(f"an unsampled client's row moved "
                           f"({len(unsampled)} unsampled)")
    if not adapters_kept:
        raise RuntimeError("a private adapter reached the server state")
    if launches <= 0:
        raise RuntimeError("the personal model's evaluation launched no "
                           "flash kernel")
    check_eval_agrees(f"client {client}'s model", flash, full)
    return launches


def lora_memory(card: str, data) -> None:
    """(c): torch.cuda.max_memory_allocated over one LoRA round and one
    full fine-tuning round at the same shape (each after its capture)."""
    peaks = {}
    for peft in ("lora", "none"):
        free_card()
        sim = lora_sim(data, peft=peft)
        peaks[peft], _ = peak_round_mb(sim, sim.init())
        del sim
    record_line(card, metric="peak_round_hbm_mb_64c_stackoverflow_"
                "transformer", lora=peaks["lora"], full=peaks["none"],
                analytic=False)
    if not peaks["lora"] < peaks["none"]:
        raise RuntimeError(f"the LoRA round's peak is not below the full "
                           f"round's: {peaks}")


def lora_bench_records(card: str, data, sim) -> None:
    """(d): bench.py's --lora-bench records under its names: the wire
    records, the round rate (``sim``, already captured: the median of
    LORA_RATE_ROUNDS rounds after a warm-up) and the rounds LoRA needs to
    reach 95% of the test accuracy 16 full rounds reach."""
    state = sim.init()
    for rec in lora_wire_records(sim.peft, state.variables):
        record_line(card, **rec)
    state, _, _ = timed_round(sim, state)
    times = []
    for _ in range(LORA_RATE_ROUNDS):
        state, m, dt = timed_round(sim, state)
        times.append(dt)
    record_line(card,
                metric="fedavg_rounds_per_sec_64c_stackoverflow_"
                       "transformer_lora",
                value=1.0 / statistics.median(times), unit="rounds/s",
                round_seconds=times, peft="lora", lora_rank=LORA_RANK,
                lora_targets=["q_proj", "v_proj"],
                note="smoke figure: host clock around each round, ending "
                     "in a synchronize")
    full = lora_sim(data, peft="none")
    fstate = full.init()
    for _ in range(LORA_FULL_ROUNDS):
        fstate, _ = full.run_round(fstate)
    full_acc = full.evaluate_global(fstate)["acc"]
    target = 0.95 * full_acc
    lora = lora_sim(data)
    state, used, acc = lora.init(), LORA_MAX_ROUNDS, 0.0
    for r in range(LORA_MAX_ROUNDS):
        state, _ = lora.run_round(state)
        acc = lora.evaluate_global(state)["acc"]
        if acc >= target:
            used = r + 1
            break
    record_line(card, metric="rounds_to_match_full_transformer_lora",
                value=used, unit="rounds", reached=acc >= target,
                target_acc=target, full_acc=full_acc,
                full_rounds=LORA_FULL_ROUNDS, lora_acc=acc)


def peft_phase(card: str) -> int:
    """Phase 12: (a)-(d). Returns the float32 flash launches of the
    evaluations of (a) and (b), the PEFT path's."""
    from fedml_tpu_torch.data.natural import synthetic_stackoverflow_nwp
    from fedml_tpu_torch.ops.flash_attention import flash_attention

    t0 = time.perf_counter()
    data = synthetic_stackoverflow_nwp(num_clients=64, vocab_size=LORA_VOCAB,
                                       seed=0)
    launches, sim = lora_aggregated(card, data)
    launches += lora_personalized(card, data)
    flash_attention.launches = 0
    flash_attention.mma_launches = 0
    lora_bench_records(card, data, sim)
    del sim
    lora_memory(card, data)
    if flash_attention.launches != 0:
        raise RuntimeError("phase 12's rounds and records launched flash "
                           "attention")
    record_line(card, metric="phase12_s", value=time.perf_counter() - t0)
    return launches


# phase 13: bench.py's --fedgdkd and --fedgdkd-scale stages
FEDGDKD_ROUNDS = 3
FEDGDKD_RATE_ROUNDS = 6
FEDGDKD_SCALE = dict(num_clients=50, cpr=25, n_train=30000)
# the CPU parity test's band (tests/test_torch_gan.py ROUND: the JAX
# package's own band between its fused and vmapped GAN updates)
GAN_BAND = dict(atol=1e-5, rtol=1e-4)
GAN_FIRST_STEP = 1e-3


def fedgdkd_config(num_clients: int = 10, cpr: int = 10):
    """bench.py build_fedgdkd_sim's configuration: cnn_medium and the
    conditional generator at GanConfig's defaults (nz 100, ngf 64, adam
    1e-3, kd_alpha 0.8, 5 KD epochs, T 4, a distillation set of 1024) on
    fake_mnist, hetero 0.1, batch 32, SGD lr 0.03, 5 epochs, cohort_groups
    5, float32."""
    from fedml_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        FedConfig,
        GanConfig,
        ModelConfig,
        TrainConfig,
    )

    return ExperimentConfig(
        data=DataConfig(dataset="fake_mnist", num_clients=num_clients,
                        partition_method="hetero", partition_alpha=0.1,
                        batch_size=32, seed=0),
        model=ModelConfig(name="cnn_medium", num_classes=10,
                          input_shape=(28, 28, 1)),
        train=TrainConfig(lr=0.03, epochs=5, cohort_groups=5),
        fed=FedConfig(num_rounds=FEDGDKD_ROUNDS, clients_per_round=cpr,
                      eval_every=10**9),
        gan=GanConfig(), seed=0)


def fedgdkd_sim(cfg, n_train: int, device: str = "cuda", n_test: int = 1000,
                **hooks):
    from fedml_tpu_torch.algorithms.gan_family import FedGDKDSim
    from fedml_tpu_torch.data.loaders import make_fake_image_dataset
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.models.gan import generator_from_config

    data = make_fake_image_dataset("mnist", cfg.data, n_train=n_train,
                                   n_test=n_test)
    h, _, c = cfg.model.input_shape
    gen = generator_from_config(cfg.gan, cfg.model.num_classes, h, c,
                                device=device)
    return FedGDKDSim(gen, create_model(cfg.model, device), data, cfg,
                      device, **hooks)


def gan_replays(sim) -> tuple[int, int]:
    return sim.gan_update.graph.replays, sim.kd_update.graph.replays


def gan_report(sim, before=(0, 0)) -> dict:
    """The last round's groups (clients, steps an epoch), the adversarial
    and distillation graphs' replays since ``before``; raises unless both
    phases ran as graph replays."""
    adv, kd = (now - was for now, was in zip(gan_replays(sim), before))
    report = {"groups": [{"clients": n, "steps_per_epoch": st}
                         for n, st in sim.last_groups],
              "adversarial_replays": adv, "kd_replays": kd,
              "group_steps_last_round": sim.cfg.train.epochs * sum(
                  st for _, st in sim.last_groups),
              "drift_corrected_last_round": sim.last_drift}
    print(json.dumps({"fedgdkd_cohort": report}), flush=True)
    if sim.gan_update.graph.graph is None or adv <= 0 or kd <= 0:
        raise RuntimeError(f"FedGDKD did not run as graph replays: {report}")
    return report


def gan_rounds(sim, state, rounds: int):
    """``rounds`` rounds, each timed on the host clock ending in a
    synchronize; returns the state, the losses as floats and the times."""
    losses, times = [], []
    for _ in range(rounds):
        state, m, dt = timed_round(sim, state)
        losses.append({k: float(v) for k, v in m.items()})
        times.append(dt)
    if not all(math.isfinite(v) for row in losses for v in row.values()):
        raise RuntimeError(f"non-finite FedGDKD loss: {losses}")
    return state, losses, times


def fedgdkd_bench(card: str) -> None:
    """(a): the --fedgdkd stage, 3 rounds, one more under
    set_sync_debug_mode("error"), the clients' evaluation and the round
    rate over FEDGDKD_RATE_ROUNDS more rounds."""
    cfg = fedgdkd_config()
    sim = fedgdkd_sim(cfg, 6000)
    state, losses, times = gan_rounds(sim, sim.init(), FEDGDKD_ROUNDS)
    cohort = gan_report(sim)
    before = gan_replays(sim)
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = sim.run_round(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    synced = {"losses": {k: float(v) for k, v in m.items()},
              "cohort": gan_report(sim, before)}
    kd_steps = sim.cfg.gan.kd_epochs * sim.synth_size // sim.batch_size
    if (synced["cohort"]["adversarial_replays"]
            != synced["cohort"]["group_steps_last_round"]
            or synced["cohort"]["kd_replays"] != kd_steps):
        raise RuntimeError(f"replays are not one per step: {synced}")
    ev = sim.evaluate_clients(state)
    if not all(0.0 <= a <= 1.0 for a in ev["per_client_acc"]):
        raise RuntimeError(f"client accuracies outside [0, 1]: {ev}")
    state, _, rate_times = gan_rounds(sim, state, FEDGDKD_RATE_ROUNDS)
    print(json.dumps({"fedgdkd_10c": {
        "per_round": losses, "round_seconds": times,
        "round_under_sync_debug_error": synced, "cohort": cohort,
        "synth_size": sim.synth_size, "test_acc": ev["test_acc"],
        "test_loss": ev["test_loss"], "card": card}}), flush=True)
    record_line(card, metric="fedgdkd_rounds_per_sec_10c_mnist_cnn_medium",
                value=FEDGDKD_RATE_ROUNDS / sum(rate_times),
                unit="rounds/s", round_seconds=rate_times,
                note="smoke figure: host clock around each of 6 rounds "
                     "after 4, each ending in a synchronize")


def fedgdkd_scale(card: str) -> None:
    """(b): the --fedgdkd-scale stage (50 clients, 25 a round, 30,000
    samples), 3 rounds: from round 1 the cohort has new joiners, which the
    drift correction distills; the classifiers of the clients a round did
    not sample stay bit for bit."""
    cfg = fedgdkd_config(FEDGDKD_SCALE["num_clients"], FEDGDKD_SCALE["cpr"])
    sim = fedgdkd_sim(cfg, FEDGDKD_SCALE["n_train"])
    state = sim.init()
    rows = []
    for r in range(FEDGDKD_ROUNDS):
        before = {k: v.clone() for k, v in state.cls_stack.items()}
        state, losses, (dt,) = gan_rounds(sim, state, 1)
        idle = torch.nonzero(~state.prev_sampled).flatten().cuda()
        moved = [k for k, v in state.cls_stack.items()
                 if not torch.equal(v[idle], before[k][idle])]
        if moved:
            raise RuntimeError(f"round {r} changed unsampled classifiers: "
                               f"{moved}")
        rows.append({"round": r, **losses[0], "seconds": dt,
                     "drift_corrected": sim.last_drift,
                     "groups": sim.last_groups})
    drifted = int(sim.counters["fedgdkd.drift_corrected"])
    print(json.dumps({"fedgdkd_50c_sampled25": {
        "per_round": rows, "drift_corrected": drifted, "card": card}}),
        flush=True)
    if drifted == 0:
        raise RuntimeError("the sampled cohorts had no new joiner")
    record_line(card,
                metric="fedgdkd_rounds_per_sec_50c_sampled25_mnist_cnn_medium",
                value=2 / (rows[1]["seconds"] + rows[2]["seconds"]),
                unit="rounds/s",
                round_seconds=[row["seconds"] for row in rows],
                note="smoke figure: rounds 1-2 (round 0 captures the "
                     "graphs; each new drift-correction cohort size "
                     "captures one), host clock ending in a synchronize")


def gan_state_err(x, y) -> tuple[float, float]:
    """Max |x - y| over the float leaves of two FedGDKD states, and the
    band's use, max |x - y| / (atol + rtol |y|) (above 1: outside)."""
    err = use = 0.0
    for a, b in zip(tree_tensors(x), tree_tensors(y)):
        if not b.is_floating_point():
            if not torch.equal(a.cpu(), b.cpu()):
                raise RuntimeError("card and CPU disagree on an integer leaf")
            continue
        d = (a.cpu() - b.cpu()).abs()
        err = max(err, d.max().item())
        use = max(use, (d / (GAN_BAND["atol"] + GAN_BAND["rtol"]
                             * b.cpu().abs())).max().item())
    return err, use


def tree_tensors(state) -> list:
    from fedml_tpu_torch.core import tree as T

    return [v for v in T.tree_leaves(tuple(state)) if torch.is_tensor(v)]


def fedgdkd_card_vs_cpu(device: str = "cuda",
                        gen_optimizer: str = "adam") -> dict:
    """(c): two rounds at the CPU parity test's tiny configuration (4
    clients, 2 a round, cnn_small, nz 16, ngf 8, batch 8, a set of 16,
    one KD epoch; the generator's optimizer ``gen_optimizer``) on
    ``device`` and on the CPU, float32 with TF32 off and
    cuDNN deterministic, from the same variables and the same draws (both
    made on the CPU). Every leaf of the state must agree within GAN_BAND;
    where one does not, the first adversarial step must agree within
    GAN_FIRST_STEP and the rounds within SPREAD_FACTOR times the CPU's own
    spread under a PERTURB relative change of the starting variables."""
    from fedml_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        FedConfig,
        GanConfig,
        ModelConfig,
        TrainConfig,
    )
    from fedml_tpu_torch.core import random as R

    cfg = ExperimentConfig(
        data=DataConfig(dataset="fake_mnist", num_clients=4,
                        partition_method="hetero", partition_alpha=0.3,
                        batch_size=8, seed=0),
        model=ModelConfig(name="cnn_small", num_classes=10,
                          input_shape=(28, 28, 1)),
        train=TrainConfig(lr=0.05, epochs=1),
        fed=FedConfig(num_rounds=2, clients_per_round=2),
        gan=GanConfig(nz=16, ngf=8, distillation_size=16, kd_epochs=1,
                      gen_optimizer=gen_optimizer),
        seed=1)
    cpu_draws = R.DeviceDraws({"gan_z": 1, "gan_labels": 1, "synth": 1},
                              "cpu", high={"gan_labels": 10})

    def sim_on(dev):
        return fedgdkd_sim(cfg, 96, dev, n_test=32, draws=lambda *a: {
            k: v.to(dev) for k, v in cpu_draws(*a).items()})

    deterministic = torch.backends.cudnn.deterministic
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        t0 = time.perf_counter()
        cpu, card = sim_on("cpu"), sim_on(device)
        start = cpu.init()
        want = rounds_of(cpu, start)
        got = rounds_of(card, moved_state(start, device))
        errs = [gan_state_err(g, w) for g, w in zip(got, want)]
        report = {"rounds": [{"max_abs_err": e, "band_use": u}
                             for e, u in errs], **GAN_BAND,
                  "drift_corrected": int(card.counters[
                      "fedgdkd.drift_corrected"])}
        if max(u for _, u in errs) > 1.0:
            report.update(gan_spread_check(cpu, card, start, want, got))
        report["seconds"] = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.benchmark = benchmark
    return report


def rounds_of(sim, start, n: int = 2) -> list:
    """The states after each of ``n`` rounds from ``start``."""
    state, out = start, []
    for _ in range(n):
        state, _ = sim.run_round(state)
        out.append(state)
    return out


def moved_state(state, device, perturb: float = 0.0):
    """A FedGDKD state on ``device``, its float tensors scaled by 1 +
    ``perturb`` x a seeded standard normal draw."""
    from fedml_tpu_torch.core import tree as T

    gen = torch.Generator().manual_seed(0)

    def one(v):
        if perturb and v.is_floating_point():
            v = v * (1 + perturb * torch.randn(v.shape, generator=gen))
        return v.to(device)

    return state._replace(gen_vars=T.tree_map(one, state.gen_vars),
                          cls_stack=T.tree_map(one, state.cls_stack),
                          prev_synth_x=one(state.prev_synth_x),
                          prev_synth_y=one(state.prev_synth_y),
                          prev_teacher=one(state.prev_teacher))


def first_gan_step(sim, state):
    """One adversarial step of round 0's cohort from ``state``: the
    lanes' generators and classifiers, on the CPU."""
    cohort = torch.as_tensor(sim.sampler(0, sim.arrays.num_clients,
                                         sim.cfg.fed.clients_per_round))
    ids = cohort.to(sim.device)
    a, b = sim.arrays, sim.batch_size
    orders = torch.stack([torch.stack(list(sim.batch_orders(0, c)))
                          for c in cohort.tolist()]).long().to(sim.device)
    shape = (1, sim.steps_per_epoch, b)
    z = sim.draws("gan_z", 0, cohort.tolist(), {"z": shape + (sim.gen.nz,)})
    labels = sim.draws("gan_labels", 0, cohort.tolist(), {"labels": shape})
    g, d, _, _ = sim.gan_update(
        state.gen_vars, {k: v.index_select(0, ids)
                         for k, v in state.cls_stack.items()},
        a.idx.index_select(0, ids), a.mask.index_select(0, ids), a.x, a.y,
        orders[:, :1], z["z"], labels["labels"].long(), 1)
    return {k: v.cpu() for k, v in {**g, **d}.items()}


def gan_spread_check(cpu, card, start, want, got) -> dict:
    """The fallback of (c): the first adversarial step of round 0's cohort
    within GAN_FIRST_STEP, then the rounds' card-vs-CPU error within
    SPREAD_FACTOR times the CPU's against itself from perturbed starting
    variables."""
    steps = [first_gan_step(cpu, start),
             first_gan_step(card, moved_state(start, card.device))]
    first = max((steps[1][k] - v).abs().max().item()
                for k, v in steps[0].items())
    perturbed = rounds_of(cpu, moved_state(start, "cpu", PERTURB))
    row = {"first_step_max_abs_err": first,
           "card_vs_cpu": max(gan_state_err(g, w)[0]
                              for g, w in zip(got, want)),
           "cpu_spread": max(gan_state_err(p, w)[0]
                             for p, w in zip(perturbed, want)),
           "spread_factor": SPREAD_FACTOR}
    if (first > GAN_FIRST_STEP
            or row["card_vs_cpu"] > SPREAD_FACTOR * row["cpu_spread"]):
        raise RuntimeError(f"FedGDKD card vs CPU outside the band and the "
                           f"spread: {row}")
    return row


def fedgdkd_phase(card: str) -> int:
    """Phase 13: (a)-(d). Returns the flash kernels' launches over it
    (0: FedGDKD has no attention)."""
    from fedml_tpu_torch.ops.flash_attention import flash_attention

    t0 = time.perf_counter()
    flash_attention.launches = 0
    flash_attention.mma_launches = 0
    fedgdkd_bench(card)
    free_card()
    fedgdkd_scale(card)
    free_card()
    parity = fedgdkd_card_vs_cpu()
    print(json.dumps({"fedgdkd_card_vs_cpu": parity}), flush=True)
    launches = flash_attention.launches + flash_attention.mma_launches
    if launches != 0:
        raise RuntimeError(f"phase 13 launched flash attention {launches} "
                           "times")
    record_line(card, metric="phase13_s", value=time.perf_counter() - t0)
    return launches


# phase 14: the rest of the GAN family at the --fedgdkd data configuration
GAN_FAMILY = ("fedgan", "feddtg", "fedssgan", "feduagan")
GAN_FAMILY_ROUNDS = 3
GAN_FAMILY_RATE_ROUNDS = 4
# the discriminator each algorithm runs, for its rate's name
GAN_FAMILY_DISC = {"fedgan": "acgan", "feddtg": "acgan_cnn_medium",
                   "fedssgan": "acgan_nohead", "feduagan": "acgan"}
# a FedGAN round's peak may exceed a FedGDKD round's by this much at most
# (its dropout masks, drawn a group at a time, about 0.4 GB a group)
GAN_MASK_HEADROOM_MB = 3000.0
# the CPU parity test's discriminator (tests/test_torch_gan_family.py)
TINY_FEATURES = (8, 16)
TINY_GEN_LR = {"fedssgan": 1e-5}


def gan_family_sim(algo: str, cfg, n_train: int, device: str = "cuda",
                   n_test: int = 1000, features=(32, 64, 128), **hooks):
    """``algo``'s sim as the harness builds it (``experiments/harness.py``
    ``_build_gan``): the conditional generator of ``cfg.gan``, the ACGAN
    discriminator at ``features`` with dropout 0.25 (without its validity
    head for FedSSGAN), FedDTG's classifier from ``cfg.model``."""
    from fedml_tpu_torch.algorithms.gan_family import FedDTGSim, FedGANSim
    from fedml_tpu_torch.algorithms.sgan import FedSSGANSim, FedUAGANSim
    from fedml_tpu_torch.data.loaders import make_fake_image_dataset
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.models.gan import (
        acgan_discriminator,
        generator_from_config,
    )

    data = make_fake_image_dataset("mnist", cfg.data, n_train=n_train,
                                   n_test=n_test)
    shape = tuple(cfg.model.input_shape)
    k = cfg.model.num_classes
    gen = generator_from_config(cfg.gan, k, shape[0], shape[-1],
                                device=device)
    disc = acgan_discriminator(k, shape, features,
                               validity_head=algo != "fedssgan",
                               device=device)
    if algo == "fedgan":
        return FedGANSim(gen, disc, data, cfg, device, **hooks)
    if algo == "feddtg":
        return FedDTGSim(gen, disc, create_model(cfg.model, device), data,
                         cfg, device, **hooks)
    if algo == "fedssgan":
        return FedSSGANSim(gen, disc, data, cfg, device, **hooks)
    hooks.pop("sampler", None)
    return FedUAGANSim(gen, disc, data, cfg, device, **hooks)


def gan_family_graphs(sim) -> dict:
    """The sim's graphs by phase: the local phase's, and FedDTG's
    distillation's."""
    local = (getattr(sim, "disc_update", None)
             or getattr(sim, "dtg_update", None) or sim.gan_update)
    graphs = {"local": local.graph}
    if hasattr(sim, "kd_update"):
        graphs["kd"] = sim.kd_update.graph
    return graphs


def gan_family_report(algo: str, sim, before=None) -> dict:
    """The last round's groups and each graph's replays since ``before``;
    raises unless every phase ran as graph replays."""
    graphs = gan_family_graphs(sim)
    replays = {k: g.replays - (before or {}).get(k, 0)
               for k, g in graphs.items()}
    epochs = 1 if algo == "feduagan" else sim.cfg.train.epochs
    report = {"algorithm": algo,
              "groups": [{"clients": n, "steps_per_epoch": st}
                         for n, st in sim.last_groups],
              "replays": replays,
              "group_steps_last_round": epochs * sum(
                  st for _, st in sim.last_groups)}
    print(json.dumps({"gan_family_cohort": report}), flush=True)
    if any(g.graph is None for g in graphs.values()) or min(
            replays.values()) <= 0:
        raise RuntimeError(f"{algo} did not run as graph replays: {report}")
    return report


def gan_family_rounds(algo: str, sim, state, rounds: int):
    losses, times = [], []
    for _ in range(rounds):
        state, m, dt = timed_round(sim, state)
        losses.append({k: float(v) for k, v in m.items()})
        times.append(dt)
    if not all(math.isfinite(v) for row in losses for v in row.values()):
        raise RuntimeError(f"non-finite {algo} loss: {losses}")
    return state, losses, times


def gan_family_bench(algo: str, card: str) -> None:
    """(a): 3 rounds, one more under set_sync_debug_mode("error") with one
    replay per group-step (and per distillation step), then the round
    rate over GAN_FAMILY_RATE_ROUNDS more."""
    import dataclasses

    cfg = fedgdkd_config()
    cfg = dataclasses.replace(cfg, fed=dataclasses.replace(
        cfg.fed, algorithm=algo))
    sim = gan_family_sim(algo, cfg, 6000)
    state, losses, times = gan_family_rounds(algo, sim, sim.init(),
                                             GAN_FAMILY_ROUNDS)
    cohort = gan_family_report(algo, sim)
    before = {k: g.replays for k, g in gan_family_graphs(sim).items()}
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = sim.run_round(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    synced = {"losses": {k: float(v) for k, v in m.items()},
              "cohort": gan_family_report(algo, sim, before)}
    want = {"local": synced["cohort"]["group_steps_last_round"]}
    if "kd" in synced["cohort"]["replays"]:
        want["kd"] = sim.cfg.gan.kd_epochs * sim.synth_size // sim.batch_size
    if synced["cohort"]["replays"] != want:
        raise RuntimeError(f"{algo}: replays are not one per step: "
                           f"{synced} against {want}")
    record = {"per_round": losses, "round_seconds": times,
              "round_under_sync_debug_error": synced, "cohort": cohort,
              "card": card}
    if hasattr(sim, "evaluate_clients"):
        ev = sim.evaluate_clients(state)
        if not all(0.0 <= a <= 1.0 for a in ev["per_client_acc"]):
            raise RuntimeError(f"client accuracies outside [0, 1]: {ev}")
        record.update(test_acc=ev["test_acc"], test_loss=ev["test_loss"])
    if hasattr(sim, "sample_images"):
        imgs = sim.sample_images(state, 16)
        if not (imgs.shape == (16, 28, 28, 1)
                and bool(torch.all(imgs.abs() <= 1.0))):
            raise RuntimeError(f"{algo}: bad image grid {imgs.shape}")
    if hasattr(sim, "generate_synthetic_dataset"):
        x, pseudo, keep = sim.generate_synthetic_dataset(state, 64)
        record["synthetic_kept"] = int(keep.sum())
        if x.shape != (64, 28, 28, 1) or not bool(torch.all(
                (pseudo >= 0) & (pseudo < 10))):
            raise RuntimeError(f"{algo}: bad synthetic set")
    state, _, rate_times = gan_family_rounds(algo, sim, state,
                                             GAN_FAMILY_RATE_ROUNDS)
    print(json.dumps({f"{algo}_10c": record}), flush=True)
    record_line(card, metric=f"{algo}_rounds_per_sec_10c_mnist_"
                             f"{GAN_FAMILY_DISC[algo]}",
                value=GAN_FAMILY_RATE_ROUNDS / sum(rate_times),
                unit="rounds/s", round_seconds=rate_times,
                note=f"smoke figure: host clock around each of "
                     f"{GAN_FAMILY_RATE_ROUNDS} rounds after "
                     f"{GAN_FAMILY_ROUNDS + 1}, each ending in a "
                     "synchronize")


def tiny_gan_config(algo: str):
    """The CPU parity test's configuration (tests/test_torch_gan_family.py
    tiny_cfg): 4 clients, hetero 0.3, 2 a round, cnn_small, nz 16, ngf 8,
    batch 8, a set of 16, one KD epoch."""
    from fedml_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        FedConfig,
        GanConfig,
        ModelConfig,
        TrainConfig,
    )

    return ExperimentConfig(
        data=DataConfig(dataset="fake_mnist", num_clients=4,
                        partition_method="hetero", partition_alpha=0.3,
                        batch_size=8, seed=0),
        model=ModelConfig(name="cnn_small", num_classes=10,
                          input_shape=(28, 28, 1)),
        train=TrainConfig(lr=0.05, epochs=1),
        fed=FedConfig(algorithm=algo, num_rounds=2, clients_per_round=2),
        gan=GanConfig(nz=16, ngf=8, distillation_size=16, kd_epochs=1,
                      gen_lr=TINY_GEN_LR.get(algo, 1e-3)),
        seed=1)


# the fields of a GAN-family state that hold model variables
MODEL_FIELDS = ("gen_vars", "disc_vars", "disc_stack", "cls_stack")


def move_state(state, device, perturb: float = 0.0):
    """A GAN-family state on ``device``, the float tensors of its models
    (MODEL_FIELDS) scaled by 1 + ``perturb`` x a seeded standard normal
    draw."""
    from fedml_tpu_torch.core import tree as T

    gen = torch.Generator().manual_seed(0)

    def one(v, scale):
        if scale and v.is_floating_point():
            v = v * (1 + perturb * torch.randn(v.shape, generator=gen))
        return v.to(device)

    out = {}
    for name, f in state._asdict().items():
        scale = perturb and name in MODEL_FIELDS
        out[name] = (T.tree_map(lambda v: one(v, scale), f)
                     if isinstance(f, dict)
                     else one(f, scale) if torch.is_tensor(f) else f)
    return type(state)(**out)


def gan_family_card_vs_cpu(algo: str, device: str = "cuda") -> dict:
    """(c): two rounds at the CPU parity test's configuration on
    ``device`` and on the CPU, float32 with TF32 off and cuDNN
    deterministic, from the same variables and the same draws, dropout
    masks included (all made on the CPU). Every leaf of the state within
    GAN_BAND; where one is not, a round of one adversarial step a client
    (``steps_per_epoch`` 1) within GAN_FIRST_STEP and the two rounds
    within SPREAD_FACTOR times the CPU's own spread under a PERTURB
    relative change of the starting variables."""
    from fedml_tpu_torch.core import random as R

    cfg = tiny_gan_config(algo)
    cpu_draws = R.DeviceDraws(
        {"gan_z": 1, "gan_labels": 1, "synth": 1, "dropout": 1}, "cpu",
        high={"gan_labels": 10}, p={"dropout": 0.75})

    def sim_on(dev):
        return gan_family_sim(algo, cfg, 96, dev, n_test=32,
                              features=TINY_FEATURES, draws=lambda *a: {
                                  k: v.to(dev)
                                  for k, v in cpu_draws(*a).items()})

    deterministic = torch.backends.cudnn.deterministic
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        t0 = time.perf_counter()
        cpu, card = sim_on("cpu"), sim_on(device)
        start = cpu.init()
        want = rounds_of(cpu, start)
        got = rounds_of(card, move_state(start, device))
        errs = [gan_state_err(g, w) for g, w in zip(got, want)]
        report = {"algorithm": algo,
                  "rounds": [{"max_abs_err": e, "band_use": u}
                             for e, u in errs], **GAN_BAND}
        if max(u for _, u in errs) > 1.0:
            one = [sim_on(d) for d in ("cpu", device)]
            for sim in one:
                sim.steps_per_epoch = 1
            first = gan_state_err(
                rounds_of(one[1], move_state(start, device), 1)[0],
                rounds_of(one[0], start, 1)[0])[0]
            perturbed = rounds_of(cpu, move_state(start, "cpu", PERTURB))
            row = {"first_step_max_abs_err": first,
                   "card_vs_cpu": max(e for e, _ in errs),
                   "cpu_spread": max(gan_state_err(p, w)[0]
                                     for p, w in zip(perturbed, want)),
                   "spread_factor": SPREAD_FACTOR}
            report.update(row)
            if (first > GAN_FIRST_STEP or row["card_vs_cpu"]
                    > SPREAD_FACTOR * row["cpu_spread"]):
                raise RuntimeError(f"{algo} card vs CPU outside the band "
                                   f"and the spread: {report}")
        report["seconds"] = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.benchmark = benchmark
    return report


def gan_peak_mb(sim) -> float:
    """``torch.cuda.max_memory_allocated`` over one round in MB, after a
    warm-up round (the captures)."""
    state, _ = sim.run_round(sim.init())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, m = sim.run_round(state)
    torch.cuda.synchronize()
    if not all(math.isfinite(float(v)) for v in m.values()):
        raise RuntimeError(f"memory round: {m}")
    return torch.cuda.max_memory_allocated() / 1e6


def gan_family_memory(card: str) -> None:
    """(b): a FedGAN round's peak beside a FedGDKD round's at the same
    configuration; FedGAN's may exceed it by GAN_MASK_HEADROOM_MB at
    most."""
    import dataclasses

    peaks = {}
    for algo in ("fedgdkd", "fedgan"):
        free_card()
        cfg = fedgdkd_config()
        cfg = dataclasses.replace(cfg, fed=dataclasses.replace(
            cfg.fed, algorithm=algo))
        sim = (fedgdkd_sim(cfg, 6000) if algo == "fedgdkd"
               else gan_family_sim(algo, cfg, 6000))
        peaks[algo] = gan_peak_mb(sim)
        del sim
    record_line(card, metric="peak_round_hbm_mb_10c_mnist_fedgan",
                value=peaks["fedgan"], fedgdkd=peaks["fedgdkd"],
                unit="MB", analytic=False,
                note="torch.cuda.max_memory_allocated over one round after "
                     "a warm-up round")
    if peaks["fedgan"] > peaks["fedgdkd"] + GAN_MASK_HEADROOM_MB:
        raise RuntimeError(f"FedGAN's round peaks too high: {peaks}")


def gan_family_phase(card: str) -> int:
    """Phase 14: (a)-(d). Returns the flash kernels' launches over it
    (0: the GAN family has no attention)."""
    from fedml_tpu_torch.ops.flash_attention import flash_attention

    t0 = time.perf_counter()
    flash_attention.launches = 0
    flash_attention.mma_launches = 0
    for algo in GAN_FAMILY:
        gan_family_bench(algo, card)
        free_card()
    gan_family_memory(card)
    free_card()
    for algo in GAN_FAMILY:
        print(json.dumps({"gan_family_card_vs_cpu":
                          gan_family_card_vs_cpu(algo)}), flush=True)
    launches = flash_attention.launches + flash_attention.mma_launches
    if launches != 0:
        raise RuntimeError(f"phase 14 launched flash attention {launches} "
                           "times")
    record_line(card, metric="phase14_s", value=time.perf_counter() - t0)
    return launches


def kernel_entry(name, source, launches, by_path, rows, row,
                 note=None) -> dict:
    """One entry of the "kernels" line: the timed ``row``'s numbers, the
    largest error over ``rows``, the launches on the entry's main path
    (``launches``) and on each path (``by_path``)."""
    entry = {
        "name": name, "route": "cuda", "source": source,
        "replaces": "fedml_tpu/ops/flash_attention.py:119",
        "launches": launches,
        "launches_by_path": by_path,
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
    paths = {"resnet56": resnet_main_path(card)}
    # 7. the bench's families (no hand-written kernel on any)
    for name in FAMILY_SPECS:
        paths[name] = family_path(name, card)
    # 8. the defended, attacked and compressed round (no hand kernel)
    paths["defended_rounds"] = defended_rounds(card)
    # 9. the bulk engine and elastic buckets (no hand kernel)
    paths["bulk"] = bulk_phase(card)
    free_card()
    # 10. the s2d ResNets, fused blocks, checkpoints and resume (no hand
    # kernel)
    paths["harness"] = harness_phase(card)
    free_card()
    # 12. federated LoRA fine-tuning: its evaluations run the float32
    # kernel at head dim 16
    peft_launches = peft_phase(card)
    free_card()
    # 13. FedGDKD (no hand kernel)
    paths["fedgdkd"] = fedgdkd_phase(card)
    free_card()
    # 14. FedGAN, FedDTG, FedSSGAN and FedUAGAN (no hand kernel)
    paths["gan_family"] = gan_family_phase(card)

    # report: the float32 entry's times are at the transformer path's
    # shape, the D = 16 entry's at the LoRA path's, the tensor-core entry's
    # at long context in bf16
    source = "fedml_tpu_torch/csrc/flash_attention.cu"
    f32 = [r for r in rows if r["dtype"] == "float32"]
    half = [r for r in rows if r["dtype"] != "float32"]
    # by instance: the transformer path runs head dim 32, the LoRA path 16
    none = {"transformer_lm": 0, **paths, "peft_lora": 0}
    print(json.dumps({"kernels": [
        kernel_entry("flash_attention", source, launches,
                     {**none, "transformer_lm": launches}, f32,
                     next(r for r in f32 if r["causal"]
                          and r["shape"] == list(MAIN_SHAPE)),
                     note="the float32 body at head dim 32; its head-dim-16 "
                          "instance is the flash_attention_d16 entry"),
        kernel_entry(
            "flash_attention_d16", source, peft_launches,
            {**none, "peft_lora": peft_launches}, f32,
            next(r for r in f32 if r["shape"] == list(PEFT_SHAPE)),
            note="the float32 body's head-dim-16 instance, on the LoRA "
                 "path's global and personal evaluations (phase 12)"),
        kernel_entry(
            "flash_attention_mma", source, mma_launches,
            {**none, "transformer_lm": mma_launches}, half,
            next(r for r in half if r["causal"] and r["dtype"] == "bfloat16"
                 and r["shape"] == list(LONG_SHAPE)),
            note="bf16/fp16 only: the transformer and LoRA paths evaluate "
                 "in float32 and no other path (the defended rounds, the "
                 "bulk phase and phase 10 included) has attention, so none "
                 "launches this kernel"),
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
