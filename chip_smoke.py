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
   (10,000 clients all sampled in 313 blocks of 32, the median of 2
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
11. A "kernels" JSON line, printed after phase 20, with one entry per
   kernel instance the paths run (flash_attention, the float32 body at
   head dim 32; flash_attention_d16, its head-dim-16 instance; and
   flash_attention_mma, the bf16/fp16 body), each with its launches on
   the transformer path, on the LoRA path, on the ResNet-56 path, on each
   family, in the defended rounds, in the bulk phase, in phase 10 and on
   the FedGDKD path, on the rest of the GAN family, in phase 15, on
   the distillation path of phase 16, in phase 17, in phase 18, in phase
   19 and in phase 20 (none of them but the transformer
   and LoRA paths runs a hand-written kernel), the card's
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
   of 3 rounds after a warm-up; a smoke figure) and
   rounds_to_match_full_transformer_lora (16 full rounds, then at most
   48 LoRA rounds). The flash counters, set to 0 before (c) and (d), must
   read 0 after them.
13. FedGDKD at bench.py's --fedgdkd configuration (cnn_medium and the
   conditional generator at GanConfig's defaults on fake_mnist, 10
   clients, hetero 0.1, all sampled, batch 32, SGD lr 0.03, 5 epochs,
   cohort_groups 5, float32), each record a JSON line with the card's name
   and power limit: (a) 2 rounds (finite g_loss, d_loss and kd_loss; the
   groups, their steps and the adversarial and distillation graphs'
   replays), one more round under set_sync_debug_mode("error") (one
   replay per group-step and per distillation step), every client's
   accuracy in [0, 1], and fedgdkd_rounds_per_sec_10c_mnist_cnn_medium
   over 1 more round (a smoke figure); (b) the --fedgdkd-scale stage (50
   clients, 25 a round, 30,000 samples), 2 rounds: the drift-corrected
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
   limit: (a) for each, 1 round (finite losses; the groups, their steps
   and each graph's replays), one more under set_sync_debug_mode("error")
   with one replay per group-step (and per distillation step for
   FedDTG), the clients' accuracies in [0, 1] (FedDTG), the image grid
   (FedGAN, FedUAGAN) or the confidence-filtered synthetic set
   (FedSSGAN), then <algo>_rounds_per_sec_10c_mnist_<disc> over 1 more
   round (a smoke figure); (b) torch.cuda.max_memory_allocated over a
   FedGAN round beside a FedGDKD round's
   (peak_round_hbm_mb_10c_mnist_fedgan): at most GAN_MASK_HEADROOM_MB
   more; (c) for each, two rounds at the CPU parity test's configuration
   (tests/test_torch_gan_family.py) on the card and on the CPU from the
   same variables, draws and dropout masks (TF32 off, cuDNN
   deterministic): every leaf within atol 1e-5, rtol 1e-4, or else a round
   of one step a client within 1e-3 and the rounds within SPREAD_FACTOR
   times the CPU's own spread; (d) the phase's seconds. The flash
   counters, set to 0 before the phase, must read 0 after it.
15. The observability planes (core/telemetry.py, perf.py, memscope.py,
   slo.py, export.py, anatomy.py), each record a JSON line with the
   card's name and power limit: (a) python -m
   fedml_tpu_torch.experiments.run at phase 6's configuration for
   OBS_ROUNDS rounds with --profile_rounds 2, --anatomy, --metrics_port
   0, an SLO, --mem_headroom_warn 0.001 and --profile_on_breach, its
   listener scraped while it runs: both capture windows hold device
   activity (busy within the window), perf.mfu in (0, 1] against the
   H100's bf16 peak, the memory plane read from the card (source
   "cuda"), exactly one mem_headroom event and one breach capture, no
   plane failed, /metrics parses and /statusz shows the round, every
   anatomy entry conserves its wall, 3 sim_round spans, one noted
   capture per build; it prints the breakdowns, round 1's top 5 kernels
   read from its trace, perf.mfu and perf.dispatch_bound_rounds; (b)
   bench.py's anatomy records (phase_share_local_c64, _c256,
   critical_path_overhead_pct) on lr, and 2 headline rounds with every
   plane on but the capture windows equal to 2 with every plane off, bit
   for bit (cuDNN deterministic for this check alone); (c) FedUAGAN at
   phase 14's configuration through the harness, 2 rounds, the first
   captured: a breakdown, perf.rounds_per_s and no perf.mfu; (d) the
   phase's seconds. The flash counters, set to 0 before the phase, must
   read 0 after it.
16. The distillation family and the dropout classifier
   (algorithms/distill.py, models/vision.py CNNDropOut), each record a
   JSON line with the card's name and power limit: (a) FedAvg over cnn
   (CNN_DropOut, its keep masks drawn a group at a time) at FAMILY_SPECS
   femnist_cnn's shape, 2 rounds, then one more under
   torch.cuda.set_sync_debug_mode("error") with one graph replay per
   group-step; (b) FedMD, FD+FAug and FedArjun at phase 13's data
   configuration with cnn (10 classes) and GanConfig's defaults: init
   (FedMD's pretraining), 2 rounds with finite metrics and the clients'
   test loss finite, every phase's graph replays counted against its
   group-steps, one round under sync debug, client accuracies in [0, 1],
   FD's teacher flags after round 1 on for every label another client
   saw, the round rate over DISTILL_RATE_ROUNDS more; a round of a cohort
   of 5 leaves FedMD's and FD's unsampled clients bit for bit; (c) FedAvg
   over cnn and each algorithm at the CPU test's configuration
   (tests/test_torch_distill.py) on the card and on the CPU from the same
   variables, draws and masks (TF32 off, cuDNN deterministic), two rounds
   (FedMD: its pretraining and two rounds) within atol 1e-5, rtol 1e-4,
   or else a round of one step a client within 1e-3 and the rounds
   within SPREAD_FACTOR times the CPU's own spread; (d) the phase's
   seconds. The flash counters, set to 0 before the phase, must read 0
   after it.
17. Heterogeneous-model FedGDKD (algorithms/hetero.py) and the dropout
   classifiers of the GAN family and the bulk engine, each record a JSON
   line with the card's name and power limit: (a) HeteroFedGDKD at phase
   13's data configuration (fake_mnist, 6,000 samples, 10 clients, hetero
   0.1, batch 32, lr 0.03, 5 epochs, GanConfig's defaults, float32) in the
   fork's cap of four buckets (cnn_small 3, cnn_medium 3, cnn_large 2,
   cnn 2), all sampled: 2 rounds, one more under
   set_sync_debug_mode("error"), each with one graph replay per
   group-step and per distillation step, every client's accuracy in
   [0, 1], the captures by bucket, phase and lane count with their static
   buffers, then hetero_fedgdkd_rounds_per_sec_10c_mnist_4arch over 1
   more round (a smoke figure); (b) the same buckets at 50 clients
   (15/15/10/10), 25 a round, 30,000 samples, 2 rounds: drift-corrected
   joiners counted in more than one bucket, the classifiers of the
   clients a round did not sample bit for bit; (c) FedGDKD and FedDTG with
   a cnn classifier at phase 13's configuration and FedAvg over cnn in
   blocks of 4 at femnist_cnn's shape: 1 round each, then one under sync
   debug with one replay per group-step (and per distillation step); (d)
   the hetero sim, FedGDKD and FedDTG over cnn and FedAvg over cnn in
   blocks of 2 at the CPU tests' configurations (tests/test_torch_hetero.py,
   tests/test_torch_dropout_gan.py) on the card and on the CPU from the
   same variables, draws and masks (TF32 off, cuDNN deterministic): every
   leaf within atol 1e-5, rtol 1e-4, or else a round of one step a client
   within 1e-3 and the rounds within SPREAD_FACTOR times the CPU's own
   spread; (e) the phase's seconds. The flash counters, set to 0 before
   the phase, must read 0 after it.
18. The rest of the model zoo with the tag and segmentation tasks and
   fedseg, then hierarchical, decentralized and online decentralized FL,
   each part a JSON line with the card's name and power limit, its lane
   groups and steps, its graph replays and its seconds a round: (a)
   fedseg (harness build_sim) over deeplab at the JAX defaults (encoder
   32/64/128, ASPP 128 at rates 1/2/4, 4 classes) on fake_seg (32x32x3,
   512 train, 64 test), 8 clients, homo, 4 a round, batch 16, SGD lr
   0.05, float32, 2 rounds: every loss finite, the last test loss below
   the initial model's, SegEvaluator's pixel accuracy, mIoU and FWIoU
   after each round; (b) vgg11, mobilenet_v3 (width 1.0) and
   efficientnet-b0 on fake_cifar10 at the headline's configuration (100
   clients, hetero 0.5, batch 32, lr 0.03, 10 a round, bf16), lenet on
   fake_mnist likewise, tag_lr on fake_stackoverflow_lr (vocab 1000, 50
   tags, 10 clients, all sampled): 2 rounds each with its parameter
   count, every loss and variable finite, then one more efficientnet-b0
   round under set_sync_debug_mode("error"); (c) hierarchical FedAvg over
   resnet56 on fake_cifar10 (bf16, batch 32, lr 0.03), 20 clients in 2
   groups of 10, 2 inner rounds, 2 rounds with a global evaluation after
   each, the test loss falling; (d) DSGD and push-sum over resnet56, 16
   clients on the ring of 2 neighbours, 2 rounds, the consensus model's
   evaluation and the consensus distance after each and the mixing's
   CUDA-event time; (e) dol_dsgd and dol_pushsum (harness build_sim) and
   push-sum on the time-varying topology on the SUSY-shaped stream (8
   nodes, 18 features, T 2000, beta 0.25, lr 0.3), each run twice, one
   graph replay an iteration, the regret below 0.7 x its 10th value; (f)
   each of (a)-(e) at its CPU test's configuration (tests/test_torch_zoo.
   py, tests/test_torch_topology.py) on the card and on the CPU from the
   same start and draws (TF32 off, cuDNN deterministic): every leaf
   within atol 1e-5, rtol 1e-4, or else within SPREAD_FACTOR times the
   CPU's own spread under a PERTURB change of the start (the zoo's
   mobilenet_v3 and efficientnet-b0 steps in float64, TINY_ZOO_X64); (g)
   the phase's seconds. The flash counters, set to 0 before the phase,
   must read 0 after it.
19. Split learning, FedNAS over DARTS, TurboAggregate's secure FedAvg and
   the local baselines, each part a JSON line with the card's name and
   power limit, at the JAX package's full widths on the headline's data
   (fake_cifar10, hetero 0.5, batch 32, lr 0.03; float32, the split sims
   and FedNAS taking no compute type; the headline's bf16 for (e) and
   (f)): (a) FedGKT (harness build_sim: the resnet8_56 edge, the
   Bottleneck [6, 6, 6] server at 16/32/64), 10 clients all training, 2
   rounds, each round's edge, server and logits seconds, the edge's
   graph replays against its group-steps and the server's against its
   sequential steps, the composed path's test accuracy; (b) SplitNN
   (convs 32/64, hidden 128) around a ring of 10 clients, 2 rounds, one
   replay a step; (c) vertical FL on fake_vfl, two parties, 5 epochs, the
   loss falling, accuracy and AUC; (d) FedNAS over DARTSNetwork's
   defaults (16 channels, 4 layers, 4 steps), 100 clients, 10 a round, 1
   round: max_memory_allocated, the alphas' largest change (above 0),
   derive_genotype; (e) TurboAggregate at the headline (resnet56, 100
   clients, 10 a round), 1 round with the field pass's host seconds apart
   from the locals, then from one state the secure round within 5e-4 of
   the plain FedAvg round and a round with client 1 dropped within 1e-6 of
   the undropped one; (f) the local baseline (all 100 clients on their own
   resnet56) and the centralized trainer over the pooled set, 1 round
   each; (g) each of (a)-(f) at its CPU test's configuration
   (tests/test_torch_split.py, _fednas.py, _mpc.py, _baselines.py) on the
   card and on the CPU from the same start and host-drawn orders (TF32
   off, cuDNN deterministic, as in (e) and (f)): every leaf within atol
   1e-5, rtol 1e-4, or else within SPREAD_FACTOR times the CPU's own
   spread (FedGKT in float64, as its CPU test, and in float32, as (a)
   runs it; the secure rounds within
   5e-4, a float32 difference in the locals moving one 2^-16 step of the
   field); (h) the phase's seconds. The flash counters, set to 0 before
   the phase, must read 0 after it.
20. Data on disk, the async buffer, per-client metrics and FID, each part
   a JSON line with the card's name and power limit. The files are the
   formats the standard library writes, in their published layouts, in a
   temporary directory removed at the end: (a) CIFAR-10's python pickles
   at 50,000/10,000 (class prototypes plus noise, seeded), the port's
   load_dataset bitwise equal to the phase's own decode, then ResNet-56
   FedAvg at bench.py build_sim's configuration through python -m
   fedml_tpu_torch.experiments.run --dataset cifar10 --data_dir, 2
   rounds: the load's host seconds, the time to the first round, each
   round's seconds, the test accuracy above chance; (b) MNIST's gzipped
   IDX at 60,000/10,000 through lr, LEAF FEMNIST's json (cut to 200
   writers of about 227 samples) through cnn, 2 rounds each, the test
   accuracy above chance, and a SUSY csv through dol_dsgd, its regret
   falling; (c) log_per_client_observability of (a)'s global model over
   all 100 clients' train and test slices, its seconds and
   max_memory_allocated, the confusion counts summed over the clients
   equal to each split's real rows; (d) one FedGDKD round at phase 13's
   data, then log_gan_round with the default scorer and with
   make_fid_scorer(train_data=...), which fits TrainedCNNEmbed on the
   card: FID(real, real) 0 up to rounding, FID(real, fake) larger, the
   grid file written; (e) 32 ResNet-56-sized deltas folded at lags 0-7
   (poly, alpha 0.5, K 32) and emitted through server_update, within
   ASYNC_BAND of a float64 weighted mean on the host, the buffer stopped
   after 13 folds, saved, loaded and finished equal to the uninterrupted
   one bit for bit, a fold's and an emit's CUDA-event time; (f) (c)'s,
   (d)'s and (e)'s functions at their CPU tests' configurations on the
   card and on the CPU from the same start, within atol 1e-5, rtol 1e-4,
   or else within SPREAD_FACTOR times the CPU's own spread; (g) the
   phase's seconds. The flash counters, set to 0 before the phase, must
   read 0 after it.
21. The synchronous deployment runtime, each part a JSON line with the
   card's name and power limit: (a) an in-process loopback world at the
   headline configuration (resnet56, fake_cifar10, 100 clients, hetero
   0.5, batch 32, lr 0.03, bf16, as python -m
   fedml_tpu_torch.experiments.run parses it): FedAvgServerActor and 10
   FedAvgClientActors sharing one LocalTrainer, 3 rounds, every loss
   finite (cuDNN deterministic); in every round each client's result
   (parameters and BatchNorm statistics) within atol 1e-5, rtol 1e-4 of
   FedAvgSim's update of that client from the round's start at a cohort
   of one (one lane, as the actor trains), and the round's global model
   within the same band of its results' float64 weighted mean; the
   trajectory against FedAvgSim on the same cohorts and orders in its
   smallest groups (2 lanes) is reported, within SPREAD_FACTOR times the
   card's own spread under a PERTURB change of the start when outside the
   band (round 0 starts both from one model, so its error is the lane
   grouping's bf16 rounding alone); (b) the same world as 11 OS
   processes (python -m fedml_tpu_torch.experiments.run --role
   server|client --backend tcp) on localhost, all on the one card: the
   seconds from the spawn to the server's first closed round, each
   round's seconds split into the aggregation, the slowest client's local
   update (with its result's copy to the host) and the rest (wire_s:
   transfers, framing, the sync's copy to the card, waiting), the
   transport's bytes a round, the final digest against
   (a)'s (equal, or within (a)'s band); (c) a loopback world of lr on
   fake_mnist with client 2 crashed by chaos at round 1: the round closed
   at its deadline over the survivors, renormalized, and a world whose
   every client crashes raising QuorumLostError; (d) (a)'s functions at
   the CPU test's configuration (tests/test_torch_deploy.py: lr,
   fake_mnist, 3 clients, 2 rounds) on the card and on the CPU from the
   same start, within (a)'s band; (e) the native tensor-frame codec in
   use, pack and unpack of a ResNet-56 payload timed against the pure
   path; (f) the phase's seconds. The flash counters, set to 0 before the
   phase, must read 0 after it. The "kernels" line comes after it.
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
    The bf16 and fp16 rows time the plain version with
    3 single calls, to keep the phase short."""
    edge_checks()
    rows = []
    for causal in (False, True):
        rows.append(kernel_vs_plain(MAIN_SHAPE, torch.float32, causal,
                                    2e-5, 2e-5, seed=0,
                                    time_plain=time_plain))
        rows.append(kernel_vs_plain(LONG_SHAPE, torch.bfloat16, causal,
                                    2e-2, 0.0, seed=1,
                                    time_plain=time_plain, plain_reps=3,
                                    plain_inner=1))
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
RATE_ROUNDS = 3  # (c): a warm-up round, then the median's samples
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
    bulk_10k_rate_record's configuration, the median of RATE_ROUNDS - 1
    rounds after a warm-up round."""
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
        fed=FedConfig(num_rounds=RATE_ROUNDS, clients_per_round=n,
                      eval_every=10**9, client_block_size=32), seed=0)
    t0 = time.perf_counter()
    data = make_fake_image_dataset("mnist", dcfg, n_train=60000)
    sim = FedAvgSim(create_model(cfg.model, device), data, cfg, device)
    setup = time.perf_counter() - t0
    state = sim.init()
    walls, losses = [], []
    for _ in range(RATE_ROUNDS):
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
                .stats["misses"], note=f"median of rounds 2-{RATE_ROUNDS}; "
                "a smoke figure (host clock ending in a synchronize)")
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
        for _ in range(2):
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
    parts = {}
    sim, state, data = bulk_headline(card, device)
    bulk_sync_round(card, sim, state, data, device)
    del sim, state, data
    free_card()
    parts["a-b"] = time.perf_counter() - t0
    for name, run in (("c", bulk_10k_rate), ("d", bulk_memory),
                      ("e", bank_memory), ("f", elastic_churn)):
        t_part = time.perf_counter()
        run(card, device)
        free_card()
        parts[name] = time.perf_counter() - t_part
    launches = flash_attention.launches + flash_attention.mma_launches
    if launches != 0:
        raise RuntimeError(f"the bulk phase launched flash attention "
                           f"{launches} times")
    print(json.dumps({"bulk_phase_s": time.perf_counter() - t0,
                      "parts_s": parts, "device": card}), flush=True)
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
    parts = {}

    def mark(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    try:
        data = load_dataset(resnet_config().data)
        s2d = s2d_headline(card, data)
        mark("a")
        s2d_exact_parity(card, data)
        mark("b")
        report = killed.finish()
        mark("d_first_half")
        r56, state, spread = fused_equals_unfused(card, data)
        state = sync_free_block(card, r56, state)
        fused_rates(card, r56, state, s2d, data)
        del r56, s2d, state, data
        free_card()
        mark("c")
        crash_and_resume(card, spread, killed, report)
        mark("d")
    finally:
        killed.stop()
    launches = flash_attention.launches + flash_attention.mma_launches
    if launches != 0:
        raise RuntimeError(f"phase 10 launched flash attention {launches} "
                           "times")
    record_line(card, metric="phase10_s", value=time.perf_counter() - t0,
                parts_s=parts)
    return launches


# Phase 12: federated LoRA fine-tuning at the shape of bench.py's
# --lora-bench stage (_lora_sims): synthetic_stackoverflow_nwp, 64
# clients, vocab 2000 + 4, T 20; transformer_lm embed 64, 4 heads (D =
# 16), 2 layers, max_len 32; 16 clients a round, batch 16, SGD lr 0.3, 1
# epoch; LoRA rank 8, alpha 16 on q_proj and v_proj, float32.
LORA_VOCAB = 2000
LORA_RANK = 8
LORA_ROUNDS = 3
LORA_RATE_ROUNDS = 3  # the rate's samples, after a warm-up round
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
FEDGDKD_ROUNDS = 2
FEDGDKD_RATE_ROUNDS = 1
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
    """(a): the --fedgdkd stage, FEDGDKD_ROUNDS rounds, one more under
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
                note=f"smoke figure: host clock around each of "
                     f"{FEDGDKD_RATE_ROUNDS} rounds after {FEDGDKD_ROUNDS + 1}, each ending in "
                     "a synchronize")


def fedgdkd_scale(card: str) -> None:
    """(b): the --fedgdkd-scale stage (50 clients, 25 a round, 30,000
    samples), FEDGDKD_ROUNDS rounds: from round 1 the cohort has new
    joiners, which the
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
                value=(len(rows) - 1) / sum(r["seconds"] for r in rows[1:]),
                unit="rounds/s",
                round_seconds=[row["seconds"] for row in rows],
                note="smoke figure: the rounds after round 0 (round 0 "
                     "captures the graphs; each new drift-correction "
                     "cohort size captures one), host clock ending in a "
                     "synchronize")


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
GAN_FAMILY_ROUNDS = 1
GAN_FAMILY_RATE_ROUNDS = 1
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
    """(a): GAN_FAMILY_ROUNDS rounds, one more under
    set_sync_debug_mode("error") with one replay per group-step (and per
    distillation step), then the round rate over GAN_FAMILY_RATE_ROUNDS
    more."""
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


# the fields of a GAN-family, distillation, split-learning or FedAvg
# state that hold model variables
MODEL_FIELDS = ("gen_vars", "disc_vars", "disc_stack", "cls_stack",
                "client_stack", "server_vars",
                "model_stack", "adapter_vars", "local_stack", "variables",
                "stacked_vars")


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
        high={"gan_labels": 10},
        p={"dropout": {f"d{i}": 0.75 for i in range(len(TINY_FEATURES))}})

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


# Phase 15: the observability planes on the card (core/telemetry.py,
# perf.py, memscope.py, slo.py, export.py, anatomy.py)

OBS_ROUNDS = 3  # (a): the headline through the CLI
OBS_PROFILED = 2  # its capture windows
OBS_SLO = "perf.round_wall_s:p99<10@60s"
OBS_HEADROOM = 0.001  # crossed at the first sample: one breach capture
OBS_BREACH_WINDOW_S = 0.1  # the breach capture closes after one round
OBS_CLI_TIMEOUT_S = 300
ANATOMY_ROUNDS = 10  # (b): bench.py anatomy_bench_records' 20, halved
ANATOMY_COHORTS = (64, 256)
INERT_ROUNDS = 2
UAGAN_ROUNDS = 2  # (c)
CONSERVE_TOL = 1e-9  # an anatomy entry's phases against its wall
_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$")


def parse_openmetrics(text: str) -> dict:
    """The exposition's families by type; raises on a line of no known
    shape, a sample without its family's ``# TYPE``, or a histogram whose
    buckets are not cumulative up to ``+Inf`` == ``_count``."""
    types, samples = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            name, kind = line[len("# TYPE "):].split(" ")
            types[name] = kind
            continue
        m = _SAMPLE.match(line)
        if m is None:
            raise RuntimeError(f"/metrics: bad line {line!r}")
        name, labels, value = m.groups()
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        if name not in types and base not in types:
            raise RuntimeError(f"/metrics: {name} has no # TYPE")
        samples.setdefault(name, []).append((labels or "", float(value)))
    for name, kind in types.items():
        if kind == "histogram":
            counts = [v for _, v in samples[f"{name}_bucket"]]
            last = samples[f"{name}_bucket"][-1][0]
            if (counts != sorted(counts) or 'le="+Inf"' not in last
                    or counts[-1] != samples[f"{name}_count"][0][1]):
                raise RuntimeError(f"/metrics: bad histogram {name}")
    return types


def scrape(port: int, path: str):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as r:
        return r.read().decode()


def watch_listener(proc, tdir: str) -> dict:
    """Scrape the child's listener until it exits: the last good
    ``/metrics`` (parsed), every ``/statusz`` run block and memory
    section, the last ``/tracez``."""
    import http.client

    seen = {"metrics": None, "runs": [], "memory": None, "tracez": None,
            "listener_s": None, "first_round_s": None, "last_round_s": None}
    port = None
    t0 = time.monotonic()
    deadline = t0 + OBS_CLI_TIMEOUT_S
    while proc.poll() is None:
        if time.monotonic() > deadline:
            raise RuntimeError("the observability CLI run timed out")
        time.sleep(0.05)
        path = os.path.join(tdir, "export_rank0.json")
        if port is None:
            if not os.path.exists(path):
                continue
            try:
                port = json.load(open(path))["port"]
            except ValueError:  # being written
                continue
            seen["listener_s"] = time.monotonic() - t0
        try:
            seen["metrics"] = parse_openmetrics(scrape(port, "/metrics"))
            status = json.loads(scrape(port, "/statusz"))
            if "run" in status:
                seen["runs"].append(status["run"])
                seen["last_round_s"] = time.monotonic() - t0
                if seen["first_round_s"] is None:
                    seen["first_round_s"] = seen["last_round_s"]
            seen["memory"] = status.get("memory") or seen["memory"]
            seen["tracez"] = json.loads(scrape(port, "/tracez"))
        except OSError:
            pass  # the listener closed with the process
        except http.client.HTTPException:
            # a response cut short (IncompleteRead): only as the listener
            # closes with the process, which then ends
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                raise RuntimeError("a listener response was cut short "
                                   "while the CLI run went on") from None
    return seen


def top_kernels(trace_path: str, n: int = 5) -> list:
    """The ``n`` kernels with the most device time in a capture, read from
    its Chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    by_name = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            t = by_name.setdefault(e["name"], [0.0, 0])
            t[0] += float(e.get("dur", 0.0))
            t[1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return [{"kernel": k[:120], "device_ms": us / 1e3, "launches": c}
            for k, (us, c) in ranked]


def obs_headline_cli(card: str, tmp: str, device: str = "cuda") -> None:
    """(a): the headline through the CLI with every plane on; raises
    unless each plane did its part on the card."""
    import dataclasses

    cfg = resnet_config()
    cfg = dataclasses.replace(cfg, fed=dataclasses.replace(
        cfg.fed, num_rounds=OBS_ROUNDS))
    cfg_path = os.path.join(tmp, "headline.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    tdir = os.path.join(tmp, "telemetry")
    argv = [sys.executable, "-m", "fedml_tpu_torch.experiments.run",
            "--config", cfg_path, "--profile_rounds", str(OBS_PROFILED),
            "--anatomy", "--metrics_port", "0", "--metrics_host",
            "127.0.0.1", "--slo", OBS_SLO, "--mem_headroom_warn",
            str(OBS_HEADROOM), "--profile_on_breach", "--profile_window_s",
            str(OBS_BREACH_WINDOW_S), "--telemetry_dir",
            tdir, "--out_dir", os.path.join(tmp, "runs"), "--run_name",
            "obs", "--device", device]
    t0 = time.perf_counter()
    with open(os.path.join(tmp, "cli.out"), "w") as out, \
            open(os.path.join(tmp, "cli.err"), "w") as err:
        proc = subprocess.Popen(
            argv, stdout=out, stderr=err,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            seen = watch_listener(proc, tdir)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        tail = open(os.path.join(tmp, "cli.err")).read()[-4000:]
        raise RuntimeError(f"the observability CLI run failed "
                           f"({proc.returncode}):\n{tail}")
    perf = json.load(open(os.path.join(tdir, "perf_rank0.json")))
    metrics = json.load(open(os.path.join(tdir, "metrics_rank0.json")))
    (flight,) = [f for f in os.listdir(tdir) if f.endswith("_run_end.json")]
    events = json.load(open(os.path.join(tdir, flight)))["events"]
    kinds = [e["kind"] for e in events]
    spans = [e.get("name") for e in json.load(open(
        os.path.join(tdir, "trace_rank0.json")))["events"]]
    profiles = os.path.join(tdir, "profiles")
    breach = sorted(d for d in os.listdir(profiles)
                    if any(f.endswith(".pt.trace.json") for f in
                           os.listdir(os.path.join(profiles, d))))
    rounds = perf["rounds"]
    g, c, h = metrics["gauges"], metrics["counters"], metrics["histograms"]
    mfu = g.get("perf.mfu")
    headroom = [e for e in events if e["kind"] == "mem_headroom"]
    entries = (seen["tracez"] or {}).get("entries", [])
    captures = h.get("mem.compile_s.step", {}).get("count", 0)
    builds = h.get("mem.compile_s.sim_round", {}).get("count", 0)
    steady = os.path.join(tdir, "torch_profile", "round1",
                          "rank0.pt.trace.json")
    record = {
        "breakdowns": [{k: b[k] for k in (
            "round", "window_s", "device_busy_s", "compute_frac",
            "collective_frac", "host_frac", "idle_frac", "n_device_ops",
            "capture_cost_s")} for b in rounds],
        "breach_cost_s": [{k: e.get(k) for k in ("stop_s", "write_s")}
                          for e in events if e["kind"] ==
                          "breach_profile_done"],
        "top_kernels_round1": top_kernels(steady),
        "perf.mfu": mfu, "flops_per_round": perf["flops_per_round"],
        "perf.dispatch_bound_rounds": c.get("perf.dispatch_bound_rounds", 0),
        "perf.rounds_per_s": g.get("perf.rounds_per_s"),
        "round_wall_p50_s": h.get("perf.round_wall_s", {}).get("p50"),
        "mem_high_water_mb": g.get("mem.high_water_bytes", 0) / 1e6,
        "mem_used_frac": g.get("mem.used_frac"),
        "captures": captures, "flight": kinds, "breach_captures": breach,
        "statusz_rounds": sorted({r["round"] for r in seen["runs"]}),
        "tracez_entries": len(entries), "sim_round_spans":
            spans.count("sim_round"), "cli_s": cli_s,
        "listener_up_s": seen["listener_s"],
        "first_round_seen_s": seen["first_round_s"],
        "last_round_seen_s": seen["last_round_s"], "card": card}
    print(json.dumps({"observability_headline": record}), flush=True)
    failures = []
    if len(rounds) != OBS_PROFILED or not all(
            b["device_planes"] and b["n_device_ops"] > 0
            and b["device_busy_s"] <= b["window_s"] for b in rounds):
        failures.append("the capture windows hold no device activity")
    if mfu is None or not 0 < mfu <= 1:
        failures.append(f"perf.mfu {mfu} outside (0, 1]")
    if (len(headroom) != 1 or headroom[0]["source"] != "cuda"
            or (seen["memory"] or {}).get("source") != "cuda"
            or g.get("mem.source_rss") != 0.0):
        failures.append(f"the memory plane did not read the card: "
                        f"{headroom}, {seen['memory']}")
    if len(breach) != 1 or kinds.count("breach_profile") != 1 \
            or kinds.count("breach_profile_done") != 1:
        failures.append(f"not one breach capture: {breach}")
    bad = [k for k in kinds if k.endswith("_failed")]
    if bad:
        failures.append(f"a plane failed: {bad}")
    if seen["metrics"] is None or not seen["runs"]:
        failures.append("the listener served no /metrics or no run block")
    if not entries or any(
            abs(sum(e["phases"].values()) - e["wall_s"]) > CONSERVE_TOL
            for e in entries):
        failures.append(f"anatomy entries do not conserve: {entries}")
    if spans.count("sim_round") != OBS_ROUNDS:
        failures.append(f"{spans.count('sim_round')} sim_round spans")
    if captures < 1 or captures != builds:
        failures.append(f"{captures} captures noted for {builds} builds")
    if failures:
        raise RuntimeError("phase 15 (a): " + "; ".join(failures))


def anatomy_records(card: str, device: str = "cuda") -> None:
    """(b), bench.py anatomy_bench_records: the lr round's ``local``
    share of the wall at cohorts 64 and 256, and the plane's cost, the
    round rate with anatomy on against off on the same captured graphs
    after a warm-up run (interleaved best-of-3 pairs)."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
    from fedml_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        FedConfig,
        ModelConfig,
        TrainConfig,
    )
    from fedml_tpu_torch.core.anatomy import ANATOMY
    from fedml_tpu_torch.data import load_dataset
    from fedml_tpu_torch.models import create_model

    for i, c in enumerate(ANATOMY_COHORTS):
        cfg = ExperimentConfig(
            data=DataConfig(dataset="synthetic_1_1", num_clients=c,
                            batch_size=32, seed=0),
            model=ModelConfig(name="lr", num_classes=10, input_shape=(60,)),
            train=TrainConfig(lr=0.1, epochs=1, cohort_fused=False),
            fed=FedConfig(num_rounds=ANATOMY_ROUNDS, clients_per_round=c,
                          eval_every=10**9),
            seed=0)
        sim = FedAvgSim(create_model(cfg.model, device),
                        load_dataset(cfg.data), cfg, device)
        sim.run()  # the warm-up: every capture outside the timed runs

        def timed_run():
            t0 = time.perf_counter()
            sim.run()  # ends on the host's read of the last metrics
            return time.perf_counter() - t0

        offs, ons = [], []
        try:
            for _ in range(3):
                ANATOMY.enabled = False
                offs.append(timed_run())
                ANATOMY.reset()
                ANATOMY.enabled = True
                ons.append(timed_run())
            entries = ANATOMY.tracez()["entries"]
        finally:
            ANATOMY.reset()
        local = sum(e["phases"].get("local", 0.0) for e in entries)
        wall = sum(e["wall_s"] for e in entries)
        record_line(card, metric=f"phase_share_local_c{c}",
                    value=100.0 * local / wall, unit="%", cohort=c,
                    rounds=len(entries), wall_s=wall, dominant=[
                        e["dominant"] for e in entries][-1])
        if i == 0:
            off_s, on_s = min(offs), min(ons)
            record_line(card, metric="critical_path_overhead_pct",
                        value=100.0 * (on_s - off_s) / off_s, unit="%",
                        cohort=c, anatomy_on_s=on_s, anatomy_off_s=off_s,
                        acceptance_lt_pct=2.0, offs=offs, ons=ons)
        del sim
        free_card()


def planes_are_inert(card: str, tmp: str, device: str = "cuda") -> None:
    """(b): the headline's final variables with every plane on but the
    capture windows (telemetry with its tracer in torch.profiler ranges,
    the SLO engine, the memory monitor, anatomy) equal the run with every
    plane off, bit for bit, under cuDNN's deterministic algorithms."""
    import dataclasses

    from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
    from fedml_tpu_torch.core import anatomy, telemetry
    from fedml_tpu_torch.data import load_dataset
    from fedml_tpu_torch.models import create_model

    cfg = resnet_config()
    cfg = dataclasses.replace(cfg, fed=dataclasses.replace(
        cfg.fed, num_rounds=INERT_ROUNDS))
    data = load_dataset(cfg.data)
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        states = []
        for on in (False, True):
            if on:
                telemetry.configure(telemetry_dir=os.path.join(tmp, "inert"),
                                    torch_profiler=True, slos=(OBS_SLO,))
                anatomy.configure(anatomy=True)
            try:
                sim = FedAvgSim(create_model(cfg.model, device), data, cfg,
                                device)
                states.append({k: v.clone() for k, v in
                               sim.run().variables.items()})
                ring = len(anatomy.ANATOMY.tracez()["entries"])
            finally:
                telemetry.shutdown()
            del sim
            free_card()
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = saved
    differ = [k for k in states[0] if not torch.equal(states[0][k],
                                                       states[1][k])]
    print(json.dumps({"planes_inert": {
        "rounds": INERT_ROUNDS, "leaves": len(states[0]),
        "differing_leaves": differ, "anatomy_entries_on": ring,
        "card": card}}), flush=True)
    if differ or ring != INERT_ROUNDS:
        raise RuntimeError(f"the planes changed the result: {differ}")


def uagan_through_harness(card: str, tmp: str,
                          device: str = "cuda") -> None:
    """(c): FedUAGAN at phase 14's configuration through the harness's
    round loop, its first round captured: a breakdown, the round rate and
    no MFU (outside the FedAvg family)."""
    import dataclasses

    from fedml_tpu_torch.core import telemetry
    from fedml_tpu_torch.experiments.harness import Experiment

    cfg = fedgdkd_config()
    cfg = dataclasses.replace(
        cfg, fed=dataclasses.replace(cfg.fed, algorithm="feduagan",
                                     num_rounds=UAGAN_ROUNDS,
                                     profile_rounds=1),
        out_dir=os.path.join(tmp, "runs"), run_name="uagan")
    tdir = os.path.join(tmp, "uagan_telemetry")
    telemetry.configure(telemetry_dir=tdir)
    try:
        (summary,) = Experiment(cfg, device=device).run()
        gauges = telemetry.METRICS.snapshot()["gauges"]
    finally:
        telemetry.shutdown()
    perf = json.load(open(os.path.join(tdir, "perf_rank0.json")))
    (bd,) = perf["rounds"]
    print(json.dumps({"observability_feduagan": {
        "breakdown": {k: bd[k] for k in (
            "window_s", "device_busy_s", "compute_frac", "host_frac",
            "idle_frac", "n_device_ops")},
        "perf.rounds_per_s": gauges.get("perf.rounds_per_s"),
        "perf.mfu": gauges.get("perf.mfu"), "d_loss": summary.get("d_loss"),
        "card": card}}), flush=True)
    if not (bd["device_planes"] and bd["n_device_ops"] > 0
            and "perf.rounds_per_s" in gauges and "perf.mfu" not in gauges
            and perf["flops_per_round"] is None):
        raise RuntimeError(f"phase 15 (c): {bd}, {sorted(gauges)}")


def observability_phase(card: str) -> int:
    """Phase 15: (a)-(d). Returns the flash kernels' launches over it
    (0: neither the headline nor FedUAGAN has attention)."""
    import tempfile

    from fedml_tpu_torch.ops.flash_attention import flash_attention

    t0 = time.perf_counter()
    flash_attention.launches = 0
    flash_attention.mma_launches = 0
    tmp = tempfile.mkdtemp(prefix="phase15_")
    parts = {}
    try:
        for name, part in (("a", obs_headline_cli),
                           ("b_anatomy", lambda c, _: anatomy_records(c)),
                           ("b_inert", planes_are_inert),
                           ("c", uagan_through_harness)):
            t_part = time.perf_counter()
            part(card, tmp)
            parts[name] = time.perf_counter() - t_part
            free_card()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = flash_attention.launches + flash_attention.mma_launches
    if launches != 0:
        raise RuntimeError(f"phase 15 launched flash attention {launches} "
                           "times")
    record_line(card, metric="phase15_s", value=time.perf_counter() - t0,
                parts_s=parts)
    return launches


# Phase 16: the distillation family (algorithms/distill.py) and the
# dropout classifier (models/vision.py CNNDropOut)
DISTILL = ("fedmd", "fd_faug", "fedarjun")
DISTILL_ROUNDS = 2
DISTILL_RATE_ROUNDS = 1
DISTILL_SUBSET = 5  # (b)'s cohort that leaves clients unsampled
TINY_DISTILL = dict(public_size=32, kd_epochs=1, digest_epochs=1,
                    revisit_epochs=1, pretrain_epochs_public=1,
                    pretrain_epochs_private=1)


def distill_sim(algo: str, cfg, n_train: int, device: str = "cuda",
                n_test: int = 1000, **hooks):
    """``algo``'s sim as the harness builds it (``experiments/harness.py``
    ``_build_distill``; "fedavg": FedAvgSim) on fake_mnist data."""
    import dataclasses

    from fedml_tpu_torch.algorithms import distill as D
    from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
    from fedml_tpu_torch.data.loaders import make_fake_image_dataset
    from fedml_tpu_torch.models import create_model

    data = make_fake_image_dataset("mnist", cfg.data, n_train=n_train,
                                   n_test=n_test)
    model = create_model(cfg.model, device)
    if algo == "fedavg":
        return FedAvgSim(model, data, cfg, device, **hooks)
    if algo == "fedmd":
        return D.FedMDSim(model, data, cfg, device, **hooks)
    if algo == "fd_faug":
        return D.FDSim(model, data, cfg, device, **hooks)
    local = create_model(dataclasses.replace(cfg.model, name="lr"), device)
    return D.FedArjunSim(model, local, data, cfg, device, **hooks)


def distill_config(algo: str, cpr: int = 10):
    """Phase 13's data configuration (fedgdkd_config) with cnn at 10
    classes and GanConfig's defaults (public 1,024, kd_lambda 1.0,
    kd_gamma 0.1, kd_epochs 5, T 4)."""
    import dataclasses

    cfg = fedgdkd_config(cpr=cpr)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, name="cnn"),
        fed=dataclasses.replace(cfg.fed, algorithm=algo))


def distill_replays(sim) -> int:
    """The graph replays over every update of ``sim`` and every lane
    count (a graph per lane count)."""
    return sum(g.replays for u in vars(sim).values()
               if hasattr(u, "programs") for g in u.programs.values()
               if g is not None)


def cnn_fedavg_bench(card: str) -> None:
    """(a): FedAvg over cnn at femnist_cnn's shape: DISTILL_ROUNDS rounds,
    one more under set_sync_debug_mode("error"), one replay per
    group-step."""
    import dataclasses

    from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
    from fedml_tpu_torch.models import create_model

    cfg, data = family_setup("femnist_cnn")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                             name="cnn"))
    sim = FedAvgSim(create_model(cfg.model), data, cfg)
    if not sim.model.has_dropout:
        raise RuntimeError("cnn has no dropout")
    state = sim.init()
    losses, times = [], []
    for _ in range(DISTILL_ROUNDS):
        state, m, dt = timed_round(sim, state)
        losses.append(float(m["train_loss"]))
        times.append(dt)
    cohort = cohort_report(sim)
    before = sim.cohort_update.graph.replays
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = sim.run_round(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    synced = cohort_report(sim, before)
    final = sim.evaluate_global(state)
    losses.append(float(m["train_loss"]))
    print(json.dumps({"fedavg_cnn_femnist": {
        "clients": cfg.data.num_clients, "parameters": sum(
            v.numel() for v in state.variables.values()),
        "mask_values_per_sample": sum(
            math.prod(s) for s in sim.model.mask_sites.values()),
        "train_loss": losses, "round_seconds": times, "cohort": cohort,
        "round_under_sync_debug_error": synced,
        "test_loss": final["loss"], "test_acc": final["acc"],
        "card": card}}), flush=True)
    if not all(math.isfinite(x) for x in losses + [final["loss"]]):
        raise RuntimeError(f"FedAvg over cnn: non-finite loss {losses}")
    if synced["graph_replays"] != synced["group_steps_last_round"]:
        raise RuntimeError(f"replays are not one per group-step: {synced}")


def distill_round(sim, state):
    """One timed round; returns the state, the metrics as floats, its
    seconds, and its replays against its group-steps."""
    before = distill_replays(sim)
    state, m, dt = timed_round(sim, state)
    return (state, {k: float(v) for k, v in m.items()}, dt,
            {"replays": distill_replays(sim) - before,
             "group_steps": sum(sim.last_steps.values()),
             "by_phase": dict(sim.last_steps)})


def teachers_expected(sim) -> torch.Tensor:
    """FD's flags after a round of every client: client i's flag for
    label l is on where some other client holds a sample of l."""
    a = sim.arrays
    labels = a.y.index_select(0, a.idx.flatten()).view(a.idx.shape)
    seen = torch.zeros(a.num_clients, a.num_classes, dtype=torch.bool,
                       device=a.y.device)
    for c in range(a.num_clients):
        seen[c, labels[c][a.mask[c] > 0].long()] = True
    others = seen.sum(0)[None] - seen.long()
    return others > 0


def distill_bench(algo: str, card: str) -> None:
    """(b) for one algorithm."""
    sim = distill_sim(algo, distill_config(algo), 6000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = sim.init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    record = {"algorithm": algo, "init_s": init_s,
              "init_replays": distill_replays(sim),
              "init_group_steps": dict(sim.last_steps) if algo == "fedmd"
              else {}, "rounds": [], "card": card}
    if algo == "fedmd" and record["init_replays"] != sum(
            sim.last_steps.values()):
        raise RuntimeError(f"pretraining replays: {record}")
    for r in range(DISTILL_ROUNDS):
        state, m, dt, rep = distill_round(sim, state)
        record["rounds"].append({"metrics": m, "seconds": dt, **rep,
                                 "groups": sim.last_groups})
        if rep["replays"] != rep["group_steps"] or rep["replays"] <= 0:
            raise RuntimeError(f"{algo}: replays are not one per "
                               f"group-step: {rep}")
        if algo == "fd_faug" and r == 0:
            want = teachers_expected(sim)
            if not torch.equal(state.has_teacher, want):
                raise RuntimeError("FD's teacher flags after round 1 are "
                                   "not the labels other clients saw")
    before = distill_replays(sim)
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = sim.run_round(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    record["round_under_sync_debug_error"] = {
        "metrics": {k: float(v) for k, v in m.items()},
        "replays": distill_replays(sim) - before,
        "group_steps": sum(sim.last_steps.values())}
    if (record["round_under_sync_debug_error"]["replays"]
            != record["round_under_sync_debug_error"]["group_steps"]):
        raise RuntimeError(f"{algo}: replays under sync debug: {record}")
    ev = sim.evaluate_clients(state)
    record.update(test_acc=ev["test_acc"], test_loss=ev["test_loss"])
    values = [v for row in record["rounds"] for v in row["metrics"].values()]
    if not all(math.isfinite(v) for v in values + [ev["test_loss"]]):
        raise RuntimeError(f"{algo}: non-finite loss: {record}")
    if not all(0.0 <= a <= 1.0 for a in ev["per_client_acc"]):
        raise RuntimeError(f"client accuracies outside [0, 1]: {ev}")
    rate = []
    for _ in range(DISTILL_RATE_ROUNDS):
        state, _, dt, _ = distill_round(sim, state)
        rate.append(dt)
    print(json.dumps({f"{algo}_10c": record}), flush=True)
    record_line(card, metric=f"{algo}_rounds_per_sec_10c_mnist_cnn",
                value=DISTILL_RATE_ROUNDS / sum(rate), unit="rounds/s",
                round_seconds=rate,
                note=f"smoke figure: host clock around each of "
                     f"{DISTILL_RATE_ROUNDS} rounds after "
                     f"{DISTILL_ROUNDS + 1}, each ending in a synchronize")
    del sim
    if algo != "fedarjun":
        free_card()
        unsampled_check(algo, card)


def unsampled_check(algo: str, card: str) -> None:
    """(b): a round of a cohort of DISTILL_SUBSET (FedMD without its
    pretraining) leaves the unsampled clients' models (and FD's teachers
    and flags) bit for bit."""
    import numpy as np

    cfg = distill_config(algo, cpr=DISTILL_SUBSET)
    sim = distill_sim(algo, cfg, 6000)
    start = sim.init(pretrain=False) if algo == "fedmd" else sim.init()
    state, _ = sim.run_round(start)
    idle = torch.from_numpy(np.setdiff1d(
        np.arange(cfg.data.num_clients), sim._cohort(0))).cuda()
    moved = []
    for name in ("model_stack", "teacher", "has_teacher"):
        if not hasattr(start, name):
            continue
        old, new = getattr(start, name), getattr(state, name)
        pairs = (old.items() if isinstance(old, dict)
                 else [(name, old)])
        for k, v in pairs:
            n = new[k] if isinstance(new, dict) else new
            if not torch.equal(n.index_select(0, idle),
                               v.index_select(0, idle)):
                moved.append(k)
    print(json.dumps({f"{algo}_unsampled": {
        "idle_clients": idle.tolist(), "changed": moved, "card": card}}),
        flush=True)
    if moved:
        raise RuntimeError(f"{algo} changed unsampled clients: {moved}")


def tiny_distill_config(algo: str):
    """The CPU test's configuration (tests/test_torch_distill.py
    tiny_cfg): 4 clients, hetero 0.3, 2 a round, cnn, batch 8, lr 0.05,
    public 32, one KD epoch; FD at kd_gamma 0.3, FedArjun at kd_lambda
    0.5."""
    from fedml_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        FedConfig,
        GanConfig,
        ModelConfig,
        TrainConfig,
    )

    gan = {"fd_faug": {"kd_gamma": 0.3},
           "fedarjun": {"kd_lambda": 0.5}}.get(algo, {})
    return ExperimentConfig(
        data=DataConfig(dataset="fake_mnist", num_clients=4,
                        partition_method="hetero", partition_alpha=0.3,
                        batch_size=8, seed=0),
        model=ModelConfig(name="cnn", num_classes=10,
                          input_shape=(28, 28, 1)),
        train=TrainConfig(lr=0.05, epochs=1),
        fed=FedConfig(algorithm=algo, num_rounds=2, clients_per_round=2),
        gan=GanConfig(**TINY_DISTILL, **gan), seed=0)


def distill_states(sim, algo: str, start, n: int = 2) -> list:
    """FedMD: the pretrained state and ``n`` rounds after it; the others:
    ``n`` rounds."""
    if algo != "fedmd":
        return rounds_of(sim, start, n)
    state = start._replace(model_stack=sim.pretrain(start.model_stack))
    return [state] + rounds_of(sim, state, n)


def distill_card_vs_cpu(algo: str, device: str = "cuda") -> dict:
    """(c) for one algorithm (or "fedavg", over cnn): the states on the
    card against the CPU's within GAN_BAND, else a round of one step a
    client within GAN_FIRST_STEP and the states within SPREAD_FACTOR times
    the CPU's own spread under a PERTURB relative change of the start."""
    from fedml_tpu_torch.algorithms.distill import DistillSim
    from fedml_tpu_torch.core import random as R

    cfg = tiny_distill_config(algo)
    keep = {"d0": 0.75, "d1": 0.5}
    cpu_draws = R.DeviceDraws({s: 0 for s in DistillSim.STREAMS}, "cpu",
                              p={s: keep for s in DistillSim.STREAMS})

    def sim_on(dev):
        return distill_sim(algo, cfg, 96, dev, n_test=32, draws=lambda *a: {
            k: v.to(dev) for k, v in cpu_draws(*a).items()})

    deterministic = torch.backends.cudnn.deterministic
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        t0 = time.perf_counter()
        cpu, card = sim_on("cpu"), sim_on(device)
        start = cpu.init(pretrain=False) if algo == "fedmd" else cpu.init()
        want = distill_states(cpu, algo, start)
        got = distill_states(card, algo, move_state(start, device))
        errs = [gan_state_err(g, w) for g, w in zip(got, want)]
        report = {"algorithm": algo,
                  "states": [{"max_abs_err": e, "band_use": u}
                             for e, u in errs], **GAN_BAND}
        if max(u for _, u in errs) > 1.0:
            one = [sim_on(d) for d in ("cpu", device)]
            for sim in one:  # one step a client an epoch
                if isinstance(sim, DistillSim):
                    sim.steps_per_epoch = 1
                else:
                    sim.max_n = sim.batch_size
            first = gan_state_err(
                distill_states(one[1], algo, move_state(start, device),
                               1)[-1],
                distill_states(one[0], algo, start, 1)[-1])[0]
            perturbed = distill_states(cpu, algo,
                                       move_state(start, "cpu", PERTURB))
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


def distillation_phase(card: str) -> int:
    """Phase 16: (a)-(d). Returns the flash kernels' launches over it
    (0: neither CNN_DropOut nor lr has attention)."""
    from fedml_tpu_torch.ops.flash_attention import flash_attention

    t0 = time.perf_counter()
    flash_attention.launches = 0
    flash_attention.mma_launches = 0
    parts = {}
    t_part = time.perf_counter()
    cnn_fedavg_bench(card)
    parts["a"] = time.perf_counter() - t_part
    free_card()
    for algo in DISTILL:
        t_part = time.perf_counter()
        distill_bench(algo, card)
        parts[f"b_{algo}"] = time.perf_counter() - t_part
        free_card()
    t_part = time.perf_counter()
    for algo in ("fedavg",) + DISTILL:
        print(json.dumps({"distill_card_vs_cpu": distill_card_vs_cpu(algo),
                          "device": card}), flush=True)
    parts["c"] = time.perf_counter() - t_part
    launches = flash_attention.launches + flash_attention.mma_launches
    if launches != 0:
        raise RuntimeError(f"phase 16 launched flash attention {launches} "
                           "times")
    record_line(card, metric="phase16_s", value=time.perf_counter() - t0,
                parts_s=parts)
    return launches


# phase 17: heterogeneous-model FedGDKD (algorithms/hetero.py) and the
# dropout classifiers of the GAN family and the bulk engine

# the fork's cap of four architectures, at bench.py build_fedgdkd_sim's
# data configuration: (model, clients) a bucket
HETERO_BUCKETS = (("cnn_small", 3), ("cnn_medium", 3), ("cnn_large", 2),
                  ("cnn", 2))
HETERO_SCALE = dict(num_clients=50, cpr=25, n_train=30000,
                    freqs=(15, 15, 10, 10))
HETERO_ROUNDS = 2
HETERO_RATE_ROUNDS = 1
DROPOUT_ROUNDS = 1  # (c)
DROPOUT_BLOCK = 4  # (c): FedAvg over cnn in blocks of 4 (10 a round)
# (d): the CPU tests' hetero buckets (tests/test_torch_hetero.py)
TINY_HETERO = (("cnn_custom", 2, (("convs", (8, 16)),)), ("lr", 2, ()),
               ("cnn", 2, ()))


def hetero_specs(buckets=HETERO_BUCKETS, freqs=None):
    from fedml_tpu_torch.algorithms.hetero import ClientModelSpec
    from fedml_tpu_torch.config import ModelConfig

    out = []
    for i, (name, freq, *extra) in enumerate(buckets):
        out.append(ClientModelSpec(ModelConfig(
            name=name, num_classes=10, input_shape=(28, 28, 1),
            extra=extra[0] if extra else ()),
            freqs[i] if freqs else freq))
    return out


def hetero_sim(cfg, n_train: int, specs, device: str = "cuda",
               n_test: int = 1000, **hooks):
    from fedml_tpu_torch.algorithms.hetero import HeteroFedGDKD
    from fedml_tpu_torch.data.loaders import make_fake_image_dataset
    from fedml_tpu_torch.models.gan import generator_from_config

    data = make_fake_image_dataset("mnist", cfg.data, n_train=n_train,
                                   n_test=n_test)
    gen = generator_from_config(cfg.gan, 10, 28, 1, device=device)
    return HeteroFedGDKD(gen, specs, data, cfg, device, **hooks)


def hetero_graphs(sim) -> dict:
    """The sim's CUDA graphs by bucket and phase: their lane counts, their
    replays and the bytes of their static buffers."""
    from fedml_tpu_torch.core import memscope
    from fedml_tpu_torch.core import tree as T

    out, replays, static = {}, 0, 0
    for b, bucket in enumerate(sim.buckets):
        name = type(bucket.model.module).__name__
        for phase, upd in (("adversarial", sim._gan[b]),
                           ("kd", sim._kd[b])):
            graphs = [g for g in upd.programs.values() if g is not None]
            out[f"{b}:{name}:{phase}"] = sorted(
                int(T.tree_leaves(g.carry)[0].shape[0]) for g in graphs
                if g.graph is not None)
            replays += sum(g.replays for g in graphs)
            static += sum(memscope.tree_bytes((g.carry, g.consts, g.inputs))
                          for g in graphs if g.graph is not None)
    return {"lanes_by_graph": out, "replays": replays,
            "captures": sum(len(v) for v in out.values()),
            "static_buffer_mb": static / 1e6}


def hetero_steps(sim) -> int:
    """The last round's graph replays it should have made: each bucket's
    adversarial group-steps, and a distillation of ``kd_epochs * S / B``
    steps for each bucket that trained and each that drift-corrected."""
    epochs = sim.cfg.train.epochs
    kd = sim.cfg.gan.kd_epochs * sim.synth_size // sim.batch_size
    adv = epochs * sum(st for groups in sim.last_groups for _, st in groups)
    trained = sum(1 for groups in sim.last_groups if groups)
    drifted = sum(1 for n in sim.last_drift if n)
    return adv + kd * (trained + drifted)


def hetero_round(sim, sync_debug: bool = False) -> dict:
    """One round (with ``sync_debug``, under set_sync_debug_mode("error")),
    timed on the host clock ending in a synchronize; raises unless its
    losses are finite and it ran as one graph replay per group-step."""
    before = hetero_graphs(sim)["replays"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if sync_debug:
        torch.cuda.set_sync_debug_mode("error")
    try:
        info = sim.run_round()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    losses = {k: float(info[k]) for k in ("g_loss", "d_loss", "kd_loss")}
    row = {"losses": losses, "seconds": dt,
           "drift_corrected": info["drift_corrected"],
           "groups": sim.last_groups,
           "replays": hetero_graphs(sim)["replays"] - before,
           "group_steps": hetero_steps(sim)}
    if not all(math.isfinite(v) for v in losses.values()):
        raise RuntimeError(f"non-finite hetero FedGDKD loss: {row}")
    if row["replays"] != row["group_steps"]:
        raise RuntimeError(f"hetero replays are not one per step: {row}")
    return row


def hetero_bench(card: str) -> None:
    """(a): HETERO_ROUNDS rounds of the four buckets, one more under
    set_sync_debug_mode("error"), every client's accuracy, the graphs and
    the round rate over HETERO_RATE_ROUNDS more."""
    cfg = fedgdkd_config()
    reserved = torch.cuda.memory_reserved()
    sim = hetero_sim(cfg, 6000, hetero_specs())
    rows = [hetero_round(sim)]
    graphs0 = hetero_graphs(sim)
    grown = (torch.cuda.memory_reserved() - reserved) / 1e6
    rows += [hetero_round(sim) for _ in range(HETERO_ROUNDS - 1)]
    synced = hetero_round(sim, sync_debug=True)
    ev = sim.evaluate_clients()
    if (len(ev["per_client_acc"]) != cfg.data.num_clients
            or not all(0.0 <= a <= 1.0 for a in ev["per_client_acc"])):
        raise RuntimeError(f"client accuracies: {ev}")
    rate = [hetero_round(sim)["seconds"] for _ in range(HETERO_RATE_ROUNDS)]
    graphs = hetero_graphs(sim)
    print(json.dumps({"hetero_fedgdkd_10c": {
        "buckets": [[type(b.model.module).__name__, b.client_ids.tolist()]
                    for b in sim.buckets],
        "rounds": rows, "round_under_sync_debug_error": synced,
        "graphs_after_round_0": graphs0, "graphs": graphs,
        "reserved_growth_mb_round_0": grown,
        "test_acc": ev["test_acc"], "test_loss": ev["test_loss"],
        "per_client_acc": ev["per_client_acc"], "card": card}}),
        flush=True)
    record_line(card, metric="hetero_fedgdkd_rounds_per_sec_10c_mnist_4arch",
                value=HETERO_RATE_ROUNDS / sum(rate), unit="rounds/s",
                round_seconds=rate,
                note=f"smoke figure: host clock around each of "
                     f"{HETERO_RATE_ROUNDS} rounds after "
                     f"{HETERO_ROUNDS + 1}, each ending in a synchronize")


def hetero_scale(card: str) -> None:
    """(b): 50 clients in the same four buckets (15/15/10/10), 25 a
    round, HETERO_ROUNDS rounds: the drift-corrected joiners counted in
    more than one
    bucket, the classifiers of the clients a round did not sample bit for
    bit as they were."""
    s = HETERO_SCALE
    cfg = fedgdkd_config(s["num_clients"], s["cpr"])
    sim = hetero_sim(cfg, s["n_train"], hetero_specs(freqs=s["freqs"]))
    rows, drifted = [], [0] * len(sim.buckets)
    for r in range(HETERO_ROUNDS):
        before = [{k: v.clone() for k, v in b.stack.items()}
                  for b in sim.buckets]
        row = hetero_round(sim)
        cohort = set(int(c) for c in sim._cohort(r))
        for b, bucket in enumerate(sim.buckets):
            idle = torch.tensor([i for i, c in enumerate(bucket.client_ids)
                                 if int(c) not in cohort],
                                dtype=torch.long).cuda()
            moved = [k for k, v in bucket.stack.items()
                     if not torch.equal(v[idle], before[b][k][idle])]
            if moved:
                raise RuntimeError(f"round {r} bucket {b} changed unsampled "
                                   f"classifiers: {moved}")
        drifted = [d + n for d, n in zip(drifted, row["drift_corrected"])]
        rows.append({"round": r, **row})
    print(json.dumps({"hetero_fedgdkd_50c_sampled25": {
        "rounds": rows, "drift_corrected_by_bucket": drifted,
        "graphs": hetero_graphs(sim), "card": card}}), flush=True)
    if sum(1 for d in drifted if d) < 2:
        raise RuntimeError(f"drift corrected in fewer than two buckets: "
                           f"{drifted}")
    record_line(card,
                metric="hetero_fedgdkd_rounds_per_sec_50c_sampled25_4arch",
                value=(len(rows) - 1) / sum(r["seconds"] for r in rows[1:]),
                unit="rounds/s",
                round_seconds=[row["seconds"] for row in rows],
                note="smoke figure: the rounds after round 0 (round 0 "
                     "captures the graphs; each new lane count captures "
                     "one), host clock ending in a synchronize")


def with_cnn(cfg, **fed):
    import dataclasses

    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, name="cnn"),
        fed=dataclasses.replace(cfg.fed, **fed))


def dropout_gan_bench(card: str) -> None:
    """(c): FedGDKD and FedDTG with a cnn classifier at phase 13's
    configuration, and FedAvg over cnn in the bulk engine at femnist_cnn's
    shape: DROPOUT_ROUNDS rounds each, then one under
    set_sync_debug_mode("error") with
    one replay per group-step (and per distillation step)."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
    from fedml_tpu_torch.models import create_model

    record = {}
    sim = fedgdkd_sim(with_cnn(fedgdkd_config(), algorithm="fedgdkd"), 6000)
    state, losses, times = gan_rounds(sim, sim.init(), DROPOUT_ROUNDS)
    before = gan_replays(sim)
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = sim.run_round(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rep = gan_report(sim, before)
    kd_steps = sim.cfg.gan.kd_epochs * sim.synth_size // sim.batch_size
    if (rep["adversarial_replays"] != rep["group_steps_last_round"]
            or rep["kd_replays"] != kd_steps):
        raise RuntimeError(f"FedGDKD over cnn: replays {rep}")
    record["fedgdkd"] = {"losses": losses, "round_seconds": times,
                         "synced": rep, "mask_sites": sorted(sim.mask_sites)}
    del sim, state
    free_card()
    sim = gan_family_sim("feddtg", with_cnn(fedgdkd_config(),
                                            algorithm="feddtg"), 6000)
    state, losses, times = gan_family_rounds("feddtg", sim, sim.init(),
                                             DROPOUT_ROUNDS)
    before = {k: g.replays for k, g in gan_family_graphs(sim).items()}
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = sim.run_round(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rep = gan_family_report("feddtg", sim, before)
    if (rep["replays"]["local"] != rep["group_steps_last_round"]
            or rep["replays"]["kd"] != kd_steps):
        raise RuntimeError(f"FedDTG over cnn: replays {rep}")
    record["feddtg"] = {"losses": losses, "round_seconds": times,
                        "synced": rep, "mask_sites": sorted(sim.mask_sites)}
    del sim, state
    free_card()
    cfg, data = family_setup("femnist_cnn")
    cfg = with_cnn(cfg, client_block_size=DROPOUT_BLOCK)
    sim = FedAvgSim(create_model(cfg.model), data, cfg)
    state = sim.init()
    losses, times = [], []
    for _ in range(DROPOUT_ROUNDS):
        state, m, dt = timed_round(sim, state)
        losses.append(float(m["train_loss"]))
        times.append(dt)
    before = sim.cohort_update.graph.replays
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = sim.run_round(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rep = cohort_report(sim, before)
    losses.append(float(m["train_loss"]))
    if (not all(math.isfinite(x) for x in losses)
            or rep["graph_replays"] != rep["group_steps_last_round"]
            or len(sim.last_groups) < 2):
        raise RuntimeError(f"FedAvg over cnn in blocks: {losses} {rep}")
    record["fedavg_bulk"] = {"train_loss": losses, "round_seconds": times,
                             "synced": rep, "block": DROPOUT_BLOCK}
    print(json.dumps({"dropout_classifiers": record, "card": card}),
          flush=True)


def hetero_tiny_config():
    """tests/test_torch_hetero.py's configuration: 6 clients, 4 a round,
    batch 8, lr 0.05, one epoch, nz 16, ngf 8, a set of 16, one KD
    epoch."""
    from fedml_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        FedConfig,
        GanConfig,
        TrainConfig,
    )

    return ExperimentConfig(
        data=DataConfig(dataset="fake_mnist", num_clients=6, batch_size=8,
                        seed=0),
        train=TrainConfig(lr=0.05, epochs=1),
        fed=FedConfig(num_rounds=2, clients_per_round=4),
        gan=GanConfig(nz=16, ngf=8, distillation_size=16, kd_epochs=1),
        seed=0)


def hetero_state(sim) -> list:
    """The hetero sim's variables: the generator, then each bucket's
    stack, as one list of tensors."""
    return [*sim.gen_vars.values(),
            *(v for b in sim.buckets for v in b.stack.values())]


def set_hetero_state(sim, state, device, perturb: float = 0.0) -> None:
    """Load ``state`` (:func:`hetero_state` of a sim with the same
    buckets) into ``sim`` on ``device``, scaled by 1 + ``perturb`` x a
    seeded standard normal draw."""
    gen = torch.Generator().manual_seed(0)
    leaves = iter(state)

    def one(v):
        v = v.cpu()
        if perturb:
            v = v * (1 + perturb * torch.randn(v.shape, generator=gen))
        return v.to(device)

    sim.gen_vars = {k: one(next(leaves)) for k in sim.gen_vars}
    for b in sim.buckets:
        b.stack = {k: one(next(leaves)) for k in b.stack}


def hetero_rounds(sim, start, n: int = 2, perturb: float = 0.0) -> list:
    """The variables after each of ``n`` rounds of a fresh ``sim`` from
    ``start`` (scaled as :func:`set_hetero_state` does), on the CPU."""
    set_hetero_state(sim, start, sim.device, perturb)
    out = []
    for _ in range(n):
        sim.run_round()
        out.append([v.cpu() for v in hetero_state(sim)])
    return out


def hetero_card_vs_cpu(device: str = "cuda") -> dict:
    """(d) for the hetero sim: two rounds at the CPU test's configuration
    on ``device`` and on the CPU from the same variables and draws (the
    CPU sim's), within GAN_BAND, or else a round of one adversarial step
    a client within GAN_FIRST_STEP and the rounds within SPREAD_FACTOR
    times the CPU's own spread under a PERTURB change of the start."""
    cfg = hetero_tiny_config()
    specs = hetero_specs(TINY_HETERO)

    def sim_on(dev, cpu=None):
        hooks = {} if cpu is None else {"draws": lambda *a: {
            k: v.to(dev) for k, v in cpu.draws(*a).items()}}
        return hetero_sim(cfg, 96, specs, dev, n_test=32, **hooks)

    cpu = sim_on("cpu")
    card = sim_on(device, cpu)
    start = [v.clone() for v in hetero_state(cpu)]
    want = hetero_rounds(cpu, start)
    got = hetero_rounds(card, start)
    errs = [gan_state_err(g, w) for g, w in zip(got, want)]
    report = {"algorithm": "hetero_fedgdkd",
              "states": [{"max_abs_err": e, "band_use": u} for e, u in errs],
              "drift_corrected": int(card.counters[
                  "fedgdkd.drift_corrected"]), **GAN_BAND}
    if max(u for _, u in errs) > 1.0:
        one = [sim_on("cpu"), None]
        one[1] = sim_on(device, one[0])
        for sim in one:
            sim.steps_per_epoch = 1
        first = gan_state_err(hetero_rounds(one[1], start, 1)[0],
                              hetero_rounds(one[0], start, 1)[0])[0]
        perturbed = hetero_rounds(sim_on("cpu"), start, perturb=PERTURB)
        row = {"first_step_max_abs_err": first,
               "card_vs_cpu": max(e for e, _ in errs),
               "cpu_spread": max(gan_state_err(p, w)[0]
                                 for p, w in zip(perturbed, want)),
               "spread_factor": SPREAD_FACTOR}
        report.update(row)
        if (first > GAN_FIRST_STEP
                or row["card_vs_cpu"] > SPREAD_FACTOR * row["cpu_spread"]):
            raise RuntimeError(f"hetero card vs CPU outside the band and the "
                               f"spread: {report}")
    return report


def dropout_card_vs_cpu(algo: str, device: str = "cuda") -> dict:
    """(d) for FedGDKD and FedDTG over a cnn classifier at the CPU tests'
    configuration (tests/test_torch_dropout_gan.py), and FedAvg over cnn
    in blocks of 2 (3 of 4 clients a round): the states on the card
    against the CPU's from the same variables, draws and masks, within
    GAN_BAND, or else the fallback of phases 13-16."""
    import dataclasses

    if algo == "fedavg":
        base = tiny_distill_config("fedavg")
        cfg = dataclasses.replace(base, fed=dataclasses.replace(
            base.fed, clients_per_round=3, client_block_size=2))
    else:
        cfg = with_cnn(tiny_gan_config(algo))

    def build(dev, draws=None):
        hooks = {} if draws is None else {"draws": draws}
        if algo == "fedavg":
            return distill_sim("fedavg", cfg, 96, dev, n_test=32, **hooks)
        if algo == "fedgdkd":
            return fedgdkd_sim(cfg, 96, dev, n_test=32, **hooks)
        return gan_family_sim(algo, cfg, 96, dev, n_test=32,
                              features=TINY_FEATURES, **hooks)

    cpu = build("cpu")

    def sim_on(dev):
        return cpu if dev == "cpu" else build(dev, lambda *a: {
            k: v.to(dev) for k, v in cpu.draws(*a).items()})

    # FedGDKD's state keeps its last cohort on the host
    move = moved_state if algo == "fedgdkd" else move_state
    t0 = time.perf_counter()
    start = cpu.init()
    want = rounds_of(cpu, start)
    card = sim_on(device)
    got = rounds_of(card, move(start, device))
    errs = [gan_state_err(g, w) for g, w in zip(got, want)]
    report = {"algorithm": f"{algo}_cnn",
              "states": [{"max_abs_err": e, "band_use": u}
                         for e, u in errs], **GAN_BAND}
    if max(u for _, u in errs) > 1.0:
        one = [build("cpu"), None]
        one[1] = build(device, lambda *a: {
            k: v.to(device) for k, v in one[0].draws(*a).items()})
        for sim in one:  # one step a client an epoch
            if algo == "fedavg":
                sim.max_n = sim.batch_size
                sim._idle_orders = sim._idle_orders[:, :sim.max_n]
            else:
                sim.steps_per_epoch = 1
        first = gan_state_err(rounds_of(one[1], move(start, device), 1)[0],
                              rounds_of(one[0], start, 1)[0])[0]
        perturbed = rounds_of(cpu, move(start, "cpu", PERTURB))
        row = {"first_step_max_abs_err": first,
               "card_vs_cpu": max(e for e, _ in errs),
               "cpu_spread": max(gan_state_err(p, w)[0]
                                 for p, w in zip(perturbed, want)),
               "spread_factor": SPREAD_FACTOR}
        report.update(row)
        if (first > GAN_FIRST_STEP
                or row["card_vs_cpu"] > SPREAD_FACTOR * row["cpu_spread"]):
            raise RuntimeError(f"{algo} over cnn: card vs CPU outside the "
                               f"band and the spread: {report}")
    report["seconds"] = time.perf_counter() - t0
    return report


def hetero_phase(card: str) -> int:
    """Phase 17: (a)-(e). Returns the flash kernels' launches over it
    (0: no classifier of the phase has attention)."""
    from fedml_tpu_torch.ops.flash_attention import flash_attention

    t0 = time.perf_counter()
    flash_attention.launches = 0
    flash_attention.mma_launches = 0
    parts = {}
    for name, run in (("a", hetero_bench), ("b", hetero_scale),
                      ("c", dropout_gan_bench)):
        t_part = time.perf_counter()
        run(card)
        parts[name] = time.perf_counter() - t_part
        free_card()
    t_part = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        print(json.dumps({"hetero_card_vs_cpu": hetero_card_vs_cpu(),
                          "device": card}), flush=True)
        for algo in ("fedgdkd", "feddtg", "fedavg"):
            print(json.dumps({"dropout_card_vs_cpu":
                              dropout_card_vs_cpu(algo), "device": card}),
                  flush=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.benchmark = benchmark
    parts["d"] = time.perf_counter() - t_part
    launches = flash_attention.launches + flash_attention.mma_launches
    if launches != 0:
        raise RuntimeError(f"phase 17 launched flash attention {launches} "
                           "times")
    record_line(card, metric="phase17_s", value=time.perf_counter() - t0,
                parts_s=parts)
    return launches


# phase 18: the rest of the model zoo with the tag and segmentation tasks
# and fedseg, then hierarchical, decentralized and online decentralized FL
TOPO_ROUNDS = 2
ZOO_ROUNDS = 3
ZOO_IMAGE_MODELS = ("vgg11", "mobilenet_v3", "efficientnet-b0")
DOL_T = 2000
DOL_LR = 0.3  # tests/test_decentralized_hierarchical.py's
# the CPU tests' zoo (tests/test_torch_zoo.py): name -> (input shape,
# classes, extra, task); efficientnet-b0 in float64 as there, and
# mobilenet_v3 too: at these inputs its float32 step on the card lands
# 4.2e-3 from the CPU's float64 one (the CPU's float32: 7.3e-7) while the
# forward agrees to 2.6e-6, and computing the stem conv alone in float64
# brings the card to 1.1e-6 (scripts/zoo_step_precision.py): a
# ReLU-family kink that the stem's rounding flips, so the float32 step is
# a knife-edge there, not a band
TINY_ZOO = {
    "vgg11": ((32, 32, 3), 10, (), "classification"),
    "mobilenet_v3": ((32, 32, 3), 10, (("width_mult", 0.25),),
                     "classification"),
    "efficientnet-b0": ((32, 32, 3), 10, (), "classification"),
    "lenet": ((28, 28, 1), 10, (), "classification"),
    "tag_lr": ((1000,), 50, (), "tag_prediction"),
    "deeplab": ((32, 32, 3), 4, (("encoder_features", (8, 16)),),
                "segmentation"),
}
TINY_ZOO_X64 = ("mobilenet_v3", "efficientnet-b0")


def topo_config(dataset: str, model: str, num_clients: int, cpr: int,
                algorithm: str = "fedavg", rounds: int = TOPO_ROUNDS,
                shape=(32, 32, 3), classes: int = 10, extra=(),
                dtype: str = "bfloat16", lr: float = 0.03,
                batch: int = 32, partition: str = "hetero",
                alpha: float = 0.5, dataset_r: float = 1.0,
                cohort_groups: int = 5):
    from fedml_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        FedConfig,
        ModelConfig,
        TrainConfig,
    )

    return ExperimentConfig(
        data=DataConfig(dataset=dataset, num_clients=num_clients,
                        partition_method=partition, partition_alpha=alpha,
                        batch_size=batch, dataset_r=dataset_r, seed=0),
        model=ModelConfig(name=model, num_classes=classes,
                          input_shape=shape, extra=extra),
        train=TrainConfig(lr=lr, epochs=1, compute_dtype=dtype,
                          cohort_groups=cohort_groups),
        fed=FedConfig(algorithm=algorithm, num_rounds=rounds,
                      clients_per_round=cpr, eval_every=1),
        seed=0)


def param_count(sim, variables) -> int:
    return int(sum(v.numel() for k, v in variables.items()
                   if k not in sim.model.stat_names))


def graph_report(sim, before: int = 0) -> dict:
    """The last round's lane groups (a hierarchical round's last inner
    round) and the cohort graph's replays since ``before``; raises unless
    the round ran as replays."""
    graph = sim.cohort_update.graph
    report = {"groups": [{"clients": n, "steps_per_epoch": s}
                         for n, s in sim.last_groups],
              "graph_replays": graph.replays - before}
    if graph.graph is None or report["graph_replays"] <= 0:
        raise RuntimeError(f"the lanes did not run as CUDA graph replays: "
                           f"{report}")
    return report


def rounds_with_eval(sim, state, rounds: int, evaluate) -> tuple:
    """``rounds`` timed rounds of ``sim`` from ``state``, ``evaluate``
    after each; returns the state and the rows."""
    rows = []
    for r in range(rounds):
        before = sim.cohort_update.graph
        before = before.replays if before is not None else 0
        state, m, seconds = timed_round(sim, state)
        row = {"round": r, "seconds": seconds,
               **{k: float(v) for k, v in m.items()},
               **graph_report(sim, before), **evaluate(state)}
        rows.append(row)
        if not all(math.isfinite(row[k]) for k in row
                   if k.endswith("loss")):
            raise RuntimeError(f"{type(sim).__name__}: non-finite loss: "
                               f"{row}")
    return state, rows


def fedseg_bench(card: str, device: str = "cuda") -> None:
    """(a): fedseg, deeplab at the JAX defaults on fake_seg, TOPO_ROUNDS
    rounds with an evaluation and the segmentation metrics after each."""
    from fedml_tpu_torch.experiments.harness import build_sim
    from fedml_tpu_torch.metrics import SegEvaluator

    cfg = topo_config("fake_seg", "deeplab", 8, 4, algorithm="fedseg",
                      classes=4, dtype="float32", lr=0.05, batch=16,
                      partition="homo")
    sim = build_sim(cfg, device)
    state = sim.init()
    init = sim.evaluate_global(state)

    def evaluate(s):
        seg = SegEvaluator(4)
        seg.add_model(sim.model, s.variables, sim.arrays.test_x,
                      sim.arrays.test_y)
        return {"test_" + k: v for k, v in sim.evaluate_global(s).items()
                } | {"pixel_acc": seg.pixel_accuracy(),
                     "miou": seg.mean_iou(), "fwiou": seg.fw_iou()}

    state, rows = rounds_with_eval(sim, state, cfg.fed.num_rounds, evaluate)
    record_line(card, metric="fedseg_deeplab_fake_seg", task=sim.task.name,
                params=param_count(sim, state.variables),
                init_test_loss=init["loss"], rounds=rows)
    if not rows[-1]["test_loss"] < init["loss"]:
        raise RuntimeError(f"fedseg: test loss did not fall: {init} -> "
                           f"{rows[-1]}")


def zoo_bench(card: str, device: str = "cuda") -> None:
    """(b): the zoo at its published widths, 3 FedAvg rounds each, then
    one more round of efficientnet-b0 under sync debug."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
    from fedml_tpu_torch.data import load_dataset
    from fedml_tpu_torch.models import create_model

    specs = {name: topo_config("fake_cifar10", name, 100, 10)
             for name in ZOO_IMAGE_MODELS}
    specs["lenet"] = topo_config("fake_mnist", "lenet", 100, 10,
                                 shape=(28, 28, 1))
    specs["tag_lr"] = topo_config("fake_stackoverflow_lr", "tag_lr", 10, 10,
                                  shape=(1000,), classes=50,
                                  partition="homo")
    for name, cfg in specs.items():
        sim = FedAvgSim(create_model(cfg.model, device),
                        load_dataset(cfg.data), cfg, device)
        state = sim.init()
        rows = []
        for r in range(cfg.fed.num_rounds):
            before = sim.cohort_update.graph
            before = before.replays if before is not None else 0
            state, m, seconds = timed_round(sim, state)
            rows.append({"round": r, "seconds": seconds,
                         "train_loss": float(m["train_loss"]),
                         **graph_report(sim, before)})
        bad = [k for k, v in state.variables.items()
               if not bool(torch.isfinite(v).all())]
        extra = {}
        if name == "efficientnet-b0":
            before = sim.cohort_update.graph.replays
            torch.cuda.set_sync_debug_mode("error")
            try:
                _, synced = sim.run_round(state)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            extra["round_under_sync_debug_error"] = {
                "train_loss": float(synced["train_loss"]),
                **graph_report(sim, before)}
        record_line(card, metric=f"zoo_{name}", task=sim.task.name,
                    dataset=cfg.data.dataset,
                    params=param_count(sim, state.variables), rounds=rows,
                    **extra)
        losses = [r["train_loss"] for r in rows] + [
            e["train_loss"] for e in extra.values()]
        if bad or not all(math.isfinite(x) for x in losses):
            raise RuntimeError(f"zoo {name}: non-finite losses {losses} or "
                               f"variables {bad}")
        del sim, state
        free_card()


def hierarchical_bench(card: str, device: str = "cuda") -> None:
    """(c): hierarchical FedAvg over resnet56, 20 clients in 2 groups of
    10, 2 inner rounds, TOPO_ROUNDS rounds with a global evaluation after
    each."""
    from fedml_tpu_torch.algorithms.hierarchical import HierarchicalFedAvg
    from fedml_tpu_torch.data import load_dataset
    from fedml_tpu_torch.models import create_model

    cfg = topo_config("fake_cifar10", "resnet56", 20, 20,
                      algorithm="hierarchical")
    sim = HierarchicalFedAvg(create_model(cfg.model, device),
                             load_dataset(cfg.data), cfg, device,
                             num_groups=2, group_comm_round=2)
    state = sim.init()
    init = sim.evaluate_global(state)
    state, rows = rounds_with_eval(
        sim, state, cfg.fed.num_rounds,
        lambda s: {"test_" + k: v for k, v in sim.evaluate_global(s).items()})
    record_line(card, metric="hierarchical_resnet56_20c_2g",
                groups=sim.grouping.tolist(), group_comm_round=2,
                init_test_loss=init["loss"], rounds=rows)
    if not rows[-1]["test_loss"] < init["loss"]:
        raise RuntimeError(f"hierarchical: test loss did not fall: {init} "
                           f"-> {rows[-1]}")


def decentralized_bench(card: str, device: str = "cuda") -> None:
    """(d): DSGD and push-sum over resnet56, 16 clients on the ring of 2
    neighbours, TOPO_ROUNDS rounds: the consensus model's evaluation and the
    consensus distance after each, and the mixing's CUDA-event time."""
    from fedml_tpu_torch.algorithms.decentralized import DecentralizedSim, mix
    from fedml_tpu_torch.data import load_dataset
    from fedml_tpu_torch.models import create_model

    for method in ("dsgd", "pushsum"):
        cfg = topo_config("fake_cifar10", "resnet56", 16, 16,
                          algorithm=f"decentralized_{method}")
        sim = DecentralizedSim(create_model(cfg.model, device),
                               load_dataset(cfg.data), cfg, device,
                               method=method)
        state = sim.init()
        state, rows = rounds_with_eval(
            sim, state, cfg.fed.num_rounds, lambda s: {
                **{"consensus_" + k: v
                   for k, v in sim.evaluate_consensus(s).items()},
                "consensus_distance": sim.consensus_distance(s)})
        matrix = sim.P if method == "pushsum" else sim.W
        record_line(card, metric=f"decentralized_{method}_resnet56_16c",
                    rounds=rows, mixing_ms=median_ms(
                        lambda: mix(matrix, state.stacked_vars), reps=5),
                    leaves=len(state.stacked_vars),
                    push_weights_sum=float(state.push_weights.sum()))
        if not all(math.isfinite(r["consensus_distance"]) for r in rows):
            raise RuntimeError(f"{method}: consensus distance {rows}")
        del sim, state
        free_card()


def dol_bench(card: str, device: str = "cuda") -> None:
    """(e): dol_dsgd and dol_pushsum through the harness and push-sum on
    the time-varying topology, on the SUSY-shaped stream (8 nodes, 18
    features, T 2000, beta 0.25): each run twice (the first captures the
    iteration's graph), its regret falling below 0.7 x its 10th value."""
    import dataclasses

    from fedml_tpu_torch.algorithms.decentralized import (
        OnlineDecentralizedSim,
    )
    from fedml_tpu_torch.data.streaming import make_susy_like_stream
    from fedml_tpu_torch.experiments.harness import build_sim

    sims = {}
    for method in ("dsgd", "pushsum"):
        cfg = topo_config("susy_like", "lr", 8, 8, algorithm=f"dol_{method}",
                          rounds=DOL_T, lr=DOL_LR, alpha=0.25)
        sims[f"dol_{method}"] = build_sim(dataclasses.replace(
            cfg, seed=1, data=dataclasses.replace(cfg.data, seed=1)), device)
    xs, ys = make_susy_like_stream(8, DOL_T, beta=0.25, seed=1)
    sims["pushsum_time_varying"] = OnlineDecentralizedSim(
        xs, ys, method="pushsum", lr=DOL_LR, time_varying=True, seed=1,
        device=device)
    for name, sim in sims.items():
        seconds = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sim.run()
            seconds.append(time.perf_counter() - t0)
        regret = out["regret"].cpu()
        record_line(card, metric=name, iterations=sim.t, nodes=sim.n,
                    seconds_per_run=seconds, graph_replays=sim.graph.replays,
                    regret_10=float(regret[9]),
                    final_regret=out["final_regret"])
        if sim.graph.replays != 2 * sim.t:
            raise RuntimeError(f"{name}: {sim.graph.replays} replays for "
                               f"2 x {sim.t} iterations")
        if not out["final_regret"] < 0.7 * float(regret[9]):
            raise RuntimeError(f"{name}: regret did not fall: "
                               f"{float(regret[9])} -> {out['final_regret']}")


def spread_check(name, sim_on, start, rounds_of, want, got) -> dict:
    """The states on the card against the CPU's within GAN_BAND, or else
    the card's error within SPREAD_FACTOR times the CPU's own spread under
    a PERTURB relative change of the start."""
    errs = [gan_state_err(g, w) for g, w in zip(got, want)]
    report = {"case": name, "states": [{"max_abs_err": e, "band_use": u}
                                       for e, u in errs], **GAN_BAND}
    if max(u for _, u in errs) > 1.0:
        perturbed = rounds_of(sim_on("cpu"), move_state(start, "cpu",
                                                        PERTURB))
        row = {"card_vs_cpu": max(e for e, _ in errs),
               "cpu_spread": max(gan_state_err(p, w)[0]
                                 for p, w in zip(perturbed, want)),
               "spread_factor": SPREAD_FACTOR}
        report.update(row)
        if row["card_vs_cpu"] > SPREAD_FACTOR * row["cpu_spread"]:
            raise RuntimeError(f"{name}: card vs CPU outside the band and "
                               f"the spread: {report}")
    return report


def topo_rounds(sim, start, n: int = 2) -> list:
    """The states after each of ``n`` rounds of ``sim`` from ``start``."""
    state, out = start, []
    for _ in range(n):
        state, _ = sim.run_round(state)
        out.append(state)
    return out


def tiny_topo_config(algorithm: str):
    """tests/test_torch_topology.py's configuration: lr on fake_mnist, 8
    clients, hetero 0.5, a quarter of the set, batch 32, lr 0.05 with
    momentum 0.5."""
    import dataclasses

    cfg = topo_config("fake_mnist", "lr", 8, 8, algorithm=algorithm,
                      rounds=2, shape=(28, 28, 1), dtype="float32",
                      lr=0.05, dataset_r=0.25, cohort_groups=0)
    return dataclasses.replace(cfg, seed=3, train=dataclasses.replace(
        cfg.train, momentum=0.5))


def zoo_step(mcfg, task: str, tcfg, dtype, x, y, device):
    """One local step of ``mcfg``'s model on a client of the 4 samples
    ``x``/``y`` on ``device``: ``(step(variables) -> CPU variables, the
    model's seeded initial variables in ``dtype`` on the CPU)``."""
    from fedml_tpu_torch.algorithms.base import build_local_update, make_task
    from fedml_tpu_torch.models import create_model

    model = create_model(mcfg, device)
    lu = build_local_update(model, make_task(task), tcfg, 4, 4)
    init = {n: v.to(dtype).cpu() for n, v in model.init(
        torch.Generator().manual_seed(0)).items()}

    def step(variables):
        out, _, _ = lu({n: v.to(device) for n, v in variables.items()},
                       torch.arange(4, dtype=torch.int32, device=device),
                       torch.ones(4, device=device), x.to(device),
                       y.to(device), [torch.arange(4, device=device)])
        return {n: v.cpu() for n, v in out.items()}

    return step, init


def topo_card_vs_cpu(device: str = "cuda") -> list:
    """(f): each of (a)-(e) at its CPU test's configuration on the card
    and on the CPU from the same start (the hooks' default draws are the
    host's, the same on both), within GAN_BAND or the spread: fedseg's
    round, each zoo model's local step, two hierarchical rounds, two
    decentralized rounds of each method (push-sum on the directed
    topology) and the online sims' losses, regret and parameters."""
    import dataclasses

    from fedml_tpu_torch.algorithms.decentralized import (
        DecentralizedSim,
        OnlineDecentralizedSim,
    )
    from fedml_tpu_torch.algorithms.hierarchical import HierarchicalFedAvg
    from fedml_tpu_torch.config import ModelConfig, TrainConfig
    from fedml_tpu_torch.core.topology import AsymmetricTopologyManager
    from fedml_tpu_torch.data import load_dataset
    from fedml_tpu_torch.data.streaming import make_susy_like_stream
    from fedml_tpu_torch.experiments.harness import build_sim
    from fedml_tpu_torch.models import create_model

    reports = []
    t0 = time.perf_counter()
    # fedseg: tests/test_torch_zoo.py's round
    seg = topo_config("fake_seg", "deeplab", 4, 4, algorithm="fedseg",
                      rounds=2, classes=4, dtype="float32", lr=0.05,
                      batch=8, partition="homo", dataset_r=0.25,
                      extra=(("encoder_features", (8, 16)),),
                      cohort_groups=0)
    seg = dataclasses.replace(seg, seed=1)

    def seg_on(dev):
        return build_sim(seg, dev)

    cpu = seg_on("cpu")
    start = cpu.init()
    want = topo_rounds(cpu, start)
    got = topo_rounds(seg_on(device), move_state(start, device))
    reports.append(spread_check("fedseg", seg_on, start, topo_rounds, want,
                                got))
    # the zoo: one local step a model, float32 (efficientnet-b0 float64)
    rng = torch.Generator().manual_seed(1)
    for name, (shape, k, extra, task) in TINY_ZOO.items():
        dtype = torch.float64 if name in TINY_ZOO_X64 else torch.float32
        mcfg = ModelConfig(name=name, num_classes=k, input_shape=shape,
                           extra=extra)
        tcfg = TrainConfig(lr=0.1, epochs=1,
                           compute_dtype=str(dtype).split(".")[1])
        x = torch.randn((4,) + shape, generator=rng, dtype=dtype)
        if task == "tag_prediction":
            x = (x > 1.5).to(dtype)
            y = (torch.rand((4, k), generator=rng) < 0.1).float()
        else:
            y_shape = (4,) + shape[:2] if task == "segmentation" else (4,)
            y = torch.randint(0, k, y_shape, generator=rng,
                              dtype=torch.int32)
        steps = {dev: zoo_step(mcfg, task, tcfg, dtype, x, y, dev)
                 for dev in ("cpu", device)}
        start = steps["cpu"][1]
        want, got = steps["cpu"][0](start), steps[device][0](start)
        err, use = gan_state_err((got,), (want,))
        report = {"case": f"zoo_{name}_step", "dtype": str(dtype),
                  "max_abs_err": err, "band_use": use, **GAN_BAND}
        if use > 1.0:
            # the statistical fallback: the CPU's own spread under a
            # PERTURB relative change of the start
            gen = torch.Generator().manual_seed(0)
            moved = {n: v * (1 + PERTURB * torch.randn(
                v.shape, generator=gen, dtype=v.dtype))
                if v.is_floating_point() else v for n, v in start.items()}
            spread = gan_state_err((steps["cpu"][0](moved),), (want,))[0]
            report.update(card_vs_cpu=err, cpu_spread=spread,
                          spread_factor=SPREAD_FACTOR)
            if err > SPREAD_FACTOR * spread:
                raise RuntimeError(f"zoo {name}: card vs CPU step outside "
                                   f"the band and the spread: {report}")
        reports.append(report)
    # hierarchical and decentralized: tests/test_torch_topology.py's
    for algo in ("hierarchical", "decentralized_dsgd",
                 "decentralized_pushsum"):
        cfg = tiny_topo_config(algo)
        data = load_dataset(cfg.data)

        def sim_on(dev, algo=algo, cfg=cfg, data=data):
            model = create_model(cfg.model, dev)
            if algo == "hierarchical":
                return HierarchicalFedAvg(model, data, cfg, dev,
                                          num_groups=2, group_comm_round=2)
            method = algo[len("decentralized_"):]
            topo = (AsymmetricTopologyManager(8, neighbor_num=4, seed=1)
                    if method == "pushsum" else None)
            return DecentralizedSim(model, data, cfg, dev, topology=topo,
                                    method=method)

        cpu = sim_on("cpu")
        start = cpu.init()
        want = topo_rounds(cpu, start)
        got = topo_rounds(sim_on(device), move_state(start, device))
        reports.append(spread_check(algo, sim_on, start, topo_rounds, want,
                                    got))
    # the online sims: N 8, T 100, the test's settings
    xs, ys = make_susy_like_stream(8, 100, beta=0.25, seed=0)
    for method, varying in (("dsgd", False), ("pushsum", False),
                            ("pushsum", True)):
        outs = [OnlineDecentralizedSim(
            xs, ys, method=method, lr=0.1, weight_decay=1e-3,
            time_varying=varying, seed=4, device=dev).run()
            for dev in ("cpu", device)]
        state = [(o["losses"], o["regret"], *o["params"]) for o in outs]
        err, use = gan_state_err(state[1], state[0])
        reports.append({"case": f"online_{method}"
                        + ("_time_varying" if varying else ""),
                        "max_abs_err": err, "band_use": use, **GAN_BAND})
        if use > 1.0:
            raise RuntimeError(f"online {method}: card vs CPU outside the "
                               f"band: {reports[-1]}")
    reports.append({"seconds": time.perf_counter() - t0})
    return reports


def topology_zoo_phase(card: str) -> int:
    """Phase 18: (a)-(g). Returns the flash kernels' launches over it (0:
    no model of the phase has attention)."""
    from fedml_tpu_torch.ops.flash_attention import flash_attention

    t0 = time.perf_counter()
    flash_attention.launches = 0
    flash_attention.mma_launches = 0
    parts = {}
    for name, run in (("a", fedseg_bench), ("b", zoo_bench),
                      ("c", hierarchical_bench), ("d", decentralized_bench),
                      ("e", dol_bench)):
        t_part = time.perf_counter()
        run(card)
        parts[name] = time.perf_counter() - t_part
        free_card()
    t_part = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        print(json.dumps({"topology_zoo_card_vs_cpu": topo_card_vs_cpu(),
                          "device": card}), flush=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.benchmark = benchmark
    parts["f"] = time.perf_counter() - t_part
    launches = flash_attention.launches + flash_attention.mma_launches
    if launches != 0:
        raise RuntimeError(f"phase 18 launched flash attention {launches} "
                           "times")
    record_line(card, metric="phase18_s", value=time.perf_counter() - t0,
                parts_s=parts, flash_launches=launches)
    return launches


# phase 19: split learning (FedGKT, SplitNN, vertical FL), FedNAS over
# DARTS, TurboAggregate's secure FedAvg and the local baselines
SPLIT_ROUNDS = 2
NAS_ROUNDS = 1
SECURE_ROUNDS = 1
VFL_EPOCHS = 5
# tests/test_mpc.py::test_secure_fedavg_matches_plain's bands
SECURE_BAND = 5e-4
DROPPED_BAND = 1e-6
# the CPU tests' clients (tests/test_torch_split.py SIZES) and batch
TINY_SIZES = (40, 30, 26)
TINY_BATCH = 8


def program_replays(update) -> int:
    """The CUDA graph replays of ``update``'s programs, every lane count."""
    return sum(g.replays for g in update.programs.values() if g is not None)


def synced(fn):
    """``fn()`` and its seconds, the host clock ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def split_config(algorithm: str, num_clients: int = 10, cpr: int = 10,
                 rounds: int = SPLIT_ROUNDS, dataset: str = "fake_cifar10"):
    """The headline's data (fake_cifar10, hetero 0.5, batch 32, lr 0.03,
    a cohort of 10 in 5 groups of lanes) for ``algorithm``, float32 (the
    JAX package's split sims and FedNAS take no compute type)."""
    return topo_config(dataset, "resnet56", num_clients, cpr,
                       algorithm=algorithm, rounds=rounds, dtype="float32")


def gkt_bench(card: str, device: str = "cuda") -> None:
    """(a): FedGKT at the JAX defaults (the resnet8_56 edge, the
    Bottleneck [6, 6, 6] server at 16/32/64), 10 clients all training,
    SPLIT_ROUNDS rounds, each phase timed; one replay a group-step and a
    server step."""
    from fedml_tpu_torch.experiments.harness import build_sim

    cfg = split_config("fedgkt")
    sim = build_sim(cfg, device)
    sim.time_phases = True
    state = sim.init()
    rows = []
    for r in range(cfg.fed.num_rounds):
        before = (program_replays(sim.edge_update),
                  program_replays(sim.server_update))
        state, _, seconds = timed_round(sim, state)
        row = {"round": r, "seconds": seconds,
               **{f"{k}_s": v for k, v in sim.last_phase_s.items()},
               "edge_group_steps": sim.last_steps["edge"],
               "edge_replays": program_replays(sim.edge_update) - before[0],
               "server_steps": sim.last_steps["server"],
               "server_replays": (program_replays(sim.server_update)
                                  - before[1]),
               "groups": [{"clients": n, "steps_per_epoch": s}
                          for n, s in sim.last_groups],
               **sim.evaluate(state)}
        rows.append(row)
        if (row["edge_replays"] != row["edge_group_steps"]
                or row["server_replays"] != row["server_steps"]
                or not bool(torch.isfinite(state.server_logits).all())):
            raise RuntimeError(f"fedgkt: {row}")
    record_line(card, metric="fedgkt_resnet8_56_server56_10c",
                edge_params=param_count_of(sim.client_model,
                                           state.client_stack, lead=1),
                server_params=param_count_of(sim.server_model,
                                             state.server_vars),
                rounds=rows)


def param_count_of(model, variables, lead: int = 0) -> int:
    return int(sum(v[(0,) * lead].numel() for k, v in variables.items()
                   if k not in model.stat_names))


def splitnn_bench(card: str, device: str = "cuda") -> None:
    """(b): SplitNN (convs 32/64, hidden 128) around a ring of 10
    clients, SPLIT_ROUNDS rounds, one replay a step."""
    from fedml_tpu_torch.experiments.harness import build_sim

    sim = build_sim(split_config("splitnn"), device)
    state = sim.init()
    rows = []
    for r in range(SPLIT_ROUNDS):
        before = program_replays(sim.update)
        state, m, seconds = timed_round(sim, state)
        row = {"round": r, "seconds": seconds, "steps": sim.last_steps,
               "replays": program_replays(sim.update) - before,
               **{k: float(v) for k, v in m.items()}, **sim.evaluate(state)}
        rows.append(row)
        if row["replays"] != row["steps"] or not math.isfinite(
                row["train_loss"]):
            raise RuntimeError(f"splitnn: {row}")
    record_line(card, metric="splitnn_10c_ring", rounds=rows)


def vfl_bench(card: str, device: str = "cuda") -> None:
    """(c): two-party vertical FL on fake_vfl, 5 epochs: the loss must
    fall; the accuracy and AUC after each epoch."""
    from fedml_tpu_torch.experiments.harness import build_sim

    sim = build_sim(split_config("vfl", rounds=VFL_EPOCHS,
                                 dataset="fake_vfl"), device)
    state = sim.init()
    rows = []
    for e in range(VFL_EPOCHS):
        (state, loss), seconds = synced(lambda: sim.run_epoch(state))
        rows.append({"epoch": e, "seconds": seconds, "train_loss": loss,
                     **sim.evaluate(state)})
    record_line(card, metric="vfl_fake_vfl_2party", parties=len(sim.splits),
                steps=state.step, epochs=rows)
    if not rows[-1]["train_loss"] < rows[0]["train_loss"]:
        raise RuntimeError(f"vfl: the loss did not fall: {rows}")


def fednas_bench(card: str, device: str = "cuda") -> None:
    """(d): FedNAS over DARTSNetwork's defaults (16 channels, 4 layers, 4
    steps), 100 clients, 10 a round, NAS_ROUNDS rounds: the peak memory,
    the alphas moving, the derived genotype."""
    from fedml_tpu_torch.experiments.harness import build_sim
    from fedml_tpu_torch.models.darts import ARCH, derive_genotype

    sim = build_sim(split_config("fednas", 100, 10, NAS_ROUNDS), device)
    state = sim.init()
    start = {k: state.variables[k].clone() for k in ARCH}
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for r in range(NAS_ROUNDS):
        before = program_replays(sim.update)
        state, _, seconds = timed_round(sim, state)
        rows.append({"round": r, "seconds": seconds,
                     "group_steps": sim.last_steps,
                     "replays": program_replays(sim.update) - before,
                     "groups": [{"clients": n, "steps_per_epoch": s}
                                for n, s in sim.last_groups]})
        if rows[-1]["replays"] != rows[-1]["group_steps"]:
            raise RuntimeError(f"fednas: {rows[-1]}")
    peak = torch.cuda.max_memory_allocated() / 2**20
    moved = {k: float((state.variables[k] - start[k]).abs().max())
             for k in ARCH}
    record_line(card, metric="fednas_darts16_4l_4s_100c", rounds=rows,
                batch=sim.batch_size, peak_allocated_mb=peak,
                alphas_max_change=moved,
                genotype=derive_genotype(state.variables),
                **sim.evaluate(state))
    if not all(v > 0 and math.isfinite(v) for v in moved.values()):
        raise RuntimeError(f"fednas: the alphas did not move: {moved}")


def vars_err(x: dict, y: dict) -> float:
    """Max |x - y| over two variable dicts, on any devices."""
    return max(float((x[k].cpu().double() - y[k].cpu().double()).abs().max())
               for k in y)


def secure_bench(card: str, device: str = "cuda") -> None:
    """(e): TurboAggregate at the headline (resnet56, bf16, 100 clients,
    10 a round), SECURE_ROUNDS rounds, the field pass's host seconds apart
    from the
    locals; then, from the state before the last round, the plain FedAvg
    round (the same sim's locals, cuDNN deterministic) against that
    secure round within SECURE_BAND, and the round with client 1 dropped
    after sharing against it within DROPPED_BAND."""
    import dataclasses

    from fedml_tpu_torch.experiments.harness import build_sim

    cfg = resnet_config()
    cfg = dataclasses.replace(cfg, fed=dataclasses.replace(
        cfg.fed, algorithm="turboaggregate", num_rounds=SECURE_ROUNDS))
    sim = build_sim(cfg, device)
    state = sim.init()
    rows = []
    for r in range(SECURE_ROUNDS):
        before = state
        state, m, seconds = timed_round(sim, state)
        rows.append({"round": r, "seconds": seconds,
                     "field_host_s": sim.last_field_s,
                     "locals_s": seconds - sim.last_field_s,
                     "train_loss": float(m["train_loss"])})
    secure = state
    plain, _ = sim.inner.run_round(before)
    dropped, _ = sim.run_round(before, dropped=[1])
    d = sum(v.numel() for v in state.variables.values())
    err = vars_err(secure.variables, plain.variables)
    drop_err = vars_err(dropped.variables, secure.variables)
    record_line(card, metric="turboaggregate_resnet56_100c_10pr",
                flat_d=d, cohort=sim.secure.num_clients,
                threshold=sim.secure.threshold,
                shares_mb=sim.secure.num_clients ** 2 * d * 8 / 2**20,
                rounds=rows, secure_vs_plain_max_abs=err,
                dropped_vs_undropped_max_abs=drop_err,
                **{"test_" + k: v for k, v in
                   sim.evaluate_global(secure).items()})
    if err > SECURE_BAND or drop_err > DROPPED_BAND:
        raise RuntimeError(f"turboaggregate: secure vs plain {err}, "
                           f"dropped vs undropped {drop_err}")


def baselines_bench(card: str, device: str = "cuda") -> None:
    """(f): the local-only baseline, every one of 100 clients on its own
    resnet56, and the centralized trainer over the pooled set, 1 round
    each at the headline (bf16)."""
    import dataclasses

    from fedml_tpu_torch.experiments.harness import build_sim

    for algo in ("baseline", "centralized"):
        cfg = resnet_config()
        cfg = dataclasses.replace(cfg, fed=dataclasses.replace(
            cfg.fed, algorithm=algo, num_rounds=1))
        sim = build_sim(cfg, device)
        state = sim.init()
        before = program_replays(sim.cohort_update)
        if algo == "baseline":
            state, m, seconds = timed_round(sim, state)
            ev = sim.evaluate_clients(state)
            ev.pop("per_client_acc")
        else:
            (state, m), seconds = synced(lambda: sim.run_round(state, 0))
            ev = {"test_" + k: v for k, v in sim.evaluate(state).items()}
        row = {"seconds": seconds, "lanes": sum(n for n, _ in
                                                sim.last_groups),
               "groups": len(sim.last_groups),
               "group_steps": sum(s for _, s in sim.last_groups),
               "replays": program_replays(sim.cohort_update) - before,
               **{k: float(v) for k, v in m.items()}, **ev}
        record_line(card, metric=f"{algo}_resnet56", **row)
        if (row["replays"] != row["group_steps"]
                or not math.isfinite(row["train_loss"])):
            raise RuntimeError(f"{algo}: {row}")
        del sim, state
        free_card()


def tiny_split_data():
    """tests/test_torch_split.py's image_data: random 16x16x3 images and
    labels from a numpy seed, TINY_SIZES clients."""
    import numpy as np

    from fedml_tpu_torch.data.federated import FederatedData

    rng = np.random.default_rng(0)
    n, n_test = sum(TINY_SIZES), 32
    x = rng.normal(size=(n, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    xt = rng.normal(size=(n_test, 16, 16, 3)).astype(np.float32)
    yt = rng.integers(0, 10, n_test).astype(np.int32)
    perm = rng.permutation(n)
    bounds = np.cumsum((0,) + TINY_SIZES)
    train = {i: np.sort(perm[bounds[i]:bounds[i + 1]])
             for i in range(len(TINY_SIZES))}
    test = {i: np.arange(n_test)[i::len(TINY_SIZES)]
            for i in range(len(TINY_SIZES))}
    return FederatedData(x, y, xt, yt, train, test, 10)


def tiny_split_config(cpr: int = len(TINY_SIZES), epochs: int = 1):
    """tests/test_torch_split.py's tiny_cfg: batch 8, SGD lr 0.05 with
    momentum 0.5."""
    from fedml_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        FedConfig,
        ModelConfig,
        TrainConfig,
    )

    return ExperimentConfig(
        data=DataConfig(dataset="fake_mnist", num_clients=len(TINY_SIZES),
                        batch_size=TINY_BATCH, seed=0),
        model=ModelConfig(name="lr", num_classes=10, input_shape=(16, 16, 3)),
        train=TrainConfig(lr=0.05, momentum=0.5, epochs=epochs),
        fed=FedConfig(num_rounds=2, clients_per_round=cpr), seed=0)


def tiny_split_sim(algo: str, device: str, float64: bool = False):
    """The CPU tests' sims of (a), (b), (d) and (f) on ``device``."""
    from fedml_tpu_torch.algorithms.fednas import FedNASSim
    from fedml_tpu_torch.algorithms.local_baselines import (
        BaselineSim,
        CentralizedTrainer,
    )
    from fedml_tpu_torch.algorithms.split import FedGKTSim, SplitNNSim
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.models import gkt as GKT
    from fedml_tpu_torch.models.base import FedModel, weightless
    from fedml_tpu_torch.models.darts import DARTSNetwork

    def fed(module_fn, shape):
        return FedModel(weightless(module_fn), shape, torch.device(device))

    data = tiny_split_data()
    if algo == "fedgkt":
        sim = FedGKTSim(fed(lambda: GKT.GKTClientResNet(10, 1, 8),
                            (16, 16, 3)),
                        fed(lambda: GKT.GKTServerResNet(10, (1, 1, 1),
                                                        (4, 8, 8), 8),
                            (16, 16, 8)), data, tiny_split_config(), device)
    elif algo == "splitnn":
        sim = SplitNNSim(fed(lambda: GKT.SplitClientNet((8, 16)),
                             (16, 16, 3)),
                         fed(lambda: GKT.SplitServerNet(256, 10, 32),
                             (256,)), data, tiny_split_config(), device)
    elif algo == "fednas":
        sim = FedNASSim(fed(lambda: DARTSNetwork(10, 4, 3, 2), (16, 16, 3)),
                        data, tiny_split_config(cpr=2), device)
    else:
        cfg = tiny_split_config(epochs=2 if algo == "centralized" else 1)
        cls = BaselineSim if algo == "baseline" else CentralizedTrainer
        sim = cls(create_model(cfg.model, device), data, cfg, device)
    if float64:
        sim.arrays.x = sim.arrays.x.double()
        sim.arrays.test_x = sim.arrays.test_x.double()
    return sim


def float64_state(state):
    """A state's floating tensors as float64."""
    from fedml_tpu_torch.core import tree as T

    return T.tree_map(lambda v: v.double() if torch.is_tensor(v)
                      and v.is_floating_point() else v, state)


def split_card_vs_cpu(device: str = "cuda") -> list:
    """(g): each of (a)-(f) at its CPU test's configuration on the card
    and on the CPU from the same start, with the same draws (the hooks'
    defaults draw on the host), TF32 off and cuDNN deterministic: every
    leaf within GAN_BAND, or else within SPREAD_FACTOR times the CPU's
    own spread under a PERTURB change of the start. FedGKT runs in
    float64 on both, as its CPU test does (its float32 server is
    ill-conditioned there), and in float32, the dtype (a) times; the
    secure rounds, whose quantization a
    float32 difference in the locals may move by one 2^-16 step, within
    SECURE_BAND, the plain rounds within GAN_BAND, and the card's secure
    round against its plain and its dropped round as in (e)."""
    from fedml_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        FedConfig,
        ModelConfig,
        TrainConfig,
    )
    from fedml_tpu_torch.core import tree as T
    from fedml_tpu_torch.experiments.harness import build_sim

    reports = []
    t0 = time.perf_counter()
    for algo, x64 in (("fedgkt", True), ("fedgkt", False),
                      ("splitnn", False), ("fednas", False),
                      ("baseline", False)):

        def sim_on(dev, algo=algo, x64=x64):
            return tiny_split_sim(algo, dev, x64)

        cpu = sim_on("cpu")
        start = cpu.init()
        if x64:
            start = float64_state(start)
        want = topo_rounds(cpu, start)
        got = topo_rounds(sim_on(device), move_state(start, device))
        report = spread_check(algo, sim_on, start, topo_rounds, want, got)
        reports.append({**report, "dtype": "float64" if x64 else "float32"})
    # the centralized trainer: its state is the variables
    trainers = {dev: tiny_split_sim("centralized", dev)
                for dev in ("cpu", device)}
    variables = trainers["cpu"].init()
    out = {}
    for dev, tr in trainers.items():
        v = {k: t.to(dev) for k, t in variables.items()}
        states = []
        for r in range(2):
            v, _ = tr.run_round(v, r)
            states.append((v,))
        out[dev] = states
    errs = [gan_state_err(g, w) for g, w in zip(out[device], out["cpu"])]
    err, use = (max(e[i] for e in errs) for i in (0, 1))
    reports.append({"case": "centralized", "max_abs_err": err,
                    "band_use": use, **GAN_BAND})
    if use > 1.0:
        raise RuntimeError(f"centralized: card vs CPU {reports[-1]}")
    # vertical FL: tests/test_torch_split.py's fake_vfl, 3 epochs
    vcfg = ExperimentConfig(data=DataConfig(dataset="fake_vfl",
                                            batch_size=64, seed=3),
                            train=TrainConfig(lr=0.1, momentum=0.5),
                            fed=FedConfig(algorithm="vfl"), seed=0)
    vsims = {dev: build_sim(vcfg, dev) for dev in ("cpu", device)}
    vstart = vsims["cpu"].init()
    runs = {}
    for dev, sim in vsims.items():
        state = T.tree_map(lambda v, dev=dev: v.to(dev) if torch.is_tensor(v)
                           else v, vstart)
        losses = []
        for _ in range(3):
            state, loss = sim.run_epoch(state)
            losses.append(loss)
        runs[dev] = (torch.tensor(losses),
                     *[v for p in state.party_vars for part in p
                       for v in part.values()])
    err, use = gan_state_err(runs[device], runs["cpu"])
    reports.append({"case": "vfl", "max_abs_err": err, "band_use": use,
                    **GAN_BAND})
    if use > 1.0:
        raise RuntimeError(f"vfl: card vs CPU {reports[-1]}")
    # the secure round: tests/test_torch_mpc.py's configuration
    scfg = ExperimentConfig(
        data=DataConfig(dataset="fake_mnist", num_clients=8, batch_size=16,
                        seed=0, dataset_r=0.2),
        model=ModelConfig(name="lr", num_classes=10,
                          input_shape=(28, 28, 1)),
        train=TrainConfig(lr=0.1, epochs=1),
        fed=FedConfig(algorithm="turboaggregate", num_rounds=1,
                      clients_per_round=4, eval_every=1), seed=0)
    secure = {dev: build_sim(scfg, dev) for dev in ("cpu", device)}
    sstart = secure["cpu"].init()
    got = {dev: sim.run_round(move_state(sstart, dev))[0]
           for dev, sim in secure.items()}
    plain = {dev: sim.inner.run_round(move_state(sstart, dev))[0]
             for dev, sim in secure.items()}
    dropped, _ = secure[device].run_round(move_state(sstart, device),
                                          dropped=[1])
    # the plain rounds within GAN_BAND; the secure ones within the
    # quantization's band: a float32 difference in the locals may move a
    # weighted delta across one 2^-16 step of the field
    err, use = gan_state_err((plain[device].variables,),
                             (plain["cpu"].variables,))
    row = {"case": "turboaggregate", "plain_max_abs_err": err,
           "plain_band_use": use, **GAN_BAND,
           "secure_max_abs_err": vars_err(got[device].variables,
                                          got["cpu"].variables),
           "card_secure_vs_plain": vars_err(got[device].variables,
                                            plain[device].variables),
           "card_dropped_vs_undropped": vars_err(dropped.variables,
                                                 got[device].variables)}
    reports.append(row)
    if (use > 1.0 or row["secure_max_abs_err"] > SECURE_BAND
            or row["card_secure_vs_plain"] > SECURE_BAND
            or row["card_dropped_vs_undropped"] > DROPPED_BAND):
        raise RuntimeError(f"turboaggregate: card vs CPU {row}")
    reports.append({"seconds": time.perf_counter() - t0})
    return reports


def split_nas_phase(card: str) -> int:
    """Phase 19: (a)-(h). Returns the flash kernels' launches over it (0:
    no model of the phase has attention)."""
    from fedml_tpu_torch.ops.flash_attention import flash_attention

    t0 = time.perf_counter()
    flash_attention.launches = 0
    flash_attention.mma_launches = 0
    parts = {}
    for name, run in (("a", gkt_bench), ("b", splitnn_bench),
                      ("c", vfl_bench), ("d", fednas_bench)):
        t_part = time.perf_counter()
        run(card)
        parts[name] = time.perf_counter() - t_part
        free_card()
    deterministic = torch.backends.cudnn.deterministic
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        for name, run in (("e", secure_bench), ("f", baselines_bench)):
            t_part = time.perf_counter()
            run(card)
            parts[name] = time.perf_counter() - t_part
            free_card()
        t_part = time.perf_counter()
        print(json.dumps({"split_nas_card_vs_cpu": split_card_vs_cpu(),
                          "device": card}), flush=True)
        parts["g"] = time.perf_counter() - t_part
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.benchmark = benchmark
    launches = flash_attention.launches + flash_attention.mma_launches
    if launches != 0:
        raise RuntimeError(f"phase 19 launched flash attention {launches} "
                           "times")
    record_line(card, metric="phase19_s", value=time.perf_counter() - t0,
                parts_s=parts, flash_launches=launches)
    return launches


# phase 20: data on disk (item 18), and item 13b's rest: the async buffer,
# the per-client metrics and FID
CIFAR_ROWS = 10_000  # a batch file's rows: five train batches and a test
MNIST_ROWS = (60_000, 10_000)
MNIST_CLIENTS = 100
FEMNIST_USERS = 200  # cut from LEAF FEMNIST's ~3,600 writers
FEMNIST_SAMPLES = (180, 275)  # a writer's samples, mean ~227 (LEAF's)
SUSY_NODES = 8
SUSY_T = 2000  # phase 18's stream length
DISK_ROUNDS = 2  # (a); (b) runs 2
DISK_CLI_TIMEOUT_S = 600
ASYNC_K = 32  # (e): the buffer's K, its lags 0-7, stopped after 13 folds
ASYNC_LAGS = 8
ASYNC_STOP = 13
ASYNC_DELTA = 0.01  # the deltas' scale
# a fold against the float64 weighted mean on the host: 32 float32 sums of
# deltas of size 0.01
ASYNC_BAND = dict(atol=1e-7, rtol=1e-5)
FID_SAME = 1e-6  # FID(real, real) at most this share of 1 + FID(real, fake)
TINY_METRICS_COUNTS = (9, 3, 0, 6)  # tests/test_torch_metrics.py's clients


def write_cifar10(root: str, seed: int = 0) -> dict:
    """CIFAR-10's python layout at its published size under
    ``root/cifar-10-batches-py``: ``data_batch_1``..``5`` and
    ``test_batch``, each a pickled dict of CIFAR_ROWS rows (``b"data"``
    ``[n, 3072]`` uint8, a 32x32 image's R, G and B planes; ``b"labels"``,
    ``b"batch_label"``, ``b"filenames"``), and ``batches.meta``. A pixel
    is its class's seeded prototype plus uniform noise, so the labels can
    be learned. Returns ``{file: (pixels, labels)}``."""
    import pickle

    import numpy as np

    rng = np.random.default_rng(seed)
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d)
    proto = rng.integers(40, 216, (10, 3072)).astype(np.int16)
    written = {}
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        labels = rng.integers(0, 10, CIFAR_ROWS)
        noise = rng.integers(-64, 65, (CIFAR_ROWS, 3072), dtype=np.int16)
        pixels = np.clip(proto[labels] + noise, 0, 255).astype(np.uint8)
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({b"batch_label": name.encode(),
                         b"labels": labels.tolist(), b"data": pixels,
                         b"filenames": [f"{name}_{i:05d}.png".encode()
                                        for i in range(CIFAR_ROWS)]}, f)
        written[name] = (pixels, labels)
    with open(os.path.join(d, "batches.meta"), "wb") as f:
        pickle.dump({b"num_cases_per_batch": CIFAR_ROWS, b"num_vis": 3072,
                     b"label_names": [c.encode() for c in (
                         "airplane", "automobile", "bird", "cat", "deer",
                         "dog", "frog", "horse", "ship", "truck")]}, f)
    return written


def decode_cifar10(root: str, written: dict):
    """The phase's own decode of the batch files: the rows back to NHWC,
    normalized by CIFAR-10's mean and std in float32. Each file's bytes
    must be the pixels written."""
    import pickle

    import numpy as np

    mean = np.array([0.4914, 0.4822, 0.4465], np.float32)
    std = np.array([0.2470, 0.2435, 0.2616], np.float32)
    out = {}
    for name, (pixels, labels) in written.items():
        with open(os.path.join(root, "cifar-10-batches-py", name), "rb") as f:
            blob = pickle.load(f, encoding="bytes")
        if not (np.array_equal(blob[b"data"], pixels)
                and blob[b"labels"] == labels.tolist()):
            raise RuntimeError(f"{name}: the file holds other rows")
        x = blob[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        out[name] = ((x.astype(np.float32) / 255.0 - mean) / std,
                     np.asarray(blob[b"labels"], np.int32))
    train = [out[f"data_batch_{i}"] for i in range(1, 6)]
    return (np.concatenate([x for x, _ in train]),
            np.concatenate([y for _, y in train]), *out["test_batch"])


def bitwise_equal(name: str, got, want) -> None:
    import numpy as np

    if got.dtype != want.dtype or not np.array_equal(got, want):
        raise RuntimeError(f"{name}: the loaded array is not the decode "
                           f"({got.dtype} {got.shape} against {want.dtype} "
                           f"{want.shape})")


def disk_config(root: str, out_dir: str):
    """(a): bench.py build_sim's configuration (resnet_config) on CIFAR-10
    read from ``root``, DISK_ROUNDS rounds, a checkpoint at the last."""
    import dataclasses

    cfg = resnet_config()
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, dataset="cifar10",
                                      data_dir=root),
        fed=dataclasses.replace(cfg.fed, num_rounds=DISK_ROUNDS),
        checkpoint_every=DISK_ROUNDS, run_name="cifar10_disk",
        out_dir=out_dir)


def cifar_from_disk(card: str, tmp: str, device: str = "cuda"):
    """(a): CIFAR-10's files written, loaded by the port bitwise equal to
    the phase's decode, then ResNet-56 FedAvg through the CLI in a child
    process reading them. Returns (the loaded data, the config, the
    final global variables on the CPU)."""
    from fedml_tpu_torch.data import load_dataset
    from fedml_tpu_torch.utils.checkpoint import RoundCheckpointer

    root = os.path.join(tmp, "cifar10")
    t0 = time.perf_counter()
    written = write_cifar10(root)
    write_s = time.perf_counter() - t0
    out_dir = os.path.join(tmp, "runs")
    cfg = disk_config(root, out_dir)
    t0 = time.perf_counter()
    data = load_dataset(cfg.data)
    load_s = time.perf_counter() - t0
    want = decode_cifar10(root, written)
    for name, got, w in zip(("x_train", "y_train", "x_test", "y_test"),
                            (data.x_train, data.y_train, data.x_test,
                             data.y_test), want):
        bitwise_equal(name, got, w)
    if data.x_train.shape != (5 * CIFAR_ROWS, 32, 32, 3) \
            or data.num_clients != cfg.data.num_clients:
        raise RuntimeError(f"CIFAR-10 from disk: {data.x_train.shape}, "
                           f"{data.num_clients} clients")
    cfg_path = os.path.join(tmp, "cifar10_disk.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    # the config file carries the rest (cohort_groups, scan_unroll)
    args = ["--config", cfg_path, "--algorithm", "fedavg", "--dataset",
            "cifar10", "--data_dir", root, "--model", cfg.model.name,
            "--client_num_in_total", str(cfg.data.num_clients),
            "--client_num_per_round", str(cfg.fed.clients_per_round),
            "--partition_method", cfg.data.partition_method,
            "--partition_alpha", str(cfg.data.partition_alpha),
            "--batch_size", str(cfg.data.batch_size), "--lr",
            str(cfg.train.lr), "--compute_dtype", cfg.train.compute_dtype,
            "--comm_round", str(DISK_ROUNDS), "--frequency_of_the_test",
            "1", "--checkpoint_every", str(DISK_ROUNDS), "--run_name",
            cfg.run_name, "--device", device]
    started = time.time()
    t0 = time.perf_counter()
    proc = child(args, out_dir)
    if proc.wait(timeout=DISK_CLI_TIMEOUT_S) != 0:
        raise RuntimeError(f"CIFAR-10 CLI run rc {proc.returncode}: "
                           f"{child_error(out_dir)}")
    cli_s = time.perf_counter() - t0
    run_dir = os.path.join(out_dir, f"{cfg.run_name}_rep0")
    rows = read_rows(run_dir)
    accs = [r["test_acc"] for r in rows]
    blob, nxt = RoundCheckpointer(os.path.join(run_dir, "ckpt")).restore_raw()
    record_line(card, metric="cifar10_from_disk_resnet56",
                files_write_s=write_s, load_s=load_s,
                load_rows=[len(data.x_train), len(data.x_test)],
                cli_s=cli_s, time_to_first_round_s=rows[0]["_ts"] - started,
                round_s=[b["_ts"] - a["_ts"] for a, b in zip(rows, rows[1:])],
                test_acc=accs, test_loss=[r["test_loss"] for r in rows],
                train_loss=[r.get("train_loss") for r in rows],
                note="host clocks; time to the first round from the child's "
                     "start to its first row (the process start, the load, "
                     "the capture, round 0 and its evaluation); a round's "
                     "seconds between consecutive rows, each with its "
                     "evaluation")
    if ([r["round"] for r in rows] != list(range(DISK_ROUNDS))
            or nxt != DISK_ROUNDS
            or not all(math.isfinite(r["test_loss"]) for r in rows)
            or not 0.1 < accs[-1] <= 1.0):
        raise RuntimeError(f"CIFAR-10 CLI run: {rows}, checkpoint {nxt}")
    return data, cfg, blob["variables"]


def write_idx_gz(path: str, arr) -> None:
    """An IDX file (big-endian dims after a 4-byte magic), gzipped."""
    import gzip
    import struct

    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(struct.pack(">HBB", 0, 8, arr.ndim)  # 8: unsigned bytes
                + struct.pack(">" + "I" * arr.ndim, *arr.shape)
                + arr.astype("uint8").tobytes())


def write_mnist(d: str, seed: int = 1) -> int:
    """MNIST's four gzipped IDX files at 60,000/10,000, each digit its
    class's seeded prototype plus noise. Returns the samples written."""
    import numpy as np

    rng = np.random.default_rng(seed)
    os.makedirs(d)
    proto = rng.integers(0, 200, (10, 28, 28)).astype(np.int16)
    for split, n in zip(("train", "t10k"), MNIST_ROWS):
        labels = rng.integers(0, 10, n)
        noise = rng.integers(-60, 61, (n, 28, 28), dtype=np.int16)
        images = np.clip(proto[labels] + noise, 0, 255)
        write_idx_gz(os.path.join(d, f"{split}-images-idx3-ubyte.gz"),
                     images)
        write_idx_gz(os.path.join(d, f"{split}-labels-idx1-ubyte.gz"),
                     labels)
    return sum(MNIST_ROWS)


def leaf_rows_json(q) -> bytes:
    """``[n, 784]`` pixel levels 0-4 as json rows of floats on a quarter
    grid (``[[0.25,1.00,...],...]``), one byte table lookup."""
    import numpy as np

    table = np.frombuffer(b"0.00,0.25,0.50,0.75,1.00,", np.uint8)
    body = table.reshape(5, 5)[q].reshape(len(q), 5 * q.shape[1])
    body[:, -1] = ord("]")
    edge = np.full((len(q), 1), ord("["), np.uint8)
    rows = np.concatenate([edge, body, np.full_like(edge, ord(","))], 1)
    return b"[" + rows.tobytes()[:-1] + b"]"


def write_leaf_femnist(d: str, seed: int = 2) -> int:
    """LEAF FEMNIST's json layout, cut to FEMNIST_USERS writers of
    FEMNIST_SAMPLES samples: ``train/`` and ``test/`` each four
    ``all_data_<k>_niid_0_keep_0_<split>_9.json`` files with ``users``,
    ``num_samples`` and ``user_data`` (``x`` 784 floats in [0, 1], ``y``
    one of 62 classes); a writer's last tenth is its test split. Returns
    the samples written."""
    import json

    import numpy as np

    rng = np.random.default_rng(seed)
    proto = rng.random((62, 784))
    users = {"train": {}, "test": {}}
    total = 0
    for u in range(FEMNIST_USERS):
        n = int(rng.integers(*FEMNIST_SAMPLES))
        y = rng.integers(0, 62, n)
        q = np.round(4 * np.clip(proto[y] + rng.normal(0, 0.15, (n, 784)),
                                 0, 1)).astype(np.int64)
        cut = n - max(1, n // 10)
        name = f"f{u:04d}_{u % 100:02d}"
        users["train"][name] = (q[:cut], y[:cut])
        users["test"][name] = (q[cut:], y[cut:])
        total += n
    for split, data in users.items():
        os.makedirs(os.path.join(d, split))
        names = list(data)
        for k in range(4):
            part = names[k::4]
            blob = b", ".join(
                json.dumps(u).encode() + b': {"x": '
                + leaf_rows_json(data[u][0]) + b', "y": '
                + json.dumps(data[u][1].tolist()).encode() + b"}"
                for u in part)
            with open(os.path.join(d, split, f"all_data_{k}_niid_0_keep_0_"
                                   f"{split}_9.json"), "wb") as f:
                f.write(b'{"users": ' + json.dumps(part).encode()
                        + b', "num_samples": ' + json.dumps(
                            [len(data[u][1]) for u in part]).encode()
                        + b', "user_data": {' + blob + b"}}")
    return total


def write_susy(d: str, seed: int = 3) -> int:
    """A ``SUSY.csv`` of the rows the stream reads (4 N T): the label
    first, then 18 features, a noisy linear concept. Returns its rows."""
    import numpy as np

    rows = 4 * SUSY_NODES * SUSY_T
    rng = np.random.default_rng(seed)
    os.makedirs(d)
    x = rng.normal(size=(rows, 18))
    y = (x @ rng.normal(size=18) + rng.normal(0, 0.5, rows) > 0)
    np.savetxt(os.path.join(d, "SUSY.csv"), np.column_stack([y, x]),
               delimiter=",", fmt="%.8e")
    return rows


def other_formats(card: str, tmp: str, device: str = "cuda") -> None:
    """(b): MNIST's gzipped IDX through lr, LEAF FEMNIST's json through
    cnn (2 rounds each, 10 clients a round) and a SUSY csv through
    dol_dsgd (its regret falling), each through the CLI's arguments and
    the harness; a JSON line each with its write and run seconds and its
    summary."""
    from fedml_tpu_torch.experiments import run as cli
    from fedml_tpu_torch.experiments.harness import Experiment

    runs = {
        "mnist": (write_mnist, [
            "--algorithm", "fedavg", "--dataset", "mnist", "--model", "lr",
            "--num_classes", "10", "--input_shape", "28", "28", "1",
            "--client_num_in_total", str(MNIST_CLIENTS),
            "--client_num_per_round", "10", "--partition_method", "hetero",
            "--partition_alpha", "0.5", "--comm_round", "2", "--batch_size",
            "32", "--lr", "0.03"], 0.1),
        "leaf_femnist": (write_leaf_femnist, [
            "--algorithm", "fedavg", "--dataset", "leaf_femnist", "--model",
            "cnn", "--num_classes", "62", "--input_shape", "28", "28", "1",
            "--client_num_per_round", "10", "--comm_round", "2",
            "--batch_size", "32", "--lr", "0.1", "--epochs", "2"], 1 / 62),
        "susy": (write_susy, [
            "--algorithm", "dol_dsgd", "--dataset", "susy", "--model", "lr",
            "--client_num_in_total", str(SUSY_NODES), "--comm_round",
            str(SUSY_T), "--lr", "0.3", "--frequency_of_the_test",
            str(SUSY_T // 4)],
            None),
    }
    out_dir = os.path.join(tmp, "runs")
    for name, (write, argv, chance) in runs.items():
        d = os.path.join(tmp, name)
        t0 = time.perf_counter()
        written = write(d)
        write_s = time.perf_counter() - t0
        cfg, _ = cli.parse_args(argv + ["--data_dir", d, "--out_dir",
                                        out_dir, "--run_name", name])
        t0 = time.perf_counter()
        summary = Experiment(cfg, device=device).run()[0]
        run_s = time.perf_counter() - t0
        rows = read_rows(os.path.join(out_dir, f"{name}_rep0"))
        record_line(card, metric=f"{name}_from_disk", files_write_s=write_s,
                    samples_written=written, run_s=run_s,
                    summary={k: v for k, v in summary.items()
                             if isinstance(v, (int, float, str))},
                    note="host clocks; run_s is the harness's whole run: "
                         "the load, the partition, the captures, the rounds "
                         "and the evaluation")
        if chance is None:
            ok = (math.isfinite(summary["final_regret"])
                  and summary["final_regret"] < rows[0]["regret"])
        else:
            ok = (math.isfinite(summary["test_loss"])
                  and chance < summary["test_acc"] <= 1.0)
        if not ok:
            raise RuntimeError(f"{name} from disk: {summary}")


def per_client_metrics(card: str, data, cfg, variables,
                       device: str = "cuda") -> None:
    """(c): log_per_client_observability of (a)'s global model over every
    client's train and test slice: its seconds and max_memory_allocated;
    every real row of each split in one confusion cell."""
    import numpy as np

    from fedml_tpu_torch.metrics import MetricsSink
    from fedml_tpu_torch.metrics.observability import (
        build_per_client_eval,
        log_per_client_observability,
    )
    from fedml_tpu_torch.models import create_model

    model = create_model(cfg.model, device)
    arrays = data.to_arrays(device=device)
    variables = {k: v.to(device) for k, v in variables.items()}
    free_card()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    record = log_per_client_observability(MetricsSink(), model, variables,
                                          arrays, DISK_ROUNDS - 1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    train = build_per_client_eval(model, arrays.num_classes)(
        variables, arrays.x, arrays.y, arrays.idx, arrays.mask)
    cells = {"train": float(train["confusion"].sum()),
             "test": float(np.asarray(record["confusion_test"]).sum())}
    rows = {"train": float(arrays.mask.sum()),
            "test": float(arrays.test_mask.sum())}
    acc = train["acc"].cpu().numpy()
    same = all(record[f"Client {i}/Train/Acc"] == float(acc[i])
               for i in range(arrays.num_clients))
    record_line(card, metric="per_client_observability_resnet56",
                clients=arrays.num_clients, seconds=seconds,
                max_memory_allocated_mb=peak / 2**20,
                resident_before_mb=base / 2**20, confusion_cells=cells,
                real_rows=rows, train_acc=record["Train/Acc"],
                test_acc=record["Test/Acc"],
                note="host clock ending in a synchronize; both splits")
    if cells != rows or rows["train"] != 5 * CIFAR_ROWS or not same:
        raise RuntimeError(f"per-client metrics: cells {cells}, rows {rows}, "
                           f"train accuracies agree {same}")


def fid_round(card: str, tmp: str, device: str = "cuda") -> None:
    """(d): one FedGDKD round at phase 13's data, then log_gan_round with
    the default scorer and with make_fid_scorer(train_data=...), which
    fits TrainedCNNEmbed here: FID(real, real) 0 up to rounding, FID(real,
    fake) larger, the grid file written."""
    import numpy as np

    from fedml_tpu_torch.metrics import MetricsSink
    from fedml_tpu_torch.metrics import fid as FID

    sim = fedgdkd_sim(fedgdkd_config(), 6000, device)
    t0 = time.perf_counter()
    state, _ = sim.run_round(sim.init())
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    sink = MetricsSink(os.path.join(tmp, "fid", "metrics.jsonl"))
    real = sim.arrays.test_x[:256].cpu().numpy()
    out = {}
    for name in ("default", "trained"):
        t0 = time.perf_counter()
        scorer = (FID._default_scorer(sim.device) if name == "default"
                  else FID.make_fid_scorer(train_data=(
                      sim.arrays.test_x.cpu().numpy(),
                      sim.arrays.test_y.cpu().numpy()), num_classes=10,
                      device=device))
        make_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec = FID.log_gan_round(sink, sim, state, 1, scorer=scorer)
        log_s = time.perf_counter() - t0
        same = scorer.calculate_fid(real, real)
        grid = np.load(rec["sample_grid"])
        out[name] = {"fid_real_fake": rec["fid"], "fid_real_real": same,
                     "scorer_s": make_s, "log_s": log_s,
                     "grid_shape": list(grid.shape)}
        if not (0.0 <= same <= FID_SAME * (1.0 + rec["fid"])
                and rec["fid"] > same and grid.shape == (224, 224, 1)):
            raise RuntimeError(f"FID, {name} scorer: {out[name]}")
    sink.close()
    record_line(card, metric="fid_fedgdkd_round", round_s=round_s, **out,
                note="host clocks; round 0 includes its captures; the "
                     "trained scorer's seconds its fit on the 1,000-image "
                     "test split, the default's log its first embed")


def async_buffer(card: str, template: dict, stat_names: tuple,
                 device: str = "cuda") -> None:
    """(e): 32 seeded ResNet-56-sized deltas folded at lags 0-7 (poly,
    alpha 0.5, K 32) and emitted through server_update, against a
    float64 weighted mean on the host; the buffer stopped after 13
    folds, saved, loaded into a new one and finished equals the
    uninterrupted one bit for bit."""
    import numpy as np

    from fedml_tpu_torch.algorithms.fedavg import (
        ServerState,
        local_reducer,
        make_server_optimizer,
        server_update,
    )
    from fedml_tpu_torch.config import FedConfig
    from fedml_tpu_torch.core.async_agg import AsyncBuffer, AsyncConfig

    acfg = AsyncConfig(ASYNC_K, "poly", 0.5)
    gen = torch.Generator(device=device).manual_seed(20)
    deltas = [{k: ASYNC_DELTA * torch.randn(v.shape, generator=gen,
                                            device=device)
               for k, v in template.items()} for _ in range(ASYNC_K)]
    n_k = np.random.default_rng(20).integers(50, 1000, ASYNC_K)
    lags = [i % ASYNC_LAGS for i in range(ASYNC_K)]

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    buf = AsyncBuffer(acfg, template)
    fold_ms = [timed(lambda: buf.fold(d, float(n), lag))[1]
               for d, n, lag in zip(deltas, n_k, lags)]
    if not buf.ready():
        raise RuntimeError(f"async buffer not ready after {buf.count}")
    (mean_delta, mass), emit_ms = timed(buf.emit)
    w = [acfg.weight(lag) * float(n) for n, lag in zip(n_k, lags)]
    want = {k: sum(wi * d[k].double().cpu() for wi, d in zip(w, deltas))
            / sum(w) for k in template}
    err = max((mean_delta[k].double().cpu() - want[k]).abs().max().item()
              for k in template)
    ok = all(torch.allclose(mean_delta[k].double().cpu(), want[k],
                            **ASYNC_BAND) for k in template)
    params = {k: v for k, v in template.items() if k not in stat_names}
    state = ServerState(template, make_server_optimizer(
        "sgd", 1.0, 0.0).init(params), {k: torch.zeros_like(v)
                                        for k, v in params.items()}, 0)
    row = {k: (v + mean_delta[k].to(v.dtype))[None]
           for k, v in template.items()}
    new = server_update(FedConfig(), state, row,
                        torch.tensor([mass], device=device), local_reducer(),
                        stat_names)
    stepped = {k: (new.variables[k].double().cpu(),
                   template[k].double().cpu() + want[k]) for k in template}
    step_err = max((a - b).abs().max().item() for a, b in stepped.values())
    # g + mean delta rounds twice in float32 (the row, then the step)
    step_ok = all(torch.allclose(a, b, rtol=1e-6, atol=1e-7)
                  for a, b in stepped.values())
    first = AsyncBuffer(acfg, template)
    for d, n, lag in zip(deltas[:ASYNC_STOP], n_k, lags):
        first.fold(d, float(n), lag)
    resumed = AsyncBuffer(acfg, template)
    resumed.load_arrays(first.state_arrays())
    for d, n, lag in zip(deltas[ASYNC_STOP:], n_k[ASYNC_STOP:],
                         lags[ASYNC_STOP:]):
        resumed.fold(d, float(n), lag)
    again, again_mass = resumed.emit()
    bitwise = again_mass == mass and all(
        torch.equal(again[k], mean_delta[k]) for k in template)
    record_line(card, metric="async_buffer_resnet56", folds=ASYNC_K,
                leaves=len(template),
                values=sum(v.numel() for v in template.values()),
                fold_ms_median=statistics.median(fold_ms),
                fold_ms_range=[min(fold_ms), max(fold_ms)], emit_ms=emit_ms,
                max_abs_err_vs_float64=err, band=ASYNC_BAND,
                server_update_err=step_err, resumed_bitwise=bitwise,
                note="CUDA-event times around one fold and one emit, each "
                     "with its host dispatch")
    if not (ok and bitwise and step_ok):
        raise RuntimeError(f"async buffer: within the band {ok}, resumed "
                           f"bitwise {bitwise}, server_update {step_err}")


def tiny_metrics_data(device: str):
    """tests/test_torch_metrics.py's clients: 9, 3, 0 and 6 rows of 8x8x3,
    5 classes, a test split that overlaps between clients."""
    import numpy as np

    from fedml_tpu_torch.data.federated import FederatedData

    rng = np.random.default_rng(0)
    n = sum(TINY_METRICS_COUNTS)
    x = rng.standard_normal((n, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 5, n).astype(np.int32)
    xt = rng.standard_normal((7, 8, 8, 3)).astype(np.float32)
    yt = rng.integers(0, 5, 7).astype(np.int32)
    starts = np.cumsum((0,) + TINY_METRICS_COUNTS)
    tr = {i: np.arange(starts[i], starts[i + 1]) for i in range(4)}
    te = {0: np.arange(0, 4), 1: np.arange(2, 7), 2: np.arange(1, 3),
          3: np.arange(5, 7)}
    return FederatedData(x, y, xt, yt, tr, te, 5).to_arrays(device=device)


def perturbed(tree: dict, perturb: float) -> dict:
    """The float leaves of ``tree`` (on the CPU) times 1 + ``perturb`` x a
    seeded standard normal draw."""
    gen = torch.Generator().manual_seed(0)
    return {k: v * (1 + perturb * torch.randn(v.shape, generator=gen,
                                              dtype=v.dtype))
            if perturb and v.is_floating_point() else v
            for k, v in tree.items()}


def held_card_vs_cpu(name: str, run, device: str) -> dict:
    """``run(device, perturb)`` (a tuple of tensors) on the card against
    the CPU within GAN_BAND, or else within SPREAD_FACTOR times the CPU's
    own spread under a PERTURB change of the start."""
    want, got = run("cpu", 0.0), run(device, 0.0)
    err, use = gan_state_err(got, want)
    report = {"case": name, "max_abs_err": err, "band_use": use,
              **GAN_BAND}
    if use > 1.0:
        spread = gan_state_err(run("cpu", PERTURB), want)[0]
        report.update(card_vs_cpu=err, cpu_spread=spread,
                      spread_factor=SPREAD_FACTOR)
        if err > SPREAD_FACTOR * spread:
            raise RuntimeError(f"{name}: card vs CPU outside the band and "
                               f"the spread: {report}")
    return report


def metrics_card_vs_cpu(device: str = "cuda") -> list:
    """(f): (c)'s, (d)'s and (e)'s functions at their CPU tests'
    configurations (tests/test_torch_metrics.py, tests/test_torch_async.
    py) on the card and on the CPU from the same start."""
    import numpy as np

    from fedml_tpu_torch.config import ModelConfig
    from fedml_tpu_torch.core.async_agg import AsyncBuffer, AsyncConfig
    from fedml_tpu_torch.metrics import fid as FID
    from fedml_tpu_torch.metrics.observability import build_per_client_eval
    from fedml_tpu_torch.models import create_model

    t0 = time.perf_counter()
    mcfg = ModelConfig(name="resnet8", num_classes=5, input_shape=(8, 8, 3))
    start = create_model(mcfg, "cpu").init(torch.Generator().manual_seed(1))

    def per_client(dev, perturb):
        arrays = tiny_metrics_data(dev)
        variables = {k: v.to(dev) for k, v in perturbed(start,
                                                        perturb).items()}
        ev = build_per_client_eval(create_model(mcfg, dev), 5, batch_size=4)
        out = []
        for split in (("x", "y", "idx", "mask"),
                      ("test_x", "test_y", "test_idx", "test_mask")):
            r = ev(variables, *(getattr(arrays, f) for f in split))
            out += [r["acc"], r["loss"], r["confusion"], r["count"]]
        return tuple(out)

    rng = np.random.default_rng(5)
    images = rng.random((40, 12, 12, 1)).astype(np.float32)
    labels = rng.integers(0, 3, 40)
    embed_start = FID.embed_model(3, 16, None, "cpu").init(
        torch.Generator().manual_seed(3))
    fit_start = FID.embed_model(1, 8, 3, "cpu").init(
        torch.Generator().manual_seed(2))

    def embeds(dev, perturb):
        rnd = FID.RandomConvEmbed(16, device=dev,
                                  start=perturbed(embed_start, perturb))
        x3 = torch.from_numpy(np.repeat(images[:10], 3, -1)).to(dev)
        trained = FID.TrainedCNNEmbed.fit(
            images, labels, num_classes=3, dim=8, epochs=2, batch_size=16,
            seed=2, device=dev, start=perturbed(fit_start, perturb),
            perms=lambda e, n: torch.randperm(
                n, generator=torch.Generator().manual_seed(e)))
        fid = FID.FIDScorer(trained, 16, dev).calculate_fid(images[:20],
                                                            images[20:])
        return (rnd(x3), trained(torch.from_numpy(images[:12]).to(dev)),
                torch.tensor(fid, dtype=torch.float64))

    shapes = {"conv.weight": (4, 3, 3, 3), "conv.bias": (4,),
              "head": (7, 5), "bn.running_mean": (4,)}
    drng = np.random.default_rng(0)
    deltas = [{k: torch.from_numpy(drng.standard_normal(s).astype(
        np.float32)) for k, s in shapes.items()} for _ in range(10)]
    arng = np.random.default_rng(1)
    arrivals = [(float(arng.integers(1, 50)), int(arng.integers(0, 8)))
                for _ in range(10)]

    def folds(dev, perturb):
        buf = AsyncBuffer(AsyncConfig(5, "poly", 0.5),
                          {k: torch.zeros(s, device=dev)
                           for k, s in shapes.items()})
        out = []
        for d, (n, lag) in zip(deltas, arrivals):
            buf.fold({k: v.to(dev) for k, v in perturbed(d, perturb).items()},
                     n, lag)
            if buf.ready():
                out += list(buf.emit()[0].values())
        return tuple(out)

    reports = [held_card_vs_cpu("per_client_eval_resnet8", per_client,
                                device),
               held_card_vs_cpu("fid_embeds", embeds, device),
               held_card_vs_cpu("async_fold_emit", folds, device)]
    reports.append({"seconds": time.perf_counter() - t0})
    return reports


def disk_phase(card: str, device: str = "cuda") -> int:
    """Phase 20: (a)-(g). Returns the flash kernels' launches over it (0:
    no model of the phase has attention)."""
    import tempfile

    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops.flash_attention import flash_attention

    t0 = time.perf_counter()
    flash_attention.launches = 0
    flash_attention.mma_launches = 0
    parts = {}
    tmp = tempfile.mkdtemp(prefix="phase20_")

    def part(name, run, *args):
        t_part = time.perf_counter()
        out = run(*args)
        parts[name] = time.perf_counter() - t_part
        free_card()
        return out

    try:
        data, cfg, variables = part("a", cifar_from_disk, card, tmp, device)
        part("b", other_formats, card, tmp, device)
        part("c", per_client_metrics, card, data, cfg, variables, device)
        del data
        part("d", fid_round, card, tmp, device)
        part("e", async_buffer, card,
             {k: v.to(device) for k, v in variables.items()},
             create_model(cfg.model, device).stat_names, device)
        deterministic = torch.backends.cudnn.deterministic
        benchmark = torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        try:
            reports = part("f", metrics_card_vs_cpu, device)
            print(json.dumps({"data_async_metrics_card_vs_cpu": reports,
                              "device": card}), flush=True)
        finally:
            torch.backends.cudnn.deterministic = deterministic
            torch.backends.cudnn.benchmark = benchmark
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = flash_attention.launches + flash_attention.mma_launches
    if launches != 0:
        raise RuntimeError(f"phase 20 launched flash attention {launches} "
                           "times")
    record_line(card, metric="phase20_s", value=time.perf_counter() - t0,
                parts_s=parts, flash_launches=launches)
    return launches


# phase 21: the synchronous deployment runtime
DEPLOY_CLIENTS = 10  # (a)/(b): the headline's cohort, one client a rank
DEPLOY_ROUNDS = 3
DEPLOY_BAND = dict(atol=1e-5, rtol=1e-4)
DEPLOY_CHILD_TIMEOUT_S = 240
DEPLOY_CODEC_REPS = 5


def deploy_argv(rounds: int = DEPLOY_ROUNDS) -> list[str]:
    """The headline (resnet_config's) as the CLI's flags."""
    return ["--algorithm", "fedavg", "--dataset", "fake_cifar10",
            "--model", "resnet56", "--num_classes", "10", "--input_shape",
            "32", "32", "3", "--client_num_in_total", "100",
            "--client_num_per_round", str(DEPLOY_CLIENTS), "--comm_round",
            str(rounds), "--batch_size", "32", "--lr", "0.03", "--epochs",
            "1", "--partition_method", "hetero", "--partition_alpha", "0.5",
            "--compute_dtype", "bfloat16", "--seed", "0"]


def deploy_band_use(got: dict, want: dict) -> tuple[float, float]:
    """Max |got - want| over two variable dicts, and the band's use."""
    err = use = 0.0
    for k, w in want.items():
        d = (got[k].double().cpu() - w.double().cpu()).abs()
        err = max(err, float(d.max()))
        use = max(use, float((d / (DEPLOY_BAND["atol"] + DEPLOY_BAND["rtol"]
                                   * w.double().cpu().abs())).max()))
    return err, use


def run_actors(server, actors) -> None:
    """Run ``server`` in this thread and ``actors`` in their own until the
    server stops; then stop and join them."""
    import threading

    threads = [threading.Thread(target=a.run, daemon=True) for a in actors]
    for t in threads:
        t.start()
    server.transport.start()
    server.start_round()
    server.run()
    for a in actors:
        a.transport.stop()
    for t in threads:
        t.join(timeout=60)
        if t.is_alive():
            raise RuntimeError("an actor did not stop")


def local_trainer(cfg, device: str):
    """A LocalTrainer of ``cfg`` on ``device`` and its data."""
    from fedml_tpu_torch.algorithms import distributed_fedavg as D
    from fedml_tpu_torch.data import load_dataset
    from fedml_tpu_torch.models import create_model

    data = load_dataset(cfg.data)
    return D.LocalTrainer(create_model(cfg.model, device), data, cfg), data


def loopback_world(cfg, device: str, clients: int, init=None,
                   transports=None, on_round=None, trainer=None, data=None,
                   server_cls=None, **server_kw):
    """A server (``server_cls``, default FedAvgServerActor) and
    ``clients`` client actors of ``cfg`` in this process (loopback unless
    ``transports(rank)`` says otherwise), the clients sharing one
    LocalTrainer (``trainer`` with its ``data``, or a new one), run to
    the end; ``on_round(server, actors)`` at each round's close. Returns
    the server, the trainer and the data."""
    from fedml_tpu_torch.algorithms import distributed_fedavg as D
    from fedml_tpu_torch.core.transport.loopback import LoopbackHub

    if trainer is None:
        trainer, data = local_trainer(cfg, device)
    model = trainer.model
    if transports is None:
        transports = LoopbackHub().create
    server = (server_cls or D.FedAvgServerActor)(
        clients + 1, transports(0), model, cfg,
        num_clients=cfg.data.num_clients, data=data, initial_variables=init,
        **server_kw)
    actors = [D.FedAvgClientActor(r, clients + 1, transports(r), model, None,
                                  cfg, trainer=trainer)
              for r in range(1, clients + 1)]
    if on_round is not None:
        server.on_round_done = lambda r, info: on_round(server, actors)
    run_actors(server, actors)
    return server, trainer, data


def deploy_sim_rounds(cfg, data, init, rounds: int,
                      device: str = "cuda") -> list:
    """FedAvgSim's globals after each round on the server's cohorts
    (``default_rng(round).choice``) and the default batch orders, in the
    smallest groups the sim runs (2 lanes)."""
    import dataclasses

    import numpy as np

    from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
    from fedml_tpu_torch.models import create_model

    n, k = cfg.data.num_clients, DEPLOY_CLIENTS
    pairs = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, cohort_groups=k // 2))
    sim = FedAvgSim(create_model(cfg.model, device), data, pairs, device,
                    sampler=lambda r, nc, kc: torch.from_numpy(
                        np.random.default_rng(r).choice(n, k, replace=False)))
    state = sim.init()._replace(variables={q: v.clone()
                                           for q, v in init.items()})
    out = []
    for _ in range(rounds):
        state, m = sim.run_round(state)
        out.append({q: v.clone() for q, v in state.variables.items()})
    return out


def deploy_one_lane_sim(cfg, data, device: str = "cuda"):
    """FedAvgSim at a cohort of one, which runs one lane as a client
    actor does; its sampler returns ``pick[0]``. Returns the sim and
    ``pick``."""
    import dataclasses

    from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
    from fedml_tpu_torch.models import create_model

    pick = [0]
    one = dataclasses.replace(cfg, fed=dataclasses.replace(
        cfg.fed, clients_per_round=1))
    sim = FedAvgSim(create_model(cfg.model, device), data, one, device,
                    sampler=lambda r, nc, kc: torch.tensor([pick[0]]))
    return sim, pick


def one_lane_use(ctx: dict, start: dict, r: int, client: int,
                 got: dict) -> tuple[float, float]:
    """A client result against FedAvgSim's one-lane update of ``client``
    from ``start`` at round ``r`` (``ctx``: (a)'s sim, its ``pick`` and
    its initial state): max error and DEPLOY_BAND's use."""
    ctx["pick"][0] = client
    want, _ = ctx["sim"].run_round(ctx["base"]._replace(variables={
        k: v.to(ctx["device"]) for k, v in start.items()}, round=r))
    return deploy_band_use(got, want.variables)


def weighted_mean64(rows: list) -> dict:
    """The float64 weighted mean of ``[(variables, n), ...]``."""
    w = torch.tensor([n for _, n in rows], dtype=torch.float64)
    return {k: torch.tensordot(w / w.sum(), torch.stack(
        [torch.as_tensor(row[k]).double() for row, _ in rows]), 1)
        for k in rows[0][0]}


def deploy_headline_loopback(card: str, device: str = "cuda"
                             ) -> tuple[dict, dict]:
    """(a). Each round's every client result is held against FedAvgSim's
    one-lane update of that client from the round's start, and each
    round's global against the float64 weighted mean of its results, both
    in DEPLOY_BAND; the trajectory against the sim's 2-lane groups is
    reported and bound by the card's own spread (bf16 rounds the lane
    groups apart). Returns the final variables, on the host, and what
    (f) and (g) reuse: the world's trainer (its captured graph) and data,
    and the one-lane sim."""
    from fedml_tpu_torch.algorithms import distributed_fedavg as D
    from fedml_tpu_torch.experiments import run as cli
    from fedml_tpu_torch.models import create_model

    cfg, _ = cli.parse_args(deploy_argv())
    init = D.initial_state(create_model(cfg.model, device), cfg).variables
    globals_, losses, closes = [], [], {}

    def on_round(server, actors):
        globals_.append({k: v.clone() for k, v in server.variables.items()})
        losses.extend(float(a.last_sums["loss_sum"]) for a in actors)

    real_close = D.FedAvgServerActor._close_round

    def close(self, results, closed_idx, **kw):
        # the round's start, each rank's client and result, on the host
        _, start, cohort, slots = self._round_sync
        closes[closed_idx] = (
            {k: torch.as_tensor(v) for k, v in start.items()},
            {r: (int(cohort[slots.get(r, r - 1) % len(cohort)]),
                 {k: torch.as_tensor(v) for k, v in row.items()}, n)
             for r, (row, n) in results.items()})
        real_close(self, results, closed_idx, **kw)

    D.FedAvgServerActor._close_round = close
    t0 = time.perf_counter()
    try:
        server, trainer, data = loopback_world(cfg, device, DEPLOY_CLIENTS,
                                               init=init, on_round=on_round)
    finally:
        D.FedAvgServerActor._close_round = real_close
    world_s = time.perf_counter() - t0
    if not (server.done.is_set() and len(globals_) == DEPLOY_ROUNDS
            and sorted(closes) == list(range(DEPLOY_ROUNDS))):
        raise RuntimeError(f"(a) world ended at round {server.round_idx}")
    if (len(losses) != DEPLOY_CLIENTS * DEPLOY_ROUNDS
            or not all(math.isfinite(x) for x in losses)):
        raise RuntimeError(f"(a) client loss sums: {losses}")
    graph = trainer.cohort_update.graph
    replays = graph.replays if graph is not None else None
    del server
    # every client's result against the sim's one lane from the same start
    t_lane = time.perf_counter()
    sim, pick = deploy_one_lane_sim(cfg, data, device)
    ctx = {"trainer": trainer, "data": data, "sim": sim, "pick": pick,
           "base": sim.init(), "device": device}
    lanes, aggregation = [], []
    for r in range(DEPLOY_ROUNDS):
        start, results = closes[r]
        for rank, (client, got, n) in sorted(results.items()):
            err, use = one_lane_use(ctx, start, r, client, got)
            lanes.append({"round": r, "rank": rank, "client": client,
                          "n": float(n), "max_abs_err": err,
                          "band_use": use})
        err, use = deploy_band_use(globals_[r], weighted_mean64(
            [(row, n) for _, row, n in results.values()]))
        aggregation.append({"round": r, "max_abs_err": err, "band_use": use})
    lane_s = time.perf_counter() - t_lane
    t_sim = time.perf_counter()
    want = deploy_sim_rounds(cfg, data, init, DEPLOY_ROUNDS, device)
    sim_s = time.perf_counter() - t_sim
    errs = [deploy_band_use(g, w) for g, w in zip(globals_, want)]
    row = {"world_s": world_s, "one_lane_s": lane_s, "sim_s": sim_s,
           "graph_replays": replays, "client_loss_sums": losses,
           "clients_vs_one_lane_sim": lanes,
           "worst_client_band_use": max(x["band_use"] for x in lanes),
           "globals_vs_weighted_mean": aggregation,
           "trajectory_vs_two_lane_sim": [
               {"max_abs_err": e, "band_use": u} for e, u in errs],
           **DEPLOY_BAND}
    if max(u for _, u in errs) > 1.0:
        spread = deploy_sim_rounds(cfg, data, {
            k: v * (1 + PERTURB) if v.is_floating_point() else v
            for k, v in init.items()}, DEPLOY_ROUNDS, device)
        row["card_spread"] = max(deploy_band_use(p, w)[0]
                                 for p, w in zip(spread, want))
        row["spread_factor"] = SPREAD_FACTOR
    record_line(card, metric="deploy_loopback_resnet56_100c_10pr", **row)
    if (len(lanes) != DEPLOY_CLIENTS * DEPLOY_ROUNDS
            or row["worst_client_band_use"] > 1.0):
        raise RuntimeError("(a) a client actor's result is outside "
                           "DEPLOY_BAND of the sim's one-lane update")
    if max(x["band_use"] for x in aggregation) > 1.0:
        raise RuntimeError("(a) a round's global is outside DEPLOY_BAND of "
                           "its results' weighted mean")
    if ("card_spread" in row and max(e for e, _ in errs)
            > SPREAD_FACTOR * row["card_spread"]):
        raise RuntimeError(f"(a) the world against FedAvgSim: {row}")
    final = {k: v.cpu() for k, v in globals_[-1].items()}
    del want, globals_, closes
    free_card()
    return final, ctx


def deploy_tcp_processes(card: str, loopback_final: dict,
                         device: str = "cuda") -> None:
    """(b): 11 ranks as OS processes over TCP on localhost."""
    import pickle
    import tempfile

    from fedml_tpu_torch.experiments.deploy import _params_digest

    tmp = tempfile.mkdtemp(prefix="phase21_")
    sock_ports = []
    import socket as _socket

    socks = [_socket.socket() for _ in range(DEPLOY_CLIENTS + 1)]
    try:
        for sk in socks:
            sk.bind(("127.0.0.1", 0))
            sock_ports.append(sk.getsockname()[1])
    finally:
        for sk in socks:
            sk.close()
    ip = os.path.join(tmp, "ip.json")
    with open(ip, "w") as f:
        json.dump({str(r): ["127.0.0.1", p] for r, p in enumerate(sock_ports)},
                  f)
    common = deploy_argv() + [
        "--backend", "tcp", "--world_size", str(DEPLOY_CLIENTS + 1),
        "--ip_config", ip, "--out_dir", tmp, "--run_name", "tcp",
        "--heartbeat_interval", "2", "--heartbeat_timeout", "60",
        "--device", device]
    # one host thread a rank: 11 ranks share the host's cores
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    roles = [["--role", "server"]] + [
        ["--role", "client", "--rank", str(r)]
        for r in range(1, DEPLOY_CLIENTS + 1)]
    here = os.path.dirname(os.path.abspath(__file__))
    t_spawn_unix = time.time()
    t0 = time.perf_counter()
    procs = []
    try:
        for r, role in enumerate(roles):
            with open(os.path.join(tmp, f"rank{r}.err"), "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "fedml_tpu_torch.experiments.run",
                     *common, *role], cwd=here, env=env,
                    stdout=subprocess.PIPE, stderr=err, text=True))
        outs = []
        for r, proc in enumerate(procs):
            left = DEPLOY_CHILD_TIMEOUT_S - (time.perf_counter() - t0)
            out, _ = proc.communicate(timeout=max(1.0, left))
            if proc.returncode != 0:
                with open(os.path.join(tmp, f"rank{r}.err")) as f:
                    raise RuntimeError(f"(b) rank {r} exited "
                                       f"{proc.returncode}: "
                                       f"{f.read()[-3000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
        wall = time.perf_counter() - t0
        server = outs[0]
        with open(server["final_params"], "rb") as f:
            final = {k: torch.as_tensor(v) for k, v in pickle.load(f).items()}
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    closes = server["round_close_unix"]
    err, use = deploy_band_use(final, loopback_final)
    same = server["params_digest"] == _params_digest(loopback_final)
    rounds = []
    for i, (s, a) in enumerate(zip(server["round_s"], server["agg_s"])):
        local = max(o["local_s"][str(i)] for o in outs[1:])
        rounds.append({"round": i, "seconds": s, "aggregation_s": a,
                       "slowest_local_s": local,
                       "wire_s": s - a - local})
    row = {"processes": len(procs), "wall_s": wall,
           "spawn_to_first_close_s": closes[0] - t_spawn_unix,
           "rounds": rounds,
           "server_bytes_sent_per_round": server["bytes_sent"]
           / server["rounds"],
           "server_bytes_received_per_round": server["bytes_received"]
           / server["rounds"],
           "client_bytes_sent": [o["bytes_sent"] for o in outs[1:]],
           "client_updates": [o["updates"] for o in outs[1:]],
           "test_acc": server.get("acc"), "digest_equal_to_a": same,
           "max_abs_err_vs_a": err, "band_use_vs_a": use,
           "note": "bytes are the transport's whole traffic over the run "
                   "(barrier, heartbeats, syncs, results) over its rounds; "
                   "a round's seconds run from its sync's broadcast to its "
                   "close; slowest_local_s is the slowest client's local "
                   "update with its result's copy to the host; wire_s is "
                   "the rest less the aggregation (transfers, framing, "
                   "the sync's copy to the card, waiting; not traced)"}
    record_line(card, metric="deploy_tcp_11proc_resnet56_100c_10pr", **row)
    if server["rounds"] != DEPLOY_ROUNDS or any(
            o["updates"] != DEPLOY_ROUNDS for o in outs[1:]):
        raise RuntimeError(f"(b) incomplete: {row}")
    if not same and use > 1.0:
        raise RuntimeError(f"(b) the TCP world's model is outside (a)'s "
                           f"band: {row}")


def tiny_deploy_config(rounds: int = 2, clients: int = 3):
    """tests/test_torch_deploy.py's world: lr on fake_mnist."""
    from fedml_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        FedConfig,
        ModelConfig,
        TrainConfig,
    )

    return ExperimentConfig(
        data=DataConfig(dataset="fake_mnist", num_clients=clients,
                        batch_size=32, seed=0, dataset_r=0.3),
        model=ModelConfig(name="lr", num_classes=10,
                          input_shape=(28, 28, 1)),
        train=TrainConfig(lr=0.1, epochs=1),
        fed=FedConfig(num_rounds=rounds, clients_per_round=clients,
                      eval_every=rounds),
        seed=0)


def deploy_faults(card: str, device: str = "cuda") -> None:
    """(c): a crashed client's round closed at the deadline over the
    survivors; an unreachable quorum raising."""
    import threading

    from fedml_tpu_torch.algorithms import distributed_fedavg as D
    from fedml_tpu_torch.core.message import MSG_TYPE_C2S_JOIN, Message
    from fedml_tpu_torch.core.transport.chaos import (
        ChaosTransport,
        FaultPolicy,
    )
    from fedml_tpu_torch.core.transport.loopback import LoopbackHub
    from fedml_tpu_torch.experiments import deploy

    cfg = tiny_deploy_config()
    hub = LoopbackHub()
    closed = {}

    def transports(r):
        t = hub.create(r)
        return (ChaosTransport(t, FaultPolicy(crash_at_round=1)) if r == 2
                else t)

    real_close = D.FedAvgServerActor._close_round

    def close(self, results, closed_idx, **kw):
        closed[closed_idx] = {r: ({k: torch.as_tensor(v) for k, v in
                                   row.items()}, n)
                              for r, (row, n) in results.items()}
        real_close(self, results, closed_idx, **kw)

    D.FedAvgServerActor._close_round = close
    t0 = time.perf_counter()
    try:
        server, _, _ = loopback_world(
            cfg, device, 3, transports=transports,
            round_policy=D.RoundPolicy(quorum_fraction=0.5,
                                       round_deadline_s=2.0))
    finally:
        D.FedAvgServerActor._close_round = real_close
    crash_s = time.perf_counter() - t0
    ws = torch.tensor([closed[1][r][1] for r in (1, 3)], dtype=torch.float64)
    worst = 0.0
    for k, v in server.variables.items():
        rows = torch.stack([closed[1][r][0][k].double() for r in (1, 3)])
        want = torch.tensordot(ws / ws.sum(), rows, 1)
        worst = max(worst, float((v.double().cpu() - want).abs().max()))
    row = {"closed_results": {str(r): sorted(v) for r, v in closed.items()},
           "dead_peers": sorted(server.dead_peers), "seconds": crash_s,
           "renormalized_max_abs_err": worst}
    if (sorted(closed[1]) != [1, 3] or server.failure is not None
            or worst > 1e-6):
        raise RuntimeError(f"(c) the crashed client's round: {row}")
    # every client crashes at round 1: the deploy server rank raises
    from fedml_tpu_torch.data import load_dataset
    from fedml_tpu_torch.models import create_model

    hub = LoopbackHub()
    model = create_model(cfg.model, device)
    data = load_dataset(cfg.data)
    server = D.FedAvgServerActor(
        4, hub.create(0), model, cfg, num_clients=3, data=data,
        round_policy=D.RoundPolicy(round_deadline_s=1.0))
    trainer = D.LocalTrainer(model, data, cfg)
    actors = [D.FedAvgClientActor(r, 4, ChaosTransport(
        hub.create(r), FaultPolicy(crash_at_round=1)), model, None, cfg,
        trainer=trainer) for r in (1, 2, 3)]
    threads = [threading.Thread(target=a.run, daemon=True) for a in actors]
    for a, t in zip(actors, threads):
        a.transport.start()
        a.send_message(Message(MSG_TYPE_C2S_JOIN, a.rank, 0, {}))
        t.start()
    try:
        deploy.serve(server, deploy.DeployConfig(
            role="server", rank=0, world_size=4, backend="loopback",
            heartbeats=False, round_deadline_s=1.0))
        raised = None
    except D.QuorumLostError as err:
        raised = str(err)
    finally:
        for a in actors:
            a.transport.stop()
        for t in threads:
            t.join(timeout=30)
    row["quorum_lost"] = raised
    record_line(card, metric="deploy_faults_lr_fake_mnist", **row)
    if raised is None or "round 1 deadline" not in raised:
        raise RuntimeError(f"(c) the lost quorum did not raise: {raised}")


def deploy_card_vs_cpu(device: str = "cuda") -> dict:
    """(d): the CPU test's world on the card and on the CPU from the same
    start."""
    cfg = tiny_deploy_config()
    cpu, _, _ = loopback_world(cfg, "cpu", 3)
    from fedml_tpu_torch.algorithms.distributed_fedavg import initial_state
    from fedml_tpu_torch.models import create_model

    start = initial_state(create_model(cfg.model, "cpu"), cfg).variables
    card, _, _ = loopback_world(cfg, device, 3, init=start)
    err, use = deploy_band_use(card.variables, cpu.variables)
    report = {"case": "fedavg lr fake_mnist 3 clients 2 rounds",
              "max_abs_err": err, "band_use": use, **DEPLOY_BAND}
    if use > 1.0:
        raise RuntimeError(f"(d) card against CPU: {report}")
    return report


def deploy_codec(card: str, device: str = "cuda") -> None:
    """(e): the native codec in use; a ResNet-56 payload's pack and unpack
    against the pure path."""
    from fedml_tpu_torch.config import ModelConfig
    from fedml_tpu_torch.core import random as R
    from fedml_tpu_torch.core.message import to_host
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.native import codec

    if not codec.native_available():
        raise RuntimeError(f"(e) the native codec did not build: "
                           f"{codec.native_error()}")
    model = create_model(ModelConfig(name="resnet56", num_classes=10,
                                     input_shape=(32, 32, 3)), device)
    arrays = list(to_host(model.init(R.generator(0, 1))).values())
    rows = {}
    for name, c in (("native", codec.TensorCodec()),
                    ("pure", codec.TensorCodec(native=False))):
        if c.native != (name == "native"):
            raise RuntimeError(f"(e) the {name} codec is not in use")
        times = []
        for _ in range(DEPLOY_CODEC_REPS):
            t0 = time.perf_counter()
            frame = c.pack(arrays)
            back = c.unpack(frame)
            times.append(time.perf_counter() - t0)
        rows[name] = {"pack_unpack_ms": [t * 1e3 for t in times],
                      "median_ms": statistics.median(times) * 1e3}
        rows[name + "_frame"] = frame
        if len(back) != len(arrays):
            raise RuntimeError("(e) the frame lost arrays")
    same = rows.pop("native_frame") == rows.pop("pure_frame")
    nbytes = sum(a.nbytes for a in arrays)
    record_line(card, metric="deploy_codec_resnet56_payload",
                leaves=len(arrays), payload_mb=nbytes / 1e6,
                frames_equal=same, **rows,
                note="host clocks, median of 5 pack+unpack calls")
    if not same:
        raise RuntimeError("(e) the native frame differs from the pure one")


# phase 21 (f)-(h): the buffered-async server and the tier worlds
ASYNC_WORLD_K = 5  # (f): K of 10 one-lane clients, so half fold stale
ASYNC_WORLD_VERSIONS = 4
TIER_CLIENTS = 5  # (g): one-lane clients a leaf of root:2
TIER_ROUNDS = 3
TIER_ASYNC_K = 2
TIER_TCP_CLIENTS = 2  # (h): clients a leaf of root:2, tiny configuration


def cpu_tensors(tree: dict) -> dict:
    """A payload's or a model's variables as CPU tensors."""
    return {k: torch.as_tensor(v).detach().cpu() for k, v in tree.items()}


def deploy_async_world(card: str, ctx: dict, device: str = "cuda") -> None:
    """(f): 10 one-lane clients against the buffered-async server at K =
    5, on (a)'s trainer. Every arriving result is held against the
    one-lane sim from the version it synced, every emission against a
    float64 re-run of AsyncBuffer and server_update over the recorded
    folds, both in DEPLOY_BAND."""
    from fedml_tpu_torch.algorithms import async_actors as AS
    from fedml_tpu_torch.algorithms import distributed_fedavg as D
    from fedml_tpu_torch.algorithms.fedavg import local_reducer, server_update
    from fedml_tpu_torch.core import robust, telemetry
    from fedml_tpu_torch.core.async_agg import AsyncBuffer, AsyncConfig
    from fedml_tpu_torch.core.message import (
        KEY_MODEL_PARAMS,
        KEY_NUM_SAMPLES,
        KEY_ROUND,
    )
    from fedml_tpu_torch.experiments import run as cli
    from fedml_tpu_torch.models import create_model

    cfg, _ = cli.parse_args(deploy_argv(ASYNC_WORLD_VERSIONS) + [
        "--async_buffer_k", str(ASYNC_WORLD_K)])
    versions, arrivals, folds, emits = {}, [], [], []

    class Recording(AS.AsyncFedAvgServerActor):
        """Keeps every version's model, arrival, fold and emission."""

        def _stash_sync_locked(self, host):
            versions.setdefault(self.round_idx, cpu_tensors(host))
            super()._stash_sync_locked(host)

        def _handle_result(self, msg):
            arrivals.append({
                "rank": msg.sender, "version": int(msg.get(KEY_ROUND)),
                "n": float(msg.get(KEY_NUM_SAMPLES)),
                "params": cpu_tensors(msg.get(KEY_MODEL_PARAMS)),
                "t": time.perf_counter()})
            super()._handle_result(msg)

        def _fold(self, sender, delta, n_k, v, lag):
            folds.append({"arrival": len(arrivals) - 1, "lag": lag})
            super()._fold(sender, delta, n_k, v, lag)

        def _emit_locked(self):
            super()._emit_locked()
            emits.append({"folds": len(folds), "t": time.perf_counter(),
                          "global": cpu_tensors(self.state.variables)})

    m = telemetry.METRICS
    enabled = m.enabled
    m.enabled = True
    m.reset()
    t0 = time.perf_counter()
    try:
        server, _, _ = loopback_world(
            cfg, device, DEPLOY_CLIENTS, trainer=ctx["trainer"],
            data=ctx["data"], server_cls=Recording)
        counters = {k: v for k, v in m.snapshot()["counters"].items()
                    if k.startswith("async.")}
    finally:
        m.reset()
        m.enabled = enabled
    world_s = time.perf_counter() - t0
    if not (server.done.is_set() and server.failure is None
            and len(emits) == ASYNC_WORLD_VERSIONS):
        raise RuntimeError(f"(f) the async world ended at version "
                           f"{server.round_idx}: {server.failure}")
    # every result against the one-lane sim from the version it synced
    clients = []
    for a in arrivals:
        err, use = one_lane_use(ctx, versions[a["version"]], a["version"],
                                a["rank"] - 1, a["params"])
        clients.append({"rank": a["rank"], "version": a["version"],
                        "max_abs_err": err, "band_use": use})
    # every emission against AsyncBuffer and server_update in float64 on
    # the host, from the version the server stepped from
    pipe = robust.DefensePipeline.from_fed(cfg.fed)
    cpu_model = create_model(cfg.model, "cpu")
    acfg = AsyncConfig.from_fed(cfg.fed)
    emissions, lo = [], 0
    for e, em in enumerate(emits):
        g = {k: v.double() for k, v in versions[e].items()}
        buf = AsyncBuffer(acfg, g)
        for f in folds[lo:em["folds"]]:
            a = arrivals[f["arrival"]]
            base = versions[a["version"]]
            delta = pipe.preprocess({k: (a["params"][k].double()
                                         - base[k].double())[None]
                                     for k in base})
            buf.fold({k: d[0] for k, d in delta.items()}, a["n"], f["lag"])
        mean, mass = buf.emit()
        state = D.initial_state(cpu_model, cfg, g)._replace(round=e)
        want = server_update(
            cfg.fed, state, {k: (g[k] + mean[k])[None] for k in g},
            torch.tensor([mass], dtype=torch.float64), local_reducer(),
            cpu_model.stat_names).variables
        err, use = deploy_band_use(em["global"], want)
        waits = [em["t"] - arrivals[f["arrival"]]["t"]
                 for f in folds[lo:em["folds"]]]
        emissions.append({"version": e + 1, "folds": em["folds"] - lo,
                          "lags": [f["lag"] for f in folds[lo:em["folds"]]],
                          "mass": mass, "max_abs_err": err, "band_use": use,
                          "arrival_to_emission_s": waits})
        lo = em["folds"]
    waits = [w for x in emissions for w in x["arrival_to_emission_s"]]
    row = {"clients": DEPLOY_CLIENTS, "buffer_k": ASYNC_WORLD_K,
           "world_s": world_s, "arrivals": len(arrivals),
           **{k: counters.get(k, 0) for k in (
               "async.folds", "async.emits", "async.stale_folds",
               "async.forced_emits", "async.too_stale")},
           "arrival_to_emission_s_median": statistics.median(waits),
           "arrival_to_emission_s_max": max(waits),
           "worst_client_band_use": max(c["band_use"] for c in clients),
           "clients_vs_one_lane_sim": clients,
           "emissions_vs_float64": emissions, **DEPLOY_BAND}
    record_line(card, metric="deploy_async_resnet56_10c_k5", **row)
    if counters.get("async.emits") != ASYNC_WORLD_VERSIONS or not counters.get(
            "async.stale_folds"):
        raise RuntimeError(f"(f) the staleness path did not run: {counters}")
    if row["worst_client_band_use"] > 1.0:
        raise RuntimeError("(f) a client result is outside DEPLOY_BAND of "
                           "the one-lane sim")
    if max(x["band_use"] for x in emissions) > 1.0:
        raise RuntimeError("(f) an emission is outside DEPLOY_BAND of the "
                           "float64 re-run")


def tier_world(cfg, device: str, per_leaf: int, root_cls, trainer, data,
               n_leaves: int = 2):
    """A tier world of ``cfg`` in this process: a root world over loopback
    and a loopback world a leaf, every client on ``trainer``; run to the
    end. Returns the root, the leaves, each leaf's closes (leaf rank,
    version) -> (the leaf's global, [(result, n), ...]), the partials the
    root received (leaf rank, version) -> (sum, n) and the root's globals
    by version."""
    from fedml_tpu_torch.algorithms import async_actors as AS
    from fedml_tpu_torch.algorithms import distributed_fedavg as D
    from fedml_tpu_torch.core.manager import Manager
    from fedml_tpu_torch.core.message import (
        KEY_NUM_SAMPLES,
        KEY_ROUND,
        MSG_TYPE_L2R_PARTIAL,
    )
    from fedml_tpu_torch.core.tier import KEY_TIER_SUM, TierSpec
    from fedml_tpu_torch.core.transport.loopback import LoopbackHub

    spec = TierSpec(n_leaves)
    model = trainer.model
    root_hub = LoopbackHub()
    root = root_cls(spec.root_world_size, root_hub.create(0), model, cfg,
                    num_clients=cfg.data.num_clients, data=data,
                    tier_spec=spec)
    closes, partials = {}, {}
    globals_ = {0: cpu_tensors(root.variables)}
    handle = root._handle_partial

    def on_partial(msg):
        partials[(msg.sender, int(msg.get(KEY_ROUND)))] = (
            cpu_tensors(msg.get(KEY_TIER_SUM)),
            float(msg.get(KEY_NUM_SAMPLES)))
        handle(msg)

    root.register_message_receive_handler(MSG_TYPE_L2R_PARTIAL, on_partial)
    root.on_round_done = lambda r, info: globals_.setdefault(
        root.round_idx, cpu_tensors(root.variables))
    leaves, actors = [], []
    for rank in spec.leaf_ranks():
        hub = LoopbackHub()
        uplink = Manager(rank, spec.root_world_size, root_hub.create(rank))
        leaf = AS.TierAggregatorActor(
            per_leaf + 1, hub.create(0), uplink, model, cfg,
            client_base=spec.client_base(rank, per_leaf),
            num_clients=cfg.data.num_clients, data=data)

        def close(results, closed_idx, leaf=leaf, rank=rank, **kw):
            closes[(rank, closed_idx)] = (
                cpu_tensors(leaf.variables),
                [(cpu_tensors(row), n) for _, (row, n) in
                 sorted(results.items())])
            AS.TierAggregatorActor._close_round(leaf, results, closed_idx,
                                                **kw)

        leaf._close_round = close
        leaves.append(leaf)
        actors += [D.FedAvgClientActor(r, per_leaf + 1, hub.create(r), model,
                                       None, cfg, trainer=trainer)
                   for r in range(1, per_leaf + 1)] + [uplink, leaf]
    run_actors(root, actors)
    if not root.done.is_set() or root.failure is not None:
        raise RuntimeError(f"the tier world ended at version "
                           f"{root.round_idx}: {root.failure}")
    return root, leaves, closes, partials, globals_


def deploy_tier_worlds(card: str, ctx: dict, device: str = "cuda") -> None:
    """(g): root:2 with 5 one-lane clients a leaf on (a)'s trainer, the
    synchronous root and then the async root at K = 2. Every partial is
    held against the float64 weighted sum of its clients' deltas, every
    root global against the float64 weighted mean of the version's 10
    results, in DEPLOY_BAND."""
    from fedml_tpu_torch.algorithms import async_actors as AS
    from fedml_tpu_torch.core import telemetry
    from fedml_tpu_torch.experiments import run as cli

    rows = []
    for name, root_cls, extra in (
            ("sync", AS.TierRootActor, []),
            ("async_k2", AS.AsyncTierRootActor,
             ["--async_buffer_k", str(TIER_ASYNC_K)])):
        cfg, _ = cli.parse_args(deploy_argv(TIER_ROUNDS) + extra)
        m = telemetry.METRICS
        enabled = m.enabled
        m.enabled = True
        m.reset()
        t0 = time.perf_counter()
        try:
            root, leaves, closes, partials, globals_ = tier_world(
                cfg, device, TIER_CLIENTS, root_cls, ctx["trainer"],
                ctx["data"])
            forward = m.counter("tier.forward_bytes")
        finally:
            m.reset()
            m.enabled = enabled
        world_s = time.perf_counter() - t0
        held = []
        for key, (psum, n) in sorted(partials.items()):
            g, results = closes[key]
            w = torch.tensor([x for _, x in results], dtype=torch.float64)
            want = {k: torch.tensordot(w, torch.stack(
                [row[k].double() - g[k].double() for row, _ in results]), 1)
                for k in g}
            err, use = deploy_band_use(psum, want)
            held.append({"leaf": key[0], "version": key[1], "n": n,
                         "mass_equal": n == float(w.sum()),
                         "max_abs_err": err, "band_use": use})
        means = []
        for v in range(1, TIER_ROUNDS + 1):
            results = [x for rank in (1, 2) for x in closes[(rank, v - 1)][1]]
            err, use = deploy_band_use(globals_[v], weighted_mean64(results))
            means.append({"version": v, "results": len(results),
                          "max_abs_err": err, "band_use": use})
        row = {"root": name, "leaves": 2, "clients_per_leaf": TIER_CLIENTS,
               "rounds": root.round_idx, "world_s": world_s,
               "partials_sent": [x.partials_sent for x in leaves],
               "tier_forward_bytes": forward,
               "tier_forward_bytes_per_round": forward / TIER_ROUNDS,
               "partials_vs_float64_sum": held,
               "globals_vs_float64_mean": means, **DEPLOY_BAND}
        record_line(card, metric="deploy_tier_resnet56_root2_5c", **row)
        rows.append(row)
        if (root.round_idx != TIER_ROUNDS
                or len(held) != 2 * TIER_ROUNDS
                or not all(x["mass_equal"] for x in held)):
            raise RuntimeError(f"(g) the {name} tier world: {row}")
        if max(x["band_use"] for x in held + means) > 1.0:
            raise RuntimeError(f"(g) the {name} tier world is outside "
                               "DEPLOY_BAND of its float64 reference")
        del root, leaves, closes, partials, globals_


def deploy_tier_processes(card: str, device: str = "cuda") -> None:
    """(h): a root, 2 leaves and 2 clients a leaf as 7 OS processes over
    TCP through the CLI at the tiny configuration; the root's digest
    against the same tier world in this process."""
    import pickle
    import socket as _socket
    import tempfile

    from fedml_tpu_torch.algorithms import async_actors as AS
    from fedml_tpu_torch.experiments.deploy import _params_digest

    cfg = tiny_deploy_config(rounds=2, clients=2 * TIER_TCP_CLIENTS)
    tmp = tempfile.mkdtemp(prefix="phase21h_")
    socks = [_socket.socket() for _ in range(3 + 2 * (TIER_TCP_CLIENTS + 1))]
    try:
        for sk in socks:
            sk.bind(("127.0.0.1", 0))
        ports = [sk.getsockname()[1] for sk in socks]
    finally:
        for sk in socks:
            sk.close()

    def table(name: str, world: list) -> str:
        path = os.path.join(tmp, name)
        with open(path, "w") as f:
            json.dump({str(r): ["127.0.0.1", p] for r, p in enumerate(world)},
                      f)
        return path

    per = TIER_TCP_CLIENTS + 1
    root_ip = table("root.json", ports[:3])
    leaf_ip = {l: table(f"leaf{l}.json", ports[3 + (l - 1) * per:3 + l * per])
               for l in (1, 2)}
    cfg_path = os.path.join(tmp, "config.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    common = ["--config", cfg_path, "--backend", "tcp", "--out_dir", tmp,
              "--heartbeat_interval", "2", "--heartbeat_timeout", "60",
              "--device", device]
    # the root's world is the root and its leaves; a leaf's, the leaf
    # (rank 0) and its clients
    roles = [["--role", "server", "--ip_config", root_ip, "--run_name",
              "root", "--tier_spec", "root:2", "--world_size", "3"]]
    for l in (1, 2):
        roles.append(["--role", "leaf", "--rank", str(l), "--ip_config",
                      leaf_ip[l], "--uplink_ip_config", root_ip,
                      "--run_name", f"leaf{l}", "--tier_spec", "root:2",
                      "--world_size", str(per)])
        roles += [["--role", "client", "--rank", str(r), "--ip_config",
                   leaf_ip[l], "--world_size", str(per), "--run_name",
                   f"leaf{l}_client{r}"] for r in range(1, per)]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs, outs = [], []
    try:
        for i, role in enumerate(roles):
            with open(os.path.join(tmp, f"proc{i}.err"), "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "fedml_tpu_torch.experiments.run",
                     *common, *role], cwd=here, env=env,
                    stdout=subprocess.PIPE, stderr=err, text=True))
        for i, proc in enumerate(procs):
            left = DEPLOY_CHILD_TIMEOUT_S - (time.perf_counter() - t0)
            out, _ = proc.communicate(timeout=max(1.0, left))
            if proc.returncode != 0:
                with open(os.path.join(tmp, f"proc{i}.err")) as f:
                    raise RuntimeError(f"(h) process {i} ({roles[i][1]}) "
                                       f"exited {proc.returncode}: "
                                       f"{f.read()[-3000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
        wall = time.perf_counter() - t0
        with open(outs[0]["final_params"], "rb") as f:
            final = {k: torch.as_tensor(v) for k, v in pickle.load(f).items()}
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    root = outs[0]
    leaves = [o for o in outs if o["role"] == "leaf"]
    trainer, data = local_trainer(cfg, device)
    inproc, _, _, _, _ = tier_world(cfg, device, TIER_TCP_CLIENTS,
                                    AS.TierRootActor, trainer, data)
    same = root["params_digest"] == _params_digest(inproc.variables)
    err, use = deploy_band_use(final, inproc.variables)
    row = {"processes": len(procs), "wall_s": wall,
           "rounds": root["rounds"], "tier_spec": root["tier_spec"],
           "partials": [o["partials"] for o in leaves],
           "root_bytes_received": root["bytes_received"],
           "digest_equal_in_process": same,
           "max_abs_err_in_process": err, "band_use_in_process": use}
    record_line(card, metric="deploy_tier_tcp_7proc_lr_fake_mnist", **row)
    if root["rounds"] != 2 or [o["partials"] for o in leaves] != [2, 2]:
        raise RuntimeError(f"(h) incomplete: {row}")
    if not same:
        raise RuntimeError(f"(h) the processes' digest is not the "
                           f"in-process tier world's: {row}")


def deploy_phase(card: str) -> int:
    """Phase 21: (a)-(h). Returns the flash kernels' launches over it (0:
    ResNet-56 and lr have no attention)."""
    from fedml_tpu_torch.ops.flash_attention import flash_attention

    t0 = time.perf_counter()
    flash_attention.launches = 0
    flash_attention.mma_launches = 0
    parts = {}
    deterministic = torch.backends.cudnn.deterministic
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        t_part = time.perf_counter()
        final, ctx = deploy_headline_loopback(card)
        parts["a"] = time.perf_counter() - t_part
        # (f) and (g) run on (a)'s trainer: no new capture
        for name, run in (("f", deploy_async_world),
                          ("g", deploy_tier_worlds)):
            t_part = time.perf_counter()
            run(card, ctx)
            parts[name] = time.perf_counter() - t_part
        del ctx
        free_card()
        for name, run, args in (("b", deploy_tcp_processes, (card, final)),
                                ("c", deploy_faults, (card,)),
                                ("h", deploy_tier_processes, (card,))):
            t_part = time.perf_counter()
            run(*args)
            parts[name] = time.perf_counter() - t_part
            free_card()
        t_part = time.perf_counter()
        print(json.dumps({"deploy_card_vs_cpu": deploy_card_vs_cpu(),
                          "device": card}), flush=True)
        parts["d"] = time.perf_counter() - t_part
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.benchmark = benchmark
    t_part = time.perf_counter()
    deploy_codec(card)
    parts["e"] = time.perf_counter() - t_part
    launches = flash_attention.launches + flash_attention.mma_launches
    if launches != 0:
        raise RuntimeError(f"phase 21 launched flash attention {launches} "
                           "times")
    record_line(card, metric="phase21_s", value=time.perf_counter() - t0,
                parts_s=parts, flash_launches=launches)
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
    t0 = time.perf_counter()
    card = environment()
    build_kernels()
    rows = kernel_checks()
    # phases 10-21 record their own seconds; these the first nine's
    ticks = {"1-3": time.perf_counter() - t0}

    def tick(name):
        ticks[name] = time.perf_counter() - t0 - sum(ticks.values())

    # 4-5. the transformer path, and the kernels' launches on it
    launches, mma_launches = main_path()
    tick("4-5")
    # 6. the ResNet-56 path (no hand-written kernel on it)
    paths = {"resnet56": resnet_main_path(card)}
    tick("6")
    # 7. the bench's families (no hand-written kernel on any)
    for name in FAMILY_SPECS:
        paths[name] = family_path(name, card)
    tick("7")
    # 8. the defended, attacked and compressed round (no hand kernel)
    paths["defended_rounds"] = defended_rounds(card)
    tick("8")
    # 9. the bulk engine and elastic buckets (no hand kernel)
    paths["bulk"] = bulk_phase(card)
    free_card()
    tick("9")
    record_line(card, metric="phases_1_9_s", value=sum(ticks.values()),
                by_phase_s=ticks)
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
    free_card()
    # 15. the observability planes (no hand kernel)
    paths["observability"] = observability_phase(card)
    free_card()
    # 16. the distillation family and the dropout classifier (no hand
    # kernel)
    paths["distillation"] = distillation_phase(card)
    free_card()
    # 17. heterogeneous-model FedGDKD and the dropout classifiers of the
    # GAN family and the bulk engine (no hand kernel)
    paths["hetero"] = hetero_phase(card)
    free_card()
    # 18. the rest of the zoo, fedseg and the topologies (no hand kernel)
    paths["topology_zoo"] = topology_zoo_phase(card)
    free_card()
    # 19. split learning, FedNAS, TurboAggregate and the local baselines
    # (no hand kernel)
    paths["split_nas"] = split_nas_phase(card)
    free_card()
    # 20. data on disk, the async buffer, per-client metrics and FID (no
    # hand kernel)
    paths["data_on_disk"] = disk_phase(card)
    free_card()
    # 21. the synchronous deployment runtime (no hand kernel)
    paths["deploy"] = deploy_phase(card)

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
