#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives the port (``distributed_model_parallel_tpu_torch``) only; imports
nothing of JAX or the JAX package. Phases, each fatal on failure:

1. device — require CUDA, print the card's name and power limit, turn
   TF32 off for float32 matmuls and convolutions;
2. build — compile every kernel of the port from ``ops/csrc`` (one
   ``nvcc`` per source, all at once) and print ptxas's register, spill
   and warning lines;
3. kernel vs plain — the paged decode kernel (a split pass over page
   ranges, then a merge launch) against its plain PyTorch version at the
   serving slice's shapes: MHA, GQA (G 4 and G 8), sliding windows of 64
   and 100, positions on page and split edges, one row alone at pos 639;
   unreferenced and stale pool slots filled with NaN; each row of a batch
   equals that row run alone, bit for bit;
4. timing — kernel (both launches), plain version, one
   ``scaled_dot_product_attention`` call over pre-gathered K/V (the
   library yardstick, never used by the port) and the HBM bound; the
   longest row alone; CUDA events, L2 flushed before each run;
5. engine — the serving engine at full width (the bench.py LM/decode
   model, random weights from a seed): 8 greedy requests under continuous
   batching; every request completes, the kernel ran n_layers times per
   decode step, a request's tokens solo equal its tokens in the batch,
   and the first decode step's logits through the kernel agree with the
   plain path's;
6. flash kernels vs plain — the forward, dq and dk/dv kernels in bf16
   against their plain versions (each backward kernel fed the kernel's
   own o and lse) and against autograd through the plain
   ``full_attention``, at the training slice's shape (B 2, H 8, T 8192,
   Dh 128, causal) and its edges (ragged T, full, windows of 256 and 100,
   Dh 64, T 77, a window of 300 over T 1000); both backward kernels run
   twice on each case's inputs and must agree with themselves bit for bit
   (no atomics, no order that depends on scheduling);
7. flash timing — each kernel, its plain version, the operation bound
   and the library yardstick (SDPA forward; SDPA's backward for the
   dq + dk/dv pair), then the port's whole backward (delta, dq, dk/dv)
   beside SDPA's backward, CUDA events, L2 flushed before each run;
8. trainer — the LM training slice at full width (bench.py's LM model,
   bf16, RoPE, remat off, LMTrainConfig's SGD): (a) one step's loss and
   gradients through the kernels against the plain attention at T 2048;
   (b) a warm-up step, then 5 steps through ``LMTrainer`` at B 2, T 8192
   — finite losses, parameters changed, each flash kernel launched
   n_layers times per step — with step time, tokens/s, MFU and peak
   memory; (c) one step under ``torch.profiler``;
9. fused SGD vs plain — ``FusedSGD`` on the card over MobileNetV2's 173
   parameter leaves (one bucket, and a cap that gives 12), 5 updates of
   each variant (momentum + weight decay, nesterov, no decay, momentum 0)
   through the kernels against the plain version per leaf; then the
   public wrappers on a cap-sized bucket, a length that is not a multiple
   of 4, views 4 bytes into their buffers (unaligned head) and views of
   differing offsets, every variant; all bit for bit, launches ==
   updates x buckets; the grid the kernel picks at the CNN and cap
   buckets;
10. fused SGD timing — each variant's one-bucket update: kernel, plain
    version, ``torch.optim.SGD(fused=True)`` over the 173 leaves (the
    library yardstick, never used by the port) and the byte bound, one
    call after an L2 flush (host enqueue included where it outlasts the
    flush); then the device time per launch, from CUDA graphs of K
    launches over R bucket sets that together exceed the L2 3x (each
    launch finds its bucket cold), at the CNN bucket and a cap-sized one,
    beside ``torch.optim.SGD(fused=True)`` over the same flat bucket in
    the same graph train; and the host's enqueue per launch of
    ``FusedSGD.step`` and of the public wrapper;
11. CNN trainer — bench.py's CNN workload with the fused optimizer
    (MobileNetV2, batch 512, bf16 over f32, device-resident, 10 steps per
    dispatch, cuDNN autotuner on): (a) two steps through the fused kernel
    against ``torch.optim.SGD`` from the same weights and batches; (b)
    bench.py's timing shape — 2 warm-up dispatches, 50 steps, one sync —
    with samples/s, step time, MFU and peak memory (fused_sgd launches
    == steps x buckets, parameters and BN statistics changed), then 20
    steps with momentum 0 (plain_sgd launches == steps) and 20 with
    ``fused=False``; (c) one step under ``torch.profiler``, and one with
    momentum 0, each printing the fused SGD kernel's device time;
12. data parallelism — the CNN slice through the port's process group,
    one process per rank started by ``mesh.spawn``: (a) at world =
    ``device_count()`` over NCCL, two gspmd steps at world 1 against
    phase 11's one-device trainer from the same weights and batches,
    cuDNN deterministic, bit for bit; bench.py's timing shape through
    gspmd with samples/s, MFU, peak memory, the grad-allreduce µs a step
    (CUDA events from the first bucket's launch to the end of the
    Reducer's ``finish``) and all-reduce launches a step (== buckets;
    fused_sgd launches counted from 0 over the timed steps); 20 ddp
    steps, bucketed, streaming input; (b) two ranks (both on the one
    card over gloo, or two cards over NCCL): ddp with per-replica, then
    synchronized BN, 5 steps of the global batch of 512 with augment
    off — parameters and momentum bitwise equal across the ranks after
    every step, BN statistics different across ranks under local and
    bitwise equal under sync, and the sync step-0 loss against the
    one-rank gspmd loss on the same rows;
13. pipeline — the CNN slice cut into stages, one ``FusedSGD`` per chunk:
    (a) the runner in one process over ``[cuda:(c % n)]`` for 4 stages
    (all on card 0 on a one-card machine, listed explicitly), cuDNN
    deterministic: two naive (M=1) steps at the reference's cut
    ``0,4,10,16,19`` bit for bit phase 11's one-device trainer, and gpipe
    M=8 == 1f1b M=8 == interleaved V=2 M=8 (8 chunks at the port's
    cost-balanced cut) bit for bit over two steps; then naive M=1, gpipe
    M=4 and M=8, 1f1b M=8 and interleaved V=2 M=8 timed (20 steps after 3,
    each synced: step s, samples/s, host enqueue, peak memory, fused_sgd
    launches == chunks x steps) and one ``PipelineTrainer.fit`` epoch;
    (b) the SPMD engine through ``mesh.spawn`` at 2 stages (two ranks on
    the one card over gloo, or two cards over NCCL), gpipe and 1f1b M=4,
    3 steps of ``Trainer(strategy="spmd_pipeline")``: each rank's
    parameters, momentum and BN statistics bit for bit the runner's at
    S=2 with the same cut and M; hops and bytes, µs a ring shift of the
    boundary activation, step time; (c) ``PipelineTrainer`` over the 4
    stages, gpipe M=4 at the reference's cut, phase 15b's workload
    (MobileNetV2 bf16, fused SGD, augment on, 4,096 / 1,024 rows at batch
    256, 2 epochs, cuDNN deterministic): ``fit(2)`` against ``fit``
    preempted by a ``step_hook`` at step 5 of epoch 1 and finished by
    ``PipelineTrainer(resume=True)``, bit for bit (parameters, momentum,
    BN statistics, update counts, global step, history), fused_sgd
    launches, the "pipeline" slot's best_acc, the text log's lines, save
    and restore ms and bytes; (d) two SPMD ranks (gloo on one card, NCCL
    on two): the same gate under gpipe and 1f1b M=4 on 2,048 / 512 rows,
    then interleaved 1F1B V=2, M=4 at S=2 over 3 steps, each rank's
    chunks bit for bit the runner's interleaved V=2 at S=2 with the same
    cut, its hops and bytes a step beside 1F1B's;
14. ResNet and the remaining data-parallel engines: (a) bench.py's CNN
    workload with ``DMP_BENCH_MODEL=resnet50`` (ResNet-50, CIFAR layout,
    batch 512, bf16 over f32, fused SGD over two buckets, device-resident,
    10 steps per dispatch): the two-step fused vs ``torch.optim.SGD``
    check, bench.py's timing shape (samples/s, MFU, peak memory;
    fused_sgd launches == steps x buckets, counted from 0 over the timed
    steps), 20 momentum-0 steps (plain_sgd == steps x buckets), a
    profiled step with the fused kernel's device time beside its byte
    bound, one ResNet-18 step and ResNet-50's ImageNet layout forward at
    batch 32 on 224 px; (b) two ranks (both on the one card over gloo, or
    two cards over NCCL), ResNet-50 in f32 at batch 128, augment off,
    cuDNN deterministic, 3 steps a case, each step from the reference
    run's state: ddp ``allreduce="ring"`` vs ``"bucketed"`` and ZeRO
    (fused SGD kernel on each rank's slice, then momentum 0) vs gspmd's
    FusedSGD, parameters per leaf within 1e-5 relative and bitwise equal
    across ranks, one kernel launch a step a rank under ZeRO and its
    momentum bytes beside gspmd's; fsdp vs gspmd within
    tests/test_fsdp.py's bounds, each rank's resident bytes; the sparse
    bag-of-words (BowConfig's defaults, 512 rows x 64 tokens, 5 steps)
    against dense SGD on the global batch within 1e-5, tables bitwise
    equal across ranks;
15. the reference's harness: (a) each of the 16 zoo models
    (``models/zoo.py``) at its CIFAR widths, bf16 over f32 parameters,
    FusedSGD (lr 0.4, momentum 0.9, wd 1e-4), batch 128 of synthetic
    32 px data on the card, device-resident: 2 one-step warm-ups, 10
    steps in one dispatch, one sync — the JAX package's parameter count,
    ``fused_sgd`` launches == steps x buckets on the card, finite losses;
    step s, samples/s and peak memory (over what was allocated before
    the model's Trainer) printed; phase 11a's check on
    EfficientNet-B0 and DenseNet-121, a momentum-0 EfficientNet-B0 run
    (``plain_sgd``); (b) MobileNetV2 bf16, batch 256, cuDNN deterministic:
    ``fit(2)`` against ``fit`` preempted by a ``step_hook`` at step 5 of
    epoch 1 and finished by ``Trainer(resume=True)``, bit for bit
    (parameters, momentum, BN statistics, update count, global step,
    history), per batch and device-resident at 10 steps a dispatch; the
    ``ckpt`` slot's best_acc, a torn newest version skipped and logged,
    the text log's lines, save and restore ms and the checkpoint's
    bytes; (c) the same gate at two ranks for ddp and zero (gloo on one
    card, NCCL on two or more), and zero's uninterrupted run against
    gspmd's from the same inputs, parameters, momentum and BN statistics
    per leaf within 1e-5 relative;
16. the data path: (a) the reference's finetune recipe — MobileNetV2 in
    the ImageNet layout, bf16 over f32, FusedSGD lr 0.05, batch 128 of
    32 px rows held on the card and resized to 224 px in every step,
    device-resident, 10 steps a dispatch, bench.py's timing shape:
    samples/s, step s, MFU, peak memory, fused_sgd == steps x buckets, a
    profiled step with the resize's share of device time, the resize on
    the card against its CPU run; (b) one epoch of 15b's workload on the
    per-batch host path with the host and device prefetch stages (depth
    2) bit for bit the epoch without them, the data time a step of each;
    (c) the C++ row gather at batch 512 of CIFAR-shaped rows against
    numpy indexing, bit for bit, µs a batch of each.

Prints the card line, each phase's seconds, a ``{"data_parallel": ...}``
line, a ``{"pipeline": ...}`` line, a ``{"resnet": ...}`` line, a
``{"dp_engines": ...}`` line, a ``{"harness": ...}`` line, a
``{"data_path": ...}`` line, the ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``. Exits non-zero
without a card, or when run outside a checkout of the repository.
``--sgd-timing-only`` runs phases 1, 2 (the fused SGD kernel) and 10 and
prints their ``{"sgd_timing": ...}`` line: copied into another checkout,
it measures that checkout's kernel the same way. ``--pipeline-only``
runs phases 1, 2 (the fused SGD kernel) and 13 and prints the
``{"pipeline": ...}`` line: on a machine with four cards, it drives the
runner with each stage on its own card and the SPMD engine over NCCL.
``--dp-only`` runs phases 1, 2 (the fused SGD kernel) and 14b at world =
``device_count()`` over NCCL and prints the ``{"dp_engines": ...}`` line;
with more than one card it adds BASELINE.json's pair per engine
(bucketed, ring, ZeRO, fsdp, gspmd): samples/s a card over 10 more steps
and the gradient reduction's µs a step by CUDA events (not measured for
fsdp, whose reduce-scatters run inside the backward). ``--harness-only``
runs phases 1, 2 (the fused SGD kernel) and 15 and prints the
``{"harness": ...}`` line; ``--data-only`` runs phases 1, 2 and 16 and
prints the ``{"data_path": ...}`` line.
"""

from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# The serving slice: bench.py's LM/decode model and serving geometry.
MODEL = dict(vocab_size=32_000, d_model=1024, n_heads=8, n_layers=8,
             d_ff=4096, max_seq_len=640, pos_embedding="rope")
GEOMETRY = dict(n_slots=8, page_size=16, n_pages=(8 + 1) * 40,
                max_seq_len=640, prefill_chunk=32)
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12          # H100 SXM, float32 outside tensor cores
# Kernel vs plain: bf16 output, f32 accumulation in both; the plain
# version runs in f32 and is cast back, so the two differ by the
# rounding of one bf16 output (<= 2^-8 relative on values of order 1)
# plus f32 summation order — 2e-2 leaves a 5x margin.
KERNEL_ATOL = 2e-2
# Engine logits, kernel vs plain attention: every layer's attention
# output is rounded to bf16 in both paths, and a 1-ulp difference there
# propagates through 8 bf16 layers into logits of order 1-5; a wrong
# kernel (a dropped page, a wrong head) moves logits by O(1).
LOGITS_ATOL = 0.25

BF16_FLOPS_PER_S = 989e12        # H100 SXM, dense bf16 tensor cores
# Flash kernels vs plain (phase 6), B 2, H 8, bf16 N(0, 1) inputs: the
# slice's shape and its edges (ragged T, full attention, a window, Dh 64).
FLASH_CASES = {
    "causal_t8192": dict(t=8192, dh=128, causal=True, window=None),
    "ragged_t1000": dict(t=1000, dh=128, causal=True, window=None),
    "full_t1024": dict(t=1024, dh=128, causal=False, window=None),
    "window256_t2048": dict(t=2048, dh=128, causal=True, window=256),
    "dh64_t2048": dict(t=2048, dh=64, causal=True, window=None),
    # Edges of the forward's 128 x 128 tiling: a window that is a multiple
    # of neither block, and T shorter than one q block.
    "window100_t2048": dict(t=2048, dh=128, causal=True, window=100),
    "t77": dict(t=77, dh=128, causal=True, window=None),
    # Edges of the backward's tiles (128-row blocks over 64-row tiles):
    # a window that is a multiple of neither, over a T that is not a
    # multiple of 128.
    "window300_t1000": dict(t=1000, dh=128, causal=True, window=300),
}
# o, gated per row: max over (b, t, h) of ||o - o_ref|| / ||o_ref|| over
# Dh. Row i of o averages ~i/e values of v, so |o| falls from ~2-4 on the
# first rows to ~0.02 at T 8192, and an absolute limit that fits the
# first rows is as large as the late rows themselves. Per row, the
# kernel's roundings (p to bf16 before p·v, o to bf16; each <= 2^-9
# relative, the plain version rounds only o) give ~2e-3; a wrong V tile
# or mask on any row moves its ratio by O(1).
O_ROW_RTOL = 1e-2
# o, absolute, an extra check: one bf16 ulp on the first rows (|o| ~ 2-4)
# is 1.6e-2.
O_ATOL = 2e-2
# lse: both in f32 from the same bf16 inputs (products exact in f32); they
# differ by summation order and exp2 vs exp, ~1e-6 on values ~10.
LSE_ATOL = 1e-3
# Gradients, max|a - b| / max|b|: the kernels round p and ds to bf16
# before the products (as the Pallas kernels do) and dq/dk/dv to bf16,
# each <= 2^-9 relative. Against the plain backward fed the kernel's own
# o and lse (each kernel alone) also per row, as for o: late rows of dq
# and late keys of dk/dv are small. Against autograd through the plain
# attention only as a whole: autograd takes delta = rowsum(dO·O) from the
# f32 o, the kernels (as the Pallas ones) from the bf16 o they return,
# and on a row whose dq cancels (a softmax peaked on one of the first
# few keys) that difference, not the kernel, sets the row's ratio.
GRAD_RTOL = 2e-2

# The LM training slice: bench.py's LM model (bench.py:243-251) at full
# width and depth, bf16, RoPE; remat off (bench.py turns it on only to fit
# a 16 GB chip; it changes memory, not numbers). bench.py's batch and
# sequence on one chip, and its token count with eval off.
LM_MODEL = dict(vocab_size=32_000, d_model=1024, n_heads=8, n_layers=8,
                d_ff=4096, max_seq_len=8192, pos_embedding="rope")
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 8192, 5
# Phase 8a runs the plain attention too, which keeps f32 [B, H, T, T]
# tensors of every layer for the backward: T 2048 holds them in a few GB.
CHECK_SEQ = 2048
# Step-0 loss, kernels vs plain attention, on a loss of ~ln(32000) = 10.4:
# every layer's activations are bf16 in both paths and the two attentions
# round differently (the kernel rounds p to bf16 before p·v), a relative
# 2^-8 per layer that the mean over 4096 tokens averages down. A wrong
# kernel (a dropped block, a wrong mask) moves the loss by far more.
TRAIN_LOSS_ATOL = 2e-2
# Gradients of blocks.wqkv, blocks.wo and head, max|a - b| / max|b|: the
# per-kernel error of phase 6 (<= 2e-2) compounded through 8 bf16 layers.
TRAIN_GRAD_RTOL = 5e-2

# The fused SGD kernels (phases 9-10) at the CNN slice's 173 MobileNetV2
# parameter leaves, f32 N(0, 1) values and gradients. Variants: the
# slice's SGD (momentum 0.9, wd 1e-4), nesterov, no weight decay, and
# momentum 0 (the plain_sgd kernel).
SGD_VARIANTS = {
    "momentum_wd": dict(momentum=0.9, weight_decay=1e-4, nesterov=False),
    "nesterov_wd": dict(momentum=0.9, weight_decay=1e-4, nesterov=True),
    "momentum_no_wd": dict(momentum=0.9, weight_decay=0.0, nesterov=False),
    "no_momentum": dict(momentum=0.0, weight_decay=1e-4, nesterov=False),
}
SGD_UPDATES = 5
SGD_SMALL_BUCKET_BYTES = 1 << 20       # ~10 buckets of MobileNetV2
# Kernel vs plain over p and m: the kernel rounds each product and sum on
# its own (__fmul_rn/__fadd_rn), as the plain version's eager ops do, so
# every phase-9 case must agree bit for bit (max_abs_err exactly 0).
# Phase 9's direct wrapper cases, each variant, 2 updates: a cap-sized
# bucket (FUSED_BUCKET_BYTES of f32), a length that is not a multiple of
# 4, a view starting 4 bytes into its buffers (an unaligned head before
# the 16-byte body), and views whose offsets differ (no common alignment:
# all scalar). Offsets in f32 elements for p, m, g.
SGD_WRAPPER_CASES = {
    "cap_bucket": dict(n=16 * 1024 * 1024, offsets=(0, 0, 0)),
    "ragged_n": dict(n=1_000_003, offsets=(0, 0, 0)),
    "unaligned_head": dict(n=2_296_922, offsets=(1, 1, 1)),
    "mixed_offsets": dict(n=100_001, offsets=(1, 2, 3)),
}
# Phase 10's device time per launch: a CUDA graph of K launches rotating
# over R bucket sets (p, m, g) whose total is >= 3x the 50 MB L2, so each
# launch finds its bucket cold; events around graph.replay(), median over
# the replays, / K. Shapes: MobileNetV2's one bucket (the CNN path's) and
# a full FUSED_BUCKET_BYTES bucket (what every bucket of a model over 64
# MiB of f32 parameters fills).
SGD_TIMING_SHAPES = {
    "cnn": dict(n=2_296_922, sets=6, launches=60),
    "cap": dict(n=16 * 1024 * 1024, sets=2, launches=20),
}
SGD_GRAPH_REPLAYS = 15
SGD_HOST_STEPS = 200                   # host enqueue: steps, no sync

# The CNN slice (phase 11): bench.py's CNN workload (bench.py:1343-1361)
# with DMP_BENCH_FUSED_OPT=1 on one device — MobileNetV2 (CIFAR layout),
# bf16 compute over f32 parameters, batch 512, 32 px synthetic data, 4 x
# 512 training images, SGD lr 0.4 / momentum 0.9 / wd 1e-4 / 10 warm-up
# steps / cosine, device-resident, 10 steps per dispatch; bench.py's
# timing shape (bench.py:1562-1586): 2 warm-up dispatches, 50 steps timed.
CNN_BATCH, CNN_SPD, CNN_WARM_DISPATCHES, CNN_TIMED_STEPS = 512, 10, 2, 50
CNN_SIDE_STEPS = 20                    # momentum 0, and fused=False
# 11a, fused kernel vs torch.optim.SGD (fused=False) from the same weights
# and batches, two steps (lr 0 at step 0 under warm-up, 0.04 at step 1):
# the forward of both steps is the same computation on the same values,
# so the losses agree to cuDNN's run-to-run order (bf16, loss ~2.3). The
# step-1 update of every leaf, max|Δa - Δb| / max|Δb|: f32 rounding
# (~1e-6) when the gradients agree bit for bit; a wrong kernel (a dropped
# bucket slot, a missing trace or decay term) moves it by O(1).
CNN_LOSS_ATOL = 1e-2
CNN_UPDATE_RTOL = 5e-2
CNN_STATS_RTOL = 1e-3

# Data parallelism (phase 12): the CNN slice through the port's process
# group. 12a at world = device_count() over NCCL: the gate step, bench.py's
# timing shape (CNN_WARM_DISPATCHES, CNN_TIMED_STEPS) through gspmd, then
# DP_DDP_STEPS ddp steps (bucketed, streaming). 12b: two ranks, DDP with
# per-replica and with synchronized BN, DP_TWO_RANK_STEPS steps of the
# global batch (256 rows a rank), augment off so that the gspmd reference
# at world 1 draws nothing and the two see the same rows.
DP_DDP_STEPS = 20
DP_TWO_RANK_STEPS = 5
# 12b's step-0 loss, two-rank ddp + sync BN vs one-rank gspmd, same weights
# and rows, loss ~2.3: the same function; the two BatchNorms (cuDNN's at
# one rank, the port's f32 E[x²] − E[x]² over the group at two) and the
# convolutions at batch 512 vs 256 round differently, each layer's bf16
# output by up to one ulp (2^-8 relative) on some elements, which the mean
# over 512 rows averages down. A wrong reduction (statistics not divided
# by the world, a rank's rows dropped) moves the loss by O(1); per-rank
# statistics under sync fail the bitwise BN gate instead.
DP_LOSS_ATOL = 2e-2

# The pipeline (phase 13): the CNN cell (MobileNetV2, batch 512, bf16
# over f32, fused SGD lr 0.4 / momentum 0.9 / wd 1e-4) cut at the
# reference's 4-GPU boundaries (scripts/train_model_parallel.py:8-9), one
# FusedSGD per chunk. 13a: the runner in one process, every chunk on the
# one card (listed explicitly); the schedules timed, cuDNN's autotuner off
# (each microbatch size would take its own first pass). 13b: the SPMD
# engine, 2 stages as 2 ranks at the port's cost-balanced 2-stage cut.
PP_STAGES, PP_CUT = 4, (0, 4, 10, 16, 19)
PP_WARM_STEPS, PP_TIMED_STEPS = 3, 20
PP_RUNS = {                       # name -> (M, schedule, virtual stages)
    "naive_m1": (1, "gpipe", 1), "gpipe_m4": (4, "gpipe", 1),
    "gpipe_m8": (8, "gpipe", 1), "1f1b_m8": (8, "1f1b", 1),
    "interleaved_v2_m8": (8, "1f1b", 2),
}
PP_SPMD_M, PP_SPMD_STEPS, PP_HOPS = 4, 3, 20

# ResNet (phase 14a): bench.py's CNN workload with DMP_BENCH_MODEL=resnet50
# (bench.py:1320-1387, 1542-1545) — ResNet-50 in the CIFAR layout, the rest
# as phase 11 (batch 512, bf16 over f32, fused SGD, device-resident, 10
# steps per dispatch, bench.py's timing shape). Its 23,520,842 f32
# parameters make two fused SGD buckets at the 64 MiB cap. Beside it one
# ResNet-18 step, and ResNet-50's ImageNet layout (7x7 stride-2 stem, 3x3
# SAME max-pool) forward at batch 32 on 224 px input made at that size.
RN_MODEL, RN_SIDE_MODEL = "resnet50", "resnet18"
RN_IMAGENET_BATCH, RN_IMAGENET_PX = 32, 224
# The DP engines (phase 14b): ResNet-50 in f32 (the gates are the JAX
# package's f32 bounds), global batch 128, augment off, SGD lr 0.01 /
# momentum 0.9 / wd 1e-4 without warm-up (at 0.1 the loss climbs from 2.6
# to 36 in 3 steps), DPE_STEPS steps per case from the
# same weights and batches. DPE_RTOL: ring vs bucketed and ZeRO vs gspmd,
# per leaf max|a - b| / max|b| after every step — two ranks sum two
# values in either order to the same bits, so any gap is a fault of the
# transport or of the slice update, not of rounding. fsdp vs gspmd:
# tests/test_fsdp.py's bounds (losses rel 2e-4; params rtol 2e-4, atol
# 2e-5). The sparse BOW at BowConfig's defaults (vocab 10,000, embed 64,
# 10 classes), 512 rows x 64 tokens, 5 steps at lr 0.1 against dense SGD
# on the global batch: tests/test_sparse_embedding.py's bounds.
DPE_BATCH, DPE_STEPS, DPE_TIMED_STEPS, DPE_LR = 128, 3, 10, 0.01
DPE_RTOL = 1e-5
FSDP_LOSS_RTOL, FSDP_RTOL, FSDP_ATOL = 2e-4, 2e-4, 2e-5
BOW_ROWS, BOW_TOKENS, BOW_STEPS, BOW_LR = 512, 64, 5, 0.1
BOW_RTOL, BOW_ATOL = 1e-5, 1e-6
# The zoo (phase 15a): each of the 16 architectures of
# models/zoo.py at its published CIFAR widths, bf16 over f32 parameters,
# bench.py's SGD recipe (lr 0.4, momentum 0.9, wd 1e-4) through FusedSGD,
# synthetic 32 px data on the card, device-resident: 2 one-step warm-up
# dispatches (cuDNN's autotuner), then 10 steps in one dispatch and one
# sync. Cut: batch 128, not bench.py's 512, so 16 models fit the phase's
# time. ZOO_PARAMS: the JAX package's parameter count of each (jax.
# eval_shape of its init on the CPU; tests/test_torch_zoo_models.py).
ZOO_BATCH, ZOO_WARM_DISPATCHES, ZOO_TIMED_STEPS = 128, 2, 10
ZOO_PARAMS = {
    "vgg11": 9228362, "vgg13": 9413066, "vgg16": 14724042,
    "vgg19": 20035018, "preactresnet18": 11171210, "senet18": 11260290,
    "googlenet": 6158346, "densenet121": 6956362,
    "resnext29_2x64d": 9130314, "mobilenetv1": 3217226, "dpn92": 34236634,
    "shufflenetg2": 888158, "shufflenetv2": 1263854,
    "efficientnetb0": 3598598, "regnetx_200mf": 2321946,
    "simpledla": 15142970,
}
# Resume (phase 15b/c): the reference's workload (MobileNetV2,
# bf16, fused SGD, augment on), 4,096 / 1,024 synthetic rows, batch 256
# (16 steps an epoch), 2 epochs, preempted at step 5 of epoch 1 (the
# first dispatch boundary after it at 10 steps a dispatch), cuDNN
# deterministic.
RES_TRAIN, RES_EVAL, RES_BATCH, RES_PREEMPT_STEP = 4096, 1024, 256, 5
# The pipeline's harness (phase 13c/13d): 15b's workload and gate through
# the pipeline. 13c: PipelineTrainer over PP_STAGES stages at the
# reference's cut, gpipe M=4, RES_TRAIN / RES_EVAL rows. 13d: two SPMD
# ranks, gpipe and 1f1b M=4, on PPS_TRAIN / PPS_EVAL rows (cut from 15b's
# 4,096 / 1,024 so that six two-epoch fits over the host-staged gloo hops
# fit the phase), then interleaved V=2 M=4 for PP_SPMD_STEPS steps
# against the runner, and 1F1B's hops beside it.
PPR_M = 4
PPS_TRAIN, PPS_EVAL = 2048, 512
# The data path (phase 16): (a) the reference's finetune recipe
# (Readme.md:186-202, SURVEY.md:309): MobileNetV2 in the ImageNet layout,
# bf16 over f32, FusedSGD lr 0.05 / momentum 0.9 / wd 1e-4 / 10 warm-up
# steps, batch 128 of CIFAR-shaped 32 px synthetic rows held on the card
# (4 x 128) and resized to 224 px in every step, device-resident, 10
# steps a dispatch, bench.py's timing shape (CNN_WARM_DISPATCHES, then
# CNN_TIMED_STEPS). FT_RESIZE_ATOL / FT_TIE: the resize on the card
# against its CPU run on the same batch, as tests/test_torch_data_path.py
# holds it against jax.image.resize (float values on the 0-255 scale;
# uint8 equal away from .5 ties). (b) one epoch of 15b's workload on the
# host path with both prefetch stages against both off. (c) the native
# row gather at batch 512 of 50,000 CIFAR-shaped rows against numpy
# indexing, FT_GATHER_REPS batches each.
FT_BATCH, FT_PX, FT_LR = 128, 224, 0.05
FT_RESIZE_ATOL, FT_TIE = 1e-3, 1e-3
FT_GATHER_ROWS, FT_GATHER_BATCH, FT_GATHER_REPS = 50_000, 512, 50


# Where the phases' trainers write their logs and checkpoints: one
# temporary directory of the run, made by main() and removed at exit;
# spawned ranks inherit the variable.
RUN_DIR_ENV = "CHIP_SMOKE_RUN_DIR"


def run_dirs(name: str) -> dict:
    """A TrainConfig's log_dir, log_name and checkpoint_dir under the
    run's temporary directory (never the working directory)."""
    root = os.environ[RUN_DIR_ENV]
    return dict(log_dir=os.path.join(root, "log"), log_name=name,
                checkpoint_dir=os.path.join(root, "ckpt", name))


def fail(phase: str, msg: str) -> None:
    print(f"chip_smoke: phase {phase} FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sgd_traffic(n: int, momentum: float, weight_decay: float,
                nesterov: bool) -> dict:
    """One fused SGD update over ``n`` f32 parameters: the HBM bytes it
    must move (p, g and, with a trace, m read once; p and m written once),
    its f32 operations, and its bound — the larger of bytes at the card's
    memory rate and operations at its f32 rate — in ms."""
    bytes_moved = (5 if momentum else 3) * n * 4
    flops = (2 * (weight_decay != 0) + 2 * (momentum != 0)
             + 2 * bool(nesterov and momentum) + 2) * n
    bound_ms, bound_by = max(
        (bytes_moved / HBM_BYTES_PER_S * 1e3, "bytes"),
        (flops / F32_FLOPS_PER_S * 1e3, "operations"))
    return dict(bytes=bytes_moved, flops=flops, bound_ms=bound_ms,
                bound_by=bound_by)


def graph_train_ms(launch, k: int, replays: int = SGD_GRAPH_REPLAYS) -> float:
    """Device ms per launch of ``launch(i)``, i = 0..k-1, captured as one
    CUDA graph: CUDA events around ``graph.replay()`` (behind a short
    device sleep, so the host's submission of the graph is not in the
    window), median over ``replays``, divided by k. A refused capture
    raises."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                  # warm-up before capture
        for i in range(k):
            launch(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(k):
            launch(i)
    graph.replay()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000)                 # ~50 us of device time
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / k)
    del graph
    return statistics.median(times)


def time_ms(fn, *, reps: int = 30, warmup: int = 5, flush=None) -> float:
    """Median device time of one ``fn()`` call in ms, CUDA events around
    each call, ``flush`` (an L2-sized buffer) rewritten before each."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def make_case(b, h, hkv, dh, page, n, n_pool, positions, seed):
    """Pools [P, page, Hkv, Dh] bf16 on the card with every slot no row
    may read (unreferenced pages, positions past a row's length) set to
    NaN, distinct random pages per row, q [B, 1, H, Dh]."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    tables = torch.randperm(n_pool, generator=gen)[:b * n].reshape(b, n)
    used = torch.zeros(n_pool, page, dtype=torch.bool)
    for row, pos in enumerate(positions):
        t = torch.arange(pos + 1)
        used[tables[row, t // page], t % page] = True
    kp = torch.randn(n_pool, page, hkv, dh, generator=gen)
    vp = torch.randn(n_pool, page, hkv, dh, generator=gen)
    kp[~used] = float("nan")
    vp[~used] = float("nan")
    q = torch.randn(b, 1, h, dh, generator=gen)
    dev = torch.device("cuda")
    return (q.to(dev, torch.bfloat16), kp.to(dev, torch.bfloat16),
            vp.to(dev, torch.bfloat16), tables.to(dev, torch.int32),
            torch.tensor(positions, dtype=torch.int32, device=dev))


def lm_kind(key: str) -> str:
    """Device-time kinds of the serving and LM steps: the port's own
    kernels, cuBLAS GEMMs (nvjet, gemm and xmma kernel names), the rest."""
    if "flash::" in key or "paged_decode" in key:
        return "port kernels"
    if any(s in key.lower() for s in ("nvjet", "gemm", "xmma")):
        return "cuBLAS GEMMs"
    return "other"


def print_profile(label: str, run, card, kind=lm_kind) -> list:
    """``run()`` under ``torch.profiler``: device time by kernel and the
    device's busy share of the run's wall time (kernels run on one
    stream, so their times add), then by ``kind(kernel name)``. ``run``
    returns a note for the summary line. Informational: a profile without
    device events prints "not measured". Returns the (kernel name, device
    us, count) rows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        note = run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    rows = [(e.key, e.device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    busy_us = sum(r[1] for r in rows)
    if not rows:
        print(f"profile {label} [{card}]: device time not measured "
              f"(no CUDA events)")
        return rows
    print(f"profile {label} [{card}]: wall {wall_us:.0f} us, device busy "
          f"{busy_us:.0f} us ({100 * busy_us / wall_us:.1f}%), {note}; "
          f"top kernels:")
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"  {us:10.0f} us {n:6d} x  {key[:90]}")
    kinds: dict[str, float] = {}
    for key, us, _ in rows:
        kinds[kind(key)] = kinds.get(kind(key), 0.0) + us
    print("  by kind: " + ", ".join(
        f"{k} {us:.0f} us ({100 * us / busy_us:.1f}%)"
        for k, us in kinds.items()))
    return rows


def profile_engine(Engine, params, cfg, serve, prompts, gens, card) -> None:
    """The same engine workload once more under ``torch.profiler``."""
    eng = Engine(params, cfg, serve)
    for i, (p, g) in enumerate(zip(prompts, gens)):
        eng.submit(p, g, seed=i)

    def run():
        eng.run()
        return f"{eng.summary()['decode_steps']} decode steps"

    print_profile("engine", run, card)


def per_batch(fn, *xs):
    """``fn`` over one batch row at a time, outputs joined on dim 0: the
    plain attention versions hold f32 [H, T, T] scores, 2.1 GB per row
    at H 8, T 8192."""
    import torch

    outs = [fn(*(x[i:i + 1] for x in xs)) for i in range(xs[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in f32."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def row_rel_err(got, want, floor: float = 1e-3) -> float:
    """max over rows (every index but the last) of ||got - want|| /
    max(||want||, floor · the largest ||want||), in f32. The floor keeps
    rows that cancel to ~0 in exact arithmetic (row 0 of causal dq:
    ds_00 = dp_00 - delta_0 = 0) from comparing f32 noise with noise;
    for o at T 8192 (row norms ~11 first, ~0.2 last) it never binds."""
    want = want.float()
    diff = (got.float() - want).norm(dim=-1)
    scale = want.norm(dim=-1)
    return (diff / scale.clamp_min(floor * scale.max())).max().item()


def flash_inputs(b, t, h, dh, seed):
    """q, k, v, dO [B, T, H, Dh] bf16 on the card, N(0, 1) from a seed."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(b, t, h, dh, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(4)]


def check_flash(fa) -> dict:
    """Phase 6: the three flash kernels against their plain versions in
    bf16 at the training slice's shapes and its edges. Returns the largest
    errors per kernel; fails the phase after listing every violation."""
    import torch

    errs = {"flash_fwd": [0.0, 0.0], "flash_bwd_dq": [0.0, 0.0],
            "flash_bwd_dkv": [0.0, 0.0]}          # [max abs, max row rel]
    bad = []
    for i, (label, c) in enumerate(FLASH_CASES.items()):
        causal, window = c["causal"], c["window"]
        q, k, v, do = flash_inputs(2, c["t"], 8, c["dh"], seed=100 + i)
        o, lse = fa.flash_forward_kernel(q, k, v, causal, window)
        delta = fa.bwd_delta(o, do)
        dq = fa.flash_bwd_dq_kernel(q, k, v, do, lse, delta, causal, window)
        dk, dv = fa.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, causal,
                                         window)
        # Both backward kernels again on the same inputs: bit for bit.
        dq2 = fa.flash_bwd_dq_kernel(q, k, v, do, lse, delta, causal, window)
        dk2, dv2 = fa.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, causal,
                                           window)
        torch.cuda.synchronize()
        repeat = {n: torch.equal(a, b) for n, a, b in (
            ("dq", dq, dq2), ("dk", dk, dk2), ("dv", dv, dv2))}
        bad += [f"{label}: {n} differs between two calls on the same inputs"
                for n, same in repeat.items() if not same]
        del dq2, dk2, dv2
        got = {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
        bad += [f"{label}: non-finite {n}" for n, x in got.items()
                if not torch.isfinite(x).all()]
        o_ref, lse_ref = per_batch(
            lambda q, k, v: fa.flash_forward_plain(q, k, v, causal, window),
            q, k, v)
        o_err = (o.float() - o_ref.float()).abs().max().item()
        o_row = row_rel_err(o, o_ref)
        lse_err = (lse - lse_ref).abs().max().item()
        # Each backward kernel alone: the plain versions fed the kernel's
        # own o (through delta) and lse.
        dq_ref = per_batch(lambda *a: fa.flash_bwd_dq_plain(
            *a, causal, window), q, k, v, do, lse, delta)
        dk_ref, dv_ref = per_batch(lambda *a: fa.flash_bwd_dkv_plain(
            *a, causal, window), q, k, v, do, lse, delta)

        # End to end: autograd through the plain full_attention.
        def auto(q, k, v, do):
            q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
            out = fa.full_attention(q, k, v, causal=causal, window=window)
            return torch.autograd.grad(out, (q, k, v), do)

        aq, ak, av = per_batch(auto, q, k, v, do)
        torch.cuda.synchronize()
        rel = {"dq": rel_err(dq, dq_ref), "dk": rel_err(dk, dk_ref),
               "dv": rel_err(dv, dv_ref), "dq_auto": rel_err(dq, aq),
               "dk_auto": rel_err(dk, ak), "dv_auto": rel_err(dv, av)}
        alone = (("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref))
        row = {n: row_rel_err(x, r) for n, x, r in alone}
        absd = {n: (x.float() - r.float()).abs().max().item()
                for n, x, r in alone}
        print(f"flash {label}: o per-row rel err {o_row:.3e} (rtol "
              f"{O_ROW_RTOL}), max_abs_err {o_err:.3e} (atol {O_ATOL}), "
              f"lse {lse_err:.3e} (atol {LSE_ATOL}); grads max|a-b|/max|b| "
              + ", ".join(f"{n} {e:.3e}" for n, e in rel.items())
              + "; per row vs the plain backward "
              + ", ".join(f"{n} {e:.3e}" for n, e in row.items())
              + f" (rtol {GRAD_RTOL} each); second call bitwise equal: "
              + ", ".join(f"{n} {same}" for n, same in repeat.items()))
        if not o_row <= O_ROW_RTOL:
            bad.append(f"{label}: o per-row rel err {o_row} > {O_ROW_RTOL}")
        if not o_err <= O_ATOL:
            bad.append(f"{label}: o err {o_err} > {O_ATOL}")
        if not lse_err <= LSE_ATOL:
            bad.append(f"{label}: lse err {lse_err} > {LSE_ATOL}")
        bad += [f"{label}: {n} rel err {e} > {GRAD_RTOL}"
                for n, e in rel.items() if not e <= GRAD_RTOL]
        bad += [f"{label}: {n} per-row rel err {e} > {GRAD_RTOL}"
                for n, e in row.items() if not e <= GRAD_RTOL]
        for name, a, r in (
                ("flash_fwd", o_err, o_row),
                ("flash_bwd_dq", absd["dq"], row["dq"]),
                ("flash_bwd_dkv", max(absd["dk"], absd["dv"]),
                 max(row["dk"], row["dv"]))):
            errs[name] = [max(errs[name][0], a), max(errs[name][1], r)]
        del q, k, v, do, o, lse, delta, dq, dk, dv, o_ref, lse_ref, dq_ref
        del dk_ref, dv_ref, aq, ak, av, got
        torch.cuda.empty_cache()
    if bad:
        fail("6/flash", "; ".join(bad))
    return errs


def attention_pairs(t: int, causal: bool, window) -> int:
    """Attended (q, k) positions per (b, h)."""
    if not causal:
        return t * t
    if window is not None:
        w = min(window, t)
        return t * w - w * (w - 1) // 2
    return t * (t + 1) // 2


def time_flash(fa, card) -> dict:
    """Phase 7: each flash kernel, its plain version and the library
    yardstick at the LM slice's shapes, CUDA events, L2 flushed before
    each run; the bound from this run's shapes."""
    import torch
    import torch.nn.functional as F

    b, t, h, dh = 2, 8192, 8, 128
    q, k, v, do = flash_inputs(b, t, h, dh, seed=7)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    o, lse = fa.flash_forward_kernel(q, k, v)
    delta = fa.bwd_delta(o, do)
    runs = {
        "flash_fwd": (lambda: fa.flash_forward_kernel(q, k, v),
                      lambda: fa.flash_forward_plain(q, k, v), 4,
                      3, 1),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq_kernel(
            q, k, v, do, lse, delta),
            lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta), 6,
            4, 1),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv_kernel(
            q, k, v, do, lse, delta),
            lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta), 8,
            4, 2),
    }
    # Library yardsticks, never called by the port: one SDPA forward, and
    # SDPA's backward alone (for dq and dk/dv together).
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    with torch.no_grad():
        sdpa_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True), flush=flush)
    oh = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(
        oh, (qh, kh, vh), doh, retain_graph=True), flush=flush)
    pairs = attention_pairs(t, True, None)
    out = {}
    for name, (kern, plain, products, n_in, n_out) in runs.items():
        ms = time_ms(kern, flush=flush)
        plain_ms = time_ms(plain, reps=20, warmup=2, flush=flush)
        flops = products * b * h * pairs * dh
        elt = b * t * h * dh * 2                             # one bf16 row set
        vec = b * h * t * 4                                  # one f32 vector
        bytes_moved = (n_in + n_out) * elt + (1 if name == "flash_fwd"
                                              else 2) * vec
        ops_ms = flops / BF16_FLOPS_PER_S * 1e3
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        bound_ms, bound_by = max((ops_ms, "operations"), (bytes_ms, "bytes"))
        library_ms = sdpa_fwd_ms if name == "flash_fwd" else sdpa_bwd_ms
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library_ms)
        print(f"{name} timing [{card}]: kernel {ms} ms, plain {plain_ms} ms, "
              f"bound {bound_ms} ms ({bound_by}: {flops} flop, "
              f"{bytes_moved} B), {bound_ms / ms:.1%} of bound, library "
              f"{library_ms} ms ("
              + ("SDPA forward" if name == "flash_fwd" else
                 "SDPA backward alone, dq and dk/dv together")
              + f"), ms / library_ms {ms / library_ms:.3f}")
    pair = out["flash_bwd_dq"]["ms"] + out["flash_bwd_dkv"]["ms"]
    print(f"flash backward timing [{card}]: dq + dk/dv {pair} ms, / SDPA "
          f"backward {pair / sdpa_bwd_ms:.3f}")

    # What FlashAttention.backward runs: delta, dq, dk/dv (SDPA's backward
    # includes its own delta pass).
    def whole_backward():
        dl = fa.bwd_delta(o, do)
        fa.flash_bwd_dq_kernel(q, k, v, do, lse, dl)
        fa.flash_bwd_dkv_kernel(q, k, v, do, lse, dl)

    bwd_ms = time_ms(whole_backward, flush=flush)
    print(f"flash whole backward timing [{card}]: delta + dq + dk/dv "
          f"{bwd_ms} ms, / SDPA backward {bwd_ms / sdpa_bwd_ms:.3f}")
    del flush, q, k, v, do, o, lse, delta, qh, kh, vh, doh, oh
    torch.cuda.empty_cache()
    return out


def flash_wrappers(fa) -> dict:
    """Kernel name -> wrapper (each carries its ``launches`` count)."""
    return {"flash_fwd": fa.flash_forward_kernel,
            "flash_bwd_dq": fa.flash_bwd_dq_kernel,
            "flash_bwd_dkv": fa.flash_bwd_dkv_kernel}


def check_training(tfm, lm, fa) -> None:
    """Phase 8a: one step's loss and the gradients of blocks.wqkv,
    blocks.wo and head at full width, T 2048, attention through the
    kernels (``attn_impl="auto"``) against the plain ``full_attention``
    (``"xla"``), on the same weights and tokens."""
    import dataclasses

    import torch

    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, **LM_MODEL)
    params = tfm.init_params(cfg, seed=0, device="cuda")
    watched = {"blocks.wqkv": params["blocks"]["wqkv"],
               "blocks.wo": params["blocks"]["wo"], "head": params["head"]}
    for w in watched.values():
        w.requires_grad_(True)
    stream = lm.make_token_stream(cfg.vocab_size,
                                  TRAIN_BATCH * (CHECK_SEQ + 1), seed=0)
    chunk = torch.from_numpy(stream.reshape(TRAIN_BATCH, -1)).to(
        "cuda", torch.long)
    toks, tgts = chunk[:, :-1], chunk[:, 1:]
    wrappers = flash_wrappers(fa)
    runs = {}
    for impl in ("auto", "xla"):
        before = {n: w.launches for n, w in wrappers.items()}
        loss = tfm.lm_loss(params, toks, tgts,
                           dataclasses.replace(cfg, attn_impl=impl))
        grads = torch.autograd.grad(loss, list(watched.values()))
        torch.cuda.synchronize()
        launched = {n: w.launches - before[n] for n, w in wrappers.items()}
        want = cfg.n_layers if impl == "auto" else 0
        if any(x != want for x in launched.values()):
            fail("8/train", f"attn_impl={impl!r}: flash launches {launched},"
                            f" want {want} each")
        if not torch.isfinite(loss) or not all(
                torch.isfinite(g).all() for g in grads):
            fail("8/train", f"attn_impl={impl!r}: non-finite loss or grads")
        runs[impl] = (loss.item(), dict(zip(watched, grads)))
    loss_err = abs(runs["auto"][0] - runs["xla"][0])
    rel = {n: rel_err(runs["auto"][1][n], runs["xla"][1][n])
           for n in watched}
    print(f"train check T {CHECK_SEQ}: step-0 loss kernels "
          f"{runs['auto'][0]} vs plain {runs['xla'][0]} (|diff| {loss_err},"
          f" atol {TRAIN_LOSS_ATOL}); grad rel err "
          + ", ".join(f"{n} {e:.3e}" for n, e in rel.items())
          + f" (rtol {TRAIN_GRAD_RTOL})")
    bad = [f"{n} grad rel err {e} > {TRAIN_GRAD_RTOL}"
           for n, e in rel.items() if not e <= TRAIN_GRAD_RTOL]
    if not loss_err <= TRAIN_LOSS_ATOL:
        bad.append(f"loss |diff| {loss_err} > {TRAIN_LOSS_ATOL}")
    if bad:
        fail("8/train", "; ".join(bad))
    del params, watched, runs, grads, loss
    torch.cuda.empty_cache()


def train_full_width(tfm, lm, fa, lm_model_flops, card) -> dict:
    """Phase 8b/8c: the trainer at full width, B 2, T 8192 — the slice's
    main path. Returns the flash kernels' launch counts of the timed run."""
    import dataclasses

    import torch

    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, **LM_MODEL)
    config = lm.LMTrainConfig(
        model=cfg, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
        steps_per_epoch=TRAIN_STEPS, epochs=1,
        n_tokens=4 * TRAIN_BATCH * (TRAIN_SEQ + 1), eval_batches=0,
        device="cuda")
    # Warm-up: one step of a throwaway trainer (kernel libraries loaded,
    # cuBLAS handles and the allocator's pools made).
    warm = lm.LMTrainer(dataclasses.replace(config, steps_per_epoch=1))
    warm.fit()
    del warm
    torch.cuda.empty_cache()

    trainer = lm.LMTrainer(config, params=tfm.init_params(cfg, seed=0,
                                                          device="cuda"))
    watched = {"head": trainer.params["head"],
               "blocks.wqkv": trainer.params["blocks"]["wqkv"]}
    before = {n: w.detach().clone() for n, w in watched.items()}
    wrappers = flash_wrappers(fa)
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    history = trainer.fit()
    launches = {n: w.launches for n, w in wrappers.items()}
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    losses = [r["loss"] for r in trainer.step_log]
    want = cfg.n_layers * TRAIN_STEPS
    print(f"trainer: {len(losses)} steps, flash launches {launches} (want "
          f"n_layers x steps = {want} each); losses {losses}")
    if len(losses) != TRAIN_STEPS or not all(
            math.isfinite(x) for x in losses):
        fail("8/train", f"losses {losses}")
    unchanged = [n for n, w in watched.items() if torch.equal(w, before[n])]
    if unchanged:
        fail("8/train", f"parameters unchanged by training: {unchanged}")
    if any(x != want for x in launches.values()):
        fail("8/train", f"flash launches {launches} != {want} each")
    # Rates over the whole window (every step's tokens over every step's
    # time, the epoch record's mean), so a stall in any step counts; the
    # median is a per-step statistic beside them.
    step_times = [r["step_time_s"] for r in trainer.step_log]
    mean_s = history[-1]["time_per_batch"]
    flops = lm_model_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    print(f"trainer [{card}]: B {TRAIN_BATCH}, T {TRAIN_SEQ}, {TRAIN_STEPS} "
          f"steps in {sum(step_times)} s: tokens/s "
          f"{history[-1]['tokens_per_s']}, MFU (lm_model_flops {flops} / "
          f"mean step s / {BF16_FLOPS_PER_S:.0f}) "
          f"{flops / mean_s / BF16_FLOPS_PER_S}; mean step {mean_s} s, "
          f"median step {statistics.median(step_times)} s (steps "
          f"{step_times}); torch.cuda.max_memory_allocated {peak} B; "
          f"epoch record {json.dumps(history[-1])}")

    # 8c: one more step under the profiler.
    toks, tgts = trainer.sample_batch(1, 0)
    print_profile("train step", lambda: f"loss {trainer.train_step(toks, tgts)}",
                  card)
    del trainer, watched, before
    torch.cuda.empty_cache()
    return launches


def sgd_leaves(model_params, seed):
    """f32 N(0, 1) tensors on the card with the model parameters' shapes
    and strides (channels-last conv weights stay so)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.empty_like(p, device="cuda").normal_(generator=gen)
            for p in model_params]


def check_sgd_wrapper_cases(fs) -> list:
    """Phase 9, direct wrapper calls: each case of ``SGD_WRAPPER_CASES``
    and each variant, 2 updates through the kernel's public wrapper on
    views at the case's offsets, against the plain version on copies;
    p and m must agree bit for bit, and each call must count one launch.
    Returns the violations."""
    import torch

    bad = []
    gen = torch.Generator(device="cuda").manual_seed(21)
    for label, c in SGD_WRAPPER_CASES.items():
        n, offs = c["n"], c["offsets"]
        errs = []
        for name, v in SGD_VARIANTS.items():
            bufs = [torch.empty(n + 4, device="cuda").normal_(generator=gen)
                    for _ in range(3)]
            p, m, g = (b[o:o + n] for b, o in zip(bufs, offs))
            m = m if v["momentum"] else None
            rp = p.clone()
            rm = None if m is None else m.clone()
            counter = (fs.plain_sgd_kernel if m is None
                       else fs.fused_sgd_kernel)
            before = counter.launches
            for k in range(2):
                lr = 0.1 * (k + 1)
                sgd_launch(fs, p, m, g, lr, v)
                fs.fused_sgd_plain(rp, rm, g, lr, **v)
            torch.cuda.synchronize()
            err = (p - rp).abs().max().item()
            if m is not None:
                err = max(err, (m - rm).abs().max().item())
            same = torch.equal(p, rp) and (m is None or torch.equal(m, rm))
            errs.append(err)
            if not same or counter.launches - before != 2:
                bad.append(f"{label}/{name}: max_abs_err {err}, launches "
                           f"{counter.launches - before} (want 2)")
        print(f"fused_sgd wrapper {label} (n {n}, offsets {offs} f32): "
              f"max_abs_err per variant {errs} (bitwise required)")
    return bad


def check_fused_sgd(fs, optim, tconfig, model_params, card) -> float:
    """Phase 9: ``FusedSGD`` on the card (the kernels, one bucket; and a
    cap that gives several) against the plain version per leaf, 5 updates
    of each variant under a warm-up/cosine schedule, then the direct
    wrapper cases. Every case must agree bit for bit. Prints the grid the
    kernel picks at the CNN and cap buckets. Returns the largest max-abs
    error of p and m (0)."""
    import torch

    cases = [(name, v, optim.FUSED_BUCKET_BYTES)
             for name, v in SGD_VARIANTS.items()]
    cases.append(("momentum_wd_small_buckets", SGD_VARIANTS["momentum_wd"],
                  SGD_SMALL_BUCKET_BYTES))
    max_abs, bad = 0.0, []
    for i, (label, v, cap) in enumerate(cases):
        cfg = tconfig.OptimizerConfig(learning_rate=0.4, warmup_steps=2,
                                      fused=True, **v)
        schedule = optim.make_schedule(cfg, 10, 1)
        leaves = [torch.nn.Parameter(x) for x in sgd_leaves(model_params,
                                                             seed=i)]
        ref_p = [x.detach().clone() for x in leaves]
        ref_m = [torch.zeros_like(x) if v["momentum"] else None
                 for x in leaves]
        opt = optim.FusedSGD(leaves, cfg, schedule, bucket_bytes=cap)
        counter = (fs.fused_sgd_kernel if v["momentum"]
                   else fs.plain_sgd_kernel)
        before = counter.launches
        gen = torch.Generator(device="cuda").manual_seed(1000 + i)
        for k in range(SGD_UPDATES):
            for p, rp, rm in zip(opt.params, ref_p, ref_m):
                g = torch.empty_like(rp).normal_(generator=gen)
                p.grad.copy_(g)
                fs.fused_sgd_plain(rp, rm, g, schedule(k), **v)
            opt.step()
        torch.cuda.synchronize()
        launched = counter.launches - before
        want = SGD_UPDATES * len(opt.buckets)
        errs = []
        for j, (p, rp, rm) in enumerate(zip(opt.params, ref_p, ref_m)):
            errs.append((p - rp).abs().max().item())
            if rm is not None:
                errs.append((opt.momentum_buffer(j) - rm).abs().max().item())
        err = max(errs)
        finite = all(torch.isfinite(p).all() for p in opt.params)
        print(f"fused_sgd {label}: {len(opt.buckets)} bucket(s), "
              f"{launched} launches (want {want}), max_abs_err {err} "
              f"(bitwise required; p and m over {len(leaves)} leaves)")
        if launched != want:
            bad.append(f"{label}: {launched} launches != {want}")
        if not finite or err != 0:
            bad.append(f"{label}: max_abs_err {err} != 0 or non-finite")
        max_abs = max(max_abs, err)
    bad += check_sgd_wrapper_cases(fs)
    if bad:
        fail("9/fused sgd", "; ".join(bad))
    for n, shape in ((SGD_TIMING_SHAPES["cnn"]["n"], "CNN bucket"),
                     (SGD_TIMING_SHAPES["cap"]["n"], "cap bucket")):
        for momentum in (True, False):
            grid = fs.kernel_grid(n, momentum)
            print(f"fused_sgd grid [{card}]: {shape} (n {n}), "
                  f"{'fused_sgd' if momentum else 'plain_sgd'}: "
                  f"{grid['blocks']} CTAs x {grid['threads']} threads, "
                  f"{grid['unroll']} float4 per operand in flight a thread")
    return max_abs


def sgd_launch(fs, p, m, g, lr, v):
    """One update through the public wrapper of the variant's kernel."""
    if v["momentum"]:
        fs.fused_sgd_kernel(p, m, g, lr, **v)
    else:
        fs.plain_sgd_kernel(p, g, lr, v["weight_decay"])


def time_sgd_graph_trains(fs, card) -> dict:
    """Phase 10, device time per launch: for each shape of
    ``SGD_TIMING_SHAPES`` and each variant, the kernel and
    ``torch.optim.SGD(fused=True)`` over the same flat bucket as one leaf
    (the library yardstick, never used by the port), each as a graph
    train over R cold bucket sets. A library call that capture refuses is
    timed as a train of eager calls and says that its time holds the
    host. Returns {variant: {shape: row}}."""
    import torch

    out = {name: {} for name in SGD_VARIANTS}
    for shape, s in SGD_TIMING_SHAPES.items():
        n, r, k = s["n"], s["sets"], s["launches"]
        gen = torch.Generator(device="cuda").manual_seed(11)
        sets = [[torch.empty(n, device="cuda").normal_(generator=gen)
                 for _ in range(3)] for _ in range(r)]
        for name, v in SGD_VARIANTS.items():
            lr = 1e-3
            t = sgd_traffic(n, **v)
            ms = graph_train_ms(lambda i: sgd_launch(
                fs, *sets[i % r], lr, v), k)
            params = [torch.nn.Parameter(st[0]) for st in sets]
            for prm, st in zip(params, sets):
                prm.grad = st[2]
            libs = [torch.optim.SGD([prm], lr=lr, fused=True, **v)
                    for prm in params]
            for lib in libs:                       # allocates the traces
                lib.step()
            try:
                lib_ms = graph_train_ms(lambda i: libs[i % r].step(), k)
                lib_kind = "graph"
            except RuntimeError as e:
                print(f"  torch.optim.SGD(fused=True) capture refused "
                      f"({str(e)[:120]}); timed as eager calls, host "
                      f"included")
                torch.cuda.synchronize()
                lib_ms = time_ms(lambda: [lb.step() for lb in libs],
                                 reps=SGD_GRAPH_REPLAYS) / r
                lib_kind = "eager, host included"
            print(f"fused_sgd device time {shape} {name} [{card}]: kernel "
                  f"{ms} ms/launch, {t['bound_ms'] / ms:.1%} of bound "
                  f"{t['bound_ms']} ms ({t['bound_by']}: {t['bytes']} B, "
                  f"n {n}); library {lib_ms} ms/launch (torch.optim.SGD "
                  f"fused=True, one flat leaf, {lib_kind}), kernel / "
                  f"library {ms / lib_ms:.3f}; {r} sets x {k} launches, "
                  f"median of {SGD_GRAPH_REPLAYS} replays")
            out[name][shape] = dict(ms=ms, bound_ms=t["bound_ms"],
                                    library_ms=lib_ms, library_kind=lib_kind)
            del params, libs
        del sets
        torch.cuda.empty_cache()
    return out


def time_sgd_host(fs, optim, tconfig, model_params, card) -> dict:
    """Phase 10, host enqueue: ``FusedSGD.step`` over MobileNetV2's 173
    leaves (the slot check, the launch, the ctypes call) and the public
    wrapper alone, ``SGD_HOST_STEPS`` calls each on the host clock with no
    sync inside; µs per launch (one bucket)."""
    import torch

    out = {}
    for name in ("momentum_wd", "no_momentum"):
        v = SGD_VARIANTS[name]
        cfg = tconfig.OptimizerConfig(learning_rate=0.1, fused=True, **v)
        leaves = [torch.nn.Parameter(x) for x in sgd_leaves(model_params,
                                                             seed=9)]
        opt = optim.FusedSGD(leaves, cfg, lambda _: 1e-3)
        p, m, g = opt.flat_buckets()[0]
        times = {}
        for what, fn in (("FusedSGD.step", opt.step),
                         ("wrapper", lambda: sgd_launch(fs, p, m, g, 1e-3,
                                                        v))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(SGD_HOST_STEPS):
                fn()
            times[what] = (time.perf_counter() - t0) / SGD_HOST_STEPS * 1e6
            torch.cuda.synchronize()
        print(f"fused_sgd host enqueue {name} [{card}]: FusedSGD.step "
              f"{times['FusedSGD.step']} us per launch ({len(leaves)} leaves, "
              f"1 bucket), public wrapper {times['wrapper']} us per launch; "
              f"{SGD_HOST_STEPS} calls, host clock, no sync")
        out[name] = dict(host_us_per_step=times["FusedSGD.step"],
                         host_us_per_wrapper_launch=times["wrapper"])
        del opt, leaves, p, m, g
    return out


def time_fused_sgd(fs, optim, tconfig, model_params, card) -> dict:
    """Phase 10: each variant's one-bucket update at the slice's shapes —
    the kernel, the plain version on the same bucket, the library call
    (``torch.optim.SGD(fused=True)`` over the 173 leaves, never used by
    the port) and the byte bound, CUDA events around one call after an L2
    flush, median of 30 (the table's continuity column, host enqueue
    included where it outlasts the flush); then the device time per
    launch from graph trains at the CNN and cap buckets, and the host
    enqueue. Returns the rows of the slice's two kernels."""
    import torch

    n = sum(p.numel() for p in model_params)
    if (n != SGD_TIMING_SHAPES["cnn"]["n"] or SGD_TIMING_SHAPES["cap"]["n"]
            != optim.FUSED_BUCKET_BYTES // 4):
        fail("10/fused sgd timing", f"SGD_TIMING_SHAPES do not match the "
             f"CNN bucket ({n}) or FUSED_BUCKET_BYTES")
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for name, v in SGD_VARIANTS.items():
        cfg = tconfig.OptimizerConfig(learning_rate=0.1, fused=True, **v)
        leaves = [torch.nn.Parameter(x) for x in sgd_leaves(model_params,
                                                             seed=7)]
        opt = optim.FusedSGD(leaves, cfg, lambda _: 0.1)
        if len(opt.buckets) != 1:
            fail("10/fused sgd timing", f"{len(opt.buckets)} buckets, want 1")
        p, m, g = opt.flat_buckets()[0]
        g.normal_()
        ms = time_ms(lambda: sgd_launch(fs, p, m, g, 0.1, v), flush=flush)
        plain_ms = time_ms(lambda: fs.fused_sgd_plain(p, m, g, 0.1, **v),
                           flush=flush)
        lib_leaves = [torch.nn.Parameter(x) for x in sgd_leaves(
            model_params, seed=8)]
        for x in lib_leaves:
            x.grad = torch.randn_like(x)
        try:
            lib = torch.optim.SGD(lib_leaves, lr=0.1, fused=True, **v)
            lib_kind = "fused=True"
        except (TypeError, RuntimeError):
            lib = torch.optim.SGD(lib_leaves, lr=0.1, foreach=True, **v)
            lib_kind = "foreach=True (fused unavailable)"
        library_ms = time_ms(lib.step, flush=flush)
        t = sgd_traffic(n, **v)
        print(f"fused_sgd timing {name} [{card}]: kernel {ms} ms, plain "
              f"{plain_ms} ms, library {library_ms} ms (torch.optim.SGD "
              f"{lib_kind}, 173 leaves), bound {t['bound_ms']} ms "
              f"({t['bound_by']}: {t['bytes']} B, {t['flops']} flop), "
              f"{t['bound_ms'] / ms:.1%} of bound (one launch after an L2 "
              f"flush, host enqueue included where it outlasts the flush)")
        row = dict(ms=ms, plain_ms=plain_ms, bound_ms=t["bound_ms"],
                   bound_by=t["bound_by"], library_ms=library_ms)
        if name == "momentum_wd":
            out["fused_sgd"] = row
        elif name == "no_momentum":
            out["plain_sgd"] = row
        del opt, leaves, lib_leaves, lib, p, m, g
    del flush
    torch.cuda.empty_cache()
    graphs = time_sgd_graph_trains(fs, card)
    host = time_sgd_host(fs, optim, tconfig, model_params, card)
    for kernel, name in (("fused_sgd", "momentum_wd"),
                         ("plain_sgd", "no_momentum")):
        for shape, row in graphs[name].items():
            out[kernel].update({
                f"device_ms_{shape}": row["ms"],
                f"bound_ms_{shape}": row["bound_ms"],
                f"library_flat_ms_{shape}": row["library_ms"],
                f"library_flat_kind_{shape}": row["library_kind"]})
        out[kernel].update(host[name])
    return out


def cnn_config(tconfig, model: str = "mobilenetv2", **optimizer):
    """The CNN slice's TrainConfig (bench.py's CNN workload, one card;
    ``model``: DMP_BENCH_MODEL)."""
    return tconfig.TrainConfig(
        model=tconfig.ModelConfig(name=model, dtype="bfloat16"),
        data=tconfig.DataConfig(
            name="synthetic", batch_size=CNN_BATCH,
            eval_batch_size=CNN_BATCH, image_size=32,
            synthetic_native_size=32, synthetic_train_size=4 * CNN_BATCH,
            synthetic_eval_size=CNN_BATCH),
        optimizer=tconfig.OptimizerConfig(
            **{**dict(learning_rate=0.4, warmup_steps=10, fused=True),
               **optimizer}),
        device_resident_data=True, steps_per_dispatch=CNN_SPD,
        device="cuda", **run_dirs(model))


def cnn_dispatch_indices(n: int, dispatches: int, batch: int = CNN_BATCH):
    """bench.py's per-dispatch batches (bench.py:1374-1380): one
    ``default_rng(0)`` stream of ``integers(0, n, (10, batch))`` draws, on
    the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.integers(0, n, (CNN_SPD, batch))
                             .astype(np.int64)).cuda()
            for _ in range(dispatches)]


def cnn_kind(key: str) -> str:
    """Device-time kinds of the CNN step (kernel-name heuristics)."""
    low = key.lower()
    if "fused_sgd" in low:
        return "port kernels (fused_sgd)"
    if "batch_norm" in low or "bn_" in low:
        return "BatchNorm"
    if any(s in low for s in ("conv", "xmma", "implicit", "dgrad", "wgrad",
                              "fprop", "cutlass", "nvjet", "gemm", "sm90")):
        return "cuDNN/cuBLAS conv and GEMM"
    return "other (elementwise, copies, reductions)"


def check_cnn_step(trainer_mod, models, staged, tconfig,
                   model: str = "mobilenetv2", phase: str = "11/cnn") -> None:
    """Phase 11a (14a for ResNet-50): two steps of the CNN slice from the
    same weights and batches through the fused kernel and through
    ``torch.optim.SGD`` (``fused=False``): losses, every leaf's step-1
    update and the BN statistics."""
    import numpy as np
    import torch

    params, state = staged.params_to_jax(models.get_model(
        tconfig.ModelConfig(name=model, dtype="bfloat16"), seed=0,
        device="cpu"))
    idx = cnn_dispatch_indices(4 * CNN_BATCH, 1)[0][:2]
    runs = {}
    for fused in (True, False):
        t = trainer_mod.Trainer(cnn_config(tconfig, model, fused=fused),
                                params=params, state=state)
        t.run_steps(idx[:1])
        p1 = [p.detach().clone() for p in t.model.parameters()]
        m = t.run_steps(idx[1:])
        loss = m["loss"].cpu().numpy()
        p2 = [p.detach().clone() for p in t.model.parameters()]
        stats = [b.detach().clone() for b in t.model.buffers()]
        runs[fused] = (loss, [b - a for a, b in zip(p1, p2)], stats)
        del t
    loss_a, upd_a, st_a = runs[True]
    loss_b, upd_b, st_b = runs[False]
    loss_err = float(np.abs(loss_a - loss_b).max())
    upd = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
              for a, b in zip(upd_a, upd_b))
    st = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
             for a, b in zip(st_a, st_b))
    label = "cnn" if model == "mobilenetv2" else model
    print(f"{label} check: step-1 loss fused {loss_a} vs torch.optim.SGD "
          f"{loss_b} (|diff| {loss_err}, atol {CNN_LOSS_ATOL}); step-1 "
          f"update per leaf max|a-b|/max|b| {upd:.3e} (rtol "
          f"{CNN_UPDATE_RTOL}); BN statistics {st:.3e} (rtol "
          f"{CNN_STATS_RTOL})")
    if not (loss_err <= CNN_LOSS_ATOL and upd <= CNN_UPDATE_RTOL
            and st <= CNN_STATS_RTOL and np.isfinite(loss_a).all()):
        fail(phase, "fused vs plain update outside tolerance")
    torch.cuda.empty_cache()


def cnn_run(trainer, idxs, steps_kind: str, card) -> dict:
    """Dispatch ``idxs`` (one list entry per dispatch) back to back, one
    sync at the end; returns host losses, seconds and rates."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ms = [trainer.run_steps(ix) for ix in idxs]
    losses = torch.cat([m["loss"] for m in ms]).cpu().tolist()
    dt = time.perf_counter() - t0
    steps = sum(ix.shape[0] for ix in idxs)
    rec = dict(steps=steps, seconds=dt, step_s=dt / steps,
               samples_per_s=CNN_BATCH * steps / dt, losses=losses)
    print(f"cnn {steps_kind} [{card}]: {steps} steps in {dt} s, step "
          f"{dt / steps} s, {CNN_BATCH * steps / dt} samples/s")
    return rec


def sgd_in_step_us(rows, kernel: str, card) -> float | None:
    """The fused SGD kernel's device µs per launch in a profiled CNN step
    (``print_profile``'s rows); None, printed as not measured, when the
    profile has no such kernel."""
    hits = [(us, n) for key, us, n in rows if "fused_sgd" in key]
    if not hits:
        print(f"cnn step {kernel} device time [{card}]: not measured")
        return None
    us, n = sum(h[0] for h in hits), sum(h[1] for h in hits)
    print(f"cnn step {kernel} device time [{card}]: {us} us in {n} "
          f"launch(es), {us / n} us per launch (torch.profiler)")
    return us / n


def train_cnn(trainer_mod, fs, tconfig, card) -> tuple:
    """Phase 11b/11c: the CNN slice's main path — bench.py's timing shape
    through ``Trainer.run_steps`` with the fused kernel — then 20 steps
    with momentum 0 (plain_sgd), 20 with ``fused=False`` (a data point),
    and a profiled step with and without momentum. Returns the main
    path's launch counts and each kernel's device µs per launch in its
    profiled step."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    n_disp = CNN_TIMED_STEPS // CNN_SPD
    idxs = cnn_dispatch_indices(4 * CNN_BATCH, CNN_WARM_DISPATCHES + n_disp)
    trainer = trainer_mod.Trainer(cnn_config(tconfig))
    for ix in idxs[:CNN_WARM_DISPATCHES]:
        trainer.run_steps(ix)
    torch.cuda.synchronize()
    params0 = [p.detach().clone() for p in trainer.model.parameters()]
    stats0 = [b.detach().clone() for b in trainer.model.buffers()]
    torch.cuda.reset_peak_memory_stats()
    fs.fused_sgd_kernel.launches = 0
    fs.plain_sgd_kernel.launches = 0
    rec = cnn_run(trainer, idxs[CNN_WARM_DISPATCHES:], "trainer (fused)",
                  card)
    launches = {"fused_sgd": fs.fused_sgd_kernel.launches,
                "plain_sgd": fs.plain_sgd_kernel.launches}
    peak = torch.cuda.max_memory_allocated()
    buckets = len(trainer.optimizer.buckets)
    changed_p = sum(not torch.equal(a, b) for a, b in
                    zip(params0, trainer.model.parameters()))
    changed_s = sum(not torch.equal(a, b) for a, b in
                    zip(stats0, trainer.model.buffers()))
    want = CNN_TIMED_STEPS * buckets
    print(f"cnn trainer: losses {rec['losses']}; fused_sgd launches "
          f"{launches['fused_sgd']} (want steps x buckets = {want}), "
          f"plain_sgd {launches['plain_sgd']} (want 0); parameters "
          f"changed {changed_p}/{len(params0)}, BN buffers changed "
          f"{changed_s}/{len(stats0)}")
    if not all(math.isfinite(x) for x in rec["losses"]):
        fail("11/cnn", f"non-finite losses {rec['losses']}")
    if launches != {"fused_sgd": want, "plain_sgd": 0}:
        fail("11/cnn", f"launches {launches}, want fused_sgd {want}")
    if changed_p != len(params0) or changed_s != len(stats0):
        fail("11/cnn", "parameters or BN statistics unchanged by training")

    # FLOPs of one step: 3 x the forward's convolution and matmul FLOPs as
    # FlopCounterMode counts them (the backward computes the input and the
    # weight gradient of each; BN, elementwise work and the update are not
    # counted). Its count of a whole train step is printed beside it but
    # not used: its convolution_backward formula ignores `groups`, so it
    # counts each depthwise conv's backward as a dense conv's.
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        trainer.model.apply(torch.zeros(CNN_BATCH, 32, 32, 3,
                                        dtype=torch.bfloat16, device="cuda"),
                            train=False)
    flops = 3 * counter.get_total_flops()
    with FlopCounterMode(display=False) as counter:
        trainer.run_steps(idxs[-1][:1])
    print(f"cnn trainer: FlopCounterMode forward x 3 = {flops} flop per "
          f"step (its whole-step count, depthwise backward as dense: "
          f"{counter.get_total_flops()})")
    print(f"cnn trainer [{card}]: B {CNN_BATCH}, {CNN_TIMED_STEPS} steps "
          f"(after {CNN_WARM_DISPATCHES} warm-up dispatches of {CNN_SPD}), "
          f"one sync: samples/s/chip {rec['samples_per_s']}, step "
          f"{rec['step_s']} s, MFU ({flops} flop per step "
          f"/ step s / {BF16_FLOPS_PER_S:.0f}) "
          f"{flops / rec['step_s'] / BF16_FLOPS_PER_S}, "
          f"torch.cuda.max_memory_allocated {peak} B; "
          f"cudnn.benchmark {torch.backends.cudnn.benchmark}, cudnn "
          f"allow_tf32 {torch.backends.cudnn.allow_tf32}")

    # 11c: one step under the profiler.
    rows = print_profile("cnn step", lambda: f"loss "
                         f"{trainer.run_steps(idxs[-1][:1])['loss'].item()}",
                         card, kind=cnn_kind)
    in_step = {"fused_sgd": sgd_in_step_us(rows, "fused_sgd", card)}
    del trainer, params0, stats0

    # Momentum 0: the plain_sgd kernel, once per step.
    side = trainer_mod.Trainer(cnn_config(tconfig, momentum=0.0))
    side.run_steps(idxs[0][:2])                    # warm-up
    fs.plain_sgd_kernel.launches = 0
    r0 = cnn_run(side, [idxs[1], idxs[2]], "trainer (fused, momentum 0)",
                 card)
    launches["plain_sgd"] = fs.plain_sgd_kernel.launches
    if launches["plain_sgd"] != CNN_SIDE_STEPS or not all(
            math.isfinite(x) for x in r0["losses"]):
        fail("11/cnn", f"momentum 0: plain_sgd launches "
                       f"{launches['plain_sgd']} != {CNN_SIDE_STEPS}, or "
                       f"non-finite losses {r0['losses']}")
    rows = print_profile("cnn step (momentum 0)", lambda: f"loss "
                         f"{side.run_steps(idxs[0][:1])['loss'].item()}",
                         card, kind=cnn_kind)
    in_step["plain_sgd"] = sgd_in_step_us(rows, "plain_sgd", card)
    del side
    # fused=False: the port's per-leaf torch.optim.SGD, as a data point.
    side = trainer_mod.Trainer(cnn_config(tconfig, fused=False))
    side.run_steps(idxs[0][:2])
    cnn_run(side, [idxs[1], idxs[2]], "trainer (fused=False, "
            "torch.optim.SGD per leaf)", card)
    del side
    # Trainer.fit, one epoch (4 steps + eval) on each input path: the
    # device-resident dataset and per-batch pinned uploads.
    for resident in (True, False):
        t = trainer_mod.Trainer(cnn_config(tconfig).replace(
            epochs=1, device_resident_data=resident))
        before = fs.fused_sgd_kernel.launches
        hist = t.fit()
        n = fs.fused_sgd_kernel.launches - before
        print(f"cnn fit (device_resident_data={resident}): {hist}, "
              f"fused_sgd launches {n}")
        if n != 4 or not all(math.isfinite(hist[0][k]) for k in
                             ("loss_train", "loss_val")):
            fail("11/cnn", f"fit: launches {n} != 4 or non-finite {hist}")
        del t
    torch.cuda.empty_cache()
    return launches, in_step


def dp_config(tconfig, world: int, **kw):
    """The CNN slice's TrainConfig over ``world`` ranks (global batch
    CNN_BATCH); ``augment=False`` also gives the 12b data (5 batches)."""
    import dataclasses

    augment = kw.pop("augment", True)
    cfg = cnn_config(tconfig).replace(mesh=tconfig.MeshConfig(data=world),
                                      **kw)
    if not augment:
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, augment=False,
            synthetic_train_size=DP_TWO_RANK_STEPS * CNN_BATCH))
    return cfg


def dp_gate_step(trainer_mod, tconfig, spec=None) -> tuple:
    """Two gspmd steps of the CNN slice (lr 0, then 0.04 under warm-up)
    from the seed-0 weights on the first bench batches, cuDNN
    deterministic (no autotuner): the losses and every parameter,
    momentum trace and BN buffer after them, as numpy."""
    import torch

    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    t = trainer_mod.Trainer(dp_config(tconfig, 1), spec=spec)
    loss = t.run_steps(cnn_dispatch_indices(4 * CNN_BATCH, 1)[0][:2])["loss"]
    params = list(t.model.parameters())
    moms = [t.optimizer.momentum_buffer(i) for i in range(len(params))]
    out = (loss.cpu().numpy(), [x.detach().cpu().numpy() for x in
                                (*params, *moms, *t.model.buffers())])
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = bench
    return out


def dp_streaming_losses(trainer, steps: int, check=None) -> list:
    """``steps`` steps of the streaming path over epoch 0's batches (this
    rank's rows of each), ``check(trainer)`` after each; the global
    losses."""
    losses = []
    trainer.train_loader.set_epoch(0)
    for _, (images, labels) in zip(range(steps), trainer.train_loader):
        m = trainer._train_step(trainer._to_device(images),
                                trainer._to_device(labels),
                                trainer._generator())
        trainer.global_step += 1
        if check is not None:
            check(trainer)
        losses.append(float(m["loss"]))
    return losses


def dp_world_rank(spec) -> dict:
    """Phase 12a on one rank of the NCCL group: the gate step, bench.py's
    CNN workload through gspmd (counts set to 0 just before the timed
    steps and read just after), DP_DDP_STEPS ddp steps (bucketed,
    streaming), and the one-rank reference losses of 12b (world 1 only).
    Numbers come back as plain Python and numpy."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from distributed_model_parallel_tpu_torch import config as tconfig
    from distributed_model_parallel_tpu_torch.ops import collectives
    from distributed_model_parallel_tpu_torch.ops import fused_sgd as fs
    from distributed_model_parallel_tpu_torch.train import (
        trainer as trainer_mod,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = spec.num_data
    out = {"backend": spec.backend,
           "gate": dp_gate_step(trainer_mod, tconfig, spec)
           if world == 1 else None}

    torch.backends.cudnn.benchmark = True
    n_disp = CNN_TIMED_STEPS // CNN_SPD
    idxs = cnn_dispatch_indices(4 * CNN_BATCH, CNN_WARM_DISPATCHES + n_disp)
    t = trainer_mod.Trainer(dp_config(tconfig, world), spec=spec)
    for ix in idxs[:CNN_WARM_DISPATCHES]:
        t.run_steps(ix)
    torch.cuda.synchronize()
    t.reducer.take_times_us()
    torch.cuda.reset_peak_memory_stats()
    fs.fused_sgd_kernel.launches = 0
    fs.plain_sgd_kernel.launches = 0
    collectives.reset_counts()
    t0 = time.perf_counter()
    ms = [t.run_steps(ix) for ix in idxs[CNN_WARM_DISPATCHES:]]
    losses = torch.cat([m["loss"] for m in ms]).cpu().tolist()
    dt = time.perf_counter() - t0
    bench = dict(steps=CNN_TIMED_STEPS, seconds=dt, step_s=dt / CNN_TIMED_STEPS,
                 samples_per_s=CNN_BATCH * CNN_TIMED_STEPS / dt,
                 losses=losses, peak_bytes=torch.cuda.max_memory_allocated(),
                 fused_sgd=fs.fused_sgd_kernel.launches,
                 plain_sgd=fs.plain_sgd_kernel.launches,
                 reducer_calls=collectives.calls["reducer"],
                 calls=dict(collectives.calls),
                 buckets=len(t.reducer.buckets),
                 allreduce_us=t.reducer.take_times_us())
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        t.model.apply(torch.zeros(CNN_BATCH // world, 32, 32, 3,
                                  dtype=torch.bfloat16, device=spec.device),
                      train=False)
    bench["flops_per_rank_step"] = 3 * counter.get_total_flops()
    out["bench"] = bench
    del t, ms

    d = trainer_mod.Trainer(dp_config(tconfig, world, strategy="ddp",
                                      ddp_allreduce="bucketed",
                                      device_resident_data=False), spec=spec)
    d.train_epoch(0)                                   # warm-up, 4 steps
    torch.cuda.synchronize()
    d.reducer.take_times_us()
    fs.fused_sgd_kernel.launches = 0
    collectives.reset_counts()
    t0 = time.perf_counter()
    per_epoch = len(d.train_loader)
    rec = [d.train_epoch(e) for e in range(1, 1 + DP_DDP_STEPS // per_epoch)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out["ddp"] = dict(steps=DP_DDP_STEPS, seconds=dt,
                      samples_per_s=CNN_BATCH * DP_DDP_STEPS / dt,
                      losses=[r.loss for r in rec],
                      fused_sgd=fs.fused_sgd_kernel.launches,
                      reducer_calls=collectives.calls["reducer"],
                      buckets=len(d.reducer.buckets),
                      allreduce_us=d.reducer.take_times_us())
    del d
    if world == 1:
        torch.backends.cudnn.benchmark = False
        ref = trainer_mod.Trainer(dp_config(tconfig, 1, augment=False,
                                            device_resident_data=False),
                                  spec=spec)
        out["ref_losses"] = dp_streaming_losses(ref, DP_TWO_RANK_STEPS)
    return out


def dp_two_rank(spec) -> dict:
    """Phase 12b on one of two ranks: ddp with per-replica BN, then with
    synchronized BN, DP_TWO_RANK_STEPS steps of the global batch each
    (augment off), parameters and momentum checked bitwise equal across
    the ranks after every step; each run's losses and both ranks' BN
    statistics."""
    import dataclasses

    import torch

    from distributed_model_parallel_tpu_torch import config as tconfig
    from distributed_model_parallel_tpu_torch.parallel import ddp
    from distributed_model_parallel_tpu_torch.train import (
        trainer as trainer_mod,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    checks = []
    for bn in ("local", "sync"):
        cfg = dp_config(tconfig, spec.num_data, augment=False,
                        strategy="ddp", ddp_allreduce="bucketed",
                        device_resident_data=False)
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    batchnorm=bn))
        t = trainer_mod.Trainer(cfg, spec=spec)

        def check(tr):
            ddp.assert_ddp_replicated(tr.model, tr.optimizer, spec)
            checks.append(bn)

        t0 = time.perf_counter()
        losses = dp_streaming_losses(t, DP_TWO_RANK_STEPS, check)
        dt = time.perf_counter() - t0
        stats = ddp.gather_replica_state(t.model, spec)
        leaves = [leaf for unit in stats for mod in unit.values()
                  for leaf in mod.values()]
        out[bn] = dict(
            losses=losses, seconds=dt, replicated_checks=checks.count(bn),
            stats_bitwise_equal=all(
                (leaf[0] == leaf[r]).all() for leaf in leaves
                for r in range(1, leaf.shape[0])),
            stats_max_rel_diff=max(
                float(abs(leaf[0] - leaf[1]).max()
                      / max(abs(leaf[1]).max(), 1e-30)) for leaf in leaves),
            allreduce_us=t.reducer.take_times_us())
        del t
    return out


def dp_spawn(mesh, fn, nproc: int, phase: str, *args, **kw):
    """``mesh.spawn`` of a phase's rank function; a failed or hung rank
    fails the phase."""
    try:
        return mesh.spawn(fn, nproc, *args, device="cuda", timeout_s=600,
                          **kw)
    except (RuntimeError, TimeoutError, ValueError) as e:
        fail(phase, f"{type(e).__name__}: {e}")


def data_parallel(mesh, trainer_mod, tconfig, card) -> dict:
    """Phase 12: the CNN slice through the port's process group. 12a:
    world = device_count() over NCCL — the world-1 gate against the
    one-device trainer of phase 11, bench.py's workload through gspmd,
    20 ddp steps; 12b: two ranks (sharing the one card over gloo, or two
    cards over NCCL), ddp with per-replica and synchronized BN."""
    import numpy as np
    import torch

    world = torch.cuda.device_count()
    ref = dp_gate_step(trainer_mod, tconfig)
    torch.cuda.empty_cache()
    a = dp_spawn(mesh, dp_world_rank, world, "12a/data parallel")[0]
    transport = a["backend"]
    out = {"world": world, "backend": transport, "transport": transport}
    if world == 1:
        (loss, leaves), (ref_loss, ref_leaves) = a["gate"], ref
        same = [np.array_equal(x, y) for x, y in zip(leaves, ref_leaves)]
        gap = max(float(np.abs(x - y).max()) for x, y in
                  zip(leaves, ref_leaves))
        print(f"dp gate [{card}]: two gspmd steps at world 1 over "
              f"{transport} vs "
              f"phase 11's "
              f"one-device trainer, cuDNN deterministic, same weights and "
              f"batches: losses {loss} vs {ref_loss}; parameters, momentum "
              f"and BN buffers bitwise equal {sum(same)}/{len(same)} (max "
              f"|diff| {gap})")
        if not (np.array_equal(loss, ref_loss) and all(same)):
            fail("12a/data parallel", "the world-1 steps are not bitwise "
                 "the one-device steps")
        out["gate_bitwise"] = True
    b = a["bench"]
    us = sorted(b["allreduce_us"])
    med_us = statistics.median(us)
    mfu = b["flops_per_rank_step"] / b["step_s"] / BF16_FLOPS_PER_S
    per_step = b["reducer_calls"] / b["steps"]
    print(f"dp gspmd [{card}]: world {world}, backend {transport}, "
          f"transport {transport}; B {CNN_BATCH} ({CNN_BATCH // world} a "
          f"rank), "
          f"{b['steps']} steps (after {CNN_WARM_DISPATCHES} warm-up "
          f"dispatches of {CNN_SPD}), one sync: samples/s {b['samples_per_s']}"
          f" ({b['samples_per_s'] / world} a card), step {b['step_s']} s, "
          f"MFU ({b['flops_per_rank_step']} flop a rank a step) {mfu}, "
          f"torch.cuda.max_memory_allocated {b['peak_bytes']} B (rank 0); "
          f"grad-allreduce {med_us} us a step (median; min {us[0]}, max "
          f"{us[-1]}; CUDA events, first bucket launch to the end of "
          f"finish), all-reduce launches a step {per_step} (buckets "
          f"{b['buckets']}); fused_sgd launches {b['fused_sgd']}, plain_sgd "
          f"{b['plain_sgd']}; collectives {b['calls']}")
    print(f"dp gspmd losses [{card}]: {b['losses']}")
    if not all(math.isfinite(x) for x in b["losses"]):
        fail("12a/data parallel", "non-finite losses")
    if (b["fused_sgd"] != b["steps"] * b["buckets"] or b["plain_sgd"]
            or per_step != b["buckets"]):
        fail("12a/data parallel", f"launches: fused_sgd {b['fused_sgd']}, "
             f"plain_sgd {b['plain_sgd']}, all-reduces a step {per_step}; "
             f"want {b['steps']} x {b['buckets']}, 0, {b['buckets']}")
    d = a["ddp"]
    dus = statistics.median(d["allreduce_us"])
    print(f"dp ddp [{card}]: world {world}, allreduce bucketed, streaming "
          f"input: {d['steps']} steps in {d['seconds']} s, samples/s "
          f"{d['samples_per_s']}, grad-allreduce {dus} us a step (median), "
          f"all-reduces {d['reducer_calls']} (buckets {d['buckets']}), "
          f"fused_sgd launches {d['fused_sgd']}; epoch losses {d['losses']}")
    if (d["reducer_calls"] != d["steps"] * d["buckets"]
            or d["fused_sgd"] != d["steps"] * d["buckets"]
            or not all(math.isfinite(x) for x in d["losses"])):
        fail("12a/data parallel", "ddp: wrong launch counts or non-finite "
             "losses")
    out.update(gspmd=dict(samples_per_s=b["samples_per_s"],
                          step_s=b["step_s"], mfu=mfu,
                          peak_bytes=b["peak_bytes"],
                          grad_allreduce_us_median=med_us,
                          allreduce_launches_per_step=per_step,
                          buckets=b["buckets"],
                          fused_sgd_launches=b["fused_sgd"],
                          plain_sgd_launches=b["plain_sgd"]),
               ddp=dict(samples_per_s=d["samples_per_s"],
                        grad_allreduce_us_median=dus))

    two_cards = world >= 2
    backend = "nccl" if two_cards else "gloo"
    torch.cuda.empty_cache()
    r = dp_spawn(mesh, dp_two_rank, 2, "12b/two ranks",
                 backend=backend)[0]
    where = "two cards" if two_cards else "both ranks on the one card"
    for bn in ("local", "sync"):
        x = r[bn]
        print(f"dp two ranks [{card}] bn {bn}: backend {backend}, transport "
              f"{backend} ({where}), ddp bucketed, B {CNN_BATCH} "
              f"({CNN_BATCH // 2} a rank), augment off: losses "
              f"{x['losses']} in {x['seconds']} s;"
              f" params and momentum bitwise equal across ranks after "
              f"{x['replicated_checks']}/{DP_TWO_RANK_STEPS} steps; BN "
              f"statistics bitwise equal across ranks "
              f"{x['stats_bitwise_equal']} (max rel diff "
              f"{x['stats_max_rel_diff']}); grad-allreduce "
              f"{statistics.median(x['allreduce_us'])} us a step (median)")
        if x["replicated_checks"] != DP_TWO_RANK_STEPS:
            fail("12b/two ranks", f"{bn}: replication checked "
                 f"{x['replicated_checks']} times")
    if r["local"]["stats_bitwise_equal"] or not r["sync"][
            "stats_bitwise_equal"]:
        fail("12b/two ranks", "BN statistics must differ across ranks "
             "under local and agree bit for bit under sync")
    if world == 1:
        err = abs(r["sync"]["losses"][0] - a["ref_losses"][0])
        print(f"dp two ranks [{card}]: step-0 loss, ddp + sync BN at 2 "
              f"ranks "
              f"{r['sync']['losses'][0]} vs gspmd at 1 rank "
              f"{a['ref_losses'][0]} (|diff| {err}, atol {DP_LOSS_ATOL}); "
              f"1-rank losses {a['ref_losses']}")
        if not err <= DP_LOSS_ATOL:
            fail("12b/two ranks", f"sync loss off the 1-rank loss by {err}")
        out["two_rank_step0_loss_diff"] = err
    out["two_ranks"] = {"backend": backend, "transport": backend,
                        **{bn: dict(losses=r[bn]["losses"],
                                    stats_bitwise_equal=r[bn][
                                        "stats_bitwise_equal"])
                           for bn in ("local", "sync")}}
    return out


def pp_runner(models, pipeline, tconfig, devices, cfg, *, m: int,
              schedule: str = "gpipe", virtual: int = 1, boundaries=None,
              augment: bool = True, steps_per_epoch: int = 4):
    """A PipelineRunner over ``devices`` from the seed-0 MobileNetV2 (the
    weights phase 11's trainer starts from), with ``cfg``'s optimizer and
    its schedule over ``steps_per_epoch`` x ``cfg.epochs`` steps."""
    from distributed_model_parallel_tpu_torch.data.registry import (
        CIFAR10_MEAN,
        CIFAR10_STD,
    )

    model = models.get_model(cfg.model, seed=cfg.seed, device="cpu")
    return pipeline.PipelineRunner(
        model, devices, optimizer=cfg.optimizer,
        steps_per_epoch=steps_per_epoch, epochs=cfg.epochs,
        mean=CIFAR10_MEAN, std=CIFAR10_STD,
        boundaries=PP_CUT if boundaries is None else boundaries,
        num_microbatches=m, augment=augment, schedule=schedule,
        virtual_stages=virtual, dtype=models.DTYPES[cfg.model.dtype])


def pp_state(runner) -> tuple:
    """Every parameter, momentum trace and BN buffer of a runner, in unit
    order, as numpy."""
    moms = [st.optimizer.momentum_buffer(i) for st in runner.stages
            for i in range(len(st.optimizer.params))]
    return [x.detach().cpu().numpy().copy() for x in (
        *runner.model.parameters(), *moms, *runner.model.buffers())]


def pp_bitwise(a: list, b: list) -> tuple[int, float]:
    import numpy as np

    same = sum(np.array_equal(x, y) for x, y in zip(a, b))
    gap = max(float(np.abs(x - y).max()) for x, y in zip(a, b))
    return same, gap


def pp_batches(cfg, idx_rows):
    """The training set on the card and each step's gathered rows."""
    import torch

    from distributed_model_parallel_tpu_torch.data.registry import (
        load_dataset,
    )

    train, _ = load_dataset(cfg.data)
    images = torch.from_numpy(train.images).cuda()
    labels = torch.from_numpy(train.labels).cuda()
    return [(images[ix], labels[ix]) for ix in idx_rows]


def pp_gates(models, pipeline, auto_partition, trainer_mod, tconfig,
             devices, card) -> dict:
    """13a's gates, cuDNN deterministic, augment off: (1) two naive (M=1)
    steps over 4 chunks == phase 11's one-device trainer from the same
    weights and batches; (2) gpipe M=8 == 1f1b M=8 == interleaved V=2 M=8
    (8 chunks at the port's cost-balanced cut), two steps. All bit for
    bit: losses, parameters, momentum, BN buffers."""
    import dataclasses

    import numpy as np
    import torch

    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    cfg = cnn_config(tconfig)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, augment=False))
    idx = cnn_dispatch_indices(4 * CNN_BATCH, 1)[0][:2]
    ref = trainer_mod.Trainer(cfg)
    ref_loss = ref.run_steps(idx)["loss"].cpu().numpy()
    params = list(ref.model.parameters())
    moms = [ref.optimizer.momentum_buffer(i) for i in range(len(params))]
    ref_state = [x.detach().cpu().numpy()
                 for x in (*params, *moms, *ref.model.buffers())]
    del ref
    batches = pp_batches(cfg, idx)
    naive = pp_runner(models, pipeline, tconfig, devices, cfg, m=1,
                      augment=False)
    loss = np.array([float(pipeline.PipelineRunner.finalize_metrics(
        naive.train_step_device(None, *b), CNN_BATCH)["loss"])
        for b in batches], np.float32)
    same, gap = pp_bitwise(pp_state(naive), ref_state)
    print(f"pp gate naive [{card}]: two M=1 steps over {naive.num_chunks} "
          f"chunks {naive.slices} on {[str(d) for d in naive.devices]} vs "
          f"phase 11's one-device trainer, cuDNN deterministic, augment "
          f"off, same weights and batches: losses {loss.tolist()} vs "
          f"{ref_loss.tolist()}; parameters, momentum and BN buffers "
          f"bitwise equal {same}/{len(ref_state)} (max |diff| {gap})")
    if not (np.array_equal(loss, ref_loss) and same == len(ref_state)):
        fail("13a/pipeline", "naive M=1 is not bitwise the one-device "
                             "trainer")
    del naive
    cut8 = auto_partition.auto_boundaries(
        models.get_model(cfg.model, device="cpu"),
        (auto_partition.microbatch_rows(CNN_BATCH, 8), 32, 32, 3),
        2 * PP_STAGES)
    runs = {}
    for name in ("gpipe_m8", "1f1b_m8", "interleaved_v2_m8"):
        m, sched, v = PP_RUNS[name]
        r = pp_runner(models, pipeline, tconfig, devices, cfg, m=m,
                      schedule=sched, virtual=v,
                      boundaries=cut8 if v > 1 else PP_CUT, augment=False)
        losses = [pipeline.PipelineRunner.finalize_metrics(
            r.train_step_device(None, *b), CNN_BATCH)["loss"]
            for b in batches]
        runs[name] = (losses, pp_state(r), r.num_chunks)
        del r
    base = runs["gpipe_m8"]
    ok = True
    for name in ("1f1b_m8", "interleaved_v2_m8"):
        same, gap = pp_bitwise(runs[name][1], base[1])
        print(f"pp gate schedules [{card}]: {name} ({runs[name][2]} chunks"
              f"{', cut ' + str(cut8) if name.startswith('inter') else ''})"
              f" vs gpipe_m8 ({base[2]} chunks, cut {list(PP_CUT)}), two "
              f"steps: losses {runs[name][0]} vs {base[0]}; bitwise equal "
              f"{same}/{len(base[1])} (max |diff| {gap})")
        ok &= runs[name][0] == base[0] and same == len(base[1])
    if not ok:
        fail("13a/pipeline", "the schedules are not bit for bit the same")
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = bench
    torch.cuda.empty_cache()
    return {"naive_vs_trainer_bitwise": True, "schedules_bitwise": True,
            "interleaved_cut": cut8}


def sync_cards(devices) -> None:
    """Waits for every card of ``devices`` (``torch.cuda.synchronize()``
    waits for the current one only)."""
    import torch

    for d in sorted({str(x) for x in devices}):
        torch.cuda.synchronize(d)


def pp_time(models, pipeline, fs, tconfig, devices, cut8, card) -> dict:
    """13a timing: each schedule of PP_RUNS from the seed-0 weights (the
    interleaved one over the 8-chunk cut ``cut8``), augment on (one set of
    draws per microbatch), batches already on the card; PP_WARM_STEPS
    steps, then PP_TIMED_STEPS steps, each synced on every card: step s
    (median), host enqueue (the call, no sync), peak memory (the most of
    any card, and per card), fused_sgd launches counted
    from 0 over the timed steps; then one step under the profiler (the
    device's busy time in it)."""
    import torch

    from distributed_model_parallel_tpu_torch.data.loader import (
        step_generator,
    )

    torch.backends.cudnn.benchmark = False
    cfg = cnn_config(tconfig)
    n = PP_WARM_STEPS + PP_TIMED_STEPS
    idx = [i for ix in cnn_dispatch_indices(4 * CNN_BATCH, -(-n // CNN_SPD))
           for i in ix][:n]
    batches = pp_batches(cfg, idx)
    cards = sorted(set(devices))
    out = {}
    for name, (m, sched, v) in PP_RUNS.items():
        r = pp_runner(models, pipeline, tconfig, devices, cfg, m=m,
                      schedule=sched, virtual=v,
                      boundaries=cut8 if v > 1 else None)
        step_s, host_s, losses = [], [], []
        for k, b in enumerate(batches):
            if k == PP_WARM_STEPS:
                sync_cards(cards)
                for d in cards:
                    torch.cuda.reset_peak_memory_stats(d)
                fs.fused_sgd_kernel.launches = 0
                fs.plain_sgd_kernel.launches = 0
            t0 = time.perf_counter()
            mm = r.train_step_device(step_generator(1, k, "cuda"), *b)
            t1 = time.perf_counter()
            sync_cards(cards)
            t2 = time.perf_counter()
            if k >= PP_WARM_STEPS:
                step_s.append(t2 - t0)
                host_s.append(t1 - t0)
                losses.append(pipeline.PipelineRunner.finalize_metrics(
                    mm, CNN_BATCH)["loss"])
        launches = fs.fused_sgd_kernel.launches
        plain = fs.plain_sgd_kernel.launches
        buckets = sum(len(st.optimizer.buckets) for st in r.stages)
        def one_step():
            mm = r.train_step_device(step_generator(1, n, "cuda"),
                                     *batches[-1])
            return f"loss {torch.stack([x['loss'] for x in mm]).mean()}"

        rows = print_profile(f"pp step {name}", one_step, card,
                             kind=cnn_kind)
        rec = dict(m=m, schedule=sched, virtual_stages=v,
                   chunks=r.num_chunks, step_s=statistics.median(step_s),
                   samples_per_s=CNN_BATCH / statistics.median(step_s),
                   host_enqueue_s=statistics.median(host_s),
                   peak_bytes=max(torch.cuda.max_memory_allocated(d)
                                  for d in cards),
                   peak_bytes_per_card={d: torch.cuda.max_memory_allocated(
                       d) for d in cards},
                   fused_sgd=launches, plain_sgd=plain,
                   want=buckets * PP_TIMED_STEPS,
                   device_busy_us=sum(row[1] for row in rows) or None,
                   losses=losses)
        out[name] = rec
        print(f"pp runner {name} [{card}]: M {m}, {sched}, V {v}, "
              f"{r.num_chunks} chunks on {len(set(r.devices))} card(s); "
              f"{PP_TIMED_STEPS} steps after {PP_WARM_STEPS}, each synced: "
              f"step {rec['step_s']} s (median; min {min(step_s)}, max "
              f"{max(step_s)}), samples/s {rec['samples_per_s']}, host "
              f"enqueue {rec['host_enqueue_s']} s a step (median), "
              f"torch.cuda.max_memory_allocated {rec['peak_bytes']} B "
              f"(the most of any card; per card "
              f"{rec['peak_bytes_per_card']}), "
              f"fused_sgd launches {launches} (want chunks x buckets x steps"
              f" = {rec['want']}), plain_sgd {plain} (want 0); "
              f"cudnn.benchmark False")
        print(f"pp runner {name} losses: {losses}")
        if launches != rec["want"] or plain or not all(
                math.isfinite(x) for x in losses):
            fail("13a/pipeline", f"{name}: fused_sgd launches {launches} != "
                                 f"{rec['want']}, plain_sgd {plain} != 0 or "
                                 f"non-finite losses")
        del r
        torch.cuda.empty_cache()
    return out


def pp_fit(pipeline_trainer, fs, tconfig, devices, card) -> dict:
    """One PipelineTrainer.fit epoch through the normal entry point: 4
    steps of gpipe M=4 over the 4-chunk cut (augment on), then eval."""
    cfg = cnn_config(tconfig).replace(
        mesh=tconfig.MeshConfig(stage=PP_STAGES), num_microbatches=4,
        stage_boundaries=PP_CUT, device_resident_data=False, epochs=1)
    t = pipeline_trainer.PipelineTrainer(cfg, devices)
    before = fs.fused_sgd_kernel.launches
    hist = t.fit()
    n = fs.fused_sgd_kernel.launches - before
    want = len(t.train_loader) * t.runner.num_chunks
    print(f"pp fit [{card}]: PipelineTrainer, {PP_STAGES} stages on "
          f"{devices}, gpipe M=4: {hist}; fused_sgd launches {n} (want "
          f"{want})")
    if n != want or not all(math.isfinite(hist[0][k])
                            for k in ("loss_train", "loss_val")):
        fail("13a/pipeline", f"fit: launches {n} != {want} or non-finite "
                             f"{hist}")
    return dict(history=hist, fused_sgd=n)


def pp_spmd_config(tconfig, schedule: str, cut):
    import dataclasses

    cfg = cnn_config(tconfig).replace(
        strategy="spmd_pipeline", mesh=tconfig.MeshConfig(stage=2),
        num_microbatches=PP_SPMD_M, pipeline_schedule=schedule,
        stage_boundaries=tuple(cut), device_resident_data=False)
    return cfg.replace(data=dataclasses.replace(
        cfg.data, augment=False,
        synthetic_train_size=PP_SPMD_STEPS * CNN_BATCH))


def pp_spmd_rank(spec, cut) -> dict:
    """Phase 13b on one rank of the 2-stage mesh: per schedule, the
    Trainer (strategy="spmd_pipeline") from the seed-0 weights, 3 steps
    of epoch 0's batches (cuDNN deterministic, augment off), then its
    stage's parameters, momentum and BN buffers, the hops of those steps,
    epoch 1's steps (each synced) and PP_HOPS ring shifts of the boundary
    activation."""
    import torch

    from distributed_model_parallel_tpu_torch import config as tconfig
    from distributed_model_parallel_tpu_torch.ops import collectives
    from distributed_model_parallel_tpu_torch.train import (
        trainer as trainer_mod,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    out = {"backend": spec.backend}
    for schedule in ("gpipe", "1f1b"):
        t = trainer_mod.Trainer(pp_spmd_config(tconfig, schedule, cut),
                                spec=spec)
        collectives.reset_counts()
        losses = dp_streaming_losses(t, PP_SPMD_STEPS)
        calls, nbytes = dict(collectives.calls), dict(collectives.wire_bytes)
        moms = [t.optimizer.momentum_buffer(i)
                for i in range(len(t.optimizer.params))]
        state = [x.detach().cpu().numpy().copy() for x in (
            *t.model.parameters(), *moms, *t.model.buffers())]
        step_s = []
        t.train_loader.set_epoch(1)
        for images, labels in t.train_loader:
            images, labels = t._to_device(images), t._to_device(labels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t._train_step(images, labels, None)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        shape, dtype = t.stage.specs(CNN_BATCH // PP_SPMD_M)[1]
        buf = torch.zeros(shape, dtype=dtype, device=spec.device)
        hop_s = []
        for _ in range(PP_HOPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            collectives.ppermute_shift(buf, 1, spec.stage_group)
            torch.cuda.synchronize()
            hop_s.append(time.perf_counter() - t0)
        out[schedule] = dict(
            lo=t.stage.lo, hi=t.stage.hi, losses=losses, state=state,
            calls=calls, bytes=nbytes, step_s=step_s,
            hop_us=statistics.median(hop_s) * 1e6,
            hop_bytes=buf.numel() * buf.element_size())
        del t
        torch.cuda.empty_cache()
    return out


def pp_spmd(mesh, models, pipeline, auto_partition, tconfig, card) -> dict:
    """Phase 13b: the SPMD engine at stage 2 through mesh.spawn (two ranks
    on the one card over gloo, or two cards over NCCL), gpipe and 1f1b
    M=4, each rank's parameters, momentum and BN statistics after 3 steps
    against the runner at S=2, the same cut, M and batches, bit for bit."""
    import torch

    from distributed_model_parallel_tpu_torch.data.loader import BatchLoader
    from distributed_model_parallel_tpu_torch.data.registry import (
        load_dataset,
    )

    two_cards = torch.cuda.device_count() >= 2
    backend = "nccl" if two_cards else "gloo"
    cut = auto_partition.auto_boundaries(
        models.get_model(cnn_config(tconfig).model, device="cpu"),
        (auto_partition.microbatch_rows(CNN_BATCH, PP_SPMD_M), 32, 32, 3), 2)
    ranks = dp_spawn(mesh, pp_spmd_rank, 2, "13b/spmd pipeline", cut,
                     backend=backend, config=tconfig.MeshConfig(stage=2))
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    devices = ["cuda:0", "cuda:1" if two_cards else "cuda:0"]
    out = {"backend": backend, "cut": cut,
           "where": "two cards" if two_cards else "both ranks on the one card"}
    for schedule in ("gpipe", "1f1b"):
        cfg = pp_spmd_config(tconfig, schedule, cut)
        train, _ = load_dataset(cfg.data)
        loader = BatchLoader(train, CNN_BATCH, shuffle=True, seed=0)
        runner = pp_runner(models, pipeline, tconfig, devices, cfg,
                           m=PP_SPMD_M, schedule=schedule, boundaries=cut,
                           augment=False, steps_per_epoch=len(loader))
        loader.set_epoch(0)
        # The ranks' loss: the mean of the microbatch losses in f32.
        losses = [float(torch.stack([m["loss"] for m in (
            runner.train_step_device(None, torch.from_numpy(im).cuda(),
                                     torch.from_numpy(lb).cuda()))]).mean())
            for im, lb in loader]
        want = []
        for st in runner.stages:
            moms = [st.optimizer.momentum_buffer(i)
                    for i in range(len(st.optimizer.params))]
            units = [runner.model.units[i] for i in range(st.lo, st.hi)]
            want.append([x.detach().cpu().numpy().copy() for x in (
                *(p for u in units for p in u.parameters()), *moms,
                *(b for u in units for b in u.buffers()))])
        rec = {}
        for s, r in enumerate(ranks):
            got = r[schedule]
            same, gap = pp_bitwise(got["state"], want[s])
            rec[s] = dict(same=same, leaves=len(want[s]), gap=gap)
            if (got["lo"], got["hi"]) != (runner.stages[s].lo,
                                          runner.stages[s].hi):
                fail("13b/spmd pipeline", "a rank holds the wrong units")
        r0 = ranks[0][schedule]
        step_s = [statistics.median(r[schedule]["step_s"]) for r in ranks]
        print(f"pp spmd {schedule} [{card}]: 2 stages as 2 ranks, backend "
              f"{backend} ({out['where']}), cut {cut}, M {PP_SPMD_M}, "
              f"{PP_SPMD_STEPS} steps of B {CNN_BATCH}, augment off: rank "
              f"losses {r0['losses']} vs runner {losses}; parameters, "
              f"momentum and BN buffers bitwise equal to the runner's at "
              f"S=2: stage 0 {rec[0]['same']}/{rec[0]['leaves']}, stage 1 "
              f"{rec[1]['same']}/{rec[1]['leaves']} (max |diff| "
              f"{max(rec[0]['gap'], rec[1]['gap'])})")
        print(f"pp spmd {schedule} hops [{card}]: stage 0 sent "
              f"{r0['calls'].get('p2p_send', 0)} hops "
              f"({r0['bytes'].get('p2p_send', 0)} B), received "
              f"{r0['calls'].get('p2p_recv', 0)} "
              f"({r0['bytes'].get('p2p_recv', 0)} B) in {PP_SPMD_STEPS} "
              f"steps; a ring shift of the boundary activation "
              f"({r0['hop_bytes']} B) {r0['hop_us']} us (median of "
              f"{PP_HOPS}, synced, {backend}); step s per rank {step_s} "
              f"(median of epoch 1's {len(r0['step_s'])} steps, each "
              f"synced)")
        ok = (all(v["same"] == v["leaves"] for v in rec.values())
              and r0["losses"] == losses)
        if not ok:
            fail("13b/spmd pipeline", f"{schedule}: the ranks are not "
                                      f"bitwise the runner at S=2")
        out[schedule] = dict(losses=losses, step_s=step_s,
                             hop_us=r0["hop_us"], hop_bytes=r0["hop_bytes"],
                             hops_sent=r0["calls"].get("p2p_send", 0),
                             bytes_sent=r0["bytes"].get("p2p_send", 0),
                             bitwise=True)
        del runner
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = bench
    return out


def ppr_config(tconfig, root: str, name: str, **kw):
    """Phase 13c/13d: 15b's workload (resume_config) through the
    pipeline, gpipe M=PPR_M at the reference's cut unless ``kw`` says
    otherwise."""
    return resume_config(tconfig, root, name).replace(**{
        "mesh": tconfig.MeshConfig(stage=PP_STAGES),
        "stage_boundaries": PP_CUT, "num_microbatches": PPR_M, **kw})


def pp_resume(pipeline_trainer, fs, tconfig, devices, root, card) -> dict:
    """Phase 13c: ``PipelineTrainer`` over ``devices`` (PP_STAGES stages,
    gpipe M=PPR_M at the reference's cut), 15b's workload, cuDNN
    deterministic: ``fit(2)`` against ``fit`` preempted by a
    ``step_hook`` at step RES_PREEMPT_STEP of epoch 1 and finished by
    ``PipelineTrainer(resume=True)`` — bit for bit (parameters, momentum,
    BN statistics, update counts, global step, history); fused_sgd
    launches counted from 0 over the three fits; the "pipeline" slot's
    best_acc, the text log's lines; save and restore ms and the
    checkpoint's bytes (median of 3)."""
    import numpy as np
    import torch

    from distributed_model_parallel_tpu_torch.train.checkpoint import (
        PAYLOAD_FILENAME,
    )

    phase = "13c/pipeline resume"
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    fs.fused_sgd_kernel.launches = 0
    fs.plain_sgd_kernel.launches = 0
    a = pipeline_trainer.PipelineTrainer(ppr_config(tconfig, root, "pp_a"),
                                         devices)
    ha = a.fit()
    steps = len(a.train_loader)
    target = steps + RES_PREEMPT_STEP

    def hook(t):
        if t.global_step >= target:
            t.preemption.request()

    cfg = ppr_config(tconfig, root, "pp_b")
    b = pipeline_trainer.PipelineTrainer(cfg, devices)
    b.step_hook = hook
    hb = b.fit()
    stopped_at = (b.global_step, b.train_loader.cursor)
    del b
    r = pipeline_trainer.PipelineTrainer(cfg.replace(resume=True), devices)
    hb = hb + r.fit()
    sync_cards(devices)
    launches = fs.fused_sgd_kernel.launches
    plain = fs.plain_sgd_kernel.launches
    chunks = r.runner.num_chunks
    want = 2 * 2 * steps * chunks * len(r.runner.stages[0].optimizer.buckets)
    sa, sr = resume_state(a), resume_state(r)
    bad = resume_mismatches(sa, sr)
    same_history = history_matches(ha, hb)
    lines = open(os.path.join(root, "log", "pp_b.txt")).read()
    epoch_lines = [x for x in lines.splitlines() if x.startswith("epoch:")]
    preempt_line = (f"preempted: checkpoint saved at epoch 1, global step "
                    f"{stopped_at[0]}") in lines
    resume_line = (f"resume: slot 'pipeline-preempt' -> epoch 1 batch "
                   f"{stopped_at[1]} (global step {stopped_at[0]})") in lines
    best = r.ckpt.restore(r._ckpt_tree(), "pipeline")
    print(f"pp resume [{card}]: PipelineTrainer, {PP_STAGES} stages on "
          f"{devices}, gpipe M={PPR_M}, cut {list(PP_CUT)}, MobileNetV2 "
          f"bf16, B {RES_BATCH}, {steps} steps an epoch, preempted at "
          f"global step {stopped_at[0]} (loader cursor {stopped_at[1]}), "
          f"resumed to {r.global_step}; B vs A: {bad} of {len(sa)} arrays "
          f"differ (parameters, BN statistics, momentum, count, step); "
          f"history equal {same_history}; fused_sgd launches {launches} "
          f"(want fits x epochs x steps x chunks x buckets = {want}), "
          f"plain_sgd {plain} (want 0: momentum 0.9); log: "
          f"{len(epoch_lines)} epoch lines, preemption line "
          f"{preempt_line}, resume line {resume_line}; 'pipeline' slot "
          f"best_acc {float(best['best_acc'])} (the run's {r.best_acc})")
    if bad or not same_history:
        fail(phase, f"the resumed run differs from the uninterrupted one "
                    f"({bad} arrays, history {same_history})")
    if len(epoch_lines) != 2 or not (preempt_line and resume_line):
        fail(phase, f"log lines {lines!r}")
    if launches != want or plain:
        fail(phase, f"fused_sgd launches {launches} != {want} or plain_sgd "
                    f"{plain} != 0")
    if float(best["best_acc"]) != np.float32(r.best_acc):
        fail(phase, "the pipeline slot's best_acc is not the run's")
    tmpl = r._ckpt_tree()
    saves, trees, restores = [], [], []
    for _ in range(3):
        sync_cards(devices)
        t0 = time.perf_counter()
        tree = r._ckpt_tree()
        t1 = time.perf_counter()
        path = r.ckpt.save(tree, "bench")
        t2 = time.perf_counter()
        r._load_tree(r.ckpt.restore(tmpl, "bench"))
        sync_cards(devices)
        t3 = time.perf_counter()
        trees.append((t1 - t0) * 1e3)
        saves.append((t2 - t1) * 1e3)
        restores.append((t3 - t2) * 1e3)
    for st in r.runner.stages:
        st.optimizer._check_views()
    nbytes = os.path.getsize(os.path.join(path, PAYLOAD_FILENAME))
    print(f"pp resume checkpoint [{card}]: {nbytes} B (every chunk's "
          f"parameters, momentum and BN statistics); tree (cards to host) "
          f"{statistics.median(trees)} ms, save {statistics.median(saves)} "
          f"ms, restore + load into the chunks {statistics.median(restores)}"
          f" ms (median of 3); each chunk's FusedSGD views intact")
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = bench
    del a, r
    torch.cuda.empty_cache()
    return dict(preempted_at=stopped_at[0], cursor=stopped_at[1],
                steps=2 * steps, bitwise=True, history_equal=same_history,
                fused_sgd=launches, plain_sgd=plain, bytes=nbytes,
                tree_ms=trees,
                save_ms=saves, restore_ms=restores,
                best_acc=float(best["best_acc"]))


def pp_resume_rank(spec, configs, train, evals, preempt_at, v2_config,
                   hop_configs) -> dict:
    """Phase 13d on one of two ranks, cuDNN deterministic: the
    preempt/resume gate per config (``workers.preempt_resume``), the
    fused_sgd launches of those runs; then, per ``hop_configs`` entry,
    PP_SPMD_STEPS steps of ``Trainer(strategy="spmd_pipeline")`` with the
    hops and bytes counted, and the interleaved run's stage state."""
    import torch

    from distributed_model_parallel_tpu_torch.ops import collectives
    from distributed_model_parallel_tpu_torch.ops import fused_sgd as fs
    from distributed_model_parallel_tpu_torch.parallel import workers
    from distributed_model_parallel_tpu_torch.train import (
        trainer as trainer_mod,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    fs.fused_sgd_kernel.launches = 0
    fs.plain_sgd_kernel.launches = 0
    out = {"runs": workers.preempt_resume(spec, configs, train, evals,
                                          preempt_at),
           "fused_sgd": fs.fused_sgd_kernel.launches,
           "plain_sgd": fs.plain_sgd_kernel.launches,
           "seconds": time.perf_counter() - t0}
    for name, cfg in hop_configs.items():
        t = trainer_mod.Trainer(cfg, spec=spec)
        collectives.reset_counts()
        losses = dp_streaming_losses(t, PP_SPMD_STEPS)
        rec = dict(losses=losses, calls=dict(collectives.calls),
                   bytes=dict(collectives.wire_bytes), units=t.stage.units)
        if name == "interleaved":
            moms = [t.optimizer.momentum_buffer(i)
                    for i in range(len(t.optimizer.params))]
            rec["state"] = [x.detach().cpu().numpy().copy() for x in (
                *t.model.parameters(), *moms, *t.model.buffers())]
        out[name] = rec
        del t
        torch.cuda.empty_cache()
    return out


def pp_spmd_resume(mesh, models, pipeline, auto_partition, tconfig, root,
                   card) -> dict:
    """Phase 13d: two SPMD ranks (gloo on one card, NCCL on two or more):
    the preempt/resume gate under gpipe and 1f1b M=PPR_M at the 2-stage
    cost-balanced cut, each rank's resumed run == its uninterrupted one
    bit for bit; interleaved V=2 M=PP_SPMD_M at S=2 over the 4-chunk
    cost-balanced cut, PP_SPMD_STEPS steps, each rank's chunks bit for bit
    the runner's interleaved V=2 at S=2 with the same cut; the hops and
    bytes a step of interleaved beside 1f1b."""
    import torch

    from distributed_model_parallel_tpu_torch.data.loader import BatchLoader
    from distributed_model_parallel_tpu_torch.data.registry import (
        load_dataset,
    )
    from distributed_model_parallel_tpu_torch.ops.collectives import (
        tree_flatten,
    )

    phase = "13d/spmd resume"
    two = torch.cuda.device_count() >= 2
    backend = "nccl" if two else "gloo"
    model = models.get_model(cnn_config(tconfig).model, device="cpu")
    cut2 = auto_partition.auto_boundaries(
        model, (auto_partition.microbatch_rows(RES_BATCH, PPR_M), 32, 32,
                3), 2)
    cut4 = auto_partition.auto_boundaries(
        model, (auto_partition.microbatch_rows(CNN_BATCH, PP_SPMD_M), 32,
                32, 3), 4)
    mesh2 = tconfig.MeshConfig(stage=2)
    configs = {s: ppr_config(
        tconfig, root, f"spmd_{s}", strategy="spmd_pipeline", mesh=mesh2,
        stage_boundaries=tuple(cut2), pipeline_schedule=s,
        data=tconfig.DataConfig(
            name="synthetic", batch_size=RES_BATCH,
            eval_batch_size=RES_BATCH, image_size=32,
            synthetic_native_size=32, synthetic_train_size=PPS_TRAIN,
            synthetic_eval_size=PPS_EVAL)) for s in ("gpipe", "1f1b")}
    hops = {"1f1b": pp_spmd_config(tconfig, "1f1b", cut2),
            "interleaved": pp_spmd_config(tconfig, "1f1b", cut4).replace(
                virtual_stages=2)}
    train, evals = load_dataset(configs["gpipe"].data)
    steps = PPS_TRAIN // RES_BATCH
    ranks = dp_spawn(mesh, pp_resume_rank, 2, phase, configs,
                     (train.images, train.labels),
                     (evals.images, evals.labels), steps + RES_PREEMPT_STEP,
                     hops["interleaved"], hops, backend=backend,
                     config=mesh2)
    out = {"backend": backend, "cut2": cut2, "cut4": cut4,
           "seconds": [r["seconds"] for r in ranks],
           "fused_sgd": [r["fused_sgd"] for r in ranks],
           "plain_sgd": [r["plain_sgd"] for r in ranks]}
    # Per rank: 2 schedules x (the uninterrupted fit + the preempted one
    # and its resume) x 2 epochs x steps, once per bucket of its stage.
    want = 2 * 2 * 2 * steps
    if any(n == 0 or n % want for n in out["fused_sgd"]) or any(
            out["plain_sgd"]):
        fail(phase, f"launches a rank: fused_sgd {out['fused_sgd']} (want a "
                    f"multiple of {want} above 0), plain_sgd "
                    f"{out['plain_sgd']} (want 0: momentum 0.9)")
    for s in configs:
        leaves = [[tree_flatten((x["runs"][s][run]["params"],
                                 x["runs"][s][run]["momentum"],
                                 x["runs"][s][run]["state"]))[0]
                   for run in "ab"] for x in ranks]
        bad = [resume_mismatches(a, b) for a, b in leaves]
        counts = [(x["runs"][s]["b"]["count"], x["runs"][s]["b"]["step"])
                  for x in ranks]
        same_history = all(history_matches(x["runs"][s]["a"]["history"],
                                           x["runs"][s]["b"]["history"])
                           for x in ranks)
        print(f"pp spmd resume {s}, 2 ranks over {backend} [{card}]: M "
              f"{PPR_M}, cut {cut2}, B {RES_BATCH}, {steps} steps an epoch, "
              f"preempted at global step {steps + RES_PREEMPT_STEP}; arrays "
              f"differing resumed vs uninterrupted {bad} (of "
              f"{[len(x[0]) for x in leaves]}) per rank; update count, step "
              f"{counts} (want {2 * steps}); history equal {same_history}")
        if any(bad) or not same_history or any(
                c != (2 * steps, 2 * steps) for c in counts):
            fail(phase, f"{s}: the resumed runs differ")
        out[s] = dict(differing=bad, steps=counts[0][1], bitwise=True)
    # Interleaved V=2 at S=2 against the runner, same cut, M, batches.
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    cfg = hops["interleaved"]
    tr, _ = load_dataset(cfg.data)
    loader = BatchLoader(tr, CNN_BATCH, shuffle=True, seed=0)
    devices = ["cuda:0", "cuda:1" if two else "cuda:0"]
    runner = pp_runner(models, pipeline, tconfig, devices, cfg, m=PP_SPMD_M,
                       schedule="1f1b", virtual=2, boundaries=cut4,
                       augment=False, steps_per_epoch=len(loader))
    loader.set_epoch(0)
    losses = [float(torch.stack([m["loss"] for m in (
        runner.train_step_device(None, torch.from_numpy(im).cuda(),
                                 torch.from_numpy(lb).cuda()))]).mean())
        for im, lb in loader]
    rec = {}
    for s, r in enumerate(ranks):
        got = r["interleaved"]
        stages = runner.stages[s::2]
        units = [runner.model.units[i] for st in stages
                 for i in range(st.lo, st.hi)]
        moms = [st.optimizer.momentum_buffer(i) for st in stages
                for i in range(len(st.optimizer.params))]
        want = [x.detach().cpu().numpy().copy() for x in (
            *(p for u in units for p in u.parameters()), *moms,
            *(b for u in units for b in u.buffers()))]
        same, gap = pp_bitwise(got["state"], want)
        rec[s] = dict(same=same, leaves=len(want), gap=gap,
                      units=got["units"])
    per_step = {name: {k: ranks[0][name]["calls"].get(k, 0) / PP_SPMD_STEPS
                       for k in ("p2p_send", "p2p_recv")} for name in hops}
    byte_step = {name: ranks[0][name]["bytes"].get("p2p_send", 0)
                 / PP_SPMD_STEPS for name in hops}
    print(f"pp spmd interleaved [{card}]: V=2 at S=2 over {backend}, 4 "
          f"chunks at {cut4}, M {PP_SPMD_M}, {PP_SPMD_STEPS} steps of B "
          f"{CNN_BATCH}, augment off: rank losses "
          f"{ranks[0]['interleaved']['losses']} vs runner {losses}; each "
          f"rank's chunks (units {[rec[s]['units'] for s in rec]}) bitwise "
          f"equal to the runner's interleaved V=2 at S=2: "
          f"{[(rec[s]['same'], rec[s]['leaves']) for s in rec]} (max |diff|"
          f" {max(v['gap'] for v in rec.values())})")
    print(f"pp spmd hops a step [{card}]: stage 0 sends/receives "
          f"{per_step['1f1b']} hops and sends {byte_step['1f1b']} B under "
          f"1f1b M={PP_SPMD_M} (2 chunks), {per_step['interleaved']} hops "
          f"and {byte_step['interleaved']} B interleaved V=2 (4 chunks)")
    if not (all(v["same"] == v["leaves"] for v in rec.values())
            and ranks[0]["interleaved"]["losses"] == losses):
        fail(phase, "interleaved V=2: the ranks are not bitwise the runner")
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = bench
    del runner
    torch.cuda.empty_cache()
    out["interleaved"] = dict(bitwise=True, losses=losses,
                              hops_per_step=per_step["interleaved"],
                              bytes_sent_per_step=byte_step["interleaved"])
    out["1f1b_hops"] = dict(hops_per_step=per_step["1f1b"],
                            bytes_sent_per_step=byte_step["1f1b"])
    return out


def pipeline_phase(laps, models, cnn_trainer, fs, tconfig, card) -> dict:
    """Phase 13: the runner over ``[cuda:(c % n)]`` for PP_STAGES stages
    (gates, timing, a fit epoch), the SPMD engine at 2 stages, then the
    harness: preempt/resume on the runner and at two ranks, interleaved
    over ranks."""
    import torch

    from distributed_model_parallel_tpu_torch import mesh
    from distributed_model_parallel_tpu_torch.parallel import (
        auto_partition,
        pipeline,
    )
    from distributed_model_parallel_tpu_torch.train import pipeline_trainer

    n_cards = torch.cuda.device_count()
    pp_devices = [f"cuda:{c % n_cards}" for c in range(PP_STAGES)]
    pp = {"devices": pp_devices,
          "gates": pp_gates(models, pipeline, auto_partition, cnn_trainer,
                            tconfig, pp_devices, card)}
    laps.done("13a/pipeline gates")
    pp["runner"] = pp_time(models, pipeline, fs, tconfig, pp_devices,
                           pp["gates"]["interleaved_cut"], card)
    pp["fit"] = pp_fit(pipeline_trainer, fs, tconfig, pp_devices, card)
    laps.done("13a/pipeline runner")
    pp["spmd"] = pp_spmd(mesh, models, pipeline, auto_partition, tconfig,
                         card)
    laps.done("13b/spmd pipeline")
    import tempfile

    with tempfile.TemporaryDirectory(dir=HERE) as root:
        pp["resume"] = pp_resume(pipeline_trainer, fs, tconfig, pp_devices,
                                 root, card)
        laps.done("13c/pipeline resume")
        pp["spmd_resume"] = pp_spmd_resume(mesh, models, pipeline,
                                           auto_partition, tconfig, root,
                                           card)
        laps.done("13d/spmd resume")
    return pp


def train_resnet(trainer_mod, fs, models, staged, tconfig, card) -> dict:
    """Phase 14a: ResNet-50 through the CNN trainer at bench.py's
    full-width shape — the fused-vs-torch.optim.SGD check, then the main
    path (bench.py's timing shape, counts set to 0 just before and read
    just after: fused_sgd launches == steps x buckets), 20 momentum-0
    steps (plain_sgd == steps x buckets), a profiled step with the fused
    kernel's device time beside its byte bound; then a ResNet-18 step and
    the ImageNet layout's forward at 224 px."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    check_cnn_step(trainer_mod, models, staged, tconfig, model=RN_MODEL,
                   phase="14a/resnet")
    n_disp = CNN_TIMED_STEPS // CNN_SPD
    idxs = cnn_dispatch_indices(4 * CNN_BATCH, CNN_WARM_DISPATCHES + n_disp)
    t = trainer_mod.Trainer(cnn_config(tconfig, RN_MODEL))
    dev = t.device
    n_params = sum(p.numel() for p in t.model.parameters())
    buckets = len(t.optimizer.buckets)
    for ix in idxs[:CNN_WARM_DISPATCHES]:
        t.run_steps(ix)
    torch.cuda.synchronize()
    params0 = [p.detach().clone() for p in t.model.parameters()]
    torch.cuda.reset_peak_memory_stats()
    fs.fused_sgd_kernel.launches = 0
    fs.plain_sgd_kernel.launches = 0
    rec = cnn_run(t, idxs[CNN_WARM_DISPATCHES:], f"{RN_MODEL} trainer "
                  f"(fused)", card)
    launches = {"fused_sgd": fs.fused_sgd_kernel.launches,
                "plain_sgd": fs.plain_sgd_kernel.launches}
    peak = torch.cuda.max_memory_allocated()
    changed = sum(not torch.equal(a, b) for a, b in
                  zip(params0, t.model.parameters()))
    want = CNN_TIMED_STEPS * buckets
    print(f"{RN_MODEL} trainer: {n_params} parameters in {buckets} "
          f"bucket(s); losses {rec['losses']}; fused_sgd launches "
          f"{launches['fused_sgd']} (want steps x buckets = {want}), "
          f"plain_sgd {launches['plain_sgd']} (want 0); parameters changed "
          f"{changed}/{len(params0)}")
    if not all(math.isfinite(x) for x in rec["losses"]):
        fail("14a/resnet", f"non-finite losses {rec['losses']}")
    if launches != {"fused_sgd": want, "plain_sgd": 0}:
        fail("14a/resnet", f"launches {launches}, want fused_sgd {want}")
    if changed != len(params0):
        fail("14a/resnet", "parameters unchanged by training")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        t.model.apply(torch.zeros(CNN_BATCH, 32, 32, 3, dtype=torch.bfloat16,
                                  device=dev), train=False)
    flops = 3 * counter.get_total_flops()
    mfu = flops / rec["step_s"] / BF16_FLOPS_PER_S
    print(f"{RN_MODEL} trainer [{card}]: B {CNN_BATCH}, {CNN_TIMED_STEPS} "
          f"steps (after {CNN_WARM_DISPATCHES} warm-up dispatches of "
          f"{CNN_SPD}), one sync: samples/s/chip {rec['samples_per_s']}, "
          f"step {rec['step_s']} s, MFU ({flops} flop per step = 3 x "
          f"FlopCounterMode's forward / step s / {BF16_FLOPS_PER_S:.0f}) "
          f"{mfu}, torch.cuda.max_memory_allocated {peak} B")
    rows = print_profile(f"{RN_MODEL} step", lambda: f"loss "
                         f"{t.run_steps(idxs[-1][:1])['loss'].item()}",
                         card, kind=cnn_kind)
    hits = [(us, n) for key, us, n in rows if "fused_sgd" in key]
    bound = sgd_traffic(n_params, 0.9, 1e-4, False)
    kernel_us = sum(h[0] for h in hits) if hits else None
    if kernel_us is None:
        print(f"{RN_MODEL} step fused_sgd device time [{card}]: not measured")
    else:
        print(f"{RN_MODEL} step fused_sgd device time [{card}]: {kernel_us} "
              f"us for {sum(h[1] for h in hits)} launch(es) over "
              f"{n_params} parameters; byte bound {bound['bound_ms'] * 1e3} "
              f"us ({bound['bytes']} B at {HBM_BYTES_PER_S:.3g} B/s), "
              f"{bound['bound_ms'] * 1e3 / kernel_us:.1%} of it")
    del t, params0

    side = trainer_mod.Trainer(cnn_config(tconfig, RN_MODEL, momentum=0.0))
    side.run_steps(idxs[0][:2])                    # warm-up
    fs.fused_sgd_kernel.launches = 0
    fs.plain_sgd_kernel.launches = 0
    r0 = cnn_run(side, [idxs[1], idxs[2]], f"{RN_MODEL} trainer (fused, "
                 f"momentum 0)", card)
    m0 = {"fused_sgd": fs.fused_sgd_kernel.launches,
          "plain_sgd": fs.plain_sgd_kernel.launches}
    want0 = CNN_SIDE_STEPS * buckets
    print(f"{RN_MODEL} momentum 0: launches {m0} (want plain_sgd steps x "
          f"buckets = {want0})")
    if m0 != {"fused_sgd": 0, "plain_sgd": want0} or not all(
            math.isfinite(x) for x in r0["losses"]):
        fail("14a/resnet", f"momentum 0: launches {m0}, want plain_sgd "
                           f"{want0}, or non-finite {r0['losses']}")
    del side

    r18 = trainer_mod.Trainer(cnn_config(tconfig, RN_SIDE_MODEL))
    loss18 = r18.run_steps(idxs[0][:1])["loss"].item()
    del r18
    gen = torch.Generator(device=dev).manual_seed(0)
    net = models.get_model(tconfig.ModelConfig(
        name=RN_MODEL, dtype="bfloat16",
        extra={"input_layout": "imagenet"}), seed=0, device=dev)
    x = torch.randn(RN_IMAGENET_BATCH, RN_IMAGENET_PX, RN_IMAGENET_PX, 3,
                    device=dev, generator=gen).to(torch.bfloat16)
    with torch.no_grad():
        y_eval, _ = net.apply(x, train=False)
        y_train, _ = net.apply(x, train=True)
    finite = bool(torch.isfinite(y_eval).all() and torch.isfinite(
        y_train).all())
    print(f"{RN_SIDE_MODEL} step: loss {loss18}; {net.name} forward, B "
          f"{RN_IMAGENET_BATCH} at {RN_IMAGENET_PX} px (stem 7x7/2 + 3x3/2 "
          f"SAME max-pool): logits {tuple(y_eval.shape)} finite {finite}")
    if not (math.isfinite(loss18) and finite and tuple(y_eval.shape) == (
            RN_IMAGENET_BATCH, 10)):
        fail("14a/resnet", "ResNet-18 step or ImageNet forward not finite")
    del net, x
    torch.cuda.empty_cache()
    return dict(model=RN_MODEL, parameters=n_params, buckets=buckets,
                samples_per_s=rec["samples_per_s"], step_s=rec["step_s"],
                mfu=mfu, flops_per_step=flops, peak_bytes=peak,
                launches=launches, launches_momentum0=m0,
                fused_sgd_in_step_us=kernel_us,
                fused_sgd_bound_us=bound["bound_ms"] * 1e3,
                resnet18_loss=loss18, imagenet_forward_finite=finite)


def dpe_config(tconfig, world: int, **kw):
    """Phase 14b's TrainConfig: ResNet-50 in f32 at DPE_BATCH over
    ``world`` ranks, augment off, streaming input, no warm-up."""
    optimizer = kw.pop("optimizer", {})
    return tconfig.TrainConfig(
        model=tconfig.ModelConfig(name=RN_MODEL, dtype="float32"),
        data=tconfig.DataConfig(
            name="synthetic", batch_size=DPE_BATCH,
            eval_batch_size=DPE_BATCH, image_size=32,
            synthetic_native_size=32, augment=False,
            synthetic_train_size=(DPE_STEPS + DPE_TIMED_STEPS) * DPE_BATCH,
            synthetic_eval_size=DPE_BATCH),
        optimizer=tconfig.OptimizerConfig(
            **{**dict(learning_rate=DPE_LR, warmup_steps=0), **optimizer}),
        mesh=tconfig.MeshConfig(data=world), device="cuda",
        **{**run_dirs(f"dpe_{RN_MODEL}"), **kw})


def rel_gap(a, b) -> float:
    """max|a - b| / max|b| over one tensor pair."""
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def dpe_batches(trainer, n: int) -> list:
    """This rank's rows of epoch 0's first ``n`` batches, on the card."""
    trainer.train_loader.set_epoch(0)
    return [(trainer._to_device(im), trainer._to_device(lb))
            for _, (im, lb) in zip(range(n), trainer.train_loader)]


def dpe_steps(trainer, batches, after=None) -> list:
    """One train step per batch; ``after(trainer)`` after each; the
    global losses."""
    out = []
    for im, lb in batches:
        m = trainer._train_step(im, lb, None)
        trainer.global_step += 1
        out.append(float(m["loss"]))
        if after is not None:
            after(trainer)
    return out


def dpe_sync_fsdp(src, dst, spec) -> None:
    """Copy the gspmd trainer ``src``'s parameters and momentum into the
    fsdp trainer ``dst``: each sharded leaf gets this rank's slice."""
    import torch
    from torch.nn.utils import parametrize

    n, r = spec.num_data, spec.data_index
    smods = dict(src.model.named_modules())
    sstate, dstate = src.optimizer.opt.state, dst.optimizer.opt.state
    with torch.no_grad():
        for name, m in dst.model.named_modules():
            if name not in smods:
                continue
            for leaf in ("weight", "bias"):
                if parametrize.is_parametrized(m, leaf):
                    p = m.parametrizations[leaf].original
                    dim = m.parametrizations[leaf][0].dim
                    cut = (lambda t, dim=dim: t.chunk(n, dim)[r])
                else:
                    p = m._parameters.get(leaf)
                    cut = (lambda t: t)
                if p is None:
                    continue
                sp = smods[name]._parameters[leaf]
                p.copy_(cut(sp))
                sm = sstate.get(sp, {}).get("momentum_buffer")
                if sm is not None:
                    dstate[p]["momentum_buffer"].copy_(cut(sm))


def dpe_params(trainer) -> list:
    """Every parameter of the trainer's model, whole (an FSDP model's
    gathered: every rank must call), in the weight carrier's order."""
    import torch

    from distributed_model_parallel_tpu_torch.models.staged import (
        _unit_slots,
        slot_leaves,
    )

    with torch.no_grad():
        return [t.detach().clone() for unit in trainer.model.units
                for t, _ in slot_leaves(_unit_slots(unit)[0])]


def dpe_timed(run, reducer_times, n: int) -> dict:
    """``run()`` n times after the gated steps, one sync at each end:
    samples/s per rank's card and the reduction's µs a step."""
    import torch

    reducer_times()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    us = sorted(reducer_times())
    return dict(steps=n, samples_per_s=DPE_BATCH * n / dt,
                reduction_us_median=statistics.median(us) if us else None)


def dp_engines_rank(spec, timed: bool) -> dict:
    """Phase 14b on one rank: ddp ring vs bucketed, ZeRO (fused, then
    momentum 0) vs gspmd's FusedSGD, fsdp vs gspmd, each DPE_STEPS steps
    from the same weights and batches (this rank's rows), cuDNN
    deterministic; the sparse BOW against dense SGD on the global batch.
    With ``timed``, DPE_TIMED_STEPS more steps of each engine, timed.
    Numbers come back as plain Python and numpy."""
    import numpy as np
    import torch
    from torch.func import functional_call

    from distributed_model_parallel_tpu_torch import config as tconfig
    from distributed_model_parallel_tpu_torch.data.loader import normalize
    from distributed_model_parallel_tpu_torch.models import embedding as bow
    from distributed_model_parallel_tpu_torch.ops import collectives
    from distributed_model_parallel_tpu_torch.ops import fused_sgd as fs
    from distributed_model_parallel_tpu_torch.parallel import ddp, fsdp, zero
    from distributed_model_parallel_tpu_torch.train import (
        trainer as trainer_mod,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    world = spec.num_data
    n_all = DPE_STEPS + (DPE_TIMED_STEPS if timed else 0)
    out = {"backend": spec.backend, "world": world}

    def replicated(tr):
        ddp.assert_ddp_replicated(tr.model, tr.optimizer, spec)

    # -- ddp: the ring against the bucketed all-reduce ------------------
    # Each step starts both from the bucketed run's state (parameters and
    # momentum copied into the ring's buckets), so a gap is the step's own.
    ref, ring = (trainer_mod.Trainer(dpe_config(
        tconfig, world, strategy="ddp", ddp_allreduce=allreduce,
        optimizer=dict(fused=True)), spec=spec)
        for allreduce in ("bucketed", "ring"))
    batches = dpe_batches(ref, n_all)
    losses, gaps = {"bucketed": [], "ring": []}, []
    for b in batches[:DPE_STEPS]:
        losses["bucketed"] += dpe_steps(ref, [b], replicated)
        losses["ring"] += dpe_steps(ring, [b], replicated)
        gaps.append(max(rel_gap(x, y) for x, y in zip(
            ring.model.parameters(), ref.model.parameters())))
        with torch.no_grad():
            for src, dst in ((ref.optimizer._p, ring.optimizer._p),
                             (ref.optimizer._m, ring.optimizer._m)):
                for x, y in zip(src, dst):
                    y.copy_(x)
    timed_runs = {}
    if timed:
        for name, tr in (("bucketed", ref), ("ring", ring)):
            it = iter(batches[DPE_STEPS:])
            timed_runs[name] = dpe_timed(
                lambda tr=tr, it=it: dpe_steps(tr, [next(it)]),
                tr.reducer.take_times_us, DPE_TIMED_STEPS)
    out["ring"] = dict(losses=losses, rel_gap=gaps, timed=timed_runs)
    del ref, ring
    torch.cuda.empty_cache()

    # -- ZeRO against gspmd's FusedSGD ----------------------------------
    # Each ZeRO step starts from the gspmd run's state before that step
    # (its parameters, and this rank's slice of its momentum).
    out["zero"] = {}
    for label, momentum in (("fused", 0.9), ("momentum0", 0.0)):
        ref = trainer_mod.Trainer(dpe_config(
            tconfig, world, optimizer=dict(fused=True, momentum=momentum)),
            spec=spec)
        batches = dpe_batches(ref, n_all)
        model = ref.model
        names = [n for n, _ in model.named_parameters()]
        mean = torch.as_tensor(ref.train_ds.mean, dtype=torch.float32,
                               device=spec.device)
        std = torch.as_tensor(ref.train_ds.std, dtype=torch.float32,
                              device=spec.device)

        def loss_fn(params, batch, model=model, mean=mean, std=std):
            images, labels = batch
            x = normalize(images, mean, std, torch.float32)
            logits = functional_call(model, params, (x,), {"train": True})
            return trainer_mod.cross_entropy(logits, labels)

        init_fn, step_fn = zero.make_zero_train_step(
            loss_fn, tconfig.OptimizerConfig(
                learning_rate=DPE_LR, momentum=momentum, weight_decay=1e-4,
                fused=True), spec, schedule=ref.optimizer.schedule)

        def ref_state(ref=ref, names=names):
            """The gspmd run's parameters (clones) and momentum."""
            params = {n: p.detach().clone()
                      for n, p in zip(names, ref.model.parameters())}
            moms = {n: ref.optimizer.momentum_buffer(i)
                    for i, n in enumerate(names)}
            return params, moms

        state = init_fn(ref_state()[0])
        fs.fused_sgd_kernel.launches = 0
        fs.plain_sgd_kernel.launches = 0
        losses, ref_losses, gaps, launches = [], [], [], {}
        for k, b in enumerate(batches[:DPE_STEPS]):
            params, moms = ref_state()
            if state.momentum is not None:
                flat = collectives.flatten_padded(moms, world)
                size = flat.numel() // world
                state.momentum.copy_(flat[spec.rank * size:
                                          (spec.rank + 1) * size])
            state.count = k
            before = (fs.fused_sgd_kernel.launches,
                      fs.plain_sgd_kernel.launches)
            params, state, loss = step_fn(params, state, b)
            launches = {"fused_sgd": launches.get("fused_sgd", 0)
                        + fs.fused_sgd_kernel.launches - before[0],
                        "plain_sgd": launches.get("plain_sgd", 0)
                        + fs.plain_sgd_kernel.launches - before[1]}
            losses.append(float(loss))
            ref_losses += dpe_steps(ref, [b])
            gaps.append(max(rel_gap(params[n], w) for n, w in zip(
                names, ref.model.parameters())))
        fp = ddp._fingerprint([params[n] for n in names], spec.device)
        every = collectives.all_gather_concat(fp[None], spec.group)
        rec = dict(losses=losses, ref_losses=ref_losses, rel_gap=gaps,
                   launches=launches,
                   bitwise_across_ranks=bool((every == every[0]).all()),
                   momentum_bytes=(0 if state.momentum is None
                                   else state.momentum.numel() * 4),
                   gspmd_momentum_bytes=sum(
                       m.numel() * 4 for m in ref.optimizer._m
                       if m is not None))
        if timed:
            it = iter(batches[DPE_STEPS:])
            box = {"p": params, "s": state}

            def zstep(box=box, it=it):
                box["p"], box["s"], _ = step_fn(box["p"], box["s"],
                                                next(it))

            step_fn.take_times_us()
            rec["timed"] = dpe_timed(zstep, step_fn.take_times_us,
                                     DPE_TIMED_STEPS)
        out["zero"][label] = rec
        del ref, model, params, state
        torch.cuda.empty_cache()

    # -- fsdp against gspmd ---------------------------------------------
    # Each step starts both from the gspmd run's state (its parameters and
    # momentum cut into this rank's slices).
    ref, sharded = (trainer_mod.Trainer(dpe_config(
        tconfig, world, strategy=strategy), spec=spec)
        for strategy in ("gspmd", "fsdp"))
    batches = dpe_batches(ref, n_all)
    losses, ref_losses, close, gaps = [], [], [], []
    for b in batches[:DPE_STEPS]:
        ref_losses += dpe_steps(ref, [b])
        losses += dpe_steps(sharded, [b])
        got, want = dpe_params(sharded), dpe_params(ref)    # gathered
        close.append(all(torch.allclose(x, y, rtol=FSDP_RTOL, atol=FSDP_ATOL)
                         for x, y in zip(got, want)))
        gaps.append(max(rel_gap(x, y) for x, y in zip(got, want)))
        dpe_sync_fsdp(ref, sharded, spec)
    resident = {name: fsdp.resident_bytes(tr.model, tr.optimizer)
                for name, tr in (("gspmd", ref), ("fsdp", sharded))}
    timed_runs = {}
    if timed:
        for name, tr in (("gspmd", ref), ("fsdp", sharded)):
            it = iter(batches[DPE_STEPS:])
            times = (tr.reducer.take_times_us if name == "gspmd"
                     else (lambda: []))
            timed_runs[name] = dpe_timed(
                lambda tr=tr, it=it: dpe_steps(tr, [next(it)]), times,
                DPE_TIMED_STEPS)
    out["fsdp"] = dict(
        losses=losses, ref_losses=ref_losses,
        loss_rel=max(abs(x - y) / abs(y) for x, y in zip(losses,
                                                        ref_losses)),
        params_close=all(close), rel_gap=gaps, resident=resident["fsdp"],
        gspmd_resident=resident["gspmd"], timed=timed_runs)
    del ref, sharded
    torch.cuda.empty_cache()

    # -- the sparse BOW -------------------------------------------------
    cfg = bow.BowConfig()
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        BOW_ROWS, BOW_TOKENS))).to(spec.device)
    labels = torch.from_numpy(rng.integers(0, cfg.num_classes,
                                           BOW_ROWS)).to(spec.device)
    rows = spec.rows(BOW_ROWS)
    params = bow.init_params(cfg, seed=0, device=spec.device)
    dense = {k: v.clone() for k, v in params.items()}
    step = bow.make_sparse_sgd_step(cfg, BOW_LR, group=spec.group)
    errs, losses = [], []
    t0 = time.perf_counter()
    for _ in range(BOW_STEPS):
        params, loss = step(params, tokens[rows], labels[rows])
        live = {k: v.detach().requires_grad_(True) for k, v in dense.items()}
        dloss = bow.loss_fn(live, tokens, labels)
        grads = torch.autograd.grad(dloss, [live[k] for k in bow.PARAM_NAMES])
        with torch.no_grad():
            dense = {k: live[k] - BOW_LR * g
                     for k, g in zip(bow.PARAM_NAMES, grads)}
        losses.append((float(loss), float(dloss.detach())))
        errs.append(max(float(((params[k] - dense[k]).abs()
                               - BOW_RTOL * dense[k].abs()).max())
                        for k in bow.PARAM_NAMES))
    torch.cuda.synchronize()
    fp = ddp._fingerprint([params[k] for k in bow.PARAM_NAMES], spec.device)
    every = collectives.all_gather_concat(fp[None], spec.group)
    out["bow"] = dict(losses=losses, excess=errs,
                      seconds=time.perf_counter() - t0,
                      bitwise_across_ranks=bool((every == every[0]).all()))
    return out


def dp_engines(mesh, card, world: int, backend: str) -> dict:
    """Phase 14b (14c under ``--dp-only``): :func:`dp_engines_rank` on
    ``world`` ranks over ``backend``; the parent prints and gates."""
    timed = backend == "nccl" and world > 1
    where = ("each rank on its own card" if backend == "nccl"
             else "both ranks on the one card")
    r = dp_spawn(mesh, dp_engines_rank, world, "14b/dp engines", timed,
                 backend=backend)
    a = r[0]
    tag = f"[{card}] {world} ranks over {backend} ({where})"
    ring = a["ring"]
    print(f"dp engines ring vs bucketed {tag}: {RN_MODEL} f32, B "
          f"{DPE_BATCH}, {DPE_STEPS} steps, fused SGD buckets, each step "
          f"from the bucketed run's state: losses ring "
          f"{ring['losses']['ring']} bucketed {ring['losses']['bucketed']}; "
          f"params per-leaf max rel gap per step {ring['rel_gap']} (gate "
          f"{DPE_RTOL}); replicas bitwise equal after every step")
    losses = [x for v in ring["losses"].values() for x in v] + [
        x for z in a["zero"].values() for x in z["losses"]] + a["fsdp"][
        "losses"] + [x for pair in a["bow"]["losses"] for x in pair]
    if not all(math.isfinite(x) for x in losses):
        fail("14b/dp engines", f"non-finite losses {losses}")
    if not max(ring["rel_gap"]) <= DPE_RTOL:
        fail("14b/dp engines", f"ring vs bucketed {ring['rel_gap']}")
    out = {"world": world, "backend": backend,
           "ring": dict(rel_gap=ring["rel_gap"])}
    for label, z in a["zero"].items():
        kernel = "plain_sgd" if label == "momentum0" else "fused_sgd"
        other = "fused_sgd" if kernel == "plain_sgd" else "plain_sgd"
        print(f"dp engines ZeRO ({label}) vs gspmd FusedSGD {tag}, each "
              f"step from gspmd's state: losses "
              f"{z['losses']} vs {z['ref_losses']}; params per-leaf max rel "
              f"gap per step {z['rel_gap']} (gate {DPE_RTOL}); {kernel} "
              f"launches {z['launches'][kernel]} on rank 0 (want one a step "
              f"a rank: {DPE_STEPS}); params bitwise equal across ranks "
              f"{z['bitwise_across_ranks']}; resident momentum "
              f"{[x['zero'][label]['momentum_bytes'] for x in r]} B a rank "
              f"vs gspmd's {z['gspmd_momentum_bytes']} B")
        bad = [x for x in r if x["zero"][label]["launches"] != {
            kernel: DPE_STEPS, other: 0}]
        if bad or not max(z["rel_gap"]) <= DPE_RTOL or not all(
                x["zero"][label]["bitwise_across_ranks"] for x in r):
            fail("14b/dp engines", f"ZeRO {label}: gaps {z['rel_gap']}, "
                 f"launches {[x['zero'][label]['launches'] for x in r]}")
        out[f"zero_{label}"] = dict(
            rel_gap=z["rel_gap"], launches=[x["zero"][label]["launches"]
                                            for x in r],
            momentum_bytes=z["momentum_bytes"],
            gspmd_momentum_bytes=z["gspmd_momentum_bytes"])
    f = a["fsdp"]
    print(f"dp engines fsdp vs gspmd {tag}, each step from gspmd's state: "
          f"losses {f['losses']} vs "
          f"{f['ref_losses']} (max rel {f['loss_rel']}, gate "
          f"{FSDP_LOSS_RTOL}); gathered params allclose(rtol {FSDP_RTOL}, "
          f"atol {FSDP_ATOL}) after every step {f['params_close']} (per-leaf "
          f"max rel gap per step {f['rel_gap']}); resident bytes a rank "
          f"{[x['fsdp']['resident'] for x in r]} vs gspmd's "
          f"{f['gspmd_resident']}")
    if not (f["loss_rel"] <= FSDP_LOSS_RTOL and all(
            x["fsdp"]["params_close"] for x in r)):
        fail("14b/dp engines", "fsdp vs gspmd outside tolerance")
    out["fsdp"] = dict(loss_rel=f["loss_rel"], rel_gap=f["rel_gap"],
                       resident=[x["fsdp"]["resident"] for x in r],
                       gspmd_resident=f["gspmd_resident"])
    b = a["bow"]
    print(f"dp engines sparse BOW {tag}: vocab 10000 x 64, {BOW_ROWS} rows "
          f"x {BOW_TOKENS} tokens, {BOW_STEPS} steps in {b['seconds']} s: "
          f"losses (sparse, dense) {b['losses']}; max(|sparse - dense| - "
          f"{BOW_RTOL}|dense|) per step {b['excess']} (gate {BOW_ATOL}); "
          f"tables bitwise equal across ranks {b['bitwise_across_ranks']}")
    if not (max(b["excess"]) <= BOW_ATOL and all(
            x["bow"]["bitwise_across_ranks"] for x in r)):
        fail("14b/dp engines", "sparse BOW outside tolerance or ranks "
                               "differ")
    out["bow"] = dict(excess=b["excess"], losses=b["losses"])
    if a["ring"]["timed"]:
        pairs = {"bucketed": a["ring"]["timed"]["bucketed"],
                 "ring": a["ring"]["timed"]["ring"],
                 "zero": a["zero"]["fused"].get("timed"),
                 "fsdp": a["fsdp"]["timed"]["fsdp"],
                 "gspmd": a["fsdp"]["timed"]["gspmd"]}
        for name, p in pairs.items():
            us = p["reduction_us_median"]
            print(f"dp engines BASELINE pair {name} {tag}: samples/s/card "
                  f"{p['samples_per_s'] / world} ({p['steps']} steps, "
                  f"{RN_MODEL} f32, B {DPE_BATCH}); grad reduction "
                  f"{'not measured' if us is None else f'{us} us'} a step "
                  f"(median, CUDA events)")
        out["timed"] = pairs
    return out


# -- phase 15: the reference's harness on the CNN trainer -----------------

def zoo_config(tconfig, model: str, root: str, **optimizer):
    """Phase 15a's TrainConfig: ``model`` at its CIFAR widths, bf16 over
    f32 parameters, bench.py's SGD recipe through FusedSGD, synthetic
    32 px data on the card, ZOO_BATCH rows, device-resident."""
    return tconfig.TrainConfig(
        model=tconfig.ModelConfig(name=model, dtype="bfloat16"),
        data=tconfig.DataConfig(
            name="synthetic", batch_size=ZOO_BATCH, eval_batch_size=ZOO_BATCH,
            image_size=32, synthetic_native_size=32,
            synthetic_train_size=4 * ZOO_BATCH, synthetic_eval_size=ZOO_BATCH),
        optimizer=tconfig.OptimizerConfig(
            **{**dict(learning_rate=0.4, warmup_steps=10, fused=True),
               **optimizer}),
        device_resident_data=True, steps_per_dispatch=ZOO_TIMED_STEPS,
        device="cuda", log_dir=os.path.join(root, "log"), log_name=model,
        checkpoint_dir=os.path.join(root, "ckpt", model))


def zoo_run(trainer_mod, fs, tconfig, name: str, root: str, card,
            momentum: float = 0.9) -> dict:
    """One zoo model through ``Trainer.run_steps``: ZOO_WARM_DISPATCHES
    one-step dispatches (cuDNN's autotuner), then ZOO_TIMED_STEPS steps in
    one dispatch, one sync at the end. Gates: the JAX package's parameter
    count, the fused update launched on the card (no plain fallback),
    launches == steps x buckets, finite losses."""
    import torch

    phase = "15a/zoo"
    # What earlier models and phases still hold, once cycles are freed (a
    # collection inside this model's run would otherwise lower the
    # allocation under the baseline).
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t = trainer_mod.Trainer(zoo_config(tconfig, name, root,
                                       momentum=momentum))
    params = list(t.model.parameters())
    n = sum(p.numel() for p in params)
    buckets = len(t.optimizer.buckets)
    if n != ZOO_PARAMS[name]:
        fail(phase, f"{name}: {n} parameters, the JAX package's "
                    f"{ZOO_PARAMS[name]}")
    if getattr(t.optimizer, "_launchers", None) is None:
        fail(phase, f"{name}: FusedSGD runs the plain update on the card")
    gen = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 4 * ZOO_BATCH, (ZOO_WARM_DISPATCHES
                                           + ZOO_TIMED_STEPS, ZOO_BATCH),
                        generator=gen).cuda()
    for w in range(ZOO_WARM_DISPATCHES):
        t.run_steps(idx[w:w + 1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fs.fused_sgd_kernel.launches = 0
    fs.plain_sgd_kernel.launches = 0
    t0 = time.perf_counter()
    m = t.run_steps(idx[ZOO_WARM_DISPATCHES:])
    losses = m["loss"].cpu().tolist()
    dt = time.perf_counter() - t0
    launches = {"fused_sgd": fs.fused_sgd_kernel.launches,
                "plain_sgd": fs.plain_sgd_kernel.launches}
    kernel = "fused_sgd" if momentum else "plain_sgd"
    want = {"fused_sgd": 0, "plain_sgd": 0, kernel: ZOO_TIMED_STEPS * buckets}
    rec = dict(params=n, leaves=len(params), buckets=buckets,
               step_s=dt / ZOO_TIMED_STEPS,
               samples_per_s=ZOO_BATCH * ZOO_TIMED_STEPS / dt,
               peak_bytes=torch.cuda.max_memory_allocated() - base,
               launches=launches, losses=losses)
    print(f"zoo {name}{'' if momentum else ' (momentum 0)'} [{card}]: "
          f"{n} parameters, {len(params)} leaves, {buckets} bucket(s); "
          f"step {rec['step_s']} s, {rec['samples_per_s']} samples/s, peak "
          f"{rec['peak_bytes']} B over what was allocated before its "
          f"Trainer; launches {launches} (want {want}); "
          f"losses {losses[0]} .. {losses[-1]}")
    if not all(math.isfinite(x) for x in losses):
        fail(phase, f"{name}: non-finite losses {losses}")
    if launches != want:
        fail(phase, f"{name}: launches {launches}, want {want}")
    del t, m
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def zoo_phase(trainer_mod, fs, models, staged, tconfig, root, card) -> dict:
    """Phase 15a: the 16 zoo models on the card, phase 11a's fused vs
    ``torch.optim.SGD`` check on EfficientNet-B0 (SE biases under BN) and
    DenseNet-121 (the most leaves), and one momentum-0 EfficientNet-B0
    run through ``plain_sgd``."""
    import torch

    torch.backends.cudnn.benchmark = True
    rows = {name: zoo_run(trainer_mod, fs, tconfig, name, root, card)
            for name in ZOO_PARAMS}
    for name in ("efficientnetb0", "densenet121"):
        check_cnn_step(trainer_mod, models, staged, tconfig, model=name,
                       phase="15a/zoo")
    m0 = zoo_run(trainer_mod, fs, tconfig, "efficientnetb0", root, card,
                 momentum=0.0)
    return {"models": rows, "efficientnetb0_momentum0": m0}


def resume_config(tconfig, root: str, name: str, **kw):
    """Phase 15b/c: the reference's workload (MobileNetV2, bf16, fused
    SGD, augment on) on RES_TRAIN / RES_EVAL synthetic 32 px rows, batch
    RES_BATCH, 2 epochs; logs and checkpoints under ``root``."""
    return tconfig.TrainConfig(
        model=tconfig.ModelConfig(name="mobilenetv2", dtype="bfloat16"),
        data=tconfig.DataConfig(
            name="synthetic", batch_size=RES_BATCH, eval_batch_size=RES_BATCH,
            image_size=32, synthetic_native_size=32,
            synthetic_train_size=RES_TRAIN, synthetic_eval_size=RES_EVAL),
        optimizer=tconfig.OptimizerConfig(learning_rate=0.4,
                                          warmup_steps=10, fused=True),
        epochs=2, log_every_n_steps=1000, device="cuda",
        log_dir=os.path.join(root, "log"), log_name=name,
        checkpoint_dir=os.path.join(root, f"ckpt_{name}"), **kw)


def resume_state(trainer) -> list:
    """A trainer's (or a pipeline trainer's, over every chunk) checkpoint
    tree's parameters, BN statistics and momentum (JAX layout, host
    copies), then its update count and global step."""
    from distributed_model_parallel_tpu_torch.ops.collectives import (
        tree_flatten,
    )

    tree = trainer._ckpt_tree()
    return tree_flatten((tree["params"], tree["batch_stats"],
                         tree["momentum"]))[0] + [int(tree["opt_count"]),
                                                  trainer.global_step]


def resume_mismatches(a: list, b: list) -> int:
    import numpy as np

    return sum(not np.array_equal(x, y) for x, y in zip(a, b, strict=True))


def history_matches(a: list, b: list) -> bool:
    """Epoch 0's record (less the time keys) and epoch 1's eval equal: the
    interrupted epoch's train averages cover only the steps its trainer
    ran, as in the JAX trainer."""
    keys = ("epoch", "loss_train", "acc1_train", "loss_val", "acc1_val")
    return ([h["epoch"] for h in b] == [h["epoch"] for h in a] == [0, 1]
            and all(a[0][k] == b[0][k] for k in keys)
            and all(a[1][k] == b[1][k] for k in ("loss_val", "acc1_val")))


def resume_gate(trainer_mod, tconfig, root, label: str, card, **kw) -> dict:
    """Phase 15b, one input path: run A ``fit(2)``; run B ``fit(2)``
    preempted by a ``step_hook`` at the first step boundary at or after
    step RES_PREEMPT_STEP of epoch 1, then a new ``Trainer(resume=True)``
    finishing it. Gates: B == A bit for bit (parameters, momentum, BN
    statistics, update count, global step, history), the text log."""
    import torch

    phase = "15b/resume"
    a = trainer_mod.Trainer(resume_config(tconfig, root, f"{label}_a", **kw))
    ha = a.fit()
    steps = len(a.train_loader)
    target = steps + RES_PREEMPT_STEP

    def hook(t):
        if t.global_step >= target:
            t.preemption.request()

    cfg = resume_config(tconfig, root, f"{label}_b", **kw)
    b = trainer_mod.Trainer(cfg)
    b.step_hook = hook
    hb = b.fit()
    stopped_at = (b.global_step, b.train_loader.cursor)
    del b
    r = trainer_mod.Trainer(cfg.replace(resume=True))
    hb = hb + r.fit()
    torch.cuda.synchronize()
    bad = resume_mismatches(resume_state(a), resume_state(r))
    same_history = history_matches(ha, hb)
    lines = open(os.path.join(root, "log", f"{label}_b.txt")).read()
    epoch_lines = [x for x in lines.splitlines() if x.startswith("epoch:")]
    preempt_line = (f"preempted: checkpoint saved at epoch 1, global step "
                    f"{stopped_at[0]}") in lines
    print(f"resume {label} [{card}]: MobileNetV2 bf16, B {RES_BATCH}, "
          f"{steps} steps an epoch, preempted at global step "
          f"{stopped_at[0]} (loader cursor {stopped_at[1]}), resumed to "
          f"{r.global_step}; B vs A: {bad} of {len(resume_state(a))} "
          f"arrays differ (parameters, BN statistics, momentum, count, "
          f"step); history equal {same_history}; log: {len(epoch_lines)} "
          f"epoch lines, preemption line {preempt_line}")
    if bad or not same_history:
        fail(phase, f"{label}: the resumed run differs from the "
                    f"uninterrupted one ({bad} arrays, history "
                    f"{same_history})")
    if len(epoch_lines) != 2 or not preempt_line:
        fail(phase, f"{label}: log lines {lines!r}")
    return dict(preempted_at=stopped_at[0], cursor=stopped_at[1],
                steps=r.global_step, best_acc=r.best_acc, trainer=r,
                history_equal=same_history)


def resume_phase(trainer_mod, tconfig, root, card) -> dict:
    """Phase 15b: the resume gate per batch (steps_per_dispatch 1) and
    device-resident at 10 steps a dispatch (a mid-epoch cursor at a
    dispatch boundary), cuDNN deterministic; the best-accuracy slot, the
    torn-version fallback, save and restore times and bytes."""
    import numpy as np
    import torch

    from distributed_model_parallel_tpu_torch.train.checkpoint import (
        PAYLOAD_FILENAME,
        fallback_note,
    )

    phase = "15b/resume"
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    per_batch = resume_gate(trainer_mod, tconfig, root, "per_batch", card)
    resident = resume_gate(trainer_mod, tconfig, root, "resident", card,
                           device_resident_data=True, steps_per_dispatch=10)
    r = per_batch.pop("trainer")
    resident.pop("trainer")
    tmpl = r._ckpt_tree()
    best = r.ckpt.restore(tmpl, "ckpt")
    if float(best["best_acc"]) != np.float32(r.best_acc):
        fail(phase, f"the ckpt slot's best_acc {float(best['best_acc'])} "
                    f"!= the run's {r.best_acc}")
    # Timing: the tree (device to host), the write, the read and load.
    saves, trees, restores = [], [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = r._ckpt_tree()
        t1 = time.perf_counter()
        path = r.ckpt.save(tree, "bench")
        t2 = time.perf_counter()
        restored = r.ckpt.restore(tmpl, "bench")
        r._load_tree(restored)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        trees.append((t1 - t0) * 1e3)
        saves.append((t2 - t1) * 1e3)
        restores.append((t3 - t2) * 1e3)
    nbytes = os.path.getsize(os.path.join(path, PAYLOAD_FILENAME))
    # The torn newest version: truncated, the one before is restored and
    # the fallback logged.
    older = r.ckpt.save(tmpl, "ckpt")
    newest = r.ckpt.save(tmpl, "ckpt")
    p = os.path.join(newest, PAYLOAD_FILENAME)
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) // 2)
    r.ckpt.restore(tmpl, "ckpt", allow_fallback=True,
                   on_fallback=fallback_note(r._log_line))
    log = open(os.path.join(root, "log", "per_batch_b.txt")).read()
    fell_back = (r.ckpt.last_restored_path == older
                 and f"checkpoint fallback: {os.path.basename(newest)} "
                     f"rejected" in log)
    print(f"resume checkpoint [{card}]: {nbytes} B (MobileNetV2 params, "
          f"momentum, BN statistics); tree (device to host) "
          f"{statistics.median(trees)} ms, save {statistics.median(saves)} "
          f"ms, restore + load {statistics.median(restores)} ms (median of "
          f"3); ckpt slot best_acc {float(best['best_acc'])}; torn newest "
          f"{os.path.basename(newest)} -> restored "
          f"{os.path.basename(r.ckpt.last_restored_path)}, logged "
          f"{fell_back}")
    if not fell_back:
        fail(phase, "the torn newest version was not skipped and logged")
    torch.backends.cudnn.deterministic = False
    return dict(per_batch=per_batch, resident=resident, bytes=nbytes,
                tree_ms=trees, save_ms=saves, restore_ms=restores,
                best_acc=float(best["best_acc"]))


def resume_rank(spec, configs, train, evals, preempt_at,
                uninterrupted) -> dict:
    """Phase 15c on one of two ranks: ``workers.preempt_resume`` under
    cuDNN determinism (a spawned rank starts with cuDNN's defaults)."""
    import torch

    from distributed_model_parallel_tpu_torch.parallel import workers

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    out = workers.preempt_resume(spec, configs, train, evals, preempt_at,
                                 uninterrupted)
    out["seconds"] = time.perf_counter() - t0
    return out


def resume_ranks(mesh, tconfig, root, card) -> dict:
    """Phase 15c: the preempt/resume gate at two ranks for ddp and zero
    (gloo on one card, NCCL on two or more): each rank's resumed run ==
    its uninterrupted one bit for bit, and the ranks agree. Beside them an
    uninterrupted gspmd run from the same inputs, which zero's must equal
    per leaf within DPE_RTOL (ZeRO is gspmd's SGD with the momentum
    sharded: a wrong slice, scatter order, mean, decay or rate shows
    there and not in a run compared with itself)."""
    import torch

    from distributed_model_parallel_tpu_torch.data.registry import (
        load_dataset,
    )
    from distributed_model_parallel_tpu_torch.ops.collectives import (
        tree_flatten,
    )

    phase = "15c/resume ranks"
    import numpy as np

    two = torch.cuda.device_count() >= 2
    backend = "nccl" if two else "gloo"
    configs = {s: resume_config(tconfig, root, f"ranks_{s}", strategy=s,
                                mesh=tconfig.MeshConfig(data=2))
               for s in ("ddp", "zero", "gspmd")}
    train, evals = load_dataset(configs["ddp"].data)
    steps = RES_TRAIN // RES_BATCH
    r = dp_spawn(mesh, resume_rank, 2, phase, configs,
                 (train.images, train.labels), (evals.images, evals.labels),
                 steps + RES_PREEMPT_STEP, ("gspmd",), backend=backend,
                 config=tconfig.MeshConfig(data=2))
    out = {"backend": backend, "seconds": [x["seconds"] for x in r]}
    gaps = []
    for x in r:
        za, ga = x["zero"]["a"], x["gspmd"]["a"]
        for key in ("params", "momentum", "state"):
            gaps += [rel_gap(torch.from_numpy(np.asarray(a, np.float32)),
                             torch.from_numpy(np.asarray(b, np.float32)))
                     for a, b in zip(tree_flatten(za[key])[0],
                                     tree_flatten(ga[key])[0], strict=True)]
    print(f"resume zero vs gspmd, 2 ranks over {backend} [{card}]: "
          f"uninterrupted fit(2), max per-leaf max|a - b| / max|b| over "
          f"parameters, momentum and BN statistics {max(gaps)} (bound "
          f"{DPE_RTOL}; {sum(g == 0 for g in gaps)} of {len(gaps)} leaves "
          f"bitwise equal); update count, step "
          f"{[(x['zero']['a']['count'], x['gspmd']['a']['count']) for x in r]}")
    if not max(gaps) <= DPE_RTOL:
        fail(phase, f"zero differs from gspmd: {max(gaps)} > {DPE_RTOL}")
    out["zero_vs_gspmd_max_rel"] = max(gaps)
    for s in ("ddp", "zero"):
        leaves = [[tree_flatten((x[s][run]["params"], x[s][run]["momentum"],
                                 x[s][run]["state"]))[0] for run in "ab"]
                  for x in r]
        bad = [resume_mismatches(a, b) for a, b in leaves]
        across = resume_mismatches(leaves[0][1], leaves[1][1])
        counts = [(x[s]["b"]["count"], x[s]["b"]["step"]) for x in r]
        same_history = all(history_matches(x[s]["a"]["history"],
                                           x[s]["b"]["history"]) for x in r)
        print(f"resume {s}, 2 ranks over {backend} [{card}]: arrays "
              f"differing resumed vs uninterrupted {bad} (of "
              f"{len(leaves[0][0])}) per rank; rank 0's resumed arrays "
              f"vs rank 1's: {across} differ; update count, step "
              f"{counts} (want {2 * steps}); history equal {same_history}")
        if any(bad) or not same_history or any(
                c != (2 * steps, 2 * steps) for c in counts):
            fail(phase, f"{s}: the resumed runs differ")
        params = [tree_flatten(x[s]["b"]["params"])[0] for x in r]
        if resume_mismatches(*params):
            fail(phase, f"{s}: the ranks' parameters differ")
        out[s] = dict(differing=bad, rank_params_equal=True,
                      steps=counts[0][1])
    return out


def harness_summary(harness: dict) -> dict:
    """Phase 15's numbers for the JSON line (no per-step losses)."""
    zoo = {name: {k: v for k, v in row.items() if k != "losses"}
           for name, row in harness["zoo"]["models"].items()}
    return {"zoo": zoo, "resume": harness["resume"],
            "resume_ranks": harness["resume_ranks"]}


def harness_phase(laps, trainer_mod, fs, models, staged, mesh, tconfig,
                  card) -> dict:
    """Phase 15 (15a zoo, 15b resume, 15c resume at two ranks), its
    temporary logs and checkpoints removed after."""
    import tempfile

    with tempfile.TemporaryDirectory(dir=HERE) as root:
        zoo = zoo_phase(trainer_mod, fs, models, staged, tconfig, root, card)
        laps.done("15a/zoo")
        fs.fused_sgd_kernel.launches = 0
        fs.plain_sgd_kernel.launches = 0
        resume = resume_phase(trainer_mod, tconfig, root, card)
        resume["launches"] = {"fused_sgd": fs.fused_sgd_kernel.launches,
                              "plain_sgd": fs.plain_sgd_kernel.launches}
        laps.done("15b/resume")
        ranks = resume_ranks(mesh, tconfig, root, card)
        laps.done("15c/resume ranks")
    return {"zoo": zoo, "resume": resume, "resume_ranks": ranks}


def ft_config(tconfig):
    """Phase 16a: the reference's finetune recipe (FT_*)."""
    return tconfig.TrainConfig(
        model=tconfig.ModelConfig(name="mobilenetv2", dtype="bfloat16",
                                  extra={"input_layout": "imagenet"}),
        data=tconfig.DataConfig(
            name="synthetic", batch_size=FT_BATCH, eval_batch_size=FT_BATCH,
            image_size=FT_PX, synthetic_native_size=32,
            synthetic_train_size=4 * FT_BATCH, synthetic_eval_size=FT_BATCH),
        optimizer=tconfig.OptimizerConfig(learning_rate=FT_LR, momentum=0.9,
                                          weight_decay=1e-4, warmup_steps=10,
                                          fused=True),
        device_resident_data=True, steps_per_dispatch=CNN_SPD,
        device="cuda", **run_dirs("finetune"))


def ft_kind(key: str) -> str:
    """cnn_kind, with the resize's kernels (F.interpolate) apart."""
    if "upsample" in key.lower() or "interpolate" in key.lower():
        return "resize (F.interpolate)"
    return cnn_kind(key)


def finetune(trainer_mod, fs, loader_mod, card) -> dict:
    """Phase 16a: the finetune recipe through ``Trainer.run_steps`` at
    bench.py's timing shape, every step resizing its 32 px rows to 224 px
    on the card: samples/s, step s, MFU (3 x FlopCounterMode's forward at
    224 px), peak memory; fused_sgd == steps x buckets, counted from 0
    over the timed steps; one profiled step with the resize's share of
    device time; the resize on the card against its CPU run on the same
    batch."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from distributed_model_parallel_tpu_torch import config as tconfig

    phase = "16a/finetune"
    torch.backends.cudnn.benchmark = True
    n_disp = CNN_TIMED_STEPS // CNN_SPD
    idxs = cnn_dispatch_indices(4 * FT_BATCH, CNN_WARM_DISPATCHES + n_disp,
                                FT_BATCH)
    trainer = trainer_mod.Trainer(ft_config(tconfig))
    for ix in idxs[:CNN_WARM_DISPATCHES]:
        trainer.run_steps(ix)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fs.fused_sgd_kernel.launches = 0
    fs.plain_sgd_kernel.launches = 0
    t0 = time.perf_counter()
    ms = [trainer.run_steps(ix) for ix in idxs[CNN_WARM_DISPATCHES:]]
    losses = torch.cat([m["loss"] for m in ms]).cpu().tolist()
    dt = time.perf_counter() - t0
    launches = fs.fused_sgd_kernel.launches
    plain = fs.plain_sgd_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    steps = n_disp * CNN_SPD
    want = steps * len(trainer.optimizer.buckets)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        trainer.model.apply(torch.zeros(FT_BATCH, FT_PX, FT_PX, 3,
                                        dtype=trainer.dtype,
                                        device=trainer.device),
                            train=False)
    flops = 3 * counter.get_total_flops()
    step_s = dt / steps
    rec = dict(steps=steps, step_s=step_s,
               samples_per_s=FT_BATCH * steps / dt,
               mfu=flops / step_s / BF16_FLOPS_PER_S, flop_per_step=flops,
               peak_bytes=peak, fused_sgd=launches, plain_sgd=plain,
               want=want,
               losses=losses)
    print(f"finetune [{card}]: MobileNetV2 ImageNet layout, bf16, B "
          f"{FT_BATCH} of 32 px rows resized to {FT_PX} px on the card, "
          f"FusedSGD lr {FT_LR}, {steps} steps (after "
          f"{CNN_WARM_DISPATCHES} warm-up dispatches of {CNN_SPD}), one "
          f"sync: samples/s {rec['samples_per_s']}, step {step_s} s, MFU "
          f"({flops} flop per step / step s / {BF16_FLOPS_PER_S:.0f}) "
          f"{rec['mfu']}, torch.cuda.max_memory_allocated {peak} B; "
          f"fused_sgd launches {launches} (want steps x buckets = {want}), "
          f"plain_sgd {plain} (want 0); losses {losses[:3]} .. {losses[-3:]}")
    if (launches != want or plain
            or not all(math.isfinite(x) for x in losses)):
        fail(phase, f"fused_sgd launches {launches} != {want}, plain_sgd "
                    f"{plain} != 0 or non-finite losses")
    rows = print_profile("finetune step", lambda: f"loss "
                         f"{trainer.run_steps(idxs[-1][:1])['loss'].item()}",
                         card, kind=ft_kind)
    busy = sum(r[1] for r in rows)
    resize_us = sum(r[1] for r in rows if ft_kind(r[0]).startswith("resize"))
    rec["resize_us_profiled"] = resize_us if rows else None
    rec["device_busy_us_profiled"] = busy if rows else None
    # The resize alone by CUDA events (the profiler's kernel list has
    # missed it in one run of two): one step's batch, median of 30.
    x = trainer.dev_images[:FT_BATCH].view(FT_BATCH, 32, 32, 3)
    rec["resize_ms"] = time_ms(lambda: loader_mod.resize_batch(x, FT_PX))
    rec["resize_share_of_step"] = rec["resize_ms"] / (step_s * 1e3)
    print(f"finetune resize [{card}]: {rec['resize_ms']} ms a step by CUDA "
          f"events (median of 30), {rec['resize_share_of_step']} of the "
          f"step; the profiled step: {resize_us} us of {busy} us device "
          f"time")
    # The resize on the card against its CPU run, the same batch.
    gpu = loader_mod.resize_batch(x, FT_PX).cpu().numpy()
    cpu = loader_mod.resize_batch(x.cpu(), FT_PX).numpy()
    as_float = lambda t: torch.nn.functional.interpolate(
        t.permute(0, 3, 1, 2).float(), size=(FT_PX, FT_PX), mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1).cpu().numpy()
    fg, fc = as_float(x), as_float(x.cpu())
    err = float(np.abs(fg - fc).max())
    away = np.abs(np.abs(fc - np.floor(fc)) - 0.5) > FT_TIE
    differ = int((gpu != cpu)[away].sum())
    print(f"finetune resize card vs CPU [{card}]: float max_abs_err {err} "
          f"(atol {FT_RESIZE_ATOL}), uint8 differing away from .5 ties "
          f"{differ} of {int(away.sum())} ({int((gpu != cpu).sum())} in "
          f"all)")
    if err > FT_RESIZE_ATOL or differ:
        fail(phase, f"the resize on the card differs from the CPU's: "
                    f"{err}, {differ}")
    rec.update(resize_max_abs_err=err, resize_uint8_differing=differ)
    del trainer
    torch.cuda.empty_cache()
    return rec


def host_path(trainer_mod, tconfig, root, card) -> dict:
    """Phase 16b: one epoch of 15b's workload on the per-batch host path,
    four times in turn — both prefetch stages off, on (depth 2), on, off
    — cuDNN deterministic: every run's parameters, momentum, BN
    statistics and history bit for bit the first's; per run the trainer's
    data time a step (JAX's measure: from one batch's arrival to the
    next, the step's host enqueue in it) and the fetch a step (the time
    inside the input stream's ``next()``, median over the epoch)."""
    import dataclasses

    import torch

    phase = "16b/host path"
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    runs = []
    for k, depth in enumerate((0, 2, 2, 0)):
        cfg = resume_config(tconfig, root, f"host_{k}")
        cfg = cfg.replace(epochs=1, data=dataclasses.replace(
            cfg.data, prefetch=depth, device_prefetch=depth))
        t = trainer_mod.Trainer(cfg)
        fetch: list = []
        stream = t._input_stream

        def timed(loader, stream=stream, fetch=fetch):
            it, times = iter(stream(loader)), []
            fetch.append(times)
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                times.append(time.perf_counter() - t0)
                yield batch

        t._input_stream = timed
        hist = t.fit()
        torch.cuda.synchronize()
        runs.append(dict(depth=depth, state=resume_state(t), history=hist,
                         data_s_per_step=hist[0]["time_load_per_batch"],
                         step_s=hist[0]["time_per_batch"],
                         fetch_s_per_step=statistics.median(fetch[0])))
        del t
    keys = ("loss_train", "acc1_train", "loss_val", "acc1_val")
    bad = [resume_mismatches(runs[0]["state"], r["state"]) for r in runs]
    same = all(r["history"][0][k] == runs[0]["history"][0][k]
               for r in runs for k in keys)
    n = len(runs[0]["state"])
    for r in runs:
        del r["state"], r["history"]
    print(f"host path [{card}]: MobileNetV2 bf16, B {RES_BATCH}, one epoch "
          f"per batch, runs prefetch/device_prefetch 0, 2, 2, 0: arrays "
          f"differing from the first run {bad} (of "
          f"{n}), history equal {same}; "
          f"fetch a step (s, median) "
          f"{[r['fetch_s_per_step'] for r in runs]}; the trainer's data "
          f"time a step {[r['data_s_per_step'] for r in runs]}, step "
          f"{[r['step_s'] for r in runs]}")
    if any(bad) or not same:
        fail(phase, "the prefetch stages changed the result")
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = bench
    return {"runs": runs, "bitwise": True}


def native_gather(native, card) -> dict:
    """Phase 16c: the C++ row gather (built here by the host compiler)
    against numpy indexing at batch FT_GATHER_BATCH of FT_GATHER_ROWS
    CIFAR-shaped uint8 rows: every batch bit for bit; µs a batch of each
    (median of FT_GATHER_REPS) at 1, 2 (DataConfig's num_workers) and 4
    threads."""
    import numpy as np

    rng = np.random.default_rng(0)
    src = rng.integers(0, 256, (FT_GATHER_ROWS, 32, 32, 3), np.uint8)
    idx = rng.integers(0, FT_GATHER_ROWS, (FT_GATHER_REPS, FT_GATHER_BATCH))
    t0 = time.perf_counter()
    try:
        native.load()
    except RuntimeError as e:
        fail("16c/native gather", str(e))
    build_s = time.perf_counter() - t0
    times = {1: [], 2: [], 4: [], "numpy": []}
    differ = 0
    for ix in idx:
        t0 = time.perf_counter()
        want = src[ix]
        times["numpy"].append((time.perf_counter() - t0) * 1e6)
        for n in (1, 2, 4):
            t0 = time.perf_counter()
            got = native.gather_rows(src, ix, n_threads=n)
            times[n].append((time.perf_counter() - t0) * 1e6)
            differ += int(not np.array_equal(got, want))
    us = {str(k): statistics.median(v) for k, v in times.items()}
    print(f"native gather [{card} host]: batch {FT_GATHER_BATCH} of "
          f"{FT_GATHER_ROWS} rows of 32x32x3 uint8, {FT_GATHER_REPS} "
          f"batches: us a batch (median) native at 1/2/4 threads "
          f"{us['1']} / {us['2']} / {us['4']}, numpy {us['numpy']}; "
          f"{differ} batches differ; build/load {build_s} s")
    if differ:
        fail("16c/native gather", f"{differ} batches differ from numpy's")
    return {"us": us, "differing": differ, "build_s": build_s}


def data_path_phase(laps, trainer_mod, fs, tconfig, card) -> dict:
    """Phase 16: the finetune recipe on the card, the host path's
    prefetch stages, the native gather."""
    import tempfile

    from distributed_model_parallel_tpu_torch.data import loader, native

    out = {"finetune": finetune(trainer_mod, fs, loader, card)}
    laps.done("16a/finetune")
    with tempfile.TemporaryDirectory(dir=HERE) as root:
        out["host"] = host_path(trainer_mod, tconfig, root, card)
    laps.done("16b/host path")
    out["gather"] = native_gather(native, card)
    laps.done("16c/native gather")
    return out


class Laps:
    """Prints each phase's seconds since the previous phase ended."""

    def __init__(self):
        self.mark = time.perf_counter()

    def done(self, phase: str) -> None:
        now = time.perf_counter()
        print(f"phase {phase}: {now - self.mark:.2f} s")
        self.mark = now


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sgd-timing-only", action="store_true",
                    help="run phases 1, 2 (the fused SGD kernel only) and "
                         "10, print their JSON line and stop: the phase-10 "
                         "measure run against another checkout's port "
                         "(copy this script into it)")
    ap.add_argument("--pipeline-only", action="store_true",
                    help="run phases 1, 2 (the fused SGD kernel only) and "
                         "13, print the pipeline's JSON line and stop: with "
                         "four cards, each stage of the runner on its own "
                         "card and the SPMD engine over NCCL")
    ap.add_argument("--harness-only", action="store_true",
                    help="run phases 1, 2 (the fused SGD kernel only) and "
                         "15 (the zoo, resume, resume at two ranks), print "
                         "the harness's JSON line and stop")
    ap.add_argument("--data-only", action="store_true",
                    help="run phases 1, 2 (the fused SGD kernel only) and "
                         "16 (the finetune recipe at 224 px, the host "
                         "path's prefetch stages, the native gather), print "
                         "the data path's JSON line and stop")
    ap.add_argument("--dp-only", action="store_true",
                    help="run phases 1, 2 (the fused SGD kernel only) and "
                         "14b at world = device_count() over NCCL, print "
                         "the DP engines' JSON line and stop: with four "
                         "cards, BASELINE's pair (samples/s a card, the "
                         "gradient reduction's us a step) per engine")
    args = ap.parse_args()
    only = (args.sgd_timing_only or args.pipeline_only or args.dp_only
            or args.harness_only or args.data_only)
    import atexit
    import shutil
    import tempfile

    os.environ[RUN_DIR_ENV] = tempfile.mkdtemp(prefix=".chip_smoke_run_",
                                               dir=HERE)
    atexit.register(shutil.rmtree, os.environ[RUN_DIR_ENV], True)
    # -- phase 1: device ----------------------------------------------------
    laps = Laps()
    import torch

    if not torch.cuda.is_available():
        fail("1/device", "torch.cuda.is_available() is False")
    sys.path.insert(0, HERE)
    try:
        import distributed_model_parallel_tpu_torch as port
    except ImportError as e:
        fail("1/device", f"the port package is not beside this script "
                         f"({e}); run from a checkout of the repository")
    if not os.path.abspath(port.__file__).startswith(HERE + os.sep):
        fail("1/device", f"the port was imported from {port.__file__}, "
                         f"not from this checkout")
    from distributed_model_parallel_tpu_torch.models import (
        transformer as tfm,
    )
    from distributed_model_parallel_tpu_torch.ops import _build
    from distributed_model_parallel_tpu_torch.ops import (
        flash_attention as fa,
    )
    from distributed_model_parallel_tpu_torch.ops import (
        paged_attention as pa,
    )
    from distributed_model_parallel_tpu_torch.serve import (
        Engine,
        ServeConfig,
    )
    from distributed_model_parallel_tpu_torch.serve.model import (
        decode_logits,
        prefill_logits,
    )
    from distributed_model_parallel_tpu_torch.serve.paged_kv import (
        PagedKVCache,
    )
    from distributed_model_parallel_tpu_torch.train import (
        lm_trainer as lm,
    )
    from distributed_model_parallel_tpu_torch.utils.profiling import (
        lm_model_flops,
    )
    from distributed_model_parallel_tpu_torch import config as tconfig
    from distributed_model_parallel_tpu_torch import models
    from distributed_model_parallel_tpu_torch.models import staged
    from distributed_model_parallel_tpu_torch.ops import fused_sgd as fs
    from distributed_model_parallel_tpu_torch.train import optim
    from distributed_model_parallel_tpu_torch.train import (
        trainer as cnn_trainer,
    )

    card = card_line()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("set torch.backends.cuda.matmul.allow_tf32=False, "
          "torch.backends.cudnn.allow_tf32=False")
    laps.done("1/device")

    # -- phase 2: build -----------------------------------------------------
    t = time.perf_counter()
    try:
        paths = _build.build_all(("fused_sgd",) if only
                                 else _build.KERNELS)
    except RuntimeError as e:
        fail("2/build", str(e))
    print(f"built {len(paths)} kernel(s) in {time.perf_counter() - t:.2f} s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "warning",
                                       "Performance Loss")):
                print(f"  {name}: {line.strip()}")
    laps.done("2/build")
    if args.sgd_timing_only:
        mnv2 = [p.detach() for p in models.get_model(
            tconfig.ModelConfig(), device="cuda").parameters()]
        print(json.dumps({"sgd_timing": time_fused_sgd(
            fs, optim, tconfig, mnv2, card)}))
        laps.done("10/fused sgd timing")
        return
    if args.pipeline_only:
        torch.backends.cudnn.benchmark = True      # as phase 11 leaves it
        print(json.dumps({"pipeline": pipeline_phase(
            laps, models, cnn_trainer, fs, tconfig, card), "card": card}))
        return
    if args.harness_only:
        from distributed_model_parallel_tpu_torch import mesh

        print(json.dumps({"harness": harness_summary(harness_phase(
            laps, cnn_trainer, fs, models, staged, mesh, tconfig, card)),
            "card": card}))
        return
    if args.data_only:
        print(json.dumps({"data_path": data_path_phase(
            laps, cnn_trainer, fs, tconfig, card), "card": card}))
        return
    if args.dp_only:
        from distributed_model_parallel_tpu_torch import mesh

        print(json.dumps({"dp_engines": dp_engines(
            mesh, card, torch.cuda.device_count(), "nccl"), "card": card}))
        laps.done("14b/dp engines")
        return

    # -- phase 3: kernel vs plain ---------------------------------------------
    page, n, n_pool, dh = 16, 40, GEOMETRY["n_pages"], 128
    spread = [0, 639, 15, 16, 100, 255, 383, 512]
    # On page (16 tokens) and split (4 pages) edges, and the longest row.
    edges = [63, 64, 127, 128, 0, 639, 255, 256]
    cases = {
        "mha": dict(b=8, h=8, hkv=8, window=None, positions=spread),
        "gqa": dict(b=8, h=8, hkv=2, window=None, positions=spread),
        "window64": dict(b=8, h=8, hkv=8, window=64, positions=spread),
        "edges": dict(b=8, h=8, hkv=8, window=None, positions=edges),
        "window64_edges": dict(b=8, h=8, hkv=8, window=64, positions=edges),
        "window100": dict(b=8, h=8, hkv=8, window=100, positions=spread),
        "gqa_g8_edges": dict(b=8, h=8, hkv=1, window=None, positions=edges),
        "long_row_b1": dict(b=1, h=8, hkv=8, window=None, positions=[639]),
    }
    max_err = 0.0
    for i, (label, c) in enumerate(cases.items()):
        q, kp, vp, tables, pos = make_case(c["b"], c["h"], c["hkv"], dh, page,
                                           n, n_pool, c["positions"], seed=i)
        got = pa.paged_attention_kernel(q, kp, vp, tables, pos,
                                        window=c["window"])
        want = pa.paged_attention_gather(
            q.float(), kp.float(), vp.float(), tables, pos[:, None],
            pos + 1, c["window"]).to(torch.bfloat16)
        # A row's output must not depend on the batch: each row alone (B 1)
        # equals its row of the batched call, bit for bit.
        alone = [pa.paged_attention_kernel(q[r:r + 1], kp, vp,
                                           tables[r:r + 1], pos[r:r + 1],
                                           window=c["window"])
                 for r in range(c["b"])]
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail("3/kernel", f"{label}: non-finite kernel output")
        err = (got.float() - want.float()).abs().max().item()
        bitwise = all(torch.equal(x, got[r:r + 1])
                      for r, x in enumerate(alone))
        print(f"paged_decode {label}: max_abs_err {err} (atol {KERNEL_ATOL});"
              f" each row alone == its row in the batch: {bitwise}")
        if not err <= KERNEL_ATOL:
            fail("3/kernel", f"{label}: max_abs_err {err} > {KERNEL_ATOL}")
        if not bitwise:
            fail("3/kernel", f"{label}: a row's output depends on the batch")
        max_err = max(max_err, err)

    laps.done("3/kernel")

    # -- phase 4: timing ------------------------------------------------------
    q, kp, vp, tables, pos = make_case(8, 8, 8, dh, page, n, n_pool, spread,
                                       seed=0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    ms = time_ms(lambda: pa.paged_attention_kernel(q, kp, vp, tables, pos),
                 flush=flush)
    r = spread.index(max(spread))                            # pos 639 alone
    ms_b1 = time_ms(lambda: pa.paged_attention_kernel(
        q[r:r + 1], kp, vp, tables[r:r + 1], pos[r:r + 1]), flush=flush)
    plain_ms = time_ms(lambda: pa.paged_attention_gather(
        q, kp, vp, tables, pos[:, None], pos + 1), flush=flush)
    t_all = n * page
    kr = kp[tables.long()].reshape(8, t_all, 8, dh).transpose(1, 2)
    vr = vp[tables.long()].reshape(8, t_all, 8, dh).transpose(1, 2)
    kr, vr = kr.contiguous(), vr.contiguous()
    qh = q.transpose(1, 2).contiguous()                      # [B, H, 1, Dh]
    mask = (torch.arange(t_all, device="cuda")[None, :]
            <= pos[:, None])[:, None, None, :]               # [B,1,1,T]
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kr, vr, attn_mask=mask), flush=flush)
    tokens_read = sum(p + 1 for p in spread)
    elt = 2                                                  # bf16 bytes
    bytes_moved = (2 * tokens_read * 8 * dh * elt            # K and V read
                   + 2 * q.numel() * elt                     # q in, out
                   + tables.numel() * 4 + pos.numel() * 4)
    flops = 4 * tokens_read * 8 * dh                         # q.k and p.v
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    print(f"paged_decode timing [{card}]: kernel {ms} ms (split + merge), "
          f"plain {plain_ms} ms, sdpa {library_ms} ms, bound {bound_ms} ms "
          f"({bound_by}: {bytes_moved} B, {flops} flop); ms / library_ms "
          f"{ms / library_ms:.3f}, {bound_ms / ms:.1%} of bound; the longest "
          f"row alone (B 1, pos {spread[r]}) {ms_b1} ms")
    del flush, kr, vr
    laps.done("4/timing")

    # -- phase 5: engine at full width ----------------------------------------
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, **MODEL)
    params = tfm.init_params(cfg, seed=0, device="cuda")
    serve = ServeConfig(policy="continuous", **GEOMETRY)
    import numpy as np

    rng = np.random.default_rng(1234)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(16, 97)))
               .tolist() for _ in range(8)]
    gens = [int(g) for g in rng.integers(16, 65, 8)]

    warm = Engine(params, cfg, serve)                 # cuBLAS/allocator warm-up
    warm.submit(prompts[0][:16], 4)
    warm.run()
    del warm

    eng = Engine(params, cfg, serve)
    reqs = [eng.submit(p, g, seed=i) for i, (p, g) in
            enumerate(zip(prompts, gens))]
    pa.paged_attention_kernel.launches = 0
    summary = eng.run()
    launches = pa.paged_attention_kernel.launches
    torch.cuda.synchronize()
    if not all(r.state.value == "completed" for r in reqs):
        fail("5/engine", f"requests not completed: "
                         f"{[(r.rid, r.state.value, r.error) for r in reqs]}")
    if [len(r.generated) for r in reqs] != gens:
        fail("5/engine", "a request generated the wrong number of tokens")
    if any(not (0 <= t < cfg.vocab_size) for r in reqs for t in r.generated):
        fail("5/engine", "a generated token is outside the vocabulary")
    want_launches = cfg.n_layers * summary["decode_steps"]
    print(f"engine: {summary['requests_completed']} requests, "
          f"{summary['decode_steps']} decode steps, paged_decode launches "
          f"{launches} (want n_layers x decode steps = {want_launches})")
    if launches != want_launches:
        fail("5/engine", f"kernel launches {launches} != {want_launches}")

    solo_idx = 3
    solo = Engine(params, cfg, serve)
    sr = solo.submit(prompts[solo_idx], gens[solo_idx], seed=solo_idx)
    solo.run()
    if sr.generated != reqs[solo_idx].generated:
        fail("5/engine", "request tokens depend on batch composition: "
                         f"solo {sr.generated} vs batch "
                         f"{reqs[solo_idx].generated}")
    print(f"engine: request {solo_idx} solo == in batch "
          f"({len(sr.generated)} tokens, bitwise)")

    # First decode step of all 8 requests, kernel vs plain attention.
    cache = PagedKVCache(cfg, n_pages=serve.n_pages,
                         page_size=serve.page_size,
                         max_seq_len=serve.max_seq_len, device="cuda")
    geo = dict(page_size=serve.page_size, n_pages=serve.n_pages,
               device=torch.device("cuda"))
    tables_np = np.zeros((8, cache.pages_per_seq), np.int32)
    first, positions = [], []
    for i, (p, g) in enumerate(zip(prompts, gens)):
        cache.try_admit(i, len(p) + g)
        tables_np[i] = cache.table_array(i)
        c = serve.prefill_chunk
        for lo in range(0, len(p), c):
            chunk = np.zeros((1, c), np.int64)
            nv = min(c, len(p) - lo)
            chunk[0, :nv] = p[lo:lo + nv]
            logits = prefill_logits(params, cache.ck, cache.cv, chunk, lo,
                                    nv, tables_np[i], cfg, impl="kernel",
                                    **geo)
        first.append(int(logits.argmax(-1)[0]))
        positions.append(len(p))
    active = np.ones(8, bool)
    ck2, cv2 = cache.ck.clone(), cache.cv.clone()
    lk = decode_logits(params, cache.ck, cache.cv, first, positions,
                       tables_np, active, cfg, impl="kernel", **geo)
    lp = decode_logits(params, ck2, cv2, first, positions, tables_np,
                       active, cfg, impl="plain", **geo)
    torch.cuda.synchronize()
    if [r.generated[0] for r in reqs] != first:
        fail("5/engine", "the engine's first tokens differ from the model "
                         "steps' own prefill")
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        fail("5/engine", "non-finite decode logits")
    lerr = (lk.float() - lp.float()).abs().max().item()
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    print(f"engine: first decode step logits kernel vs plain max_abs_err "
          f"{lerr} (atol {LOGITS_ATOL}; |logits| max "
          f"{lp.float().abs().max().item()}), argmax agreement {agree}")
    if not lerr <= LOGITS_ATOL:
        fail("5/engine", f"logits max_abs_err {lerr} > {LOGITS_ATOL}")

    print(f"engine [{card}]: tokens/s {summary['tokens_per_s']}, "
          f"TTFT p50 {summary['ttft_s']['p50']} s p99 "
          f"{summary['ttft_s']['p99']} s, per-token latency p50 "
          f"{summary['token_latency_s']['p50']} s, "
          f"{summary['tokens_generated']} tokens in {summary['wall_s']} s")
    profile_engine(Engine, params, cfg, serve, prompts, gens, card)
    del params, cache, ck2, cv2, lk, lp, eng, solo
    torch.cuda.empty_cache()
    laps.done("5/engine")

    # -- phase 6: flash kernels vs plain --------------------------------------
    flash_errs = check_flash(fa)
    laps.done("6/flash")

    # -- phase 7: flash timing ------------------------------------------------
    flash_times = time_flash(fa, card)
    laps.done("7/flash timing")

    # -- phase 8: trainer at full width ---------------------------------------
    check_training(tfm, lm, fa)
    laps.done("8a/train check")
    flash_launches = train_full_width(tfm, lm, fa, lm_model_flops, card)
    laps.done("8b-c/trainer")

    # -- phases 9-10: fused SGD kernels vs plain, timing ----------------------
    mnv2 = [p.detach() for p in models.get_model(
        tconfig.ModelConfig(), device="cuda").parameters()]
    print(f"MobileNetV2 (CIFAR): {len(mnv2)} leaves, "
          f"{sum(p.numel() for p in mnv2)} parameters")
    sgd_err = check_fused_sgd(fs, optim, tconfig, mnv2, card)
    laps.done("9/fused sgd")
    sgd_times = time_fused_sgd(fs, optim, tconfig, mnv2, card)
    del mnv2
    laps.done("10/fused sgd timing")

    # -- phase 11: CNN trainer at full width ----------------------------------
    torch.backends.cudnn.benchmark = True
    print("set torch.backends.cudnn.benchmark=True")
    check_cnn_step(cnn_trainer, models, staged, tconfig)
    laps.done("11a/cnn check")
    sgd_launches, sgd_in_step = train_cnn(cnn_trainer, fs, tconfig, card)
    laps.done("11b-c/cnn trainer")

    # -- phase 12: data parallelism over the port's process group ------------
    from distributed_model_parallel_tpu_torch import mesh

    dp = data_parallel(mesh, cnn_trainer, tconfig, card)
    laps.done("12/data parallel")

    # -- phase 13: the pipeline -----------------------------------------------
    pp = pipeline_phase(laps, models, cnn_trainer, fs, tconfig, card)
    pp_launches = {k: sum(r[k] for r in pp["runner"].values())
                   for k in ("fused_sgd", "plain_sgd")}

    # -- phase 14: ResNet and the remaining data-parallel engines ------------
    torch.backends.cudnn.benchmark = True
    resnet = train_resnet(cnn_trainer, fs, models, staged, tconfig, card)
    laps.done("14a/resnet")
    two_cards = torch.cuda.device_count() >= 2
    dpe = dp_engines(mesh, card, 2, "nccl" if two_cards else "gloo")
    laps.done("14b/dp engines")

    # -- phase 15: the zoo, checkpoint/resume, preemption, logs ------------
    harness = harness_phase(laps, cnn_trainer, fs, models, staged, mesh,
                            tconfig, card)

    # -- phase 16: the data path: the finetune recipe, prefetch, gather -----
    data_path = data_path_phase(laps, cnn_trainer, fs, tconfig, card)

    kernels = [{
        "name": "paged_decode",
        "route": "cuda",
        "source": "distributed_model_parallel_tpu_torch/ops/csrc/"
                  "paged_decode.cu",
        "replaces": "distributed_model_parallel_tpu/ops/paged_attention.py"
                    ":115",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "ms_b1_long_row": ms_b1,
    }]
    for name, line in (("flash_fwd", 112), ("flash_bwd_dq", 199),
                       ("flash_bwd_dkv", 278)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"distributed_model_parallel_tpu_torch/ops/csrc/"
                      f"{name}.cu",
            "replaces": f"distributed_model_parallel_tpu/ops/"
                        f"pallas_attention.py:{line}",
            "launches": flash_launches[name],
            "max_abs_err": flash_errs[name][0],
            "max_row_rel_err": flash_errs[name][1],
            **flash_times[name],
        })
    for name, line in (("fused_sgd", 64), ("plain_sgd", 80)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "distributed_model_parallel_tpu_torch/ops/csrc/"
                      "fused_sgd.cu",
            "replaces": f"distributed_model_parallel_tpu/ops/"
                        f"pallas_optim.py:{line}",
            "launches": sgd_launches[name],
            "launches_12a_gspmd": dp["gspmd"][f"{name}_launches"],
            "launches_13a_pipeline": pp_launches[name],
            "launches_14a_resnet50": (
                resnet["launches"]["fused_sgd"] if name == "fused_sgd"
                else resnet["launches_momentum0"]["plain_sgd"]),
            "launches_14b_zero_rank0": dpe[
                "zero_fused" if name == "fused_sgd" else
                "zero_momentum0"]["launches"][0][name],
            "launches_15a_zoo": (
                sum(r["launches"]["fused_sgd"]
                    for r in harness["zoo"]["models"].values())
                if name == "fused_sgd" else harness["zoo"][
                    "efficientnetb0_momentum0"]["launches"]["plain_sgd"]),
            "launches_15b_resume": harness["resume"]["launches"][name],
            "launches_13c_pipeline_resume": pp["resume"][name],
            "launches_13d_spmd_resume_per_rank": pp["spmd_resume"][name],
            "launches_16a_finetune": data_path["finetune"][name],
            "max_abs_err": sgd_err,
            **sgd_times[name],
            "in_step_us": sgd_in_step[name],
        })
    print(json.dumps({"data_parallel": dp, "card": card}))
    print(json.dumps({"pipeline": pp, "card": card}))
    print(json.dumps({"resnet": resnet, "card": card}))
    print(json.dumps({"dp_engines": dpe, "card": card}))
    print(json.dumps({"harness": harness_summary(harness), "card": card}))
    print(json.dumps({"data_path": data_path, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
