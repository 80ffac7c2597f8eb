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
   through the kernels against the plain version per leaf; launches ==
   updates x buckets;
10. fused SGD timing — each variant's one-bucket update: kernel, plain
    version, ``torch.optim.SGD(fused=True)`` over the 173 leaves (the
    library yardstick, never used by the port) and the byte bound, CUDA
    events, L2 flushed before each run;
11. CNN trainer — bench.py's CNN workload with the fused optimizer
    (MobileNetV2, batch 512, bf16 over f32, device-resident, 10 steps per
    dispatch, cuDNN autotuner on): (a) two steps through the fused kernel
    against ``torch.optim.SGD`` from the same weights and batches; (b)
    bench.py's timing shape — 2 warm-up dispatches, 50 steps, one sync —
    with samples/s, step time, MFU and peak memory (fused_sgd launches
    == steps x buckets, parameters and BN statistics changed), then 20
    steps with momentum 0 (plain_sgd launches == steps) and 20 with
    ``fused=False``; (c) one step under ``torch.profiler``.

Prints the card line, each phase's seconds, the ``{"kernels": [...]}``
line and, last, ``{"ok": true, "device": {...}}``. Exits non-zero
without a card, or when run outside a checkout of the repository.
"""

from __future__ import annotations

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
# Kernel vs plain, max|a - b| / max|b| over p and m: the kernel rounds each
# product and sum on its own (__fmul_rn/__fadd_rn), as the plain version's
# eager ops do, so the two agree bit for bit; 1e-6 (~8 f32 ulp) leaves
# room for nothing but an FMA contraction creeping into either side.
SGD_RTOL = 1e-6

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


def fail(phase: str, msg: str) -> None:
    print(f"chip_smoke: phase {phase} FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def print_profile(label: str, run, card, kind=lm_kind) -> None:
    """``run()`` under ``torch.profiler``: device time by kernel and the
    device's busy share of the run's wall time (kernels run on one
    stream, so their times add), then by ``kind(kernel name)``. ``run``
    returns a note for the summary line. Informational: a profile without
    device events prints "not measured"."""
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
        return
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


def check_fused_sgd(fs, optim, tconfig, model_params) -> float:
    """Phase 9: ``FusedSGD`` on the card (the kernels, one bucket; and a
    cap that gives several) against the plain version per leaf, 5 updates
    of each variant under a warm-up/cosine schedule. Returns the largest
    max-abs error of p and m."""
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
            errs.append(((p - rp).abs().max().item(), rp.abs().max().item()))
            if rm is not None:
                m = opt.momentum_buffer(j)
                errs.append(((m - rm).abs().max().item(),
                             rm.abs().max().item()))
        err = max(e for e, _ in errs)
        rel = err / max(r for _, r in errs)
        finite = all(torch.isfinite(p).all() for p in opt.params)
        print(f"fused_sgd {label}: {len(opt.buckets)} bucket(s), "
              f"{launched} launches (want {want}), max_abs_err {err}, "
              f"max|a-b|/max|b| {rel:.3e} (rtol {SGD_RTOL}, p and m over "
              f"{len(leaves)} leaves)")
        if launched != want:
            bad.append(f"{label}: {launched} launches != {want}")
        if not finite or not rel <= SGD_RTOL:
            bad.append(f"{label}: rel err {rel} > {SGD_RTOL} or non-finite")
        max_abs = max(max_abs, err)
    if bad:
        fail("9/fused sgd", "; ".join(bad))
    return max_abs


def time_fused_sgd(fs, optim, tconfig, model_params, card) -> dict:
    """Phase 10: each variant's one-bucket update at the slice's shapes —
    the kernel, the plain version on the same bucket, the library call
    (``torch.optim.SGD(fused=True)`` over the 173 leaves, never used by
    the port) and the byte bound. CUDA events, L2 flushed, median of 30.
    Returns the rows of the slice's two kernels."""
    import torch

    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    n = sum(p.numel() for p in model_params)
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
        if v["momentum"]:
            kern = lambda: fs.fused_sgd_kernel(p, m, g, 0.1, **v)
        else:
            kern = lambda: fs.plain_sgd_kernel(p, g, 0.1,
                                               v["weight_decay"])
        ms = time_ms(kern, flush=flush)
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
        bytes_moved = (5 if v["momentum"] else 3) * n * 4
        flops = (2 * (v["weight_decay"] != 0) + 2 * (v["momentum"] != 0)
                 + 2 * v["nesterov"] + 2) * n
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_FLOPS_PER_S * 1e3
        bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
        print(f"fused_sgd timing {name} [{card}]: kernel {ms} ms, plain "
              f"{plain_ms} ms, library {library_ms} ms (torch.optim.SGD "
              f"{lib_kind}, 173 leaves), bound {bound_ms} ms ({bound_by}: "
              f"{bytes_moved} B, {flops} flop), {bound_ms / ms:.1%} of bound")
        row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=library_ms)
        if name == "momentum_wd":
            out["fused_sgd"] = row
        elif name == "no_momentum":
            out["plain_sgd"] = row
        del opt, leaves, lib_leaves, lib, p, m, g
    del flush
    torch.cuda.empty_cache()
    return out


def cnn_config(tconfig, **optimizer):
    """The CNN slice's TrainConfig (bench.py's CNN workload, one card)."""
    return tconfig.TrainConfig(
        model=tconfig.ModelConfig(name="mobilenetv2", dtype="bfloat16"),
        data=tconfig.DataConfig(
            name="synthetic", batch_size=CNN_BATCH,
            eval_batch_size=CNN_BATCH, image_size=32,
            synthetic_native_size=32, synthetic_train_size=4 * CNN_BATCH,
            synthetic_eval_size=CNN_BATCH),
        optimizer=tconfig.OptimizerConfig(
            **{**dict(learning_rate=0.4, warmup_steps=10, fused=True),
               **optimizer}),
        device_resident_data=True, steps_per_dispatch=CNN_SPD,
        device="cuda")


def cnn_dispatch_indices(n: int, dispatches: int):
    """bench.py's per-dispatch batches (bench.py:1374-1380): one
    ``default_rng(0)`` stream of ``integers(0, n, (10, 512))`` draws, on
    the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.integers(0, n, (CNN_SPD, CNN_BATCH))
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


def check_cnn_step(trainer_mod, models, staged, tconfig) -> None:
    """Phase 11a: two steps of the CNN slice from the same weights and
    batches through the fused kernel and through ``torch.optim.SGD``
    (``fused=False``): losses, every leaf's step-1 update and the BN
    statistics."""
    import numpy as np
    import torch

    params, state = staged.params_to_jax(models.get_model(
        tconfig.ModelConfig(name="mobilenetv2", dtype="bfloat16"), seed=0,
        device="cpu"))
    idx = cnn_dispatch_indices(4 * CNN_BATCH, 1)[0][:2]
    runs = {}
    for fused in (True, False):
        t = trainer_mod.Trainer(cnn_config(tconfig, fused=fused),
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
    print(f"cnn check: step-1 loss fused {loss_a} vs torch.optim.SGD "
          f"{loss_b} (|diff| {loss_err}, atol {CNN_LOSS_ATOL}); step-1 "
          f"update per leaf max|a-b|/max|b| {upd:.3e} (rtol "
          f"{CNN_UPDATE_RTOL}); BN statistics {st:.3e} (rtol "
          f"{CNN_STATS_RTOL})")
    if not (loss_err <= CNN_LOSS_ATOL and upd <= CNN_UPDATE_RTOL
            and st <= CNN_STATS_RTOL and np.isfinite(loss_a).all()):
        fail("11/cnn", "fused vs plain update outside tolerance")
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


def train_cnn(trainer_mod, fs, tconfig, card) -> dict:
    """Phase 11b/11c: the CNN slice's main path — bench.py's timing shape
    through ``Trainer.run_steps`` with the fused kernel — then 20 steps
    with momentum 0 (plain_sgd), 20 with ``fused=False`` (a data point),
    and one profiled step. Returns the main path's launch counts."""
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
    print_profile("cnn step", lambda: f"loss "
                  f"{trainer.run_steps(idxs[-1][:1])['loss'].item()}",
                  card, kind=cnn_kind)
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
    return launches


class Laps:
    """Prints each phase's seconds since the previous phase ended."""

    def __init__(self):
        self.mark = time.perf_counter()

    def done(self, phase: str) -> None:
        now = time.perf_counter()
        print(f"phase {phase}: {now - self.mark:.2f} s")
        self.mark = now


def main() -> None:
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
        paths = _build.build_all()
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
    sgd_err = check_fused_sgd(fs, optim, tconfig, mnv2)
    laps.done("9/fused sgd")
    sgd_times = time_fused_sgd(fs, optim, tconfig, mnv2, card)
    del mnv2
    laps.done("10/fused sgd timing")

    # -- phase 11: CNN trainer at full width ----------------------------------
    torch.backends.cudnn.benchmark = True
    print("set torch.backends.cudnn.benchmark=True")
    check_cnn_step(cnn_trainer, models, staged, tconfig)
    laps.done("11a/cnn check")
    sgd_launches = train_cnn(cnn_trainer, fs, tconfig, card)
    laps.done("11b-c/cnn trainer")

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
            "max_abs_err": sgd_err,
            **sgd_times[name],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
