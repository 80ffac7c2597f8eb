#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives the port (``distributed_model_parallel_tpu_torch``) only; imports
nothing of JAX or the JAX package. Phases, each fatal on failure:

1. device — require CUDA, print the card's name and power limit, turn
   TF32 off for float32 matmuls and convolutions;
2. build — compile every kernel of the port from ``ops/csrc`` (one
   ``nvcc`` per source, all at once) and print ptxas's register and
   spill lines;
3. kernel vs plain — the paged decode kernel against its plain PyTorch
   version at the serving slice's shapes (MHA, GQA, sliding window),
   unreferenced and stale pool slots filled with NaN;
4. timing — kernel, plain version, one ``scaled_dot_product_attention``
   call over pre-gathered K/V (the library yardstick, never used by the
   port) and the HBM bound, with CUDA events, L2 flushed before each run;
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
   Dh 128, causal) and its edges (ragged T, full, window, Dh 64);
7. flash timing — each kernel, its plain version, the operation bound
   and the library yardstick (SDPA forward; SDPA's backward for the
   dq + dk/dv pair), CUDA events, L2 flushed before each run;
8. trainer — the LM training slice at full width (bench.py's LM model,
   bf16, RoPE, remat off, LMTrainConfig's SGD): (a) one step's loss and
   gradients through the kernels against the plain attention at T 2048;
   (b) a warm-up step, then 5 steps through ``LMTrainer`` at B 2, T 8192
   — finite losses, parameters changed, each flash kernel launched
   n_layers times per step — with step time, tokens/s, MFU and peak
   memory; (c) one step under ``torch.profiler``.

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


def print_profile(label: str, run, card) -> None:
    """``run()`` under ``torch.profiler``: device time by kernel and the
    device's busy share of the run's wall time (kernels run on one
    stream, so their times add). ``run`` returns a note for the summary
    line. Informational: a profile without device events prints "not
    measured"."""
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
    # Device time by kind: the port's own kernels, cuBLAS GEMMs (nvjet,
    # gemm and xmma kernel names), everything else.
    kinds = {"port kernels": 0.0, "cuBLAS GEMMs": 0.0, "other": 0.0}
    for key, us, _ in rows:
        if "flash::" in key or "paged_decode" in key:
            kinds["port kernels"] += us
        elif any(s in key.lower() for s in ("nvjet", "gemm", "xmma")):
            kinds["cuBLAS GEMMs"] += us
        else:
            kinds["other"] += us
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
        torch.cuda.synchronize()
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
              + f" (rtol {GRAD_RTOL} each)")
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
                 "SDPA backward alone, dq and dk/dv together") + ")")
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
                                       "spill")):
                print(f"  {name}: {line.strip()}")
    laps.done("2/build")

    # -- phase 3: kernel vs plain ---------------------------------------------
    page, n, n_pool, dh = 16, 40, GEOMETRY["n_pages"], 128
    spread = [0, 639, 15, 16, 100, 255, 383, 512]
    cases = {
        "mha": dict(h=8, hkv=8, window=None),
        "gqa": dict(h=8, hkv=2, window=None),
        "window64": dict(h=8, hkv=8, window=64),
    }
    max_err = 0.0
    for i, (label, c) in enumerate(cases.items()):
        q, kp, vp, tables, pos = make_case(8, c["h"], c["hkv"], dh, page, n,
                                           n_pool, spread, seed=i)
        got = pa.paged_attention_kernel(q, kp, vp, tables, pos,
                                        window=c["window"])
        want = pa.paged_attention_gather(
            q.float(), kp.float(), vp.float(), tables, pos[:, None],
            pos + 1, c["window"]).to(torch.bfloat16)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail("3/kernel", f"{label}: non-finite kernel output")
        err = (got.float() - want.float()).abs().max().item()
        print(f"paged_decode {label}: max_abs_err {err} (atol {KERNEL_ATOL})")
        if not err <= KERNEL_ATOL:
            fail("3/kernel", f"{label}: max_abs_err {err} > {KERNEL_ATOL}")
        max_err = max(max_err, err)

    laps.done("3/kernel")

    # -- phase 4: timing ------------------------------------------------------
    q, kp, vp, tables, pos = make_case(8, 8, 8, dh, page, n, n_pool, spread,
                                       seed=0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    ms = time_ms(lambda: pa.paged_attention_kernel(q, kp, vp, tables, pos),
                 flush=flush)
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
    print(f"paged_decode timing [{card}]: kernel {ms} ms, plain {plain_ms} "
          f"ms, sdpa {library_ms} ms, bound {bound_ms} ms ({bound_by}: "
          f"{bytes_moved} B, {flops} flop)")
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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
