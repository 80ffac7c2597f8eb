#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives the port (``distributed_model_parallel_tpu_torch``) only; imports
nothing of JAX or the JAX package. Phases, each fatal on failure:

1. device — require CUDA, print the card's name and power limit, turn
   TF32 off for float32 matmuls and convolutions;
2. build — compile every kernel of the serving path from ``ops/csrc``;
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
   plain path's.

Prints the card line, the ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``. Exits non-zero without a card, or
when run outside a checkout of the repository.
"""

from __future__ import annotations

import json
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


def profile_engine(Engine, params, cfg, serve, prompts, gens, card) -> None:
    """The same engine workload once more under ``torch.profiler``: device
    time by kernel and the device's busy share of the run's wall time
    (kernels run on one stream, so their times add). Informational: a
    profile without device events prints "not measured"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    eng = Engine(params, cfg, serve)
    for i, (p, g) in enumerate(zip(prompts, gens)):
        eng.submit(p, g, seed=i)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    rows = [(e.key, e.device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    busy_us = sum(r[1] for r in rows)
    if not rows:
        print(f"profile [{card}]: device time not measured (no CUDA events)")
        return
    print(f"profile [{card}]: wall {wall_us:.0f} us, device busy "
          f"{busy_us:.0f} us ({100 * busy_us / wall_us:.1f}%), "
          f"{eng.summary()['decode_steps']} decode steps; top kernels:")
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"  {us:10.0f} us {n:6d} x  {key[:90]}")


def main() -> None:
    # -- phase 1: device ----------------------------------------------------
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

    card = card_line()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("set torch.backends.cuda.matmul.allow_tf32=False, "
          "torch.backends.cudnn.allow_tf32=False")

    # -- phase 2: build -----------------------------------------------------
    t = time.perf_counter()
    try:
        paths = _build.build_all()
    except RuntimeError as e:
        fail("2/build", str(e))
    print(f"built {len(paths)} kernel(s) in {time.perf_counter() - t:.2f} s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

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

    print(json.dumps({"kernels": [{
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
