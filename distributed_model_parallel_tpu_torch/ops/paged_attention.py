"""Paged decode attention — the KV-cache read path of the serving engine.

Counterpart of ``distributed_model_parallel_tpu/ops/paged_attention.py``.
The cache is a pool of fixed-size pages ``[P, page, Hkv, Dh]`` per layer
plus a per-sequence page table; this module reads it:

* :func:`attend_rows` — the one score/softmax definition (grouped heads,
  ``band_keep`` masking, f32 scores, softmax and V);
* :func:`paged_attention_gather` — gather the table's pages into a
  contiguous ``[B, T, Hkv, Dh]`` view and run :func:`attend_rows`: the
  prefill path, and the plain version of the kernel;
* :func:`paged_attention_kernel` — the wrapper of the hand-written CUDA
  kernel ``csrc/paged_decode.cu`` for single-token decode (the
  counterpart of the Pallas ``_paged_decode_kernel``): a row's pages are
  split over CTAs of a fixed number of pages and a second launch merges
  the splits.

Masking is sanitizing, not just causal: positions past a row's length
are zeroed in K/V *and* banded out of the scores, so stale page contents
(freed pages are reused without clearing) contribute exact 0 — a row's
values depend only on its own written tokens.
"""

from __future__ import annotations

import ctypes

import torch

from distributed_model_parallel_tpu_torch.ops import _build

IMPLS = ("kernel", "plain")


def band_keep(q_pos, k_pos, window):
    """Causal (and optionally banded) keep-mask: k_pos in (q_pos - window,
    q_pos]."""
    keep = k_pos <= q_pos
    if window is not None:
        keep = keep & (k_pos > q_pos - window)
    return keep


def attend_rows(q: torch.Tensor, kr: torch.Tensor, vr: torch.Tensor,
                positions: torch.Tensor, lengths: torch.Tensor,
                window: int | None = None) -> torch.Tensor:
    """Grouped-head cached attention over per-row contiguous K/V.

    q: [B, C, H, Dh]; kr/vr: [B, T, Hkv, Dh]; positions: [B, C] absolute
    query positions; lengths: [B] valid K prefix per row (everything at
    k_pos >= length is zeroed before any reduction). Query head h reads
    kv head h // G. Returns [B, C, H, Dh] in ``q.dtype``.
    """
    b, c, h, dh = q.shape
    t, hkv = kr.shape[1], kr.shape[2]
    k_pos = torch.arange(t, device=q.device)
    valid = k_pos[None, :] < lengths[:, None]                  # [B, T]
    kr = kr.masked_fill(~valid[:, :, None, None], 0)
    vr = vr.masked_fill(~valid[:, :, None, None], 0)
    qg = q.reshape(b, c, hkv, h // hkv, dh)
    # Scores and softmax in f32 whatever the cache type: a product of two
    # bf16 values is exact in f32, so this is the JAX package's
    # preferred_element_type=f32 contraction.
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), kr.float()) * (
        dh ** -0.5)
    keep = band_keep(positions[:, :, None], k_pos[None, None, :], window)
    keep = keep & valid[:, None, :]                            # [B, C, T]
    s = s.masked_fill(~keep[:, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, vr.float())
    return o.reshape(b, c, h, dh).to(q.dtype)


def paged_attention_gather(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           positions: torch.Tensor, lengths: torch.Tensor,
                           window: int | None = None) -> torch.Tensor:
    """Plain paged attention: gather then :func:`attend_rows`.

    q: [B, C, H, Dh]; k_pool/v_pool: [P, page, Hkv, Dh] (one layer);
    tables: [B, N] physical page ids (padded with any in-range id);
    positions: [B, C]; lengths: [B]. Materializes the gathered
    [B, N*page, Hkv, Dh] view.
    """
    b, n = tables.shape
    page = k_pool.shape[1]
    idx = tables.long()
    kr = k_pool[idx].reshape(b, n * page, *k_pool.shape[2:])
    vr = v_pool[idx].reshape(b, n * page, *v_pool.shape[2:])
    return attend_rows(q, kr, vr, positions, lengths, window)


def _kernel_fns():
    """The kernel's C entry and its split count, ``paged_decode_splits(N)``
    (a row's N table pages split over CTAs of a fixed number of pages)."""
    lib = _build.load("paged_decode")
    fn, splits = lib.paged_decode, lib.paged_decode_splits
    if fn.argtypes is None:
        fn.restype = splits.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        splits.argtypes = [ctypes.c_int]
    return fn, splits


def paged_attention_kernel(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           positions: torch.Tensor,
                           window: int | None = None) -> torch.Tensor:
    """Paged decode attention through the CUDA kernel. q: [B, 1, H, Dh];
    pools [P, page, Hkv, Dh]; tables [B, N] int32; positions [B] int32
    (the query token's absolute position; the row attends [0, pos],
    band-clamped under ``window``). Returns [B, 1, H, Dh].

    A CPU ``q`` takes the plain version (:func:`paged_attention_gather`
    with lengths ``positions + 1``); a CUDA ``q`` launches the kernel or
    raises. ``paged_attention_kernel.launches`` counts wrapper calls
    that launched (each is two CUDA launches: the split pass and the
    merge).
    """
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"the paged decode kernel takes one query token "
                         f"per row, got q of shape {tuple(q.shape)} "
                         f"(prefill chunks go through "
                         f"paged_attention_gather)")
    if q.device.type == "cpu":
        return paged_attention_gather(q, k_pool, v_pool, tables,
                                      positions[:, None], positions + 1,
                                      window)
    b, _, h, dh = q.shape
    if k_pool.ndim != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"pools must be [P, page, Hkv, Dh] and alike, got "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    n_pool, page, hkv, pdh = k_pool.shape
    if q.device.type != "cuda" or any(
            x.device != q.device for x in (k_pool, v_pool, tables,
                                           positions)):
        raise ValueError("q, pools, tables and positions must all lie on "
                         "the same CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k_pool.dtype == v_pool.dtype == q.dtype):
        raise TypeError(f"q and pools must share one dtype, float32 or "
                        f"bfloat16; got {q.dtype}, {k_pool.dtype}, "
                        f"{v_pool.dtype}")
    if tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("tables and positions must be int32")
    if (pdh != dh or h % hkv or h // hkv > 8 or dh % 32 or dh > 1024
            or tables.ndim != 2 or tables.shape[0] != b
            or positions.shape != (b,)):
        raise ValueError(
            f"unsupported shapes: q {tuple(q.shape)}, pool "
            f"{tuple(k_pool.shape)}, tables {tuple(tables.shape)}, "
            f"positions {tuple(positions.shape)} (needs H % Hkv == 0, "
            f"H / Hkv <= 8, Dh a multiple of 32 up to 1024)")
    if not all(x.is_contiguous() for x in (q, k_pool, v_pool, tables,
                                           positions)):
        raise ValueError("q, pools, tables and positions must be contiguous")
    if any(x.data_ptr() % 16 for x in (q, k_pool, v_pool)):
        raise ValueError("q and pools must be 16-byte aligned")
    fn, splits = _kernel_fns()
    n = tables.shape[1]
    out = torch.empty_like(q)
    # f32 scratch of the split pass: (m, l) and acc[Dh] per (b, h, split).
    part = torch.empty(b * h * splits(n) * (2 + dh), dtype=torch.float32,
                       device=q.device)
    rc = fn(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
        part.data_ptr(), b, h, hkv, dh, n_pool, page, n,
        0 if window is None else int(window), float(dh ** -0.5),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error "
                           f"{rc}")
    paged_attention_kernel.launches += 1
    return out


paged_attention_kernel.launches = 0


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, tables: torch.Tensor,
                    positions: torch.Tensor, lengths: torch.Tensor,
                    window: int | None = None,
                    impl: str = "kernel") -> torch.Tensor:
    """Dispatch: single-token decode (C == 1) goes to the kernel wrapper
    under ``impl="kernel"``; multi-token prefill chunks, and everything
    under ``impl="plain"``, take the gather path. On decode,
    ``lengths`` must be ``positions + 1`` (the query token is the newest
    written position) — the kernel derives it itself."""
    if impl not in IMPLS:
        raise ValueError(f"unknown paged-attention impl {impl!r}; known: "
                         f"{', '.join(IMPLS)}")
    if impl == "kernel" and q.shape[1] == 1:
        return paged_attention_kernel(q, k_pool, v_pool, tables,
                                      positions[:, 0], window)
    return paged_attention_gather(q, k_pool, v_pool, tables, positions,
                                  lengths, window)
