"""The port's paged attention against the JAX package's, on the same
inputs: the plain gather path (``attend_rows``) against JAX
``paged_attention_xla`` and against the Pallas kernel run in interpret
mode, and the CUDA kernel's wrapper on CPU tensors (its plain version).
f32, atol 1e-5 (the same math in another summation order). Then the CUDA
kernel's flash-decoding algebra on the CPU: per-split (m, l, acc) merged
in split order against attention over the whole band, the port's and
JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import t
from distributed_model_parallel_tpu.ops import paged_attention as jpa
from distributed_model_parallel_tpu_torch.ops import paged_attention as tpa

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ATOL = 1e-5

# tests/test_paged_attention.py's shapes: pool of 16 pages of 8, Dh 16.
CASES = {
    "mha": dict(h=2, hkv=2, window=None, stale=False),
    "gqa": dict(h=8, hkv=2, window=None, stale=False),
    "window": dict(h=4, hkv=2, window=8, stale=False),
    "stale_nan": dict(h=4, hkv=2, window=None, stale=True),
}


def _case(h, hkv, window, stale, seed=0, dh=16, page=8, n_pool=16):
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((n_pool, page, hkv, dh)).astype(np.float32)
    vp = rng.standard_normal((n_pool, page, hkv, dh)).astype(np.float32)
    tables = np.asarray([[3, 7, 1, 0], [2, 5, 0, 0], [9, 8, 4, 6]], np.int32)
    positions = np.asarray([19, 10, 31], np.int32)
    if stale:
        # Every slot no row may read — unreferenced pages and positions
        # past a row's length — holds NaN.
        used = np.zeros((n_pool, page), bool)
        for row, pos in zip(tables, positions):
            for p in range(pos + 1):
                used[row[p // page], p % page] = True
        kp[~used] = np.nan
        vp[~used] = np.nan
    q = rng.standard_normal((3, 1, h, dh)).astype(np.float32)
    return q, kp, vp, tables, positions, window


@pytest.mark.parametrize("name", sorted(CASES))
def test_gather_matches_jax_xla_and_pallas_interpret(name):
    q, kp, vp, tables, pos, window = _case(**CASES[name])
    ref_xla = np.asarray(jpa.paged_attention_xla(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(pos)[:, None],
        jnp.asarray(pos) + 1, window))
    ref_kernel = np.asarray(jpa.paged_attention_kernel(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(pos), window=window,
        interpret=True))
    got = tpa.paged_attention_gather(t(q), t(kp), t(vp), t(tables),
                                     t(pos)[:, None], t(pos) + 1,
                                     window).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref_xla, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, ref_kernel, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_wrapper_on_cpu_is_the_plain_version(name):
    """A CPU tensor takes the plain version — bitwise the gather path —
    and launches nothing; the dispatch routes decode (C == 1) there."""
    q, kp, vp, tables, pos, window = _case(**CASES[name])
    before = tpa.paged_attention_kernel.launches
    got = tpa.paged_attention_kernel(t(q), t(kp), t(vp), t(tables), t(pos),
                                     window)
    via = tpa.paged_attention(t(q), t(kp), t(vp), t(tables),
                              t(pos)[:, None], t(pos) + 1, window,
                              impl="kernel")
    plain = tpa.paged_attention_gather(t(q), t(kp), t(vp), t(tables),
                                       t(pos)[:, None], t(pos) + 1, window)
    assert torch.equal(got, plain) and torch.equal(via, plain)
    assert tpa.paged_attention_kernel.launches == before


def test_prefill_chunk_matches_jax_xla():
    """A multi-token chunk read (prefill) against JAX, within tolerance —
    not the bitwise chunked-vs-whole property, which the reference itself
    does not hold on this tree."""
    rng = np.random.default_rng(3)
    kp = rng.standard_normal((16, 8, 2, 16)).astype(np.float32)
    vp = rng.standard_normal((16, 8, 2, 16)).astype(np.float32)
    table = np.asarray([[5, 2, 11, 4]], np.int32)
    q = rng.standard_normal((1, 8, 4, 16)).astype(np.float32)
    positions = (8 + np.arange(8, dtype=np.int32))[None]
    lengths = np.asarray([16], np.int32)
    ref = np.asarray(jpa.paged_attention_xla(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(positions), jnp.asarray(lengths)))
    got = tpa.paged_attention(t(q), t(kp), t(vp), t(table), t(positions),
                              t(lengths), impl="kernel").numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_bfloat16_plain_matches_f32_within_bf16_rounding():
    q, kp, vp, tables, pos, _ = _case(4, 2, None, False)
    args = (t(tables), t(pos)[:, None], t(pos) + 1)
    ref = tpa.paged_attention_gather(t(q), t(kp), t(vp), *args)
    got = tpa.paged_attention_gather(
        t(q).bfloat16(), t(kp).bfloat16(), t(vp).bfloat16(), *args)
    assert got.dtype == torch.bfloat16
    # bf16 inputs and output: a few 2^-8 relative roundings on O(1) values.
    torch.testing.assert_close(got.float(), ref, atol=5e-2, rtol=0)


def test_dispatch_rejects_unknown_impl_and_multi_token_kernel():
    q, kp, vp, tables, pos, _ = _case(4, 2, None, False)
    with pytest.raises(ValueError, match="impl"):
        tpa.paged_attention(t(q), t(kp), t(vp), t(tables), t(pos)[:, None],
                            t(pos) + 1, impl="pallas")
    with pytest.raises(ValueError, match="one query token"):
        tpa.paged_attention_kernel(t(q).repeat(1, 2, 1, 1), t(kp), t(vp),
                                   t(tables), t(pos))


@pytest.mark.parametrize("window", [None, 1, 3])
def test_band_keep_matches_jax(window):
    from distributed_model_parallel_tpu.ops.pallas_attention import (
        band_keep,
    )

    qp = np.arange(6)[:, None]
    kp = np.arange(6)[None, :]
    ref = np.asarray(band_keep(jnp.asarray(qp), jnp.asarray(kp), window))
    got = tpa.band_keep(t(qp), t(kp), window).numpy()
    assert (got == ref).all()


# The decode kernel's split/merge (csrc/paged_decode.cu), at a small
# geometry: pages of 4 tokens, 8 pages per row, 2 pages per split, so
# splits of 8 tokens. Positions on page edges (3/4, 15/16), on split edges
# (7/8, 23/24), the first and the last token; windows of one token (1),
# of one split (8), that start the band mid-split (5, 13) or never cut it.
SPLIT_PAGE, SPLIT_N, SPLIT_PPS = 4, 8, 2
SPLIT_POSITIONS = [0, 3, 4, 7, 8, 15, 16, 23, 24, 31]
# f32 on O(1) values: the merge reorders a softmax sum over <= 32 terms.
MERGE_ATOL = 1e-6


def _split_page_ranges(positions, window, page, n_pages, pages_per_split):
    """The decode kernel's split plan (csrc/paged_decode.cu, `first` and
    `last`): for each row, the first and last logical page of each of its
    ``ceil(n_pages / pages_per_split)`` split CTAs, ``[B, S]`` each —
    split s takes pages ``[s·pps, (s+1)·pps)`` of the row's band pages
    ``[(pos - window + 1) // page, pos // page]``; ``first > last`` marks
    a split with no page."""
    n_splits = -(-n_pages // pages_per_split)
    s = torch.arange(n_splits)
    pos = positions.long()[:, None]
    lo = (pos - window + 1).clamp_min(0) if window else torch.zeros_like(pos)
    first = torch.maximum(lo // page, s * pages_per_split)
    last = torch.minimum((pos // page).clamp_max(n_pages - 1),
                         (s + 1) * pages_per_split - 1)
    return first, last


def _split_merge_reference(q, kr, vr, positions, window):
    """Decode attention the kernel's way, in f32: for each split of each
    row, (m, l, acc) of the split's pages — acc from ``attend_rows`` over
    the split's sub-range, m and l from its scores — merged in split order:
    out = Σ e^(m_s - m*)·acc_s / Σ e^(m_s - m*)·l_s over non-empty
    splits."""
    first, last = _split_page_ranges(positions, window, SPLIT_PAGE,
                                        SPLIT_N, SPLIT_PPS)
    b, _, h, dh = q.shape
    hkv = kr.shape[2]
    out = torch.empty_like(q)
    for r in range(b):
        pos = int(positions[r])
        parts = []
        for s in range(first.shape[1]):
            if first[r, s] > last[r, s]:
                continue                                   # an empty split
            t0 = int(first[r, s]) * SPLIT_PAGE
            t1 = (int(last[r, s]) + 1) * SPLIT_PAGE
            sub_pos = torch.tensor([[pos - t0]])
            sub_len = torch.tensor([pos + 1 - t0])
            ks, vs = kr[r:r + 1, t0:t1], vr[r:r + 1, t0:t1]
            o_s = tpa.attend_rows(q[r:r + 1], ks, vs, sub_pos, sub_len,
                                  window)
            k_pos = torch.arange(t0, t1)
            keep = tpa.band_keep(torch.tensor(pos), k_pos, window)
            keep &= k_pos <= pos
            # Query head h reads kv head h // G.
            sc = torch.einsum("hd,khd->hk", q[r, 0],
                              ks[0].repeat_interleave(h // hkv, dim=1)) * (
                dh ** -0.5)
            sc = sc.masked_fill(~keep, float("-inf"))
            m = sc.max(-1).values                          # [H]
            l = torch.exp(sc - m[:, None]).sum(-1)
            parts.append((m, l, o_s[0, 0] * l[:, None]))
        m_star = torch.stack([m for m, _, _ in parts]).max(0).values
        num = torch.zeros(h, dh)
        den = torch.zeros(h)
        for m, l, acc in parts:                            # split order
            w = torch.exp(m - m_star)
            num += w[:, None] * acc
            den += w * l
        out[r, 0] = num / den[:, None]
    return out


@pytest.mark.parametrize("window", [None, 1, 5, 8, 13])
@pytest.mark.parametrize("group", [1, 2, 8])
def test_split_merge_equals_attention_over_the_whole_band(group, window):
    """Split partials merged in split order equal attention over the whole
    band: the port's ``attend_rows`` within 1e-6 and JAX's
    ``paged_attention_xla`` within ATOL, on the same pages read through a
    shuffled page table."""
    rng = np.random.default_rng(group * 31 + (window or 0))
    b, hkv, dh = len(SPLIT_POSITIONS), 2, 16
    t_all = SPLIT_N * SPLIT_PAGE
    q = rng.standard_normal((b, 1, hkv * group, dh)).astype(np.float32)
    kr = rng.standard_normal((b, t_all, hkv, dh)).astype(np.float32)
    vr = rng.standard_normal((b, t_all, hkv, dh)).astype(np.float32)
    # Row r's logical page j lives at pool page tables[r, j].
    tables = rng.permutation(b * SPLIT_N).astype(np.int32).reshape(b, SPLIT_N)
    k_pool = np.empty((b * SPLIT_N, SPLIT_PAGE, hkv, dh), np.float32)
    v_pool = np.empty_like(k_pool)
    k_pool[tables] = kr.reshape(b, SPLIT_N, SPLIT_PAGE, hkv, dh)
    v_pool[tables] = vr.reshape(b, SPLIT_N, SPLIT_PAGE, hkv, dh)
    pos = np.asarray(SPLIT_POSITIONS, np.int32)
    positions = torch.tensor(SPLIT_POSITIONS)
    got = _split_merge_reference(t(q), t(kr), t(vr), positions, window)
    want = tpa.attend_rows(t(q), t(kr), t(vr), positions[:, None],
                           positions + 1, window)
    ref = np.asarray(jpa.paged_attention_xla(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(tables), jnp.asarray(pos)[:, None], jnp.asarray(pos) + 1,
        window))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=MERGE_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
