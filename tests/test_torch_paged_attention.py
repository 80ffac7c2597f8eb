"""The port's paged attention against the JAX package's, on the same
inputs: the plain gather path (``attend_rows``) against JAX
``paged_attention_xla`` and against the Pallas kernel run in interpret
mode, and the CUDA kernel's wrapper on CPU tensors (its plain version).
f32, atol 1e-5 (the same math in another summation order)."""

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
