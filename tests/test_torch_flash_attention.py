"""The port's flash attention (ops/flash_attention.py) against the JAX
package's Pallas kernels run in interpret mode, on the same f32 inputs:
the plain forward (o, lse) against ``_flash_impl`` and ``full_attention``,
the plain dq/dk/dv against ``_flash_bwd_impl``, and autograd through
``flash_attention`` against ``jax.vjp`` of the JAX ``flash_attention``.
Causal, full, ragged T (40 with blocks of 16) and windows {1, 7, 17,
>= T}. atol 1e-5 forward, 1e-4 gradients (f32 sums in another order).
On the CPU every wrapper runs its plain version; the kernels themselves
are held against those on the card by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import t
from distributed_model_parallel_tpu.ops import pallas_attention as jpa
from distributed_model_parallel_tpu.ops.ring_attention import (
    full_attention as j_full_attention,
)
from distributed_model_parallel_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4
BLOCK = 16

# label -> (T, causal, window)
CASES = {
    "causal": (64, True, None),
    "full": (48, False, None),
    "ragged": (40, True, None),
    "window1": (40, True, 1),
    "window7": (40, True, 7),
    "window17": (40, True, 17),
    "window_ge_t": (40, True, 64),
}


def _inputs(t_len, seed, b=2, h=2, dh=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t_len, h, dh)).astype(np.float32)
            for _ in range(4)]


def _jax_fwd(q, k, v, causal, window):
    """JAX kernel o [B, T, H, D] and lse [B, H, T] (padding dropped)."""
    o, lse = jpa._flash_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal, BLOCK, BLOCK, True, window)
    b, t_len, h, _ = q.shape
    return o, lse, np.asarray(lse).reshape(b, h, -1)[:, :, :t_len]


def _close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(ref),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("label", list(CASES))
def test_plain_forward_matches_jax_kernel(label):
    t_len, causal, window = CASES[label]
    q, k, v, _ = _inputs(t_len, 0)
    o_ref, _, lse_ref = _jax_fwd(q, k, v, causal, window)
    o, lse = fa.flash_forward_plain(t(q), t(k), t(v), causal, window)
    assert o.dtype == torch.float32 and lse.shape == (2, 2, t_len)
    _close(o, o_ref, FWD_ATOL)
    _close(lse, lse_ref, FWD_ATOL)
    # The plain reference (banded under a window) agrees as well.
    _close(fa.full_attention(t(q), t(k), t(v), causal=causal, window=window),
           o_ref, FWD_ATOL)


@pytest.mark.parametrize("label", list(CASES))
def test_plain_backward_matches_jax_kernels(label):
    t_len, causal, window = CASES[label]
    q, k, v, do = _inputs(t_len, 1)
    o, lse_flat, lse = _jax_fwd(q, k, v, causal, window)
    ref = jpa._flash_bwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              o, lse_flat, jnp.asarray(do), causal, BLOCK,
                              BLOCK, True, window)
    delta = fa.bwd_delta(t(o), t(do))
    args = (t(q), t(k), t(v), t(do), t(lse), delta, causal, window)
    dq = fa.flash_bwd_dq_plain(*args)
    dk, dv = fa.flash_bwd_dkv_plain(*args)
    for got, want in zip((dq, dk, dv), ref):
        _close(got, want, GRAD_ATOL)


@pytest.mark.parametrize("label", list(CASES))
def test_autograd_matches_jax_vjp(label):
    t_len, causal, window = CASES[label]
    q, k, v, do = _inputs(t_len, 2)
    o_ref, vjp = jax.vjp(
        lambda q, k, v: jpa.flash_attention(
            q, k, v, causal=causal, window=window, block_q=BLOCK,
            block_k=BLOCK, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_ref = vjp(jnp.asarray(do))
    qt, kt, vt = (t(x).requires_grad_(True) for x in (q, k, v))
    o = fa.flash_attention(qt, kt, vt, causal=causal, window=window)
    o.backward(t(do))
    _close(o, o_ref, FWD_ATOL)
    for got, want in zip((qt.grad, kt.grad, vt.grad), grads_ref):
        _close(got, want, GRAD_ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_full_attention_and_grads_match_jax(causal):
    q, k, v, do = _inputs(24, 3)
    o_ref, vjp = jax.vjp(lambda q, k, v: j_full_attention(
        q, k, v, causal=causal), *(jnp.asarray(x) for x in (q, k, v)))
    qt, kt, vt = (t(x).requires_grad_(True) for x in (q, k, v))
    o = fa.full_attention(qt, kt, vt, causal=causal)
    o.backward(t(do))
    _close(o, o_ref, FWD_ATOL)
    for got, want in zip((qt.grad, kt.grad, vt.grad), vjp(jnp.asarray(do))):
        _close(got, want, GRAD_ATOL)


@pytest.mark.parametrize("kw, match", [
    (dict(causal=False, window=4), "causal"),
    (dict(causal=True, window=0), ">= 1"),
])
def test_argument_checks_raise_as_jax(kw, match):
    q = np.zeros((1, 8, 1, 16), np.float32)
    with pytest.raises(ValueError, match=match):
        jpa.flash_attention(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q),
                            interpret=True, **kw)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention(t(q), t(q), t(q), **kw)


def test_cpu_wrappers_run_the_plain_versions_and_count_no_launch():
    q, k, v, do = (t(x) for x in _inputs(20, 4))
    before = (fa.flash_forward_kernel.launches, fa.flash_bwd_dq_kernel.launches,
              fa.flash_bwd_dkv_kernel.launches)
    o, lse = fa.flash_forward_kernel(q, k, v, True, 5)
    o2, lse2 = fa.flash_forward_plain(q, k, v, True, 5)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    delta = fa.bwd_delta(o, do)
    assert torch.equal(fa.flash_bwd_dq_kernel(q, k, v, do, lse, delta),
                       fa.flash_bwd_dq_plain(q, k, v, do, lse, delta))
    for a, b in zip(fa.flash_bwd_dkv_kernel(q, k, v, do, lse, delta),
                    fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta)):
        assert torch.equal(a, b)
    assert (fa.flash_forward_kernel.launches, fa.flash_bwd_dq_kernel.launches,
            fa.flash_bwd_dkv_kernel.launches) == before


@pytest.mark.parametrize("dtype, dh, error, match", [
    (torch.float32, 128, TypeError, "bfloat16"),
    (torch.bfloat16, 32, ValueError, "head dim"),
])
def test_non_cpu_tensors_never_take_the_plain_version(dtype, dh, error,
                                                      match):
    """A tensor off the CPU goes to the kernel's checks (and raises for
    what the kernel does not take) — never to the plain version."""
    q = torch.empty((1, 8, 2, dh), dtype=dtype, device="meta")
    with pytest.raises(error, match=match):
        fa.flash_forward_kernel(q, q, q)
    lse = torch.empty((1, 2, 8), device="meta")
    with pytest.raises(error, match=match):
        fa.flash_bwd_dq_kernel(q, q, q, q, lse, lse)
