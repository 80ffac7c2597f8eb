"""Flash attention for training — forward and FlashAttention-2 backward.

Counterpart of ``distributed_model_parallel_tpu/ops/pallas_attention.py``
(the Pallas kernels ``_flash_kernel``, ``_flash_bwd_dq_kernel`` and
``_flash_bwd_dkv_kernel``), with the plain reference ``full_attention``
of ``ops/ring_attention.py``. Layout ``[B, T, H, Dh]`` at every public
function, as in the JAX package; lse and delta are f32 ``[B, H, T]``.

* :func:`full_attention` — plain autograd attention (causal, full, or
  banded under a window), the reference and the ``attn_impl="xla"`` path;
* plain versions of each kernel's function: :func:`flash_forward_plain`
  (o, lse), :func:`bwd_delta` (rowsum(dO·O), plain in JAX too),
  :func:`flash_bwd_dq_plain` and :func:`flash_bwd_dkv_plain`;
* the kernel wrappers :func:`flash_forward_kernel`,
  :func:`flash_bwd_dq_kernel` and :func:`flash_bwd_dkv_kernel` (CUDA
  sources ``csrc/flash_fwd.cu``, ``csrc/flash_bwd_dq.cu`` and
  ``csrc/flash_bwd_dkv.cu``). A CPU tensor takes the plain version; a CUDA
  tensor launches the kernel or raises. Each counts its launches;
* :class:`FlashAttention` and :func:`flash_attention`, the differentiable
  entry (the counterpart of the JAX ``custom_vjp``).

Scale placement: every direction scales the f32 product ``q·k`` by
``Dh**-0.5``. (The Pallas forward scales q in the input type first; in
bf16 that rounds differently, in f32 the two agree.)
"""

from __future__ import annotations

import ctypes

import torch

from distributed_model_parallel_tpu_torch.ops import _build
from distributed_model_parallel_tpu_torch.ops.paged_attention import (
    band_keep,
)

# lse of a row with no key (JAX's sentinel; never reached by a causal or
# windowed row, which always keeps its diagonal).
NEG_INF = -1e30
HEAD_DIMS = (64, 128)


def _keep_mask(t: int, causal: bool, window: int | None, device):
    """[T, T] bool keep-mask (None when everything is kept)."""
    if not causal:
        return None
    pos = torch.arange(t, device=device)
    return band_keep(pos[:, None], pos[None, :], window)


def _scores(q, k, causal, window):
    """Scaled f32 scores [B, H, T, T] and the keep-mask."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        q.shape[-1] ** -0.5)
    return s, _keep_mask(q.shape[1], causal, window, q.device)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True,
                   window: int | None = None) -> torch.Tensor:
    """Plain attention [B, T, H, Dh] -> [B, T, H, Dh], differentiable by
    autograd: scores and softmax in f32, output in the input type. With
    ``window`` (causal only) each query keeps keys in (q - W, q] — the
    dense banded reference the JAX package has only as a test mask."""
    s, keep = _scores(q, k, causal, window)
    if keep is not None:
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def flash_forward_plain(q, k, v, causal: bool = True,
                        window: int | None = None):
    """Plain version of the forward kernel: (o [B, T, H, Dh] in q's type,
    lse [B, H, T] f32), lse the logsumexp of the scaled scores, or
    ``NEG_INF`` for a row that keeps no key."""
    s, keep = _scores(q, k, causal, window)
    if keep is not None:
        s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    lse = torch.where(torch.isinf(lse), torch.full_like(lse, NEG_INF), lse)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype), lse.contiguous()


def bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO · O) in f32, [B, H, T] (``_bwd_prep``)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _probs(q, k, lse, causal, window):
    """p recomputed from (q, k, lse), zero where masked: [B, H, T, T]."""
    s, keep = _scores(q, k, causal, window)
    p = torch.exp(s - lse[..., None])
    return p if keep is None else p.masked_fill(~keep, 0.0)


def _dscores(p, v, do, delta):
    """ds = p * (dO·v^T - delta) * scale, f32 [B, H, T, T]."""
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p * (dp - delta[..., None]) * (v.shape[-1] ** -0.5)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool = True,
                       window: int | None = None) -> torch.Tensor:
    """Plain version of the dq kernel: dq = scale · Σ_j ds_ij k_j."""
    ds = _dscores(_probs(q, k, lse, causal, window), v, do, delta)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool = True,
                        window: int | None = None):
    """Plain version of the dk/dv kernel: dv_j = Σ_i p_ij dO_i,
    dk_j = scale · Σ_i ds_ij q_i."""
    p = _probs(q, k, lse, causal, window)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", _dscores(p, v, do, delta),
                      q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_ARGTYPES = {
    # pointers..., B, T, H, D, causal, window, scale, stream
    "flash_fwd": 5,
    "flash_bwd_dq": 7,
    "flash_bwd_dkv": 8,
}


def _entry(name: str):
    fn = getattr(_build.load(name), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * _ARGTYPES[name]
                       + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _check(name, rows, vecs):
    """Validate the kernel's inputs: ``rows`` are [B, T, H, Dh] bf16,
    ``vecs`` [B, H, T] f32, all contiguous on one CUDA device."""
    q = rows[0]
    if q.ndim != 4:
        raise ValueError(f"{name}: q must be [B, T, H, Dh], got "
                         f"{tuple(q.shape)}")
    b, t, h, d = q.shape
    if any(x.device != q.device for x in (*rows, *vecs)):
        raise ValueError(f"{name}: all inputs must lie on one CUDA device")
    if any(x.dtype != torch.bfloat16 for x in rows):
        raise TypeError(f"{name}: the kernel takes bfloat16 q/k/v/dO, got "
                        f"{[str(x.dtype) for x in rows]} (compute the "
                        f"model in bf16 on the card, or pass CPU tensors "
                        f"for the plain version)")
    if any(x.dtype != torch.float32 for x in vecs):
        raise TypeError(f"{name}: lse and delta must be float32")
    if any(tuple(x.shape) != (b, t, h, d) for x in rows) or any(
            tuple(x.shape) != (b, h, t) for x in vecs):
        raise ValueError(f"{name}: shapes {[tuple(x.shape) for x in rows]}"
                         f" / {[tuple(x.shape) for x in vecs]} do not match "
                         f"[B, T, H, Dh] = {(b, t, h, d)} and [B, H, T]")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not supported (kernels "
                         f"take {HEAD_DIMS})")
    if b * h > 65535 or b * t * h * d >= 2 ** 31:
        raise ValueError(f"{name}: B*H = {b * h} or B*T*H*Dh too large")
    if not all(x.is_contiguous() for x in (*rows, *vecs)):
        raise ValueError(f"{name}: inputs must be contiguous")
    if any(x.data_ptr() % 16 for x in rows):
        raise ValueError(f"{name}: q/k/v/dO must be 16-byte aligned")


def _launch(name, ptrs, q, causal, window):
    b, t, h, d = q.shape
    # The kernel launches on the current device (the .cu entry points set
    # none): make it the tensors' own, so that q on cuda:k runs on card k,
    # on that card's current stream.
    with torch.cuda.device(q.device):
        rc = _entry(name)(
            *ptrs, b, t, h, d, int(bool(causal)),
            0 if window is None else int(window), float(d ** -0.5),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def flash_forward_kernel(q, k, v, causal: bool = True,
                         window: int | None = None):
    """Forward through ``csrc/flash_fwd.cu``: (o, lse f32 [B, H, T]).
    CPU tensors take :func:`flash_forward_plain`."""
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, causal, window)
    _check("flash_fwd", (q, k, v), ())
    b, t, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), lse.data_ptr()), q, causal, window)
    flash_forward_kernel.launches += 1
    return o, lse


def flash_bwd_dq_kernel(q, k, v, do, lse, delta, causal: bool = True,
                        window: int | None = None):
    """dq through ``csrc/flash_bwd_dq.cu``. CPU tensors take
    :func:`flash_bwd_dq_plain`."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, window)
    _check("flash_bwd_dq", (q, k, v, do), (lse, delta))
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                             dq.data_ptr()), q, causal, window)
    flash_bwd_dq_kernel.launches += 1
    return dq


def flash_bwd_dkv_kernel(q, k, v, do, lse, delta, causal: bool = True,
                         window: int | None = None):
    """(dk, dv) through ``csrc/flash_bwd_dkv.cu``. CPU tensors take
    :func:`flash_bwd_dkv_plain`."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, window)
    _check("flash_bwd_dkv", (q, k, v, do), (lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkv", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              do.data_ptr(), lse.data_ptr(),
                              delta.data_ptr(), dk.data_ptr(),
                              dv.data_ptr()), q, causal, window)
    flash_bwd_dkv_kernel.launches += 1
    return dk, dv


flash_forward_kernel.launches = 0
flash_bwd_dq_kernel.launches = 0
flash_bwd_dkv_kernel.launches = 0


class FlashAttention(torch.autograd.Function):
    """Forward kernel, then delta, dq and dk/dv kernels in the backward —
    the counterpart of the JAX ``custom_vjp`` (``_flash_fwd``/
    ``_flash_bwd``). Neither direction puts [T, T] in device memory."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_forward_kernel(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = bwd_delta(o, do)
        dq = flash_bwd_dq_kernel(q, k, v, do, lse, delta, ctx.causal,
                                 ctx.window)
        dk, dv = flash_bwd_dkv_kernel(q, k, v, do, lse, delta, ctx.causal,
                                      ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """[B, T, H, Dh] -> [B, T, H, Dh] attention through the flash kernels
    (the plain versions for CPU tensors), differentiable. ``window=W``
    (causal only) keeps keys in (q - W, q]."""
    if window is not None:
        if not causal:
            raise ValueError("window requires causal attention")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    return FlashAttention.apply(q, k, v, causal, window)
