"""Sequence parallelism: ring attention and Ulysses all-to-all — the port
of ``distributed_model_parallel_tpu/ops/ring_attention.py``.

The JAX functions run inside ``shard_map`` over a named ``seq`` axis; these
run on every rank of the mesh's seq group (``mesh.MeshSpec.seq_group``),
each on its local shard ``[B, T_local, H, Dh]`` of a sequence laid out in
group-rank order. Both accumulate in f32 whatever the input type.

* **Ring attention** (:func:`ring_attention`): Q stays put; (K, V) blocks
  travel one rank round the ring a hop (``collectives.exchange``), and
  each hop's (Q_local, K_block) tile is folded in.
  :class:`RingFlash` runs each hop through the flash kernels
  (``ops/flash_attention``: the forward, then dq and dk/dv in a second
  ring pass) for CUDA tensors and through their plain versions for CPU
  tensors, merging the hops by their logsumexp; :func:`ring_xla` is the
  plain block ring, differentiable by autograd.
* **Ulysses** (:func:`ulysses_attention`): an all-to-all from
  sequence-sharded to head-sharded, full attention over the whole
  sequence for H/n heads (the flash kernels on the card), and back.
"""

from __future__ import annotations

import torch

from distributed_model_parallel_tpu_torch.ops import flash_attention as fa
from distributed_model_parallel_tpu_torch.ops.collectives import (
    all_to_all_tiled,
    exchange,
)

# lse of a hop that contributes nothing (JAX's _NEG): a finite sentinel,
# so the merge's exp(lse - max) is 0, never NaN.
NEG = -1e30
IMPLS = ("auto", "flash", "xla")


def _ring(group):
    """(n, this rank's index, global rank of the next, of the previous)
    on the ring of ``group``'s ranks in group-rank order."""
    import torch.distributed as dist

    if group is None or not dist.is_initialized():
        return 1, 0, None, None
    n = dist.get_world_size(group)
    i = dist.get_rank(group)
    peer = lambda j: dist.get_global_rank(group, j % n)
    return n, i, peer(i + 1), peer(i - 1)


def _rotate(tensors, nxt, prv, group):
    """Every tensor of ``tensors`` one rank on round the ring (rank i
    sends to i + 1 and receives from i - 1, ``jax.lax.ppermute`` with
    ``perm=[(i, i + 1)]``), in one batch of hops, counted as ``ring``."""
    outs = [torch.empty_like(t) for t in tensors]
    exchange([(t, nxt) for t in tensors], [(o, prv) for o in outs], group,
             kind="ring")
    return outs


def hop_is_full(idx: int, hop: int) -> bool:
    """At ``hop`` rank ``idx`` holds the block of rank ``(idx - hop) mod
    n``; under causal masking it contributes iff it does not wrap round
    the ring (``_hop_is_full``)."""
    return idx >= hop


def merge_by_lse(o_acc, lse_acc, o_b, lse_b):
    """Merge two normalized attention outputs by their logsumexp, all f32
    (o ``[B, T, H, D]``, lse ``[B, H, T]``; ``_merge_by_lse``)."""
    m = torch.maximum(lse_acc, lse_b)
    w_a = torch.exp(lse_acc - m)
    w_b = torch.exp(lse_b - m)
    tot = w_a + w_b
    wa = (w_a / tot).transpose(1, 2)[..., None]
    wb = (w_b / tot).transpose(1, 2)[..., None]
    return wa * o_acc + wb * o_b, m + torch.log(tot)


class RingFlash(torch.autograd.Function):
    """Ring attention with each hop through the flash kernels (their plain
    versions for CPU tensors): ``_ring_flash``'s ``custom_vjp``.

    Forward: hop 0 is causal (under ``causal``), later hops full; a hop
    whose block lies above the diagonal is skipped, which merges as a
    no-op; K/V move on after every hop but the last. Backward: a second
    ring pass; every hop reads the global o (delta = rowsum(dO·O) of it)
    and lse, dq accumulates in place and the dk/dv accumulators travel
    with their blocks, home after n hops; all sums in f32."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        n, idx, nxt, prv = _ring(group)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o_acc = lse_acc = None
        k_t, v_t = k, v
        for hop in range(n):
            if not (causal and hop > 0 and not hop_is_full(idx, hop)):
                o_b, lse_b = fa.flash_forward_kernel(
                    q, k_t, v_t, causal and hop == 0)
                if o_acc is None:
                    o_acc, lse_acc = o_b.float(), lse_b
                else:
                    o_acc, lse_acc = merge_by_lse(o_acc, lse_acc,
                                                  o_b.float(), lse_b)
            if hop < n - 1:
                k_t, v_t = _rotate((k_t, v_t), nxt, prv, group)
        o = o_acc.to(q.dtype)
        lse = lse_acc.contiguous()
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.causal = group, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group, causal = ctx.group, ctx.causal
        n, idx, nxt, prv = _ring(group)
        do = do.contiguous()
        delta = fa.bwd_delta(o, do)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk_t = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_t = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_t, v_t = k, v
        for hop in range(n):
            if not (causal and hop > 0 and not hop_is_full(idx, hop)):
                hop_causal = causal and hop == 0
                dq += fa.flash_bwd_dq_kernel(q, k_t, v_t, do, lse, delta,
                                             hop_causal).float()
                dk_b, dv_b = fa.flash_bwd_dkv_kernel(q, k_t, v_t, do, lse,
                                                     delta, hop_causal)
                dk_t += dk_b.float()
                dv_t += dv_b.float()
            if n > 1:
                moving = (dk_t, dv_t) if hop == n - 1 else (k_t, v_t, dk_t,
                                                            dv_t)
                moved = _rotate(moving, nxt, prv, group)
                if hop == n - 1:
                    dk_t, dv_t = moved
                else:
                    k_t, v_t, dk_t, dv_t = moved
        return (dq.to(q.dtype), dk_t.to(k.dtype), dv_t.to(v.dtype), None,
                None)


def _block_attn(q, k, v, *, scale, q_pos, k_pos, causal):
    """Scores and masking for one (Q_local, K_block) pair in f32: the
    per-query max, the softmax denominator and the value sums of the
    block (``_block_attn``)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        keep = k_pos[None, :] <= q_pos[:, None]
        s = s.masked_fill(~keep[None, None], float("-inf"))
    m = s.amax(-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    l = p.sum(-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return m_safe, l, o


class _Rotate(torch.autograd.Function):
    """One hop of K and V round the ring, differentiable: the cotangents
    go one hop back (the transpose of ``ppermute``). K and V move in one
    node, so the hops' backward runs as one chain, in the same order on
    every rank."""

    @staticmethod
    def forward(ctx, k, v, group):
        ctx.group = group
        _, _, nxt, prv = _ring(group)
        return tuple(_rotate((k.contiguous(), v.contiguous()), nxt, prv,
                             group))

    @staticmethod
    def backward(ctx, gk, gv):
        _, _, nxt, prv = _ring(ctx.group)
        dk, dv = _rotate((gk.contiguous(), gv.contiguous()), prv, nxt,
                         ctx.group)
        return dk, dv, None


def ring_xla(q, k, v, group, causal: bool = True) -> torch.Tensor:
    """The plain block ring (``_ring_xla``): each hop's local score tensor
    materialized, online-softmax state in f32, differentiable by autograd
    (the K/V hops carry their cotangents back). A block above the
    diagonal is computed too, fully masked: it merges as JAX's skipped
    hop does (``m = l = o = 0``), and it keeps every rank's K/V hops on
    the autograd graph, so the backward's hops run on every rank."""
    n, idx, _, _ = _ring(group)
    t_local = q.shape[1]
    scale = q.shape[-1] ** -0.5
    dev = q.device
    q_pos = idx * t_local + torch.arange(t_local, device=dev)
    shape = (q.shape[0], q.shape[2], t_local)
    m_acc = torch.full(shape, float("-inf"), device=dev)
    l_acc = torch.zeros(shape, device=dev)
    o_acc = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    k_t, v_t = k, v
    for hop in range(n):
        src = (idx - hop) % n
        k_pos = src * t_local + torch.arange(t_local, device=dev)
        m_b, l_b, o_b = _block_attn(q, k_t, v_t, scale=scale, q_pos=q_pos,
                                    k_pos=k_pos, causal=causal)
        m_new = torch.maximum(m_acc, m_b)
        a = torch.where(torch.isfinite(m_acc), torch.exp(m_acc - m_new),
                        torch.zeros_like(m_acc))
        b = torch.exp(m_b - m_new) * (l_b > 0)
        l_acc = a * l_acc + b * l_b
        o_acc = (a.transpose(1, 2)[..., None] * o_acc
                 + b.transpose(1, 2)[..., None] * o_b)
        m_acc = m_new
        if hop < n - 1:
            k_t, v_t = _Rotate.apply(k_t, v_t, group)
    denom = torch.where(l_acc > 0, l_acc, torch.ones_like(l_acc))
    return (o_acc / denom.transpose(1, 2)[..., None]).to(q.dtype)


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown ring impl {impl!r}; known: auto, flash, "
                         f"xla")


def ring_attention(q, k, v, group, *, causal: bool = True,
                   impl: str = "auto") -> torch.Tensor:
    """Blockwise ring attention over ``group`` (the seq group).

    q/k/v: local shards ``[B, T_local, H, Dh]``; the global sequence is
    the concatenation of the shards in group-rank order. Returns the
    local output shard. ``impl``: "flash" runs every hop through the
    flash kernels (:class:`RingFlash`: the kernels on CUDA tensors, their
    plain versions on CPU tensors), "xla" the plain block ring
    (:func:`ring_xla`), "auto" is "flash": on the card a shard the
    kernels do not take raises, as ``flash_attention`` does, and never
    falls back to the plain ring. No dispatch threshold is taken from the
    TPU."""
    _check_impl(impl)
    if impl == "xla":
        return ring_xla(q, k, v, group, causal)
    return RingFlash.apply(q, k, v, group, causal)


def ulysses_attention(q, k, v, group, *, causal: bool = True,
                      impl: str = "auto") -> torch.Tensor:
    """All-to-all (DeepSpeed-Ulysses) sequence parallelism over ``group``:
    ``[B, T/n, H, Dh] -> [B, T, H/n, Dh]``, attention over the whole
    sequence for the local heads, and back. Requires ``H % n == 0``.
    ``impl``: "xla" runs the plain ``full_attention``; "auto" and "flash"
    the flash kernels (their plain versions on CPU tensors)."""
    _check_impl(impl)
    import torch.distributed as dist

    n = (dist.get_world_size(group)
         if group is not None and dist.is_initialized() else 1)
    if q.shape[2] % n:
        raise ValueError(f"heads {q.shape[2]} not divisible by axis size "
                         f"{n}")

    def seq_to_heads(x):
        return all_to_all_tiled(x, 2, 1, group, kind="ulysses")

    def heads_to_seq(x):
        return all_to_all_tiled(x, 1, 2, group, kind="ulysses")

    qh, kh, vh = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    if impl == "xla":
        o = fa.full_attention(qh, kh, vh, causal=causal)
    else:
        o = fa.flash_attention(qh, kh, vh, causal=causal)
    return heads_to_seq(o)
