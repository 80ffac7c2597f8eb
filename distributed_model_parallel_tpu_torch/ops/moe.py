"""Mixture-of-Experts with expert parallelism over the ``expert`` mesh
axis — the port of ``distributed_model_parallel_tpu/ops/moe.py``.

Top-k token routing — top-1 (Switch-style, the raw gate) or top-2 and up
(GShard-style, gates renormalized over the chosen experts) — with a
static capacity per expert, and dispatch and combine in index form: each
kept token-choice owns one slot of the ``[E·cap]`` queue space, so the
dispatch is a scatter of token ids into the slots and a gather of the
tokens, and the combine a gather of each choice's expert output. Dropped
choices ride the residual path. The JAX package writes the same work as
gathers, scatters and two einsums outside any Pallas kernel; here it is
torch index ops and two batched products (``torch.bmm``).

* :class:`MoEConfig` — the JAX config, with its ``top_k`` range check;
* :func:`route` — the routing of N tokens in index form, and the stats
  vector ``[balance, z, drop]``;
* :func:`moe_ffn` — the MoE FFN on ``[B, T, d]``, the experts local or
  sharded over a process group (``ep_group``) with the tiled all-to-all
  before and after them;
* :func:`naive_moe_ffn` — the plain per-token version of the same
  routing (each kept choice's expert applied to its token alone), the
  reference the tests and the card's check hold :func:`moe_ffn` to.

Ties: ``jax.lax.top_k`` takes the lower expert index among equal
probabilities, which bf16 makes common; :func:`route` ranks by a stable
descending sort, which keeps the lower index first.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from distributed_model_parallel_tpu_torch.ops.collectives import (
    all_to_all_tiled,
    world_size,
)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 4
    d_model: int = 64
    d_ff: int = 128
    capacity_factor: float = 2.0
    top_k: int = 1
    # Only consulted for top_k > 1: renormalize the chosen experts' gates
    # to sum to 1 (GShard). Top-1 always uses the raw softmax prob.
    normalize_gates: bool = True

    def __post_init__(self):
        if not (1 <= self.top_k <= self.num_experts):
            raise ValueError(
                f"top_k={self.top_k} must be in [1, num_experts="
                f"{self.num_experts}]")


def capacity(cfg: MoEConfig, n: int) -> int:
    """Queue slots per expert for ``n`` tokens: ``max(1, int(cf·k·n/E))``
    (capacity scales with k, as in GShard)."""
    return max(1, int(cfg.capacity_factor * cfg.top_k * n
                      / cfg.num_experts))


def route(router: torch.Tensor, x: torch.Tensor, cfg: MoEConfig):
    """Top-k routing of ``x`` ([N, d]) with per-expert capacity, in index
    form. Returns ``(experts [N, k], gates [N, k], slot [N, k], keep [N,
    k], cap, stats [3] f32)``: ``slot[n, j] = experts[n, j]·cap + queue
    position`` (clamped to the queue's last slot where the choice is
    dropped), ``keep`` where the position is under ``cap``. Choice j's
    positions come after every earlier choice's assignments (GShard
    order), so a second choice never collides with first-choice traffic.

    ``stats``: the load-balance loss over first-choice fractions (Switch/
    GShard), the router z-loss (the mean squared logsumexp of the f32
    logits) and the drop rate (the share of the N·k choices past
    capacity; a metric, with no gradient)."""
    n = x.shape[0]
    E, k = cfg.num_experts, cfg.top_k
    cap = capacity(cfg, n)
    logits = x @ router                                  # [N, E], x's dtype
    probs = torch.softmax(logits, dim=-1)
    # A stable descending sort keeps the lower index first among ties, as
    # lax.top_k does; torch.topk promises no order there.
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    experts = order[:, :k]
    gates = torch.gather(probs, 1, experts)
    if k > 1 and cfg.normalize_gates:
        gates = gates / gates.sum(-1, keepdim=True)
    counts = torch.zeros(E, dtype=torch.long, device=x.device)
    slots, keeps = [], []
    for j in range(k):
        e_j = experts[:, j]
        onehot = F.one_hot(e_j, E)                       # [N, E] int64
        pos_all = torch.cumsum(onehot, 0) - 1 + counts
        pos = torch.gather(pos_all, 1, e_j[:, None])[:, 0]
        keeps.append(pos < cap)
        slots.append(e_j * cap + torch.clamp(pos, max=cap - 1))
        counts = counts + onehot.sum(0)
    slot = torch.stack(slots, 1)
    keep = torch.stack(keeps, 1)
    frac_tokens = F.one_hot(experts[:, 0], E).float().mean(0)
    frac_probs = probs.mean(0)
    balance = E * torch.sum(frac_tokens * frac_probs)
    z = torch.mean(torch.logsumexp(logits.float(), dim=-1) ** 2)
    drop = 1.0 - keep.float().sum() / (n * k)
    stats = torch.stack([balance.float(), z, drop.detach()])
    return experts, gates, slot, keep, cap, stats


def _experts_ffn(expert_in: torch.Tensor, w_in: torch.Tensor,
                 w_out: torch.Tensor) -> torch.Tensor:
    """Each expert's MLP over its queue: ``[E, C, d] -> [E, C, d]``
    (``gelu`` in its tanh form, as ``jax.nn.gelu`` defaults)."""
    h = F.gelu(torch.bmm(expert_in, w_in), approximate="tanh")
    return torch.bmm(h, w_out)


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig,
            ep_group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN on ``x`` ([B, T, d]): ``(y, stats)``, ``y`` in ``x``'s
    dtype, ``stats`` :func:`route`'s f32 vector.

    ``params``: ``router`` [d, E], ``w_in`` [E(_local), d, f], ``w_out``
    [E(_local), f, d]. Without ``ep_group`` every expert is local. With
    it, this rank holds experts ``[r·E_local, (r+1)·E_local)`` of the
    group's rank r, and the expert queues ``[E, C, d]`` are exchanged by
    the tiled all-to-all (``kind="moe"``) to ``[E_local, ep·C, d]`` — its
    experts' queues from every rank of the group — and back after the
    experts.

    The LM replicates its tokens over the expert group, so each local
    expert sees ``ep`` copies of every queue. The return exchange hands
    each copy ``1/ep`` of its cotangent and the dispatch exchange scales
    the cotangent it returns by ``ep``: the expert weights get the
    gradient of the mean of the group's losses (the true gradient, where
    the copies are equal), and every rank's tokens, router and upstream
    weights the gradient of its own loss — with no reduction over the
    group, as JAX's shard_map gives at ``expert=2`` the one-device
    gradient."""
    b, t, d = x.shape
    n = b * t
    xf = x.reshape(n, d)
    experts, gates, slot, keep, cap, stats = route(params["router"], xf, cfg)
    E = cfg.num_experts
    # Dispatch: kept slots are unique, so the scatter of token ids never
    # collides; dropped choices land in one extra row, cut off (JAX drops
    # them at the out-of-range sentinel E·cap); unfilled slots keep token
    # id n, the zero pad row.
    slot_token = torch.full((E * cap + 1,), n, dtype=torch.long,
                            device=x.device)
    ids = torch.arange(n, device=x.device)
    for j in range(cfg.top_k):
        slot_token[torch.where(keep[:, j], slot[:, j], E * cap)] = ids
    xf_pad = torch.cat([xf, xf.new_zeros(1, d)])
    expert_in = xf_pad[slot_token[:E * cap]].reshape(E, cap, d)
    ep = world_size(ep_group) if ep_group is not None else 1
    if ep > 1:
        expert_in = all_to_all_tiled(expert_in, 0, 1, ep_group, kind="moe",
                                     grad_scale=float(ep))
        expert_out = _experts_ffn(expert_in, params["w_in"],
                                  params["w_out"])
        expert_out = all_to_all_tiled(expert_out, 1, 0, ep_group,
                                      kind="moe", grad_scale=1.0 / ep)
    else:
        expert_out = _experts_ffn(expert_in, params["w_in"],
                                  params["w_out"])
    # Combine: each kept choice's expert output, weighted by its gate.
    out_flat = expert_out.reshape(E * cap, d)
    y = torch.zeros(n, d, dtype=x.dtype, device=x.device)
    for j in range(cfg.top_k):
        w = torch.where(keep[:, j], gates[:, j],
                        torch.zeros((), dtype=gates.dtype,
                                    device=x.device)).to(x.dtype)
        y = y + w[:, None] * out_flat[slot[:, j]]
    return y.reshape(b, t, d).to(x.dtype), stats


@torch.no_grad()
def naive_moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig,
                  routing: tuple | None = None) -> torch.Tensor:
    """The plain version of :func:`moe_ffn` with all experts local: the
    same routing (:func:`route`, or ``routing``, its output for these
    tokens), then each kept choice's expert MLP applied to its token
    alone — no queues, no capacity buffer, no padding — weighted by its
    gate and summed per token."""
    b, t, d = x.shape
    xf = x.reshape(-1, d)
    experts, gates, _, keep, _, _ = (routing if routing is not None else
                                     route(params["router"], xf, cfg))
    y = torch.zeros_like(xf)
    for j in range(cfg.top_k):
        for e in range(cfg.num_experts):
            rows = torch.nonzero(keep[:, j] & (experts[:, j] == e))[:, 0]
            if rows.numel() == 0:
                continue
            h = F.gelu(xf[rows] @ params["w_in"][e], approximate="tanh")
            y[rows] += (gates[rows, j].to(x.dtype)[:, None]
                        * (h @ params["w_out"][e]))
    return y.reshape(b, t, d)
