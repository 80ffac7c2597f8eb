"""The optimizers other than SGD — ``adam``, ``adamw``, ``lamb``, ``lars``
and ``adafactor`` — each composed as optax 0.2.6 composes it
(``optax/_src/alias.py``), in plain tensor ops over a list of leaves.

The JAX package runs them through optax, as XLA elementwise work: there is
no Pallas kernel behind them, so there is none here either. Each
optimizer is an :class:`Transform`: ``init`` allocates its state as named
per-leaf tensors in optax's layout (``mu``/``nu`` of ``scale_by_adam``,
``trace`` of ``trace``, ``v_row``/``v_col``/``v`` of
``scale_by_factored_rms``; a leaf without one of them holds None), and
``update(grads, params, lr, count)`` returns each leaf's update (what
``optax.apply_updates`` adds) and advances the state. ``count`` is the
number of updates applied before this one, the count every optax state of
the chain carries. The elementwise work runs as ``torch._foreach_*`` ops
over all the leaves at once (a few launches a step on the card instead of
one a leaf), in optax's operation order, each product and sum rounded on
its own; whole-leaf norms are ``torch._foreach_norm``.

Whole-leaf reductions — the norms of lars and lamb's trust ratio, the
RMS of adafactor's block clip and parameter scale, and its factored row
and column means — read a :class:`LeafLayout` per leaf: the leaf's shape
in the port's layout, the port dim of each of its JAX dims (adafactor
factors by the JAX shape, as optax does in the JAX package) and, for a
slice, each dim it is cut along over a process group (FSDP's one cut;
the LM's cuts over the stage, model and expert axes, up to two at once);
a sum over a cut dim is all-reduced over that cut's group, so a slice's
update is the whole leaf's, each distinct slice counted once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from distributed_model_parallel_tpu_torch.ops.collectives import all_reduce_

NAMES = ("adam", "adamw", "lamb", "lars", "adafactor")


class LeafLayout(NamedTuple):
    """How a leaf maps onto the whole leaf of the JAX package: ``shape``
    the whole leaf's shape in the port's layout, ``jax_dims`` the port dim
    of each JAX dim, ``cuts`` every ``(dim, group)`` the slice is cut
    along, each port dim over its process group (empty: the leaf is
    whole)."""

    shape: tuple
    jax_dims: tuple
    cuts: tuple = ()


def plain_layout(t: torch.Tensor) -> LeafLayout:
    """A whole leaf whose port layout is its JAX layout."""
    return LeafLayout(tuple(t.shape), tuple(range(t.ndim)))


def _sums(parts: list[torch.Tensor], layouts: list[LeafLayout],
          sharded: list[bool], kind: str = "optimizer"
          ) -> list[torch.Tensor]:
    """``parts[i]`` summed over the ranks of every group its layout is cut
    over where ``sharded[i]``: one all-reduce per group, of every part
    cut over it (a part cut twice, over each of its two groups in
    turn)."""
    out = list(parts)
    for level in range(max((len(lay.cuts) for lay, s in
                            zip(layouts, sharded) if s), default=0)):
        groups: dict = {}
        for i, (lay, s) in enumerate(zip(layouts, sharded)):
            if s and level < len(lay.cuts):
                group = lay.cuts[level][1]
                groups.setdefault(id(group), (group, []))[1].append(i)
        for group, idx in groups.values():
            flat = torch.cat([out[i].reshape(-1) for i in idx])
            all_reduce_(flat, group, kind=kind)
            off = 0
            for i in idx:
                n = out[i].numel()
                out[i] = flat[off:off + n].view(out[i].shape)
                off += n
    return out


def leaf_norms(xs: list[torch.Tensor],
               layouts: list[LeafLayout]) -> torch.Tensor:
    """``jnp.linalg.norm`` of each whole leaf, ``sqrt(sum(x * x))``, as
    one vector: a slice's squared norm summed over its group first."""
    norms = list(torch._foreach_norm(xs))
    sharded = [bool(lay.cuts) for lay in layouts]
    if any(sharded):
        sq = _sums([n * n for n in norms], layouts, sharded)
        norms = [q.sqrt() if s else n for q, n, s in zip(sq, norms, sharded)]
    return torch.stack(norms)


def leaf_rms(xs: list[torch.Tensor],
             layouts: list[LeafLayout]) -> torch.Tensor:
    """``sqrt(mean(x * x))`` of each whole leaf, as one vector."""
    n = torch.tensor([float(_numel(lay.shape)) for lay in layouts],
                     device=xs[0].device)
    norms = leaf_norms(xs, layouts)
    return (norms * norms / n).sqrt()


def _each(xs: list[torch.Tensor], v: torch.Tensor, op) -> list:
    """``op`` (``torch._foreach_mul`` or ``_foreach_div``) of each leaf by
    its entry of the vector ``v``."""
    return op(xs, list(v.to(xs[0].dtype).unbind()))


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def factored_dims(layout: LeafLayout, min_dim_size: int = 128
                  ) -> tuple[int, int] | None:
    """optax's ``_factored_dims`` on the JAX shape, as port dims
    ``(d1, d0)``: the second largest and the largest dimension (a stable
    sort, as numpy's argsort of a short shape), or None when the leaf has
    under two dims or its second largest is under ``min_dim_size``."""
    jshape = [layout.shape[d] for d in layout.jax_dims]
    if len(jshape) < 2:
        return None
    order = sorted(range(len(jshape)), key=lambda j: jshape[j])
    if jshape[order[-2]] < min_dim_size:
        return None
    return layout.jax_dims[order[-2]], layout.jax_dims[order[-1]]


def _bias_correction(decay: float, count: int) -> torch.Tensor:
    """``1 - decay ** count`` in float32, as ``tree_bias_correction``
    computes it: a float power (an integer exponent would multiply, and
    round, ``count`` times)."""
    f32 = torch.float32
    return 1 - torch.tensor(decay, dtype=f32) ** torch.tensor(float(count),
                                                              dtype=f32)


class Transform:
    """One optimizer's chain over a fixed list of leaves. ``state`` maps a
    state name to its per-leaf tensors (None where the leaf has none);
    ``cut_dims[name][i]``: the dim of that state tensor along each of the
    leaf's cuts (None where a reduction removed it; empty: whole)."""

    def __init__(self, params: list[torch.Tensor],
                 layouts: list[LeafLayout] | None = None):
        self.layouts = layouts or [plain_layout(p) for p in params]
        if len(self.layouts) != len(params):
            raise ValueError("one LeafLayout per parameter")
        self.state: dict[str, list] = {}
        self.cut_dims: dict[str, list] = {}

    def _zeros(self, name: str, params) -> None:
        self.state[name] = [torch.zeros_like(p) for p in params]
        self.cut_dims[name] = [tuple(d for d, _ in lay.cuts)
                               for lay in self.layouts]

    def update(self, grads: list, params: list, lr: float,
               count: int) -> list[torch.Tensor]:
        raise NotImplementedError


class Adam(Transform):
    """``scale_by_adam`` (b1 0.9, b2 0.999, ``eps``, eps_root 0), then
    ``add_decayed_weights`` (adamw, lamb), ``scale_by_trust_ratio``
    (lamb), then ``scale_by_learning_rate``."""

    def __init__(self, params, layouts=None, *, eps: float = 1e-8,
                 weight_decay: float | None = None,
                 trust_ratio: bool = False, b1: float = 0.9,
                 b2: float = 0.999):
        super().__init__(params, layouts)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.trust_ratio = trust_ratio
        self._zeros("mu", params)
        self._zeros("nu", params)

    def update(self, grads, params, lr, count):
        b1, b2 = self.b1, self.b2
        bc1 = float(_bias_correction(b1, count + 1))
        bc2 = float(_bias_correction(b2, count + 1))
        mu = torch._foreach_mul(grads, 1 - b1)
        torch._foreach_add_(mu, torch._foreach_mul(self.state["mu"], b1))
        nu = torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2)
        torch._foreach_add_(nu, torch._foreach_mul(self.state["nu"], b2))
        self.state["mu"][:], self.state["nu"][:] = mu, nu
        # m_hat / (sqrt(v_hat + eps_root) + eps), eps_root 0
        den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        if self.weight_decay is not None:
            torch._foreach_add_(u, torch._foreach_mul(params,
                                                      self.weight_decay))
        if self.trust_ratio:
            u = _trust_ratio(u, params, self.layouts, 1.0)
        return _scale(u, -lr)


class Lars(Transform):
    """``add_decayed_weights`` (every leaf), ``scale_by_trust_ratio``
    (trust coefficient 0.001, eps 0, every leaf),
    ``scale_by_learning_rate``, then ``trace`` (the momentum runs after
    the learning rate, so the trace holds lr-scaled updates)."""

    def __init__(self, params, layouts=None, *, weight_decay: float = 0.0,
                 momentum: float = 0.9, nesterov: bool = False):
        super().__init__(params, layouts)
        self.weight_decay = weight_decay
        self.momentum, self.nesterov = momentum, nesterov
        self._zeros("trace", params)

    def update(self, grads, params, lr, count):
        u = torch._foreach_add(grads, torch._foreach_mul(
            params, self.weight_decay))
        u = _scale(_trust_ratio(u, params, self.layouts, 0.001), -lr)
        mu = self.momentum
        trace = torch._foreach_add(u, torch._foreach_mul(self.state["trace"],
                                                         mu))
        self.state["trace"][:] = trace
        if self.nesterov:
            return torch._foreach_add(u, torch._foreach_mul(trace, mu))
        return list(trace)


class Adafactor(Transform):
    """``scale_by_factored_rms`` (decay rate 0.8, leaves with two dims of
    at least ``min_dim_size`` factored, eps 1e-30), ``clip_by_block_rms``
    (1.0), the learning rate, ``scale_by_param_block_rms`` (min scale
    1e-3), ``add_decayed_weights`` (when ``weight_decay_rate`` is set),
    then ``scale(-1)``."""

    def __init__(self, params, layouts=None, *,
                 weight_decay_rate: float | None = None,
                 min_dim_size: int = 128, decay_rate: float = 0.8,
                 eps: float = 1e-30, clipping_threshold: float = 1.0,
                 min_scale: float = 1e-3):
        super().__init__(params, layouts)
        self.weight_decay_rate = weight_decay_rate
        self.decay_rate, self.eps = decay_rate, eps
        self.clipping_threshold, self.min_scale = clipping_threshold, min_scale
        self.dims = [factored_dims(lay, min_dim_size) for lay in self.layouts]
        for name in ("v_row", "v_col", "v"):
            self.state[name] = [None] * len(params)
            self.cut_dims[name] = [()] * len(params)
        for i, (p, lay, dims) in enumerate(zip(params, self.layouts,
                                               self.dims)):
            cut = tuple(d for d, _ in lay.cuts)
            if dims is None:
                self.state["v"][i] = torch.zeros_like(p)
                self.cut_dims["v"][i] = cut
                continue
            d1, d0 = dims
            self.state["v_row"][i] = torch.zeros_like(p.sum(d0))
            self.state["v_col"][i] = torch.zeros_like(p.sum(d1))
            self.cut_dims["v_row"][i] = tuple(_drop(d, d0) for d in cut)
            self.cut_dims["v_col"][i] = tuple(_drop(d, d1) for d in cut)

    def _mean(self, x: torch.Tensor, dim: int, lay: LeafLayout,
              cut_dims: tuple, keepdim: bool = False) -> torch.Tensor:
        """The mean over ``dim`` of the whole leaf's ``x`` (``x`` is cut
        along ``cut_dims``, one per cut of ``lay``; None where gone)."""
        s = x.sum(dim, keepdim=keepdim)
        n = x.shape[dim]
        for d, (_, group) in zip(cut_dims, lay.cuts):
            if d == dim:
                s = _sums([s], [LeafLayout(lay.shape, lay.jax_dims,
                                           ((d, group),))], [True])[0]
                n *= _world(group)
        return s / n

    def update(self, grads, params, lr, count):
        t = torch.tensor(count + 1, dtype=torch.float32)
        rate = 1.0 - t ** (-self.decay_rate)
        r, one_minus = float(rate), float(1.0 - rate)
        st = self.state
        flat = [i for i, dims in enumerate(self.dims) if dims is None]
        out: list = [None] * len(grads)
        if flat:
            # Unfactored: v = r·v + (1 - r)·(g² + eps); u = g · v^-0.5.
            g = [grads[i] for i in flat]
            g_sqr = torch._foreach_add(torch._foreach_mul(g, g), self.eps)
            v = torch._foreach_mul([st["v"][i] for i in flat], r)
            torch._foreach_add_(v, torch._foreach_mul(g_sqr, one_minus))
            for i, vi in zip(flat, v):
                st["v"][i] = vi
            for i, ui in zip(flat, torch._foreach_mul(
                    g, torch._foreach_pow(v, -0.5))):
                out[i] = ui
        for i, (g, lay, dims) in enumerate(zip(grads, self.layouts,
                                               self.dims)):
            if dims is None:
                continue
            d1, d0 = dims
            cut = tuple(d for d, _ in lay.cuts)
            g_sqr = g * g + self.eps
            st["v_row"][i] = (r * st["v_row"][i]
                              + one_minus * self._mean(g_sqr, d0, lay, cut))
            st["v_col"][i] = (r * st["v_col"][i]
                              + one_minus * self._mean(g_sqr, d1, lay, cut))
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_mean = self._mean(st["v_row"][i], reduced_d1, lay,
                                  tuple(_drop(d, d0) for d in cut),
                                  keepdim=True)
            row_factor = (st["v_row"][i] / row_mean).pow(-0.5)
            col_factor = st["v_col"][i].pow(-0.5)
            out[i] = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        # clip_by_block_rms: u / max(1, rms(u) / threshold)
        rms = leaf_rms(out, self.layouts)
        out = _each(out, torch.clamp(rms / self.clipping_threshold,
                                     min=1.0), torch._foreach_div)
        out = _scale(out, lr)
        # scale_by_param_block_rms: u · max-clamped rms(p)
        p_rms = leaf_rms(list(params), self.layouts)
        out = _each(out, torch.where(p_rms <= self.min_scale,
                                     torch.full_like(p_rms, self.min_scale),
                                     p_rms), torch._foreach_mul)
        if self.weight_decay_rate is not None:
            torch._foreach_add_(out, torch._foreach_mul(
                params, self.weight_decay_rate))
        return torch._foreach_neg(out)


def _world(group) -> int:
    from distributed_model_parallel_tpu_torch.ops.collectives import (
        world_size,
    )

    return world_size(group)


def _drop(shard_dim: int | None, removed: int) -> int | None:
    """``shard_dim`` of a tensor once dim ``removed`` is reduced away
    (None when it was the removed one)."""
    if shard_dim is None or shard_dim == removed:
        return None
    return shard_dim - 1 if shard_dim > removed else shard_dim


def _scale(u: list, step: float) -> list:
    """``scale_by_schedule``: ``jnp.array(step, u.dtype) * u`` per leaf (a
    float32 leaf takes the Python float, which torch rounds to float32
    once)."""
    if all(x.dtype == torch.float32 for x in u):
        return torch._foreach_mul(u, step)
    return [torch.tensor(step, dtype=x.dtype).to(x.device) * x for x in u]


def _trust_ratio(updates: list, params: list, layouts: list,
                 coefficient: float) -> list:
    """``scale_by_trust_ratio`` (min norm 0, eps 0): each update times
    ``coefficient · ||p|| / ||u||``, or 1 where either norm is 0."""
    pn = leaf_norms(list(params), layouts)
    un = leaf_norms(updates, layouts)
    ratio = coefficient * pn / (un + 0.0)
    zero = (pn == 0.0) | (un == 0.0)
    return _each(updates, torch.where(zero, torch.ones_like(ratio), ratio),
                 torch._foreach_mul)


def make_transform(config, params: list, layouts=None) -> Transform:
    """The ``config.name`` chain over ``params``, as the JAX package's
    ``make_optimizer`` builds it from optax."""
    name = config.name
    if name == "adam":
        return Adam(params, layouts)
    if name == "adamw":
        return Adam(params, layouts, weight_decay=config.weight_decay)
    if name == "lamb":
        return Adam(params, layouts, eps=1e-6,
                    weight_decay=config.weight_decay, trust_ratio=True)
    if name == "lars":
        return Lars(params, layouts, weight_decay=config.weight_decay,
                    momentum=config.momentum, nesterov=config.nesterov)
    if name == "adafactor":
        return Adafactor(params, layouts,
                         weight_decay_rate=config.weight_decay or None)
    raise KeyError(f"unknown optimizer {name!r}; known: sgd, adam, adamw, "
                   f"adafactor, lamb, lars")
