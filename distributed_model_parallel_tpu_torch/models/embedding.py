"""Bag-of-words embedding classifier, the sparse-gradient DDP workload —
the port of ``distributed_model_parallel_tpu/models/embedding.py``
(BASELINE.json config 5: ``nn.Embedding(sparse=True)`` bag of words).

Mean-pooled token embeddings and a linear head: a huge sparse table and a
tiny dense head, so the embedding gradient path (``ops/sparse.py``)
dominates. Parameters are a flat dict ``{"embedding" [V, d], "w" [d, C],
"b" [C]}`` in the JAX package's layout (``w`` is ``[in, out]``), so a
JAX tree carries over as is (:func:`params_from_jax`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from distributed_model_parallel_tpu_torch.ops.collectives import psum_mean
from distributed_model_parallel_tpu_torch.ops.sparse import (
    apply_sparse_grad,
    embedding_grad_sparse,
    embedding_lookup,
    sparse_allreduce,
)

PARAM_NAMES = ("embedding", "w", "b")


@dataclasses.dataclass(frozen=True)
class BowConfig:
    vocab_size: int = 10000
    embed_dim: int = 64
    num_classes: int = 10


def init_params(cfg: BowConfig, seed: int = 0, device="cuda") -> dict:
    """The JAX package's init distributions (table N(0, 0.1²), head
    N(0, 1/d), zero bias) from the port's own draws of ``seed``."""
    from distributed_model_parallel_tpu_torch.models.transformer import (
        resolve_device,
    )

    gen = torch.Generator().manual_seed(int(seed))
    params = {
        "embedding": torch.randn(cfg.vocab_size, cfg.embed_dim,
                                 generator=gen) * 0.1,
        "w": torch.randn(cfg.embed_dim, cfg.num_classes, generator=gen)
        * cfg.embed_dim ** -0.5,
        "b": torch.zeros(cfg.num_classes),
    }
    dev = resolve_device(device)
    return {k: v.to(dev) for k, v in params.items()}


def params_from_jax(tree: dict, device="cuda") -> dict:
    """The JAX package's BOW parameters (numpy arrays, or anything
    ``np.asarray`` takes) as the port's f32 tensors on ``device``; the
    names must be the three of :data:`PARAM_NAMES`."""
    from distributed_model_parallel_tpu_torch.models.transformer import (
        resolve_device,
    )

    if set(tree) != set(PARAM_NAMES):
        raise ValueError(f"the JAX tree has {sorted(tree)}, the BOW "
                         f"{sorted(PARAM_NAMES)}")
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(tree[k], np.float32)).to(dev)
            for k in PARAM_NAMES}


def params_to_jax(params: dict) -> dict:
    """The port's BOW parameters as float32 numpy arrays."""
    return {k: params[k].detach().float().cpu().numpy().copy()
            for k in PARAM_NAMES}


def apply(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """``[B, T]`` int tokens -> ``[B, C]`` logits (mean-pooled bag of
    words)."""
    pooled = embedding_lookup(params["embedding"], tokens).mean(1)
    return pooled @ params["w"] + params["b"]


def loss_fn(params: dict, tokens: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of :func:`apply`'s logits."""
    return F.cross_entropy(apply(params, tokens), labels.long())


def make_sparse_sgd_step(cfg: BowConfig, lr: float, group=None):
    """``step(params, tokens, labels) -> (new_params, loss)``: SGD where
    the table's gradient stays COO end to end. The head (``w``, ``b``)
    takes its ordinary dense gradient (averaged over ``group``); the table
    takes a scatter-add of the COO pairs. With ``group`` (a process
    group; None: no reduction, as the JAX step without ``axis_name``) each
    rank runs
    its rows of the global batch and the pairs cross by
    :func:`~..ops.sparse.sparse_allreduce`; the loss is the mean over
    ranks."""

    def step(params, tokens, labels):
        t = tokens.shape[1]
        with torch.no_grad():
            pooled = embedding_lookup(params["embedding"], tokens).mean(1)
        pooled.requires_grad_(True)
        head = {k: params[k].detach().requires_grad_(True)
                for k in ("w", "b")}
        loss = F.cross_entropy(pooled @ head["w"] + head["b"],
                               labels.long())
        gw, gb, d_pooled = torch.autograd.grad(
            loss, (head["w"], head["b"], pooled))
        d_emb = (d_pooled[:, None] / t).expand(-1, t, -1)
        ids, vals = embedding_grad_sparse(tokens, d_emb)
        loss = loss.detach()
        if group is not None:
            gw, gb, loss = psum_mean([gw, gb, loss], group)
            ids, vals = sparse_allreduce(ids, vals, group)
        with torch.no_grad():
            new = {"embedding": apply_sparse_grad(params["embedding"], ids,
                                                  vals, lr),
                   "w": params["w"] - lr * gw,
                   "b": params["b"] - lr * gb}
        return new, loss

    return step


def build_embedding_bow(model_config) -> BowConfig:
    """The registry's adapter: ``ModelConfig.extra`` carries BowConfig's
    fields, ``num_classes`` the model config's."""
    extra = dict(model_config.extra)
    extra.setdefault("num_classes", model_config.num_classes)
    return BowConfig(**extra)
