"""Tensor-parallel sharding rules for the Transformer LM — the port of
``distributed_model_parallel_tpu/parallel/tensor_parallel.py``.

Megatron-style intra-layer parallelism over the mesh's ``model`` axis:
column-parallel first products (``wqkv``/``wq``/``wkv`` cut by heads,
``w1``/``b1`` by columns), row-parallel second products (``wo`` and
``w2`` cut by rows), completed by one all-reduce each
(``ops/collectives.reduce_from_group`` in ``models/transformer``). The
JAX package states the cut as a PartitionSpec per leaf and lets
``shard_map`` hand each device its slice; here each rank holds its slice
as a tensor of its own, and the spec becomes the one dim each leaf is cut
along (:func:`param_shard_dims`).

* :func:`kv_heads_shardable` — JAX's three cases for ``wkv`` under
  grouped-query attention;
* :func:`block_shard_dims` / :func:`param_shard_dims` — the cut dim of
  each leaf (None: replicated);
* :func:`shard_params` — a whole tree in the JAX layout → this rank's
  slices; :func:`gather_params` — the inverse, over the model group (the
  checkpoint, an eval export, the tests).
"""

from __future__ import annotations

import torch

from distributed_model_parallel_tpu_torch.ops.collectives import (
    all_gather_concat,
)


def kv_heads_shardable(cfg, num_model: int) -> bool:
    """Whether wkv's head dim can shard over the tensor-parallel axis.

    True when the tp ways divide the kv head count (shard), False for
    multi-query (replicate — each query shard pairs every local q head
    with the single kv head, which is the only replicated layout where the
    local ``_repeat_kv`` head mapping equals the global one). Anything
    else has no correct local mapping and is rejected loudly.
    """
    tp = num_model if cfg.tp_axis else 1
    if tp == 1 or not cfg.gqa or cfg.kv_heads % tp == 0:
        return True
    if cfg.kv_heads == 1:
        return False
    raise ValueError(
        f"n_kv_heads={cfg.kv_heads} is neither divisible by the "
        f"tensor-parallel ways ({tp}) nor 1 (multi-query); no correct "
        f"sharded or replicated kv layout exists for this combination")


def block_shard_dims(tp: bool, *, gqa: bool = False,
                     shard_kv: bool = True) -> dict:
    """The dim of each stacked ``params["blocks"]`` leaf cut over the model
    axis (None: replicated) — JAX's ``block_specs`` with no stage axis.
    Leaves are ``[L, ...]``; heads and ffn columns shard, the rest is
    replicated."""
    m = (lambda d: d) if tp else (lambda d: None)
    dims = {
        "ln1_scale": None, "ln1_bias": None,
        "wo": m(1),                      # row-parallel: rows = heads x Dh
        "ln2_scale": None, "ln2_bias": None,
        "w1": m(2), "b1": m(1),          # column-parallel
        "w2": m(1),                      # row-parallel
        "b2": None,
    }
    if gqa:
        dims["wq"] = m(2)                # [L, d, H, Dh]: by heads
        dims["wkv"] = m(2) if shard_kv else None
    else:
        dims["wqkv"] = m(2)              # [L, d, H, 3*Dh]: by heads
    return dims


def param_shard_dims(cfg, num_model: int) -> dict:
    """The cut dim of every leaf of the transformer parameter tree over a
    model axis of ``num_model`` ranks (``cfg.tp_axis`` None: nothing is
    cut). Embedding, positions, final norm and head stay replicated."""
    tp = cfg.tp_axis is not None and num_model > 1
    out = {"embed": None,
           "blocks": block_shard_dims(
               tp, gqa=cfg.gqa,
               shard_kv=kv_heads_shardable(cfg, num_model)),
           "ln_f_scale": None, "ln_f_bias": None, "head": None}
    if cfg.pos_embedding == "learned":
        out["pos"] = None
    return out


def _map(fn, tree: dict, dims: dict) -> dict:
    return {k: (_map(fn, v, dims[k]) if isinstance(v, dict)
                else fn(k, v, dims[k])) for k, v in tree.items()}


def shard_params(params: dict, cfg, num_model: int,
                 model_index: int) -> dict:
    """This rank's slices of a whole parameter tree (tensors in the JAX
    layout): each cut leaf split into ``num_model`` equal parts along its
    dim, part ``model_index`` kept (a contiguous copy); replicated leaves
    as they are. A dim that does not split evenly raises."""
    dims = param_shard_dims(cfg, num_model)

    def cut(name, leaf, dim):
        if dim is None:
            return leaf
        if leaf.shape[dim] % num_model:
            raise ValueError(f"parameter {name}: dim {dim} of size "
                             f"{leaf.shape[dim]} does not split over "
                             f"{num_model} model ranks")
        return leaf.chunk(num_model, dim)[model_index].contiguous()

    return _map(cut, params, dims)


@torch.no_grad()
def gather_params(params: dict, cfg, num_model: int, group) -> dict:
    """Whole leaves from this rank's slices: every cut leaf all-gathered
    over the model ``group`` along its dim (every rank of the group
    calls); replicated leaves as they are."""
    dims = param_shard_dims(cfg, num_model)
    return _map(lambda _, leaf, dim: leaf if dim is None or num_model == 1
                else all_gather_concat(leaf.detach().contiguous(), group,
                                       axis=dim), params, dims)
