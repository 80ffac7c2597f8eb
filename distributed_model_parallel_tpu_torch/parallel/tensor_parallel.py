"""Sharding rules for the Transformer LM over the stage, model and expert
axes — the port of ``distributed_model_parallel_tpu/parallel/
tensor_parallel.py``.

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
  slices over the model axis;
* :func:`param_cuts` — every cut of each leaf over the whole mesh, as
  JAX's ``param_specs`` with a stage axis and an ``ep_axis`` states them:
  dim 0 of every ``blocks`` leaf (the stacked layers) over ``stage``,
  ``w_in``/``w_out``'s expert dim 1 over ``expert``, the model cuts above
  (never a MoE leaf: MoE replaces the MLP, so the model axis cuts
  attention only); :func:`cut_leaf` and :func:`gather_leaf` cut and
  gather a leaf over one or two axes at once, :func:`shard_tree` a
  whole tree (the trainer, the checkpoint, an export).
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
                     shard_kv: bool = True, moe: bool = False) -> dict:
    """The dim of each stacked ``params["blocks"]`` leaf cut over the model
    axis (None: replicated) — JAX's ``block_specs`` with no stage axis.
    Leaves are ``[L, ...]``; heads and ffn columns shard, the rest is
    replicated; the MoE leaves (``moe``) are never cut over it."""
    m = (lambda d: d) if tp else (lambda d: None)
    dims = {
        "ln1_scale": None, "ln1_bias": None,
        "wo": m(1),                      # row-parallel: rows = heads x Dh
        "ln2_scale": None, "ln2_bias": None,
    }
    if moe:
        dims.update(router=None, w_in=None, w_out=None)
    else:
        dims.update(w1=m(2), b1=m(1),    # column-parallel
                    w2=m(1),             # row-parallel
                    b2=None)
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
               shard_kv=kv_heads_shardable(cfg, num_model),
               moe=bool(cfg.moe_experts)),
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


# -- every axis: stage, model, expert ---------------------------------------------

# Each cut axis's process group and index on a MeshSpec.
_AXIS_ATTRS = {"stage": ("stage_group", "stage_index", "num_stages"),
               "model": ("model_group", "model_index", "num_model"),
               "expert": ("expert_group", "expert_index", "num_expert")}


def param_cuts(cfg, spec) -> dict:
    """Every cut of each leaf on the mesh of ``spec`` (a ``MeshSpec``):
    a tuple of ``(axis, dim)``, ``axis`` one of ``"stage"``, ``"model"``,
    ``"expert"``, in that order; an axis of size 1 cuts nothing. Dim 0 of
    every ``blocks`` leaf over the stage axis; the model cuts of
    :func:`param_shard_dims`; ``w_in`` and ``w_out`` (``[L, E, ...]``)
    over the expert axis on dim 1 under ``cfg.ep_axis``; ``router`` and
    the top-level leaves (embedding, positions, final norm, head) are
    never cut."""
    model = param_shard_dims(cfg, spec.num_model)
    stage = spec.num_stages > 1
    expert = (bool(cfg.moe_experts) and cfg.ep_axis is not None
              and spec.num_expert > 1)

    def cuts(name, dim, block):
        out = []
        if block and stage:
            out.append(("stage", 0))
        if dim is not None and spec.num_model > 1:
            out.append(("model", dim))
        if block and expert and name in ("w_in", "w_out"):
            out.append(("expert", 1))
        return tuple(out)

    return {k: ({bk: cuts(bk, bd, True) for bk, bd in v.items()}
                if k == "blocks" else cuts(k, v, False))
            for k, v in model.items()}


def axis_group(spec, axis: str):
    """The process group of ``axis`` (a name of :func:`param_cuts`) on
    ``spec``."""
    return getattr(spec, _AXIS_ATTRS[axis][0])


def axis_size(spec, axis: str) -> int:
    """The ranks along ``axis`` (a name of :func:`param_cuts`) on
    ``spec``."""
    return getattr(spec, _AXIS_ATTRS[axis][2])


def cut_leaf(leaf: torch.Tensor, cuts: tuple, spec,
             name: str = "") -> torch.Tensor:
    """This rank's slice of a whole leaf: each cut in turn, the leaf split
    into equal parts along its dim and the rank's part kept (a contiguous
    copy where it is cut). A dim that does not split evenly raises."""
    for axis, dim in cuts:
        _, index, size = _AXIS_ATTRS[axis]
        n = getattr(spec, size)
        if leaf.shape[dim] % n:
            raise ValueError(f"parameter {name}: dim {dim} of size "
                             f"{leaf.shape[dim]} does not split over "
                             f"{n} {axis} ranks")
        leaf = leaf.chunk(n, dim)[getattr(spec, index)]
    return leaf.contiguous() if cuts else leaf


@torch.no_grad()
def gather_leaf(leaf: torch.Tensor, cuts: tuple, spec) -> torch.Tensor:
    """The whole leaf from this rank's slice: all-gathered over each cut's
    group along its dim, the last cut first (every rank of the groups
    calls)."""
    for axis, dim in reversed(cuts):
        leaf = all_gather_concat(leaf.detach().contiguous(),
                                 axis_group(spec, axis), axis=dim)
    return leaf


def shard_tree(params: dict, cfg, spec) -> dict:
    """This rank's slices of a whole parameter tree over every axis of
    ``spec`` (:func:`param_cuts`)."""
    return _map(lambda k, leaf, cuts: cut_leaf(leaf, cuts, spec, k), params,
                param_cuts(cfg, spec))

