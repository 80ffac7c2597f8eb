"""Decoder-only Transformer LM in PyTorch — the serving subset and the
training forward over a ``(data, stage, model, seq, expert)`` mesh.

Counterpart of ``distributed_model_parallel_tpu/models/transformer.py``:
the config, the parameter layout, the block pieces the paged
prefill/decode steps (``serve/model.py``) compose, and the training path
(``block_apply``, ``blocks_scan``, ``apply``, ``lm_loss``) whose attention
runs the flash kernels (``ops/flash_attention.py``) on the card.

The JAX functions bind ``cfg.tp_axis``/``cfg.sp_axis``/``cfg.ep_axis``
inside a ``shard_map``; here the training functions take the rank's
``mesh.MeshSpec`` (``mesh=``), whose model, seq and expert groups those
names resolve to. Under ``tp_axis`` the block's column-parallel products take
their input through ``collectives.copy_to_group`` and its row-parallel
products end in ``collectives.reduce_from_group`` (Megatron's ``f`` and
``g``); under ``sp_axis`` attention is ring or Ulysses attention
(``ops/ring_attention.py``) and positions start at the shard's global
offset. With ``moe_experts`` every block's MLP is the top-k routed MoE
of ``ops/moe.py`` (its experts cut over the expert group under
``ep_axis``), and every block carries the MoE stats vector
``[balance, z, drop]`` (zeros for a dense block) into the loss
(:func:`aux_loss`). ``remat`` recomputes each block in the backward
(``torch.utils.checkpoint``: the whole block under ``"full"``, all but
the products with no batch dims under ``"dots"``), and ``loss_chunk``
computes the head and its loss in slices recomputed in the backward.
:func:`generate` decodes over a dense KV cache (the one-token attention
through the paged-decode kernel, the batched prefill through the flash
forward), and :func:`generate_sharded` runs it on each rank of a
``(data, model)`` mesh.

The parameter tree keeps the JAX package's layout exactly — blocks
stacked on a leading ``[n_layers]`` axis, ``wqkv: [L, d, H, 3*Dh]`` with
the q/k/v split per head along the last axis — so one tree of numpy
arrays feeds both packages (:func:`params_from_jax`) and every function
here can be held against its JAX counterpart on the same inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from distributed_model_parallel_tpu_torch.ops.collectives import (
    copy_to_group,
    reduce_from_group,
)
from distributed_model_parallel_tpu_torch.ops.flash_attention import (
    flash_attention,
    full_attention,
)
from distributed_model_parallel_tpu_torch.ops.moe import MoEConfig, moe_ffn
from distributed_model_parallel_tpu_torch.ops.paged_attention import (
    attend_rows,
    paged_attention_gather,
    paged_attention_kernel,
)

ATTN_IMPLS = ("auto", "xla", "flash")
# Length of the MoE stats vector every block carries: [load-balance loss,
# router z-loss, drop rate] (ops/moe.route). Dense blocks carry zeros.
AUX_STATS = 3


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing CUDA when no card is present —
    the port's entry points run on the card unless the caller asks for
    the CPU, and never fall back silently."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch paths")
    return dev


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The fields of the JAX ``TransformerConfig`` that serving and
    training read (the serving engine refuses MoE, as the JAX one
    does)."""

    vocab_size: int = 1024
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 4
    d_ff: int = 512
    max_seq_len: int = 256
    dtype: torch.dtype = torch.float32
    tp_axis: str | None = None
    sp_axis: str | None = None
    sp_impl: str = "ring"
    # Attention of the training path: "auto" and "flash" run the flash
    # kernels on the card (their plain versions on CPU tensors); "xla"
    # names the plain ``full_attention``, the reference. No dispatch table
    # or crossover is taken from the TPU.
    attn_impl: str = "auto"
    # Sliding-window (local) attention: each token attends the last W
    # positions — the (pos - W, pos] band of ``band_keep``.
    attn_window: int | None = None
    # Recompute each block in the backward: "full" the whole block,
    # "dots" all but the outputs of products with no batch dims (JAX's
    # dots_with_no_batch_dims_saveable).
    remat: bool = False
    remat_policy: str = "full"
    # Mixture-of-experts MLP (0 = dense): every block's MLP is a top-k
    # routed MoE (ops/moe.py); ep_axis cuts the experts over the expert
    # axis. MoE replaces the MLP, so tp_axis then cuts attention only.
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.5
    moe_aux_weight: float = 0.05   # load-balance loss weight
    moe_z_weight: float = 1e-3     # router z-loss weight
    ep_axis: str | None = None
    pos_embedding: str = "learned"     # "learned" | "rope"
    rope_theta: float = 10000.0
    # Grouped-query attention: k/v get n_kv_heads heads (must divide
    # n_heads). None = multi-head (k/v fused in wqkv).
    n_kv_heads: int | None = None
    loss_chunk: int = 0

    def __post_init__(self):
        if self.attn_window is not None and self.attn_window < 1:
            raise ValueError(
                f"attn_window must be >= 1, got {self.attn_window}")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn impl {self.attn_impl!r}; known: "
                             f"{', '.join(ATTN_IMPLS)}")
        if self.loss_chunk < 0:
            raise ValueError(
                f"loss_chunk must be >= 0 (0 = dense head), got "
                f"{self.loss_chunk}")
        if self.pos_embedding not in ("learned", "rope"):
            raise ValueError(f"unknown pos_embedding {self.pos_embedding!r}")
        if self.n_kv_heads is not None:
            if not (1 <= self.n_kv_heads <= self.n_heads):
                raise ValueError(f"n_kv_heads={self.n_kv_heads} must be in "
                                 f"[1, n_heads={self.n_heads}]")
            if self.n_heads % self.n_kv_heads:
                raise ValueError(f"n_kv_heads={self.n_kv_heads} must divide "
                                 f"n_heads={self.n_heads}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    @property
    def gqa(self) -> bool:
        return self.n_kv_heads is not None

    @property
    def moe(self):
        """The ``ops/moe.MoEConfig`` of the blocks' MLP (None: dense)."""
        if not self.moe_experts:
            return None
        return MoEConfig(num_experts=self.moe_experts, d_model=self.d_model,
                         d_ff=self.d_ff, top_k=self.moe_top_k,
                         capacity_factor=self.moe_capacity_factor)


def param_specs(cfg: TransformerConfig) -> dict:
    """The parameter tree as ``{name: (shape, init)}`` (``blocks`` nested),
    ``init`` being ``"ones"``, ``"zeros"`` or a normal's std. The JAX
    ``init_params`` layout and scales, shared by :func:`init_params` and
    the shape check of :func:`params_from_jax`."""
    d, f, L, v = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size
    h, dh, hkv = cfg.n_heads, cfg.head_dim, cfg.kv_heads
    blocks = {
        "ln1_scale": ((L, d), "ones"),
        "ln1_bias": ((L, d), "zeros"),
        "wo": ((L, d, d), d ** -0.5),
        "ln2_scale": ((L, d), "ones"),
        "ln2_bias": ((L, d), "zeros"),
    }
    if cfg.moe_experts:
        E = cfg.moe_experts
        blocks.update({
            "router": ((L, d, E), d ** -0.5),
            "w_in": ((L, E, d, f), d ** -0.5),
            "w_out": ((L, E, f, d), f ** -0.5),
        })
    else:
        blocks.update({
            "w1": ((L, d, f), d ** -0.5),
            "b1": ((L, f), "zeros"),
            "w2": ((L, f, d), f ** -0.5),
            "b2": ((L, d), "zeros"),
        })
    if cfg.gqa:
        blocks["wq"] = ((L, d, h, dh), d ** -0.5)
        blocks["wkv"] = ((L, d, hkv, 2 * dh), d ** -0.5)
    else:
        blocks["wqkv"] = ((L, d, h, 3 * dh), d ** -0.5)
    out = {
        "embed": ((v, d), 0.02),
        "blocks": blocks,
        "ln_f_scale": ((d,), "ones"),
        "ln_f_bias": ((d,), "zeros"),
        "head": ((d, v), d ** -0.5),
    }
    if cfg.pos_embedding == "learned":
        out["pos"] = ((cfg.max_seq_len, d), 0.02)
    return out


def init_params(cfg: TransformerConfig, seed: int = 0,
                device="cuda") -> dict:
    """Random parameters in the JAX layout, drawn from a ``torch.Generator``
    on ``device`` seeded with ``seed`` (the draws differ from JAX's for
    the same seed; tests share weights through :func:`params_from_jax`)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def make(spec):
        shape, init = spec
        if init == "ones":
            return torch.ones(shape, dtype=cfg.dtype, device=dev)
        if init == "zeros":
            return torch.zeros(shape, dtype=cfg.dtype, device=dev)
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32) * init
        return w.to(cfg.dtype)

    return {k: ({bk: make(bs) for bk, bs in s.items()}
                if k == "blocks" else make(s))
            for k, s in param_specs(cfg).items()}


def params_from_jax(tree: dict, cfg: TransformerConfig,
                    device="cuda") -> dict:
    """The JAX package's parameter tree (leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's tensors, in
    ``cfg.dtype`` on ``device``. Keys and shapes must match
    :func:`param_specs` exactly."""
    dev = resolve_device(device)

    def convert(name, leaf, shape):
        a = np.asarray(leaf)
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"parameter {name}: shape {a.shape}, "
                             f"expected {shape}")
        # bf16 numpy arrays (ml_dtypes) have no torch counterpart: go
        # through f32, which holds every bf16 value exactly.
        if a.dtype.kind != "f" or a.dtype.itemsize not in (4, 8):
            a = a.astype(np.float32)
        if not a.flags.writeable:        # e.g. a view of a JAX array
            a = a.copy()
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=dev, dtype=cfg.dtype)

    specs = param_specs(cfg)
    if set(tree) != set(specs) or set(tree["blocks"]) != set(
            specs["blocks"]):
        raise ValueError(f"parameter tree keys {sorted(tree)} / "
                         f"{sorted(tree.get('blocks', {}))} do not match "
                         f"the config's {sorted(specs)} / "
                         f"{sorted(specs['blocks'])}")
    out = {}
    for k, s in specs.items():
        if k == "blocks":
            out[k] = {bk: convert(f"blocks.{bk}", tree[k][bk], bs[0])
                      for bk, bs in s.items()}
        else:
            out[k] = convert(k, tree[k], s[0])
    return out


def layer_params(params: dict, layer: int) -> dict:
    """One block's (unstacked) parameters: views into the stacked tree."""
    return {k: v[layer] for k, v in params["blocks"].items()}


def layer_norm(x, scale, bias, eps=1e-5):
    """Population-variance layer norm, as ``jnp.var`` computes it."""
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding (GPT-NeoX half-split convention).

    x: [B, T, H, Dh] (Dh even); positions: [T] shared across the batch or
    [B, T] per row (the continuous decode batch). Angles in f32; the
    result is cast back to ``x.dtype``.
    """
    dh = x.shape[-1]
    if dh % 2:
        raise ValueError(f"RoPE needs an even head_dim, got {dh}")
    inv_freq = theta ** (-torch.arange(0, dh, 2, dtype=torch.float32,
                                       device=x.device) / dh)
    ang = positions.to(torch.float32)[..., :, None] * inv_freq
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    if positions.ndim == 1:
        cos, sin = cos[None], sin[None]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _qkv_proj(bp: dict, h: torch.Tensor, cfg: TransformerConfig):
    """q [B,T,H,Dh] and k/v [B,T,Hkv,Dh]: fused ``wqkv`` for multi-head,
    separate ``wq``/``wkv`` for grouped-query; the split is per head,
    along the last axis."""
    b, t, d = h.shape
    dh = cfg.head_dim
    # Head counts from the weights: the local ones under tensor parallelism.
    if cfg.gqa:
        q = (h @ bp["wq"].reshape(d, -1)).reshape(b, t, -1, dh)
        kv = (h @ bp["wkv"].reshape(d, -1)).reshape(b, t, -1, 2 * dh)
        k, v = kv.split(dh, dim=-1)
    else:
        qkv = (h @ bp["wqkv"].reshape(d, -1)).reshape(b, t, -1, 3 * dh)
        q, k, v = qkv.split(dh, dim=-1)
    return q, k, v


def _ffn(bp: dict, h: torch.Tensor, tp_group=None, *,
         cfg: TransformerConfig | None = None, ep_group=None):
    """The MLP tail: ``(y, aux)``, ``aux`` the f32 MoE stats vector
    (zeros for the dense MLP). Dense: ``jax.nn.gelu`` defaults to the tanh
    approximation, so this does too; under tensor parallelism
    ``w1``/``b1`` hold this rank's columns and ``w2`` its rows, the
    product's partial sums are all-reduced over ``tp_group``, and ``b2``
    is added once, after. MoE (a ``router`` in ``bp``; ``cfg`` gives its
    routing): ``ops/moe.moe_ffn``, the experts cut over ``ep_group``; its
    leaves are never cut over the model group, whose ranks all run it on
    the same tokens."""
    if "router" in bp:
        y, aux = moe_ffn({k: bp[k] for k in ("router", "w_in", "w_out")},
                         h, cfg.moe, ep_group)
        return y, aux.float()
    y = F.gelu(h @ bp["w1"] + bp["b1"], approximate="tanh")
    y = y @ bp["w2"]
    y = reduce_from_group(y, tp_group)
    return y + bp["b2"], torch.zeros(AUX_STATS, device=h.device)


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    x = layer_norm(x, params["ln_f_scale"], params["ln_f_bias"])
    return x @ params["head"]


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------

REMAT_POLICIES = ("full", "dots")


def check_training_config(cfg: TransformerConfig) -> None:
    """Raise, in the JAX package's words, on a config the training path
    cannot run: the MoE config's ``top_k`` range (``cfg.moe`` builds
    it)."""
    cfg.moe


# The mesh axis and group each axis-name field binds.
_AXES = {"tp_axis": ("model_axis", "model_group"),
         "sp_axis": ("seq_axis", "seq_group"),
         "ep_axis": ("expert_axis", "expert_group")}


def _axis_group(mesh, name: str | None, kind: str):
    """The process group ``name`` (``cfg.tp_axis``/``sp_axis``/``ep_axis``)
    binds on ``mesh``: its model, seq or expert group (None where the
    axis has size 1, and when ``name`` is None). A name without a mesh,
    or one the mesh does not call its model/seq/expert axis, raises (the
    JAX package's unbound axis name)."""
    if name is None:
        return None
    if mesh is None:
        raise ValueError(f"{kind}={name!r} names a mesh axis: pass the "
                         f"rank's mesh.MeshSpec (parallel/spmd_lm.py runs "
                         f"the mesh)")
    axis_attr, group_attr = _AXES[kind]
    axis = getattr(mesh, axis_attr)
    if name != axis:
        raise ValueError(f"{kind}={name!r} is not an axis of the mesh "
                         f"(its {kind[:2]} axis is {axis!r})")
    return getattr(mesh, group_attr)


def _seq_offset(t: int, cfg: TransformerConfig, mesh) -> int:
    """Global position of this rank's first token: ``seq_index x T_local``
    under a seq axis, else 0."""
    if cfg.sp_axis is None or mesh is None:
        return 0
    return mesh.seq_index * t


def embed(params: dict, tokens: torch.Tensor, cfg: TransformerConfig, *,
          pos_offset: int = 0) -> torch.Tensor:
    """[B, T] int tokens -> [B, T, d]: the table lookup, plus the learned
    positions from ``pos_offset`` (RoPE rotates q/k inside attention
    instead, and takes no offset here, as in the JAX package)."""
    if cfg.pos_embedding == "rope":
        if pos_offset:
            raise ValueError(
                "pos_offset is not supported with pos_embedding='rope'; "
                "use generate() for offset (cached) decoding")
        return params["embed"][tokens]
    t = tokens.shape[1]
    pos = params["pos"][pos_offset:pos_offset + t]
    return params["embed"][tokens] + pos[None]


def _rope_qk(q: torch.Tensor, k: torch.Tensor, cfg: TransformerConfig,
             start: int = 0):
    """Rotate q/k for the training path: the shard starts at global
    position ``start`` (0 without a seq axis)."""
    positions = start + torch.arange(q.shape[1], device=q.device)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def _repeat_kv(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """kv heads up to the query head count ([..., Hkv, Dh] -> [..., H,
    Dh]): kv head j serves query heads j·G … j·G+G−1 (``jnp.repeat``).
    The group factor comes from the local shapes, so it holds under
    tensor-parallel head sharding. Autograd sums dK/dV over each group."""
    groups = q.shape[2] // x.shape[2]
    return x if groups == 1 else x.repeat_interleave(groups, dim=2)


def _attention(q, k, v, cfg: TransformerConfig, mesh=None) -> torch.Tensor:
    """Causal attention of the training path, [B, T(_local), H(_local),
    Dh]. Under ``sp_axis``: ring or Ulysses attention over the mesh's seq
    group (``cfg.sp_impl``; any name but "ring" is Ulysses, as in the JAX
    package). Otherwise "auto" and "flash" go to :func:`flash_attention`
    (the CUDA kernels for CUDA tensors, their plain versions for CPU
    tensors); "xla" to the plain :func:`full_attention`. A window needs
    ``attn_impl="flash"`` and no seq axis, as in the JAX package."""
    if cfg.sp_axis is not None:
        if cfg.attn_window is not None:
            raise ValueError(
                "attn_window is not supported with sequence parallelism")
        from distributed_model_parallel_tpu_torch.ops.ring_attention import (
            ring_attention,
            ulysses_attention,
        )

        group = _axis_group(mesh, cfg.sp_axis, "sp_axis")
        if cfg.sp_impl == "ring":
            return ring_attention(q, k, v, group, causal=True,
                                  impl=cfg.attn_impl)
        return ulysses_attention(q, k, v, group, causal=True,
                                 impl=cfg.attn_impl)
    if cfg.attn_window is not None:
        if cfg.attn_impl != "flash":
            raise ValueError(
                "attn_window requires attn_impl='flash' (the banded "
                "block-skipping lives in the flash kernels)")
        return flash_attention(q, k, v, causal=True, window=cfg.attn_window)
    if cfg.attn_impl == "xla":
        return full_attention(q, k, v, causal=True)
    return flash_attention(q, k, v, causal=True)


def block_apply(bp: dict, x: torch.Tensor, cfg: TransformerConfig,
                mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """One pre-LN block on [B, T(_local), d] with unstacked parameters
    ``bp`` (this rank's slices under tensor and expert parallelism):
    ``(x, aux)``, ``aux`` the block's MoE stats vector (zeros for a dense
    block).

    Tensor parallelism: the normalized input enters the column-parallel
    products through ``copy_to_group`` (the backward sums the cotangent
    over the model group, which shard_map's transpose does in JAX); a
    ``wkv`` replicated under multi-query takes the same operator, since
    every model rank's heads read it; ``wo`` and ``w2`` end in
    ``reduce_from_group``. The MoE MLP takes the normalized input as it
    is (every model rank routes the same tokens)."""
    tp = _axis_group(mesh, cfg.tp_axis, "tp_axis")
    b, t, _ = x.shape
    h = layer_norm(x, bp["ln1_scale"], bp["ln1_bias"])
    h = copy_to_group(h, tp)
    if tp is not None and cfg.gqa and bp["wkv"].shape[1] == cfg.kv_heads:
        bp = dict(bp, wkv=copy_to_group(bp["wkv"], tp))
    q, k, v = _qkv_proj(bp, h, cfg)
    if cfg.pos_embedding == "rope":
        q, k = _rope_qk(q, k, cfg, _seq_offset(t, cfg, mesh))
    k, v = _repeat_kv(k, q), _repeat_kv(v, q)
    o = _attention(q, k, v, cfg, mesh)
    o = reduce_from_group(o.reshape(b, t, -1) @ bp["wo"], tp)
    x = x + o
    h = layer_norm(x, bp["ln2_scale"], bp["ln2_bias"])
    if cfg.moe_experts:
        y, aux = _ffn(bp, h, cfg=cfg, ep_group=_axis_group(
            mesh, cfg.ep_axis, "ep_axis"))
    else:
        y, aux = _ffn(bp, copy_to_group(h, tp), tp)
    return x + y, aux


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing's policy for ``remat_policy="dots"``: keep
    the outputs of 2-D matrix products (the weight products, which have
    no batch dims; ``h @ W`` reaches the dispatcher as ``mm``), recompute
    everything else (elementwise work, the batched attention products,
    the kernels and collectives)."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: TransformerConfig):
    """``fn`` wrapped in ``torch.utils.checkpoint`` (non-reentrant) under
    ``cfg.remat``, as ``jax.checkpoint`` with the policy of
    ``cfg.remat_policy``; ``fn`` itself without remat."""
    if not cfg.remat:
        return fn
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; "
                         f"known: full, dots")
    import functools

    from torch.utils.checkpoint import (
        checkpoint,
        create_selective_checkpoint_contexts,
    )

    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return lambda *args: checkpoint(fn, *args, **kw)


def blocks_scan(blocks: dict, x: torch.Tensor, cfg: TransformerConfig,
                mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """All stacked blocks in order (the JAX ``lax.scan``, as a loop), each
    under :func:`_remat`: ``(x, aux)``, ``aux`` the mean of the blocks'
    stats vectors."""
    n_layers = next(iter(blocks.values())).shape[0]
    apply_one = _remat(lambda bp, x: block_apply(bp, x, cfg, mesh), cfg)
    auxes = []
    for layer in range(n_layers):
        x, aux = apply_one({k: w[layer] for k, w in blocks.items()}, x)
        auxes.append(aux)
    return x, torch.stack(auxes).mean(0)


def embed_local(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
                mesh=None) -> torch.Tensor:
    """:func:`embed` of this rank's tokens: learned positions start at the
    shard's global offset (JAX embeds outside its shard_map, over the
    whole sequence)."""
    offset = (_seq_offset(tokens.shape[1], cfg, mesh)
              if cfg.pos_embedding == "learned" else 0)
    return embed(params, tokens, cfg, pos_offset=offset)


def hidden_with_aux(params: dict, tokens: torch.Tensor,
                    cfg: TransformerConfig, mesh=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, T(_local)] tokens -> ([B, T(_local), d] pre-head activations,
    the blocks' mean stats vector)."""
    check_training_config(cfg)
    return blocks_scan(params["blocks"], embed_local(params, tokens, cfg,
                                                     mesh), cfg, mesh)


def hidden(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
           mesh=None) -> torch.Tensor:
    """The activations of :func:`hidden_with_aux` alone."""
    return hidden_with_aux(params, tokens, cfg, mesh)[0]


def apply_with_aux(params: dict, tokens: torch.Tensor,
                   cfg: TransformerConfig, mesh=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full forward: [B, T] tokens -> ([B, T, V] logits, stats vector)."""
    x, aux = hidden_with_aux(params, tokens, cfg, mesh)
    return unembed(params, x), aux


def apply(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
          mesh=None) -> torch.Tensor:
    """Full forward: [B, T] tokens -> [B, T, V] logits."""
    return apply_with_aux(params, tokens, cfg, mesh)[0]


def aux_loss(aux: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """The weighted loss terms of the stats vector: balance and z with
    their weights; the drop rate is a metric only."""
    return cfg.moe_aux_weight * aux[0] + cfg.moe_z_weight * aux[1]


def token_loss(logits: torch.Tensor, targets: torch.Tensor,
               aux: torch.Tensor | None = None,
               cfg: TransformerConfig | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy, log-softmax in f32, plus
    :func:`aux_loss` of ``aux`` for an MoE ``cfg`` (a dense model's stats
    are zeros, which JAX adds and which change nothing)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0].mean()
    return _plus_aux(nll, aux, cfg)


def _plus_aux(loss: torch.Tensor, aux, cfg) -> torch.Tensor:
    if aux is None or cfg is None or not cfg.moe_experts:
        return loss
    return loss + aux_loss(aux, cfg)


def _chunk_nll_sum(ln_f_scale, ln_f_bias, head, xc, tc):
    logits = unembed({"ln_f_scale": ln_f_scale, "ln_f_bias": ln_f_bias,
                      "head": head}, xc)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, tc[..., None].long())[..., 0].sum()


def chunked_nll_sum(params: dict, x: torch.Tensor, targets: torch.Tensor,
                    chunk: int) -> torch.Tensor:
    """SUM of next-token NLL over ``unembed(x)`` in ``chunk``-token slices,
    each slice's logits and log-softmax recomputed in the backward
    (non-reentrant ``torch.utils.checkpoint``), so ``[B, T, V]`` never
    lives in memory: peak O(B x chunk x V) for one more head forward.
    Raises, in the JAX package's words, when ``chunk`` does not divide
    T."""
    from torch.utils.checkpoint import checkpoint

    b, t, _ = x.shape
    if t % chunk:
        raise ValueError(f"seq len {t} not divisible by loss_chunk={chunk}")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, t, chunk):
        total = total + checkpoint(
            _chunk_nll_sum, params["ln_f_scale"], params["ln_f_bias"],
            params["head"], x[:, lo:lo + chunk], targets[:, lo:lo + chunk],
            use_reentrant=False, preserve_rng_state=False)
    return total


def chunked_token_loss(params: dict, x: torch.Tensor, targets: torch.Tensor,
                       chunk: int, aux: torch.Tensor | None = None,
                       cfg: TransformerConfig | None = None) -> torch.Tensor:
    """``token_loss`` over ``unembed(x)`` through :func:`chunked_nll_sum`,
    plus the MoE terms as :func:`token_loss` adds them."""
    b, t, _ = x.shape
    return _plus_aux(chunked_nll_sum(params, x, targets, chunk) / (b * t),
                     aux, cfg)


def local_loss_chunk(cfg: TransformerConfig, t_local: int,
                     n_seq: int = 1) -> int:
    """The slice length of this rank's chunked head: ``cfg.loss_chunk``
    where it divides the local shard, else the largest length that
    divides both. JAX chunks the whole sequence of ``t_local x n_seq``
    tokens (its head sits outside the shard_map), so that is what must
    divide; the loss is the same sum of per-token terms either way."""
    import math

    chunk, t = cfg.loss_chunk, t_local * n_seq
    if t % chunk:
        raise ValueError(f"seq len {t} not divisible by loss_chunk={chunk}")
    return chunk if t_local % chunk == 0 else math.gcd(chunk, t_local)


def lm_loss_with_aux(params: dict, tokens: torch.Tensor,
                     targets: torch.Tensor, cfg: TransformerConfig,
                     mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token cross-entropy over this rank's tokens, through the
    dense head or, under ``loss_chunk``, the chunked one, plus the MoE
    terms of its stats: ``(loss, stats)``. On a mesh the mean over every
    token is the mean of the ranks' means (``parallel/spmd_lm``: the
    shards are equal)."""
    if cfg.loss_chunk:
        n_seq = mesh.num_seq if (cfg.sp_axis and mesh is not None) else 1
        chunk = local_loss_chunk(cfg, tokens.shape[1], n_seq)
        x, aux = hidden_with_aux(params, tokens, cfg, mesh)
        return chunked_token_loss(params, x, targets, chunk, aux, cfg), aux
    logits, aux = apply_with_aux(params, tokens, cfg, mesh)
    return token_loss(logits, targets, aux, cfg), aux


def lm_loss(params: dict, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: TransformerConfig, mesh=None) -> torch.Tensor:
    """The loss of :func:`lm_loss_with_aux`."""
    return lm_loss_with_aux(params, tokens, targets, cfg, mesh)[0]


def _filter_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask all but the k highest logits to -inf ([B, V])."""
    kth = torch.topk(logits, k, dim=-1).values[:, -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def _filter_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest set of tokens whose cumulative
    probability reaches p (always the top token), by rank — the JAX
    package's exclusive-cumsum rule, so tied logits outside the nucleus
    do not leak in."""
    order = torch.argsort(logits, dim=-1, descending=True)
    probs = torch.softmax(torch.gather(logits, -1, order), dim=-1)
    keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < p
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    return logits.masked_fill(~keep, float("-inf"))


def validate_sampling(cfg: TransformerConfig, temperature: float,
                      top_k: int | None, top_p: float | None) -> None:
    """The sampling-knob rules the JAX package's ``generate`` and engine
    enforce."""
    if (top_k is not None or top_p is not None) and temperature <= 0:
        raise ValueError("top_k/top_p filter the sampling distribution; "
                         "set temperature > 0 (greedy ignores them)")
    if top_k is not None and not (1 <= top_k <= cfg.vocab_size):
        raise ValueError(f"top_k must be in [1, {cfg.vocab_size}], got {top_k}")
    if top_p is not None and not (0.0 < top_p <= 1.0):
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


def _draw_seed(seed: int, position: int) -> int:
    """The generator seed of one (request seed, position) draw: a
    request's stream depends on nothing else, so it does not depend on
    who shares the batch. The CPU generator keeps only the low 32 bits of
    its seed, so the pair is mixed (splitmix64) and folded to 32 bits."""
    x = (((seed & 0xFFFFFFFF) << 32) | (position & 0xFFFFFFFF))
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 31
    return (x ^ (x >> 32)) & 0xFFFFFFFF


def make_sampler(cfg: TransformerConfig, temperature: float,
                 top_k: int | None, top_p: float | None):
    """``sample(logits [B, V], seeds, positions) -> [B] int64``: greedy
    argmax at temperature 0 (``seeds``/``positions`` unused), else
    temperature/top-k/nucleus sampling by the Gumbel-max rule, each row's
    noise drawn from a CPU ``torch.Generator`` seeded from that row's
    (seed, position). Sampled streams cannot match JAX's bits; only
    greedy is compared across frameworks."""
    validate_sampling(cfg, temperature, top_k, top_p)

    def sample(logits, seeds=None, positions=None):
        if temperature <= 0:
            return torch.argmax(logits, dim=-1)
        logits = logits.float() / temperature
        if top_k is not None:
            logits = _filter_top_k(logits, top_k)
        if top_p is not None:
            logits = _filter_top_p(logits, top_p)
        noise = torch.empty(logits.shape, dtype=torch.float32)
        for row, (s, pos) in enumerate(zip(seeds, positions)):
            gen = torch.Generator().manual_seed(_draw_seed(int(s), int(pos)))
            u = torch.rand(logits.shape[-1], generator=gen)
            noise[row] = -torch.log(-torch.log(u))
        return torch.argmax(logits + noise.to(logits.device), dim=-1)

    return sample


# ---------------------------------------------------------------------------
# cached decoding
# ---------------------------------------------------------------------------

# Decode read-boundary segment size: the plain decode attention of a
# segment's positions reads the cache prefix up to the next multiple of
# this, as the JAX package's segments do (bench.py's decode byte model is
# built on it). The kernel reads only [0, pos] of each row, segment or not.
DECODE_READ_SEG = 256
# The dense cache's page size: a layer's slab [B, T_pad, Hkv, Dh] (T_pad a
# multiple of it) is read by the paged-decode kernel as the page pool
# [B·N, page, Hkv, Dh], N = T_pad / page, row b's table b·N + arange(N).
CACHE_PAGE = 16
DECODE_IMPLS = ("kernel", "plain")


def _local_kv_heads(params: dict, cfg: TransformerConfig) -> int:
    """The kv heads this rank's weights hold (the local count under tensor
    parallelism)."""
    blocks = params["blocks"]
    return blocks["wkv"].shape[2] if cfg.gqa else blocks["wqkv"].shape[2]


def dense_cache(params: dict, cfg: TransformerConfig, batch: int,
                total: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Zeroed K and V caches ``[L, B, T_pad, Hkv, Dh]`` on the params'
    device, ``T_pad`` = ``total`` rounded up to :data:`CACHE_PAGE`; Hkv
    is the local kv head count (the GQA and tensor-parallel memory
    saving)."""
    t_pad = -(-total // CACHE_PAGE) * CACHE_PAGE
    shape = (cfg.n_layers, batch, t_pad, _local_kv_heads(params, cfg),
             cfg.head_dim)
    ck = torch.zeros(shape, dtype=cfg.dtype, device=params["embed"].device)
    return ck, torch.zeros_like(ck)


class _CacheStep:
    """What every layer of one cached step shares: the query positions
    ([C] on the device), and for the kernel the slab's page tables and
    each row's query position (int32 on the device)."""

    def __init__(self, positions, ck: torch.Tensor, kernel: bool):
        dev = ck.device
        self.host = torch.as_tensor(positions, dtype=torch.long).cpu()
        self.dev = self.host.to(dev)
        b, t_pad = ck.shape[1], ck.shape[2]
        self.t_pad, self.kernel = t_pad, kernel
        if kernel:
            n = t_pad // CACHE_PAGE
            self.tables = (torch.arange(b, dtype=torch.int32)[:, None] * n
                           + torch.arange(n, dtype=torch.int32)[None]
                           ).to(dev)
            self.pos = torch.full((b,), int(self.host[-1]),
                                  dtype=torch.int32).to(dev)


def _cached_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                      layer: int, step: _CacheStep, cfg: TransformerConfig,
                      read_len: int | None) -> torch.Tensor:
    """q [B, C, H, Dh] at ``step``'s positions over ``layer``'s written
    slab. Kernel route (a CUDA cache under ``impl="kernel"``): one token
    through the paged-decode kernel over the slab viewed as pages (it reads
    [0, pos] of each row), C > 1 through the gather path over the same
    view. Plain route: :func:`ops.paged_attention.attend_rows` over the
    first ``read_len`` positions (the whole slab when None), as the JAX
    package slices its segments."""
    b, c = q.shape[:2]
    sk, sv = ck[layer], cv[layer]                    # [B, T_pad, Hkv, Dh]
    last = int(step.host[-1])
    if step.kernel:
        pk = sk.view(-1, CACHE_PAGE, *sk.shape[2:])
        pv = sv.view(-1, CACHE_PAGE, *sv.shape[2:])
        if c == 1:
            return paged_attention_kernel(q.contiguous(), pk, pv,
                                          step.tables, step.pos,
                                          cfg.attn_window)
        return paged_attention_gather(
            q, pk, pv, step.tables, step.dev[None].expand(b, c),
            torch.full((b,), last + 1, device=q.device), cfg.attn_window)
    rl = step.t_pad if read_len is None else min(read_len, step.t_pad)
    return attend_rows(q, sk[:, :rl], sv[:, :rl],
                       step.dev[None].expand(b, c),
                       torch.full((b,), last + 1, device=q.device),
                       cfg.attn_window)


def _cached_block(bp: dict, ck: torch.Tensor, cv: torch.Tensor, layer: int,
                  x: torch.Tensor, positions, cfg: TransformerConfig, *,
                  tp_group=None, read_len: int | None = None,
                  impl: str = "kernel", step: _CacheStep | None = None
                  ) -> torch.Tensor:
    """One block for C contiguous positions over the stacked dense cache.

    x: [B, C, d]; positions: [C] absolute, contiguous; ck/cv:
    [L, B, T_pad, Hkv, Dh] (the local kv heads only), ``layer``'s slab
    written in place at ``positions`` (RoPE applied before the write, so
    the cache holds rotated keys). Scores are grouped (query head h reads
    kv head h // G) under the ``band_keep`` mask, which also hides the
    unwritten tail; ``read_len`` bounds the plain route's read (callers
    guarantee every attended position lies below it). Under ``tp_group``
    the products after ``wo`` and the dense FFN end in
    ``collectives.reduce_from_group``, as in :func:`block_apply`; a MoE
    FFN runs on the tokens present with its experts replicated. ``step``
    carries what the layers of one step share (made here when None).
    Returns the new x."""
    if step is None:
        step = _CacheStep(positions, ck, impl == "kernel" and ck.is_cuda)
    b, c = x.shape[:2]
    p0 = int(step.host[0])
    h = layer_norm(x, bp["ln1_scale"], bp["ln1_bias"])
    q, k, v = _qkv_proj(bp, h, cfg)        # q [B,C,H,Dh], kv [B,C,Hkv,Dh]
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, step.dev, cfg.rope_theta)
        k = apply_rope(k, step.dev, cfg.rope_theta)
    ck[layer, :, p0:p0 + c] = k.to(ck.dtype)
    cv[layer, :, p0:p0 + c] = v.to(cv.dtype)
    o = _cached_attention(q, ck, cv, layer, step, cfg, read_len)
    x = x + reduce_from_group(o.reshape(b, c, -1) @ bp["wo"], tp_group)
    h = layer_norm(x, bp["ln2_scale"], bp["ln2_bias"])
    y, _ = _ffn(bp, h, tp_group, cfg=cfg, ep_group=None)
    return x + y


def _prefill_block(bp: dict, ck: torch.Tensor, cv: torch.Tensor, layer: int,
                   x: torch.Tensor, cfg: TransformerConfig, *, tp_group,
                   impl: str) -> torch.Tensor:
    """The batched prefill of one block over the whole prompt [B, T0, d]:
    its K/V written to ``layer``'s slab at [0, T0), causal (banded under
    ``attn_window``) attention over the broadcast kv heads through the
    flash forward (its plain version for CPU tensors) under
    ``impl="kernel"``, the plain ``full_attention`` under ``"plain"``."""
    b, t, _ = x.shape
    h = layer_norm(x, bp["ln1_scale"], bp["ln1_bias"])
    q, k, v = _qkv_proj(bp, h, cfg)
    if cfg.pos_embedding == "rope":
        q, k = _rope_qk(q, k, cfg)
    ck[layer, :, :t] = k.to(ck.dtype)
    cv[layer, :, :t] = v.to(cv.dtype)
    kr, vr = _repeat_kv(k, q), _repeat_kv(v, q)
    attend = flash_attention if impl == "kernel" else full_attention
    o = attend(q, kr, vr, causal=True, window=cfg.attn_window)
    x = x + reduce_from_group(o.reshape(b, t, -1) @ bp["wo"], tp_group)
    h = layer_norm(x, bp["ln2_scale"], bp["ln2_bias"])
    y, _ = _ffn(bp, h, tp_group, cfg=cfg, ep_group=None)
    return x + y


def _row_seed(seed: int, row: int) -> int:
    """The sampling seed of batch row ``row`` (its global index) of a
    ``generate`` call seeded ``seed``."""
    return (seed * 0x9E3779B1 + row) & 0xFFFFFFFF


def check_generate(cfg: TransformerConfig, t0: int, steps: int,
                   prefill_chunk: int | None) -> None:
    """The JAX ``generate``'s refusals, in its words."""
    total = t0 + steps
    if steps < 1:
        raise ValueError("steps must be >= 1")
    if total > cfg.max_seq_len:
        raise ValueError(f"prompt + steps = {total} exceeds max_seq_len "
                         f"{cfg.max_seq_len}")
    if prefill_chunk is not None:
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{prefill_chunk}")
        if t0 % prefill_chunk:
            raise ValueError(f"prompt length {t0} not divisible by "
                             f"prefill_chunk={prefill_chunk}")


@torch.no_grad()
def generate(params: dict, cfg: TransformerConfig, prompt, steps: int, *,
             seed: int = 0, temperature: float = 0.0,
             top_k: int | None = None, top_p: float | None = None,
             prefill_chunk: int | None = None, mesh=None,
             row_offset: int = 0, impl: str = "kernel",
             return_logits: int = 0):
    """Autoregressive decoding over a dense per-layer KV cache.

    prompt: [B, T0] ints -> [B, T0 + steps] int64 tokens on the params'
    device. Greedy at ``temperature`` 0, else sampling at that temperature
    filtered by ``top_k`` and/or ``top_p`` (the engine's
    :func:`make_sampler`). The prompt fills the cache in one batched
    forward, or in ``prefill_chunk``-token slices against the growing cache
    (the prompt length must be a multiple); then one cached step per new
    position, in read-boundary segments of :data:`DECODE_READ_SEG`.

    On the card (``impl="kernel"``) the batched prefill's attention runs the
    flash forward kernel and each one-token step's attention the
    paged-decode kernel over the cache viewed as pages; chunked prefill's
    slices take the gather path. ``impl="plain"`` runs the plain versions
    on the card; CPU tensors always do. MoE blocks run ``ops/moe.moe_ffn``
    with the experts replicated, capacity taken from the tokens present.

    ``mesh``: the rank's ``mesh.MeshSpec`` when ``cfg.tp_axis`` is set; the
    params are then its slices (:func:`generate_sharded`), the cache holds
    the local kv heads, and the products after ``wo`` and the FFN are
    all-reduced over the model group.

    Sampling: JAX draws the whole batch from one key. Here a row's draw
    depends only on (``seed``, the row's global index ``row_offset + b``,
    the position), through ``_row_seed`` and ``_draw_seed``, so a data
    split does not change a row's stream. Sampled tokens cannot match
    JAX's bits; greedy tokens are what the two packages compare.

    ``return_logits=n`` also returns the logits of the first n sampling
    steps (the prefill's, then the decode steps'), ``[B, n, V]``. The
    shape of the last cache built is kept in ``generate.cache_shape``.
    """
    if impl not in DECODE_IMPLS:
        raise ValueError(f"unknown decode impl {impl!r}; known: "
                         f"{', '.join(DECODE_IMPLS)}")
    dev = params["embed"].device
    prompt = torch.as_tensor(prompt).to(device=dev, dtype=torch.long)
    b, t0 = prompt.shape
    check_generate(cfg, t0, steps, prefill_chunk)
    total = t0 + steps
    sample = make_sampler(cfg, temperature, top_k, top_p)
    tp = _axis_group(mesh, cfg.tp_axis, "tp_axis")
    ck, cv = dense_cache(params, cfg, b, total)
    generate.cache_shape = tuple(ck.shape)
    kernel = impl == "kernel" and ck.is_cuda
    blocks = [layer_params(params, li) for li in range(cfg.n_layers)]
    seeds = [_row_seed(seed, row_offset + r) for r in range(b)]
    kept: list[torch.Tensor] = []
    learned = cfg.pos_embedding == "learned"

    def embed_at(tokens: torch.Tensor, start: int) -> torch.Tensor:
        # RoPE rotates q/k inside the blocks and takes no offset here.
        return embed(params, tokens, cfg, pos_offset=start if learned else 0)

    def pick(logits: torch.Tensor, pos: int) -> torch.Tensor:
        if len(kept) < return_logits:
            kept.append(logits)
        return sample(logits, seeds, [pos] * b).to(dev)

    if prefill_chunk is not None:
        for lo in range(0, t0, prefill_chunk):
            step = _CacheStep(range(lo, lo + prefill_chunk), ck, kernel)
            x = embed_at(prompt[:, lo:lo + prefill_chunk], lo)
            for li, bp in enumerate(blocks):
                x = _cached_block(bp, ck, cv, li, x, None, cfg, tp_group=tp,
                                  step=step)
    else:
        x = embed_at(prompt, 0)
        for li, bp in enumerate(blocks):
            x = _prefill_block(bp, ck, cv, li, x, cfg, tp_group=tp,
                               impl=impl)
    tok = pick(unembed(params, x[:, -1:])[:, 0], t0 - 1)   # position t0
    out = [prompt, tok[:, None]]
    # Positions t0 .. total-2 consume tokens t0 .. total-2 and emit tokens
    # t0+1 .. total-1. A segment's positions all lie below its boundary
    # ``hi``, so the plain route reads [0, hi) of the cache.
    p = t0
    while p < total - 1:
        hi = min(total, (p // DECODE_READ_SEG + 1) * DECODE_READ_SEG)
        p_end = min(total - 1, hi)
        for pos in range(p, p_end):
            step = _CacheStep((pos,), ck, kernel)
            x = embed_at(tok[:, None], pos)
            for li, bp in enumerate(blocks):
                x = _cached_block(bp, ck, cv, li, x, None, cfg, tp_group=tp,
                                  read_len=hi, step=step)
            tok = pick(unembed(params, x)[:, 0], pos)
            out.append(tok[:, None])
        p = p_end
    tokens = torch.cat(out, dim=1)
    if return_logits:
        return tokens, torch.stack(kept, dim=1)
    return tokens


generate.cache_shape = None


@torch.no_grad()
def generate_sharded(params: dict, cfg: TransformerConfig, prompt,
                     steps: int, spec, *, seed: int = 0,
                     temperature: float = 0.0, top_k: int | None = None,
                     top_p: float | None = None,
                     prefill_chunk: int | None = None, impl: str = "kernel",
                     return_logits: int = 0):
    """:func:`generate` on each rank of a ``(data, model)`` mesh: every rank
    passes the whole params and the whole prompt [B, T0] and gets the whole
    result [B, T0 + steps] back, as JAX's ``out_specs=P(data)`` assembles
    it.

    The rank cuts its model-axis slices (``parallel/tensor_parallel.
    shard_tree``: heads and FFN columns; a ``wkv`` that
    ``kv_heads_shardable`` cannot split stays replicated), takes its data
    row's prompt rows, decodes them with the model group (its cache holds
    the local kv heads; the products after ``wo`` and the FFN are
    all-reduced), and all-gathers the rows over the data group. Greedy
    tokens equal the replicated :func:`generate`'s; a row's sampled stream
    depends on its global index, not on the split. ``return_logits`` gives
    this rank's rows' logits beside the whole tokens."""
    from distributed_model_parallel_tpu_torch.ops.collectives import (
        all_gather_concat,
    )
    from distributed_model_parallel_tpu_torch.parallel.tensor_parallel import (
        shard_tree,
    )

    if cfg.moe_experts and cfg.ep_axis:
        raise ValueError("expert-parallel decode is not implemented; "
                         "decode with experts replicated (ep_axis=None)")
    if spec.num_stages > 1 or spec.num_seq > 1 or spec.num_expert > 1:
        raise ValueError("generate_sharded runs on a (data, model) mesh; "
                         "decode keeps the blocks layer-stacked and the "
                         "sequence whole")
    local = shard_tree(params, cfg, spec)
    prompt = torch.as_tensor(prompt)
    rows = spec.rows(prompt.shape[0])
    got = generate(local, cfg, prompt[rows], steps, seed=seed,
                   temperature=temperature, top_k=top_k, top_p=top_p,
                   prefill_chunk=prefill_chunk, mesh=spec,
                   row_offset=rows.start, impl=impl,
                   return_logits=return_logits)
    tokens = got[0] if return_logits else got
    if spec.num_data > 1:
        # gloo moves host tensors: stage a CUDA result through host memory.
        staged = tokens.is_cuda and spec.backend == "gloo"
        whole = all_gather_concat(tokens.cpu() if staged else tokens,
                                  spec.group)
        tokens = whole.to(tokens.device)
    return (tokens, got[1]) if return_logits else tokens
