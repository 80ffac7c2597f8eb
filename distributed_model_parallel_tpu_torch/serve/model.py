"""Paged prefill/decode forward over ``models/transformer`` params.

Counterpart of ``distributed_model_parallel_tpu/serve/model.py``:

* the **prefill step** runs one fixed-size chunk of one request's prompt
  against the growing paged cache (the final partial chunk is padded and
  its writes dropped), so every prompt length runs the same shapes;
* the **decode step** advances every slot one token at the engine's fixed
  slot width, idle rows computed and masked (writes dropped), so a
  request's tokens do not depend on who shares the batch: same shapes,
  row-independent math, its own pages.

PyTorch runs eagerly, so a step is a plain function, not a compiled
program. The host-side index work (which tokens write where) is done on
the CPU from the host's tables before the step touches the device; the
pools ``ck``/``cv`` are updated in place. Decode attention goes through
the paged kernel (``impl="kernel"``); prefill chunks take the gather path.
"""

from __future__ import annotations

import torch

from distributed_model_parallel_tpu_torch.models.transformer import (
    TransformerConfig,
    _ffn,
    _qkv_proj,
    apply_rope,
    layer_norm,
    layer_params,
    make_sampler,
    resolve_device,
    unembed,
)
from distributed_model_parallel_tpu_torch.ops.paged_attention import (
    paged_attention,
)


def write_index(pages: torch.Tensor, offsets: torch.Tensor,
                keep: torch.Tensor, n_pages: int, device) -> tuple:
    """Host [B, C] page ids, in-page offsets and a keep mask -> device
    ``(rows, cols, pages, offsets)`` of the tokens whose K/V is written.
    A page id outside ``[0, n_pages)`` drops the write, as the JAX
    package's ``.at[...].set(mode="drop")`` does (``index_put_`` would
    raise instead)."""
    keep = keep & (pages >= 0) & (pages < n_pages)
    rows, cols = keep.nonzero(as_tuple=True)
    return tuple(t.to(device) for t in (rows, cols, pages[rows, cols],
                                        offsets[rows, cols]))


def paged_block(bp: dict, ck: torch.Tensor, cv: torch.Tensor, layer: int,
                x: torch.Tensor, positions: torch.Tensor, writes: tuple,
                tables: torch.Tensor, lengths: torch.Tensor,
                cfg: TransformerConfig, *, impl: str) -> torch.Tensor:
    """One transformer block over the paged cache.

    x: [B, C, d]; positions: [B, C] int32 absolute; writes: the
    :func:`write_index` of this step; tables: [B, N] int32; lengths: [B]
    valid K prefix after this step's writes; ck/cv: [L, P, page, Hkv, Dh]
    pools, written in place at ``layer``.
    """
    b, c = x.shape[:2]
    h = layer_norm(x, bp["ln1_scale"], bp["ln1_bias"])
    q, k, v = _qkv_proj(bp, h, cfg)          # q:[B,C,H,Dh] kv:[B,C,Hkv,Dh]
    if cfg.pos_embedding == "rope":
        # Per-row positions; the cache stores rotated keys.
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    rows, cols, pages, offsets = writes
    ck[layer].index_put_((pages, offsets), k[rows, cols].to(ck.dtype))
    cv[layer].index_put_((pages, offsets), v[rows, cols].to(cv.dtype))
    o = paged_attention(q.contiguous(), ck[layer], cv[layer], tables,
                        positions, lengths, window=cfg.attn_window,
                        impl=impl)
    x = x + o.reshape(b, c, -1) @ bp["wo"]
    h = layer_norm(x, bp["ln2_scale"], bp["ln2_bias"])
    return x + _ffn(bp, h)[0]


def _layers(params: dict, ck, cv, x, positions, writes, tables, lengths,
            cfg: TransformerConfig, impl: str) -> torch.Tensor:
    for li in range(cfg.n_layers):
        x = paged_block(layer_params(params, li), ck, cv, li, x, positions,
                        writes, tables, lengths, cfg, impl=impl)
    return x


def _embed_rows(params: dict, tokens: torch.Tensor, positions: torch.Tensor,
                cfg: TransformerConfig) -> torch.Tensor:
    """[B, C] tokens at per-row absolute positions -> [B, C, d]. Learned
    positions gather per row, clipped (padded prefill tails may index past
    the table; their rows are never read)."""
    x = params["embed"][tokens]
    if cfg.pos_embedding == "learned":
        x = x + params["pos"][positions.long().clamp(0, cfg.max_seq_len - 1)]
    return x


def prefill_logits(params: dict, ck, cv, tokens, pos0: int, n_valid: int,
                   table, cfg: TransformerConfig, *, page_size: int,
                   n_pages: int, impl: str, device) -> torch.Tensor:
    """One prompt chunk (``tokens`` [1, C], host) at positions
    ``pos0 .. pos0 + C - 1`` of which the first ``n_valid`` are real,
    through page table ``table`` [N] (host). Writes the valid tokens' K/V
    and returns the last valid position's logits [1, V]."""
    chunk = torch.as_tensor(tokens).shape[-1]
    table = torch.as_tensor(table).long()
    ar = torch.arange(chunk)
    positions = pos0 + ar                                       # [C]
    pages = table[torch.clamp(positions // page_size, 0, len(table) - 1)]
    writes = write_index(pages[None], (positions % page_size)[None],
                         (ar < n_valid)[None], n_pages, device)
    pos_d = positions[None].to(device=device, dtype=torch.int32)
    lengths = torch.tensor([pos0 + n_valid], device=device)
    tables_d = table[None].to(device=device, dtype=torch.int32)
    toks = torch.as_tensor(tokens).reshape(1, chunk).to(device).long()
    x = _embed_rows(params, toks, pos_d, cfg)
    x = _layers(params, ck, cv, x, pos_d, writes, tables_d, lengths, cfg,
                impl)
    return unembed(params, x[:, n_valid - 1:n_valid])[:, 0]


def decode_logits(params: dict, ck, cv, tokens, positions, tables, active,
                  cfg: TransformerConfig, *, page_size: int, n_pages: int,
                  impl: str, device) -> torch.Tensor:
    """One token for every row of the fixed-width batch: ``tokens`` [B]
    at ``positions`` [B] through ``tables`` [B, N], ``active`` [B] bool
    (all host). Idle rows compute garbage with their writes dropped.
    Returns logits [B, V]."""
    positions = torch.as_tensor(positions).long()
    tables = torch.as_tensor(tables).long()
    active = torch.as_tensor(active).bool()
    pos2 = positions[:, None]                                   # [B, 1]
    logical = torch.clamp(pos2 // page_size, 0, tables.shape[1] - 1)
    pages = torch.gather(tables, 1, logical)
    writes = write_index(pages, pos2 % page_size, active[:, None], n_pages,
                         device)
    pos_d = pos2.to(device=device, dtype=torch.int32)
    lengths = (positions + 1).to(device)
    tables_d = tables.to(device=device, dtype=torch.int32)
    toks = torch.as_tensor(tokens).to(device).long()[:, None]
    x = _embed_rows(params, toks, pos_d, cfg)
    x = _layers(params, ck, cv, x, pos_d, writes, tables_d, lengths, cfg,
                impl)
    return unembed(params, x)[:, 0]


def make_prefill_step(cfg: TransformerConfig, *, page_size: int,
                      n_pages: int, chunk: int, impl: str = "kernel",
                      temperature: float = 0.0, top_k: int | None = None,
                      top_p: float | None = None, device="cuda"):
    """One request's prompt chunk against the paged cache.

    Returns ``step(params, ck, cv, tokens [1, chunk], pos0, n_valid,
    table [N], seed) -> next_token [1]`` (pools updated in place). The
    token is sampled from the last valid position's logits — meaningful
    only on the final chunk, where it is the request's first generated
    token.
    """
    dev = resolve_device(device)
    sampler = make_sampler(cfg, temperature, top_k, top_p)

    def step(params, ck, cv, tokens, pos0, n_valid, table, seed=0):
        pos0, n_valid = int(pos0), int(n_valid)
        if torch.as_tensor(tokens).shape[-1] != chunk:
            raise ValueError(f"prefill step takes {chunk}-token chunks")
        logits = prefill_logits(params, ck, cv, tokens, pos0, n_valid,
                                table, cfg, page_size=page_size,
                                n_pages=n_pages, impl=impl, device=dev)
        return sampler(logits, [seed], [pos0 + n_valid - 1])

    return step


def make_decode_step(cfg: TransformerConfig, *, page_size: int,
                     n_pages: int, impl: str = "kernel",
                     temperature: float = 0.0, top_k: int | None = None,
                     top_p: float | None = None, device="cuda"):
    """One token for every slot of the fixed-width decode batch.

    Returns ``step(params, ck, cv, tokens [B], positions [B], tables
    [B, N], active [B] bool, seeds [B]) -> next_tokens [B]`` (pools
    updated in place). Sampling draws each row from its own (seed,
    position), so a request's stream does not depend on the batch.
    """
    dev = resolve_device(device)
    sampler = make_sampler(cfg, temperature, top_k, top_p)

    def step(params, ck, cv, tokens, positions, tables, active, seeds=None):
        logits = decode_logits(params, ck, cv, tokens, positions, tables,
                               active, cfg, page_size=page_size,
                               n_pages=n_pages, impl=impl, device=dev)
        return sampler(logits, seeds, list(map(int, positions)))

    return step
