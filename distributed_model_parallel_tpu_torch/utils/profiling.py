"""Analytic model FLOPs — the port's own copy of ``lm_model_flops`` from
``distributed_model_parallel_tpu/utils/profiling.py`` (which imports
jax), for the MFU that ``chip_smoke.py`` prints."""

from __future__ import annotations


def lm_model_flops(cfg, batch: int, seq: int, causal: bool = True) -> float:
    """Model FLOPs (forward + backward) of one Transformer LM train step
    at ``batch`` sequences of ``seq`` tokens.

    * dense matmuls: ``6 * N_mm * tokens``, ``N_mm`` the matmul parameters
      touched per token (q/kv/o projections, the MLP or the top-k routed
      experts' slice plus the router, LM head; embeddings and elementwise
      work excluded);
    * attention scores/values: fwd ``4*B*H*pairs*hd`` + bwd twice that,
      ``pairs`` the attended (q, k) positions — ``T*(T+1)/2`` causal,
      banded under a sliding window;
    * backward recompute (remat, the flash backward's score rebuild) is
      excluded: this is MFU, not HFU.
    """
    d, hd = cfg.d_model, cfg.head_dim
    H, kv = cfg.n_heads, cfg.kv_heads
    L, f, V = cfg.n_layers, cfg.d_ff, cfg.vocab_size
    attn_proj = d * H * hd + d * kv * 2 * hd + H * hd * d
    if cfg.moe_experts:
        mlp = cfg.moe_top_k * 2 * d * f + d * cfg.moe_experts
    else:
        mlp = 2 * d * f
    n_mm = L * (attn_proj + mlp) + d * V
    tokens = batch * seq
    dense = 6 * n_mm * tokens
    if cfg.attn_window is not None:
        w = min(cfg.attn_window, seq)
        # query i attends keys (i-w, i]: min(i+1, w) positions
        pairs = seq * w - w * (w - 1) // 2
    elif causal:
        pairs = seq * (seq + 1) // 2
    else:
        pairs = seq * seq
    attn = 12 * batch * H * pairs * hd * L
    return float(dense + attn)
