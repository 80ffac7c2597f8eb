"""The card's peak rates and the analytic model FLOPs — the port's own
copy of what it needs from ``distributed_model_parallel_tpu/utils/
profiling.py`` (which imports jax): :func:`lm_model_flops` for the MFU
that ``chip_smoke.py`` prints, and :func:`match_device_kind`,
:func:`peak_flops_per_chip` and :func:`peak_hbm_bytes_per_chip`, which the
autotuner's cost model (``autotune/cost_model.py``) reads.

The tables are the GPUs', keyed by ``torch.cuda.get_device_name()``
prefix; the JAX package's are its TPUs' and none of them is copied here.
"""

from __future__ import annotations

# Dense bf16 tensor-core peak per card (FLOP/s), without sparsity.
GPU_PEAK_FLOPS: dict[str, float] = {
    # NVIDIA H100 data sheet, SXM5 part: 1,979 TFLOP/s bf16 with
    # sparsity, 989 dense, at the 700 W limit (nvidia-smi reads the card
    # as "NVIDIA H100 80GB HBM3, 700.00 W").
    "NVIDIA H100 80GB HBM3": 989e12,
    # NVIDIA H100 data sheet, PCIe part: 1,513 with sparsity, 756 dense.
    "NVIDIA H100 PCIe": 756e12,
}

# HBM bandwidth per card (bytes/s).
GPU_PEAK_HBM_BYTES: dict[str, float] = {
    # NVIDIA H100 data sheet, SXM5 part: 80 GB HBM3 at 3.35 TB/s.
    "NVIDIA H100 80GB HBM3": 3.35e12,
    # NVIDIA H100 data sheet, PCIe part: 80 GB HBM2e at 2.0 TB/s.
    "NVIDIA H100 PCIe": 2.0e12,
}


def _device_name(device) -> str:
    """``torch.cuda.get_device_name`` of ``device`` (default: the current
    card), or "" for a CPU device or a process without CUDA."""
    import torch

    if device is not None:
        device = torch.device(device) if not isinstance(device, int) \
            else torch.device("cuda", device)
        if device.type != "cuda":
            return ""
    if not torch.cuda.is_available():
        return ""
    return torch.cuda.get_device_name(device)


def match_device_kind(table: dict, device=None, *, kind: str | None = None):
    """Longest-prefix lookup of the card's name in ``table`` (so a longer
    row wins over a shorter one it starts with). ``device`` is a
    ``torch.device``, its string or a card index (default: the current
    card); ``kind`` looks up a recorded name without a card. Returns the
    value, or None (the CPU, or a card the table lacks)."""
    if kind is None:
        kind = _device_name(device)
    for prefix in sorted(table, key=len, reverse=True):
        if kind.startswith(prefix):
            return table[prefix]
    return None


def peak_flops_per_chip(device=None) -> float | None:
    """Dense bf16 peak FLOP/s of the card; None when unknown (the CPU),
    in which case MFU cannot be reported honestly."""
    return match_device_kind(GPU_PEAK_FLOPS, device)


def peak_hbm_bytes_per_chip(device=None) -> float | None:
    """HBM bandwidth (bytes/s) of the card; None when unknown."""
    return match_device_kind(GPU_PEAK_HBM_BYTES, device)


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
