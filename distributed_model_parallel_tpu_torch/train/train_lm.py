"""Transformer LM training on one device — the port's counterpart of
``scripts/train_lm.py``.

    python -m distributed_model_parallel_tpu_torch.train.train_lm \\
        --device cpu --layers 2 --d-model 64 --seq-len 32 --steps 3

``--device`` defaults to ``cuda``, where the model runs in bf16 (the flash
kernels take bf16) and attention goes through the hand-written kernels;
on ``cpu`` it runs in f32 through their plain versions. Prints one JSON
record per epoch. Multi-device meshes, MoE, remat, the chunked loss,
resume and the recovery plane are not ported yet and are refused.
"""

from __future__ import annotations

import argparse
import json

import torch

# flag -> (value that is refused, ROADMAP item), for what is not ported.
_REFUSED = {
    "dp": (lambda v: v > 1, "A9: the LM's data axis"),
    "pp": (lambda v: v > 1, "A9: spmd_pipeline"),
    "tp": (lambda v: v > 1, "A9: tensor parallelism"),
    "sp": (lambda v: v > 1, "A9: ring/Ulysses attention"),
    "ep": (lambda v: v > 1, "A9: MoE"),
    "moe_experts": (lambda v: v > 0, "A9: MoE"),
    "remat": (bool, "A9: remat"),
    "loss_chunk": (lambda v: v != 0, "A9: chunked loss head"),
    "resume": (bool, "A9: checkpoint/resume"),
    "emergency_every": (lambda v: v != 0, "A9: resilience hooks"),
    "elastic": (bool, "A9: resilience hooks"),
    "check_finite_every": (lambda v: v != 0, "A9: resilience hooks"),
    "consistency_every": (lambda v: v != 0, "A9: resilience hooks"),
    "recovery_retries": (lambda v: v != 0, "A9: resilience hooks"),
    "inject_faults": (lambda v: v is not None, "A9: resilience hooks"),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--vocab", type=int, default=1024)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--d-ff", type=int, default=512)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--rope", action="store_true",
                   help="rotary position embeddings instead of a learned "
                        "table")
    p.add_argument("--kv-heads", type=int, default=None,
                   help="grouped-query attention: k/v head count (must "
                        "divide --heads)")
    p.add_argument("--attn-window", type=int, default=None,
                   help="sliding-window attention width (flash kernels)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--epochs", type=int, default=1)
    # Accepted so they can be refused by name (not ported yet).
    for flag in ("--dp", "--pp", "--tp", "--sp", "--ep"):
        p.add_argument(flag, type=int, default=1)
    for flag in ("--moe-experts", "--loss-chunk", "--emergency-every",
                 "--check-finite-every", "--consistency-every",
                 "--recovery-retries"):
        p.add_argument(flag, type=int, default=0)
    for flag in ("--remat", "--resume", "--elastic"):
        p.add_argument(flag, action="store_true")
    p.add_argument("--inject-faults", default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    refused = [f"--{k.replace('_', '-')} (ROADMAP {item})"
               for k, (bad, item) in _REFUSED.items()
               if bad(getattr(args, k))]
    if refused:
        raise SystemExit(f"not ported yet: {', '.join(refused)}")
    if args.attn_window is not None and args.attn_window < 1:
        raise SystemExit("--attn-window must be >= 1")
    from distributed_model_parallel_tpu_torch.config import OptimizerConfig
    from distributed_model_parallel_tpu_torch.models.transformer import (
        TransformerConfig,
    )
    from distributed_model_parallel_tpu_torch.train.lm_trainer import (
        LMTrainConfig,
        LMTrainer,
    )

    # The flash kernels take bf16; the CPU's plain versions run in f32.
    dtype = torch.float32 if args.device == "cpu" else torch.bfloat16
    config = LMTrainConfig(
        model=TransformerConfig(
            vocab_size=args.vocab, d_model=args.d_model, n_heads=args.heads,
            n_layers=args.layers, d_ff=args.d_ff,
            max_seq_len=max(args.seq_len, 128),
            dtype=dtype,
            pos_embedding="rope" if args.rope else "learned",
            n_kv_heads=args.kv_heads, attn_window=args.attn_window,
            attn_impl="flash" if args.attn_window is not None else "auto"),
        optimizer=OptimizerConfig(learning_rate=args.lr, weight_decay=0.0,
                                  warmup_steps=10),
        batch_size=args.batch_size, seq_len=args.seq_len,
        steps_per_epoch=args.steps, epochs=args.epochs, device=args.device)
    for record in LMTrainer(config).fit():
        print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
