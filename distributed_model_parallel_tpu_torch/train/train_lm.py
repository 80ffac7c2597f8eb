"""Transformer LM training over a ``(data, stage, model, seq, expert)``
mesh — the port's counterpart of ``scripts/train_lm.py``.

    python -m distributed_model_parallel_tpu_torch.train.train_lm \\
        --device cpu --layers 2 --d-model 64 --seq-len 32 --steps 3
    python -m distributed_model_parallel_tpu_torch.train.train_lm \\
        --device cpu --tp 2 --sp 2 --layers 2 --d-model 64
    python -m distributed_model_parallel_tpu_torch.train.train_lm \\
        --device cpu --pp 2 --ep 2 --moe-experts 4 --microbatches 2 \\
        --schedule 1f1b --virtual-stages 2 --layers 4 --d-model 64

``--device`` defaults to ``cuda``, where the model runs in bf16 (the flash
kernels take bf16) and attention goes through the hand-written kernels;
on ``cpu`` it runs in f32 through their plain versions. ``--dp``,
``--pp``, ``--tp``, ``--sp`` and ``--ep`` lay the ranks out as
``MeshConfig(data, stage, model, seq, expert)``: ``tp_axis="model"`` when
``--tp > 1``, ``sp_axis="seq"`` when ``--sp > 1`` (``--sp-impl ulysses``
for the all-to-all), ``ep_axis="expert"`` when ``--ep > 1`` (the
``--moe-experts`` experts cut over it, ``--moe-top-k`` a token).
``--microbatches``, ``--schedule`` (gpipe, 1f1b) and ``--virtual-stages``
set the pipeline's schedule, with the JAX script's checks. The mesh's
``dp x pp x tp x sp x ep`` ranks are processes started here (a
``file://`` store; rank r on ``cuda:r`` over NCCL, ``--backend gloo`` to
share cards, gloo on the CPU), or come from torchrun's environment. Rank
0 prints one JSON record per epoch and writes the run log and the
checkpoints. The recovery plane's flags are refused by name.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

# flag -> (value that is refused, ROADMAP item), for what is not ported.
_REFUSED = {
    "emergency_every": (lambda v: v != 0, "A11: emergency checkpoints"),
    "elastic": (bool, "A11: elastic restarts"),
    "check_finite_every": (lambda v: v != 0, "A11: guards"),
    "consistency_every": (lambda v: v != 0, "A11: consistency sentinel"),
    "recovery_retries": (lambda v: v != 0, "A11: recovery"),
    "inject_faults": (lambda v: v is not None, "A11: fault injection"),
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
    p.add_argument("--dp", type=int, default=1, help="data-parallel ways")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ways (the model axis)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel ways (the seq axis)")
    p.add_argument("--sp-impl", default="ring", choices=("ring", "ulysses"))
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline stages (the stage axis)")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel ways (shards --moe-experts)")
    p.add_argument("--moe-experts", type=int, default=0,
                   help="experts per MoE layer (0 = dense MLP)")
    p.add_argument("--moe-top-k", type=int, default=2)
    p.add_argument("--moe-z-weight", type=float, default=0.0,
                   help="router z-loss weight")
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--schedule", default="gpipe", choices=("gpipe", "1f1b"),
                   help="the pipeline's schedule")
    p.add_argument("--virtual-stages", type=int, default=1,
                   help="interleaved virtual stages (1f1b; microbatches "
                        "a multiple of --pp)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each block in the backward")
    p.add_argument("--remat-policy", default="full", choices=("full", "dots"))
    p.add_argument("--loss-chunk", type=int, default=0,
                   help="chunked cross-entropy head: tokens per slice "
                        "(0 = dense head)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--log-dir", default="./log")
    p.add_argument("--log-name", default="lm")
    p.add_argument("--checkpoint-dir", default="./checkpoint")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    # Accepted so they can be refused by name (not ported yet).
    for flag in ("--emergency-every",
                 "--check-finite-every", "--consistency-every",
                 "--recovery-retries"):
        p.add_argument(flag, type=int, default=0)
    p.add_argument("--elastic", action="store_true")
    p.add_argument("--inject-faults", default=None)
    return p.parse_args(argv)


def build_config(args):
    """The ``LMTrainConfig`` of the parsed flags, wired as JAX's
    ``scripts/train_lm.py`` wires them."""
    from distributed_model_parallel_tpu_torch.config import (
        MeshConfig,
        OptimizerConfig,
    )
    from distributed_model_parallel_tpu_torch.models.transformer import (
        TransformerConfig,
    )
    from distributed_model_parallel_tpu_torch.train.lm_trainer import (
        LMTrainConfig,
    )

    # The flash kernels take bf16; the CPU's plain versions run in f32.
    dtype = torch.float32 if args.device == "cpu" else torch.bfloat16
    return LMTrainConfig(
        model=TransformerConfig(
            vocab_size=args.vocab, d_model=args.d_model, n_heads=args.heads,
            n_layers=args.layers, d_ff=args.d_ff,
            max_seq_len=max(args.seq_len, 128),
            dtype=dtype,
            tp_axis="model" if args.tp > 1 else None,
            sp_axis="seq" if args.sp > 1 else None,
            sp_impl=args.sp_impl,
            moe_experts=args.moe_experts, moe_top_k=args.moe_top_k,
            moe_z_weight=args.moe_z_weight,
            ep_axis="expert" if args.ep > 1 else None,
            pos_embedding="rope" if args.rope else "learned",
            n_kv_heads=args.kv_heads, attn_window=args.attn_window,
            remat=args.remat, remat_policy=args.remat_policy,
            loss_chunk=args.loss_chunk,
            attn_impl="flash" if args.attn_window is not None else "auto"),
        mesh=MeshConfig(data=args.dp, stage=args.pp, model=args.tp,
                        seq=args.sp, expert=args.ep),
        optimizer=OptimizerConfig(learning_rate=args.lr, weight_decay=0.0,
                                  warmup_steps=10),
        batch_size=args.batch_size, seq_len=args.seq_len,
        num_microbatches=args.microbatches,
        pipeline_schedule=args.schedule,
        virtual_stages=args.virtual_stages,
        steps_per_epoch=args.steps, epochs=args.epochs, resume=args.resume,
        log_dir=args.log_dir, log_name=args.log_name,
        checkpoint_dir=args.checkpoint_dir, device=args.device)


def run(spec, config) -> list:
    """Fit on this rank; rank 0 prints the records. Returns the history."""
    from distributed_model_parallel_tpu_torch.train.lm_trainer import (
        LMTrainer,
    )

    history = LMTrainer(config, spec=spec).fit()
    if spec.rank == 0:
        for record in history:
            print(json.dumps(record), flush=True)
    return history


def main(argv=None):
    args = parse_args(argv)
    refused = [f"--{k.replace('_', '-')} (ROADMAP {item})"
               for k, (bad, item) in _REFUSED.items()
               if bad(getattr(args, k))]
    if refused:
        raise SystemExit(f"not ported yet: {', '.join(refused)}")
    if args.layers % max(args.pp, 1):
        raise SystemExit("--layers must be divisible by --pp")
    if args.ep > 1 and args.moe_experts % args.ep:
        raise SystemExit("--moe-experts must be divisible by --ep")
    if args.moe_experts and not (1 <= args.moe_top_k <= args.moe_experts):
        raise SystemExit(
            f"--moe-top-k must be in [1, --moe-experts={args.moe_experts}]")
    if args.attn_window is not None and args.attn_window < 1:
        raise SystemExit("--attn-window must be >= 1")
    from distributed_model_parallel_tpu_torch import mesh

    config = build_config(args)
    world = config.mesh.num_devices
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        spec = mesh.init_process_group(config.mesh, device=args.device,
                                       backend=args.backend)
        try:
            run(spec, config)
        finally:
            import torch.distributed as dist

            dist.destroy_process_group()
        return
    if world == 1:
        run(mesh.make_mesh(config.mesh, args.device), config)
        return
    mesh.spawn(run, world, config, device=args.device, backend=args.backend,
               config=config.mesh, timeout_s=24 * 3600.0)


if __name__ == "__main__":
    main()
