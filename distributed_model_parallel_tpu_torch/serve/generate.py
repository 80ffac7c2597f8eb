"""LM generation CLI: restore a ``train_lm`` checkpoint and decode.

Counterpart of ``scripts/generate.py``. Model-shape flags must match the
training run; the params are read from the ``lm`` slot under
``--checkpoint-dir`` (the port's ``train_lm`` writes it), or, when there
is none, drawn from ``--seed`` (announced on stderr), so the decode path
runs without a training run. A checkpoint written with
``--virtual-stages > 1`` stores its block rows interleaved: ``--pp-stages``
(the training run's stage count) de-interleaves them.

* ``--dp``/``--tp`` > 1: ``dp x tp`` ranks (``mesh.spawn``: rank r on
  ``cuda:r`` over NCCL, ``--backend gloo`` to share a card, gloo on the
  CPU) decode with ``models/transformer.generate_sharded`` — the batch
  over ``data`` (one prompt row a replica), heads and the KV cache over
  ``model``;
* ``--moe-experts``: ``models/transformer.generate`` (the serving engine
  refuses MoE, whose routing couples co-resident tokens);
* otherwise the serving engine, one request: the prompt prefills in
  fixed-size chunks against the paged cache, decode attention through the
  paged CUDA kernel.

``--device`` defaults to ``cuda``, where the model runs in bf16 (the flash
and paged kernels); on ``cpu`` it runs in f32 through their plain
versions. Greedy, temperature, top-k and nucleus (top-p) sampling.

Example:
  python -m distributed_model_parallel_tpu_torch.train.train_lm \\
      --device cpu --layers 2 --d-model 64 --steps 50
  python -m distributed_model_parallel_tpu_torch.serve.generate \\
      --device cpu --layers 2 --d-model 64 --prompt 5,17,42 --gen-steps 32
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--dp", type=int, default=1,
                   help="batch-shard decoding over this many ranks")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel decoding: heads (and the KV cache) "
                        "split over this many ranks, the training layout")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="process group of --dp/--tp ranks (gloo shares a "
                        "card)")
    p.add_argument("--prefill-chunk", type=int, default=None,
                   help="prefill the prompt in N-token slices against the "
                        "growing cache; on the engine path the chunk size "
                        "(default 32; prompts pad to a multiple)")
    p.add_argument("--page-size", type=int, default=16,
                   help="KV-cache page size (tokens) on the engine path")
    p.add_argument("--vocab", type=int, default=1024)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--d-ff", type=int, default=512)
    p.add_argument("--max-seq-len", type=int, default=128)
    p.add_argument("--rope", action="store_true",
                   help="rotary positions; must match the training run")
    p.add_argument("--kv-heads", type=int, default=None,
                   help="grouped-query k/v heads; must match the training "
                        "run")
    p.add_argument("--attn-window", type=int, default=None,
                   help="sliding-window width; must match the training run")
    p.add_argument("--moe-experts", type=int, default=0,
                   help="experts per block; must match the training run")
    p.add_argument("--moe-top-k", type=int, default=2,
                   help="routing fan-out; must match the training run")
    p.add_argument("--checkpoint-dir", default="./checkpoint")
    p.add_argument("--pp-stages", type=int, default=1,
                   help="stage count of the training run: only needed to "
                        "de-interleave a checkpoint trained with "
                        "--virtual-stages > 1")
    p.add_argument("--prompt", default="1,2,3",
                   help="comma-separated token ids")
    p.add_argument("--gen-steps", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy argmax decoding")
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def model_config(args):
    """The ``TransformerConfig`` of the shape flags (bf16 on the card, f32
    on the CPU; ``tp_axis="model"`` under ``--tp > 1``)."""
    import torch

    from distributed_model_parallel_tpu_torch.models.transformer import (
        TransformerConfig,
    )

    return TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=args.heads,
        n_layers=args.layers, d_ff=args.d_ff,
        max_seq_len=max(args.max_seq_len, 128),
        dtype=torch.float32 if args.device == "cpu" else torch.bfloat16,
        moe_experts=args.moe_experts, moe_top_k=args.moe_top_k,
        tp_axis="model" if args.tp > 1 else None,
        pos_embedding="rope" if args.rope else "learned",
        n_kv_heads=args.kv_heads, attn_window=args.attn_window,
        attn_impl="flash" if args.attn_window is not None else "auto")


def _stderr(msg: str) -> None:
    print(msg, file=sys.stderr)


def load_params(args, cfg, device, note=_stderr):
    """The params of the ``lm`` slot under ``--checkpoint-dir`` (blocks
    de-interleaved under a ``virtual_stages > 1`` stamp), or random ones
    from ``--seed`` when there is no checkpoint; ``note`` gets what was
    loaded (stderr)."""
    import numpy as np

    from distributed_model_parallel_tpu_torch.models import (
        transformer as tfm,
    )
    from distributed_model_parallel_tpu_torch.parallel.spmd_pipeline import (
        deinterleave_block_rows,
    )
    from distributed_model_parallel_tpu_torch.train.checkpoint import (
        Checkpointer,
    )

    ckpt = (Checkpointer(args.checkpoint_dir)
            if os.path.isdir(args.checkpoint_dir) else None)
    if ckpt is None or not ckpt.exists("lm"):
        note(f"no LM checkpoint under {args.checkpoint_dir}; using random "
             f"init (run train_lm first for a trained model)")
        return tfm.init_params(cfg, seed=args.seed, device=device)
    specs = tfm.param_specs(cfg)
    template = {"params": {k: ({bk: np.zeros(bs[0], np.float32)
                                for bk, bs in s.items()}
                               if k == "blocks" else np.zeros(s[0],
                                                              np.float32))
                           for k, s in specs.items()}}
    try:
        tree = ckpt.restore_subtree(template, "lm")["params"]
    except ValueError as e:
        raise SystemExit(
            f"checkpoint under {args.checkpoint_dir} does not match the "
            f"model flags (--layers/--d-model/--kv-heads/--moe-experts/... "
            f"must equal the training run's): {e}") from e
    try:
        v = int(ckpt.restore_subtree(
            {"virtual_stages": np.zeros((), np.int32)},
            "lm")["virtual_stages"])
    except ValueError:
        v = 1
    params = tfm.params_from_jax(tree, cfg, device)
    if v > 1:
        if args.pp_stages < 2:
            raise SystemExit(
                f"checkpoint was trained with virtual_stages={v}; pass "
                f"--pp-stages equal to the training stage count so the "
                f"block rows can be de-interleaved")
        params["blocks"] = deinterleave_block_rows(
            params["blocks"], cfg.n_layers, args.pp_stages, v)
        note(f"de-interleaved blocks (virtual_stages={v}, "
             f"S={args.pp_stages})")
    note(f"restored LM checkpoint from {args.checkpoint_dir}")
    return params


def sharded_rank(spec, args) -> list[int]:
    """One rank of ``--dp x --tp``: the whole params, its slices cut by
    ``generate_sharded``; returns row 0's tokens."""
    from distributed_model_parallel_tpu_torch.models import (
        transformer as tfm,
    )

    cfg = model_config(args)
    params = load_params(args, cfg, spec.device,
                         _stderr if spec.rank == 0 else lambda msg: None)
    prompt = [[int(x) for x in args.prompt.split(",")]] * args.dp
    out = tfm.generate_sharded(
        params, cfg, prompt, args.gen_steps, spec, seed=args.seed + 1,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        prefill_chunk=args.prefill_chunk)
    return [int(t) for t in out[0]]


def main(argv=None) -> list[int]:
    args = parse_args(argv)
    if args.moe_experts and not (1 <= args.moe_top_k <= args.moe_experts):
        raise SystemExit(
            f"--moe-top-k must be in [1, --moe-experts={args.moe_experts}]")
    if args.prefill_chunk is not None and args.prefill_chunk < 1:
        raise SystemExit(f"--prefill-chunk must be >= 1, got "
                         f"{args.prefill_chunk}")
    if args.page_size < 1:
        raise SystemExit(f"--page-size must be >= 1, got {args.page_size}")
    prompt = [int(x) for x in args.prompt.split(",")]
    bad = [t for t in prompt if not (0 <= t < args.vocab)]
    if bad:
        raise SystemExit(f"prompt tokens {bad} outside vocab [0, "
                         f"{args.vocab})")
    from distributed_model_parallel_tpu_torch.models import (
        transformer as tfm,
    )

    if args.dp > 1 or args.tp > 1:
        from distributed_model_parallel_tpu_torch import mesh
        from distributed_model_parallel_tpu_torch.config import MeshConfig

        tokens = mesh.spawn(sharded_rank, args.dp * args.tp, args,
                            device=args.device, backend=args.backend,
                            config=MeshConfig(data=args.dp, model=args.tp),
                            timeout_s=3600.0)[0]
    else:
        cfg = model_config(args)
        params = load_params(args, cfg, args.device)
        if args.moe_experts:
            print("MoE checkpoint: decoding via models.transformer.generate "
                  "(the serving engine rejects batch-coupled MoE routing)",
                  file=sys.stderr)
            out = tfm.generate(params, cfg, [prompt], args.gen_steps,
                               seed=args.seed + 1,
                               temperature=args.temperature,
                               top_k=args.top_k, top_p=args.top_p,
                               prefill_chunk=args.prefill_chunk)
            tokens = [int(t) for t in out[0]]
        else:
            from distributed_model_parallel_tpu_torch.serve import (
                Engine,
                ServeConfig,
            )

            chunk = args.prefill_chunk or 32
            serve = ServeConfig(
                n_slots=1, page_size=args.page_size,
                n_pages=-(-cfg.max_seq_len // args.page_size) + 1,
                max_seq_len=cfg.max_seq_len,
                prefill_chunk=min(chunk, cfg.max_seq_len),
                temperature=args.temperature, top_k=args.top_k,
                top_p=args.top_p)
            engine = Engine(params, cfg, serve, device=args.device)
            req = engine.submit(prompt, args.gen_steps, seed=args.seed + 1)
            engine.run()
            if req.error:
                raise SystemExit(f"engine failed: {req.error}")
            tokens = prompt + req.generated
    print(",".join(str(t) for t in tokens))
    return tokens


if __name__ == "__main__":
    main()
