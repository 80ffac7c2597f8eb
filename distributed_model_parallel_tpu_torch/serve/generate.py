"""LM generation CLI on the port's serving engine, with random weights.

Counterpart of ``scripts/generate.py`` on its engine path (one request,
the degenerate case of continuous batching): the prompt prefills in
fixed-size chunks against the paged cache and decode attention runs
through the paged CUDA kernel. Weights are drawn from ``--seed``; there
is no checkpoint loading in the port yet. Greedy, temperature, top-k and
nucleus (top-p) sampling.

Example:
  python -m distributed_model_parallel_tpu_torch.serve.generate \\
      --device cuda --rope --layers 2 --d-model 64 --prompt 5,17,42 \\
      --gen-steps 32
"""

from __future__ import annotations

import argparse
import sys

def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--prefill-chunk", type=int, default=32,
                   help="prompt chunk size; prompts pad to a multiple")
    p.add_argument("--page-size", type=int, default=16,
                   help="KV-cache page size (tokens)")
    p.add_argument("--vocab", type=int, default=1024)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--d-ff", type=int, default=512)
    p.add_argument("--max-seq-len", type=int, default=128)
    p.add_argument("--rope", action="store_true", help="rotary positions")
    p.add_argument("--kv-heads", type=int, default=None,
                   help="grouped-query k/v heads")
    p.add_argument("--attn-window", type=int, default=None,
                   help="sliding-window width")
    p.add_argument("--prompt", default="1,2,3",
                   help="comma-separated token ids")
    p.add_argument("--gen-steps", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy argmax decoding")
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None) -> list[int]:
    args = parse_args(argv)
    if args.prefill_chunk < 1:
        raise SystemExit(f"--prefill-chunk must be >= 1, got "
                         f"{args.prefill_chunk}")
    if args.page_size < 1:
        raise SystemExit(f"--page-size must be >= 1, got {args.page_size}")
    from distributed_model_parallel_tpu_torch.models import (
        transformer as tfm,
    )
    from distributed_model_parallel_tpu_torch.serve import (
        Engine,
        ServeConfig,
    )

    cfg = tfm.TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=args.heads,
        n_layers=args.layers, d_ff=args.d_ff,
        max_seq_len=max(args.max_seq_len, 128),
        pos_embedding="rope" if args.rope else "learned",
        n_kv_heads=args.kv_heads, attn_window=args.attn_window)
    params = tfm.init_params(cfg, seed=args.seed, device=args.device)
    print(f"random weights (seed {args.seed}) on {args.device}",
          file=sys.stderr)
    prompt = [int(x) for x in args.prompt.split(",")]
    serve = ServeConfig(
        n_slots=1, page_size=args.page_size,
        n_pages=-(-cfg.max_seq_len // args.page_size) + 1,
        max_seq_len=cfg.max_seq_len,
        prefill_chunk=min(args.prefill_chunk, cfg.max_seq_len),
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p)
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
