"""Parallelism-plan CLI: rank mesh layouts for a workload, optionally
validate the top candidates with short measured steps — the port of
``scripts/dmp_plan.py``, with its flags and its output.

* ``--dry-run`` — pure analytic planning (enumerate -> HBM filter ->
  alpha-beta rank on the cost model of the card), no rank started.
  Prints ONE JSON object: the chosen plan, the ranked feasible list, and
  the rejections. Exits 2 with a parseable
  ``{"error": "no-feasible-plan", ...}`` record when the constraints
  admit no layout.
* ``--measure K`` — additionally time the analytic top-K candidates with
  short LM trainer steps, letting the measurement overrule the model. A
  candidate of n devices runs on a fresh ``mesh.spawn`` of n ranks: NCCL
  with a card a rank where there are enough cards, else gloo (sharing
  cards, or on the CPU under ``--device cpu``).

``--device`` (default ``cuda``) sets the coefficients, the HBM capacity
and the measured ranks' device; the LM is bf16 on the card (the flash
kernels take bf16) and f32 on the CPU, as the LM CLI runs it.

Examples:
  python -m distributed_model_parallel_tpu_torch.autotune.dmp_plan \\
      --workload lm --devices 8 --dry-run
  python -m distributed_model_parallel_tpu_torch.autotune.dmp_plan \\
      --workload lm --devices 2 --batch 4 --seq 32 --d-model 32 \\
      --heads 2 --layers 2 --vocab 64 --d-ff 64 --device cpu --measure 2
  python -m distributed_model_parallel_tpu_torch.autotune.dmp_plan \\
      --workload cnn --model mobilenetv2 --devices 8 --batch 512 --dry-run
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", choices=("lm", "cnn"), default="lm")
    p.add_argument("--devices", type=int, default=8,
                   help="device count to plan for (analytic planning is "
                        "pure math; --measure starts that many ranks)")
    p.add_argument("--batch", type=int, default=64)
    # LM model geometry (the JAX script's defaults).
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--d-ff", type=int, default=1024)
    p.add_argument("--vocab", type=int, default=2048)
    p.add_argument("--moe-experts", type=int, default=0)
    # CNN workload.
    p.add_argument("--model", default="tinycnn",
                   help="CNN model registry key (--workload cnn)")
    p.add_argument("--image-size", type=int, default=32)
    # Planner knobs.
    p.add_argument("--device", default="cuda",
                   help="cuda (the card's coefficients and HBM; measured "
                        "ranks on the cards) or cpu")
    p.add_argument("--hbm-gb", type=float, default=None,
                   help="per-device HBM override, GB (default: the card's "
                        "total_memory; unfiltered on the CPU)")
    p.add_argument("--top", type=int, default=None,
                   help="truncate the printed ranked list (default: all)")
    p.add_argument("--dry-run", action="store_true",
                   help="analytic only — no rank started")
    p.add_argument("--measure", type=int, default=0, metavar="K",
                   help="time the analytic top-K with LM trainer steps; "
                        "measured-best wins")
    p.add_argument("--measure-steps", type=int, default=2)
    return p.parse_args(argv)


def _on_card(args) -> bool:
    import torch

    return torch.device(args.device).type == "cuda"


def _build_workload(args):
    import torch

    from distributed_model_parallel_tpu_torch.autotune import search

    if args.workload == "lm":
        from distributed_model_parallel_tpu_torch.models import (
            transformer as tfm,
        )

        model = tfm.TransformerConfig(
            vocab_size=args.vocab, d_model=args.d_model,
            n_heads=args.heads, n_layers=args.layers, d_ff=args.d_ff,
            max_seq_len=args.seq, pos_embedding="rope",
            moe_experts=args.moe_experts,
            dtype=torch.bfloat16 if _on_card(args) else torch.float32)
        return search.lm_workload(model, args.batch, args.seq), model
    from distributed_model_parallel_tpu_torch.config import (
        DataConfig,
        ModelConfig,
    )

    model_cfg = ModelConfig(name=args.model)
    data_cfg = DataConfig(name="synthetic", batch_size=args.batch,
                          image_size=args.image_size)
    return search.cnn_workload(model_cfg, data_cfg), model_cfg


def measure_rank(spec, model_cfg, plan, batch: int, seq: int, steps: int,
                 root: str) -> float:
    """One rank of a measured candidate: an LM trainer on the plan's mesh
    (``spec``), one warm-up step, then ``steps`` timed ones; returns
    seconds a step."""
    from distributed_model_parallel_tpu_torch.autotune import (
        lm_model_for_plan,
        time_step_fn,
    )
    from distributed_model_parallel_tpu_torch.train.lm_trainer import (
        LMTrainConfig,
        LMTrainer,
    )

    trainer = LMTrainer(LMTrainConfig(
        model=lm_model_for_plan(model_cfg, plan), mesh=spec.config,
        batch_size=batch, seq_len=seq,
        num_microbatches=plan.num_microbatches, steps_per_epoch=steps + 1,
        n_tokens=max(4 * batch * (seq + 1), 4096), eval_batches=0,
        device=spec.device.type, log_dir=root, checkpoint_dir=root,
        log_name=f"measure_rank{spec.rank}"), spec=spec)
    calls = iter(range(steps + 1))

    def step():
        trainer.train_step(*trainer.sample_batch(0, next(calls)))

    return time_step_fn(step, warmup=1, iters=steps, device=trainer.device)


def _lm_measure_fn(args, model_cfg, root: str):
    """Per-plan measured seconds a step: the slowest rank's, on a fresh
    spawn of the plan's ranks (module docstring)."""
    import torch

    from distributed_model_parallel_tpu_torch import mesh
    from distributed_model_parallel_tpu_torch.autotune import mesh_from_plan

    def measure(plan):
        n = plan.num_devices
        nccl = _on_card(args) and n <= torch.cuda.device_count()
        return max(mesh.spawn(
            measure_rank, n, model_cfg, plan, args.batch, args.seq,
            args.measure_steps, root, device=args.device,
            backend="nccl" if nccl else "gloo",
            config=mesh_from_plan(plan), store_dir=root))

    return measure


def main(argv=None) -> None:
    args = parse_args(argv)
    from distributed_model_parallel_tpu_torch.autotune import (
        InfeasiblePlanError,
        cost_model,
        memory,
        planner,
    )

    if args.measure > 0 and args.dry_run:
        raise SystemExit(
            "--measure times candidates with real device steps, which "
            "--dry-run promises not to run; pick one — no silent ignores")
    if args.measure > 0 and args.workload != "lm":
        raise SystemExit(
            "--measure times LM trainer steps; use --workload lm (the cnn "
            "path ranks analytically)")
    coeffs = cost_model.default_coefficients(
        args.device if _on_card(args) else "cpu")
    hbm = (args.hbm_gb * 1e9 if args.hbm_gb is not None
           else memory.device_hbm_bytes(device=args.device))
    workload, model_cfg = _build_workload(args)
    root = tempfile.mkdtemp(prefix="dmp_plan_")
    try:
        measure_fn = (_lm_measure_fn(args, model_cfg, root)
                      if args.measure > 0 else None)
        try:
            decision = planner.plan_parallelism(
                workload, args.devices, coeffs=coeffs, hbm_bytes=hbm,
                measure_fn=measure_fn, measure_top=args.measure)
        except InfeasiblePlanError as e:
            print(json.dumps({"error": "no-feasible-plan",
                              "workload": args.workload,
                              "n_devices": args.devices,
                              "detail": str(e)}))
            sys.exit(2)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = decision.telemetry_payload()
    ranked = [r.payload() for r in decision.ranked]
    out["ranked"] = ranked[:args.top] if args.top else ranked
    out["rejected"] = [{**p.payload(), "reason": why}
                       for p, why in decision.rejected]
    print(json.dumps(out))
    print(f"[dmp_plan] {decision.describe()}", file=sys.stderr)


if __name__ == "__main__":
    main()
