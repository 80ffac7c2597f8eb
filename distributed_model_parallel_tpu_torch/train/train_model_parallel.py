"""Pipeline (model-parallel) training — the port's counterpart of
``scripts/train_model_parallel.py``.

    python -m distributed_model_parallel_tpu_torch.train.train_model_parallel \\
        --device cpu --model tinycnn --stages 2 --microbatches 2 \\
        --batch-size 32 --synthetic-train-size 96 --synthetic-eval-size 32
    python -m distributed_model_parallel_tpu_torch.train.train_model_parallel \\
        --device cpu --model tinycnn --engine spmd --stages 2 --dp 2 \\
        --nproc 4 --schedule 1f1b --microbatches 2 --batch-size 32
    torchrun --nproc-per-node 4 -m \\
        distributed_model_parallel_tpu_torch.train.train_model_parallel \\
        --engine spmd --stages 4 --microbatches 8 --fused

``--engine runner`` (the default) drives every stage from one process
(``PipelineTrainer``): ``--stages`` devices, ``cuda:0 .. cuda:S-1``, or
``--devices`` to name them (``cuda:0,cuda:0`` shares one card);
``--microbatches 1`` is the reference's naive schedule, more give GPipe
or ``--schedule 1f1b``; ``--virtual-stages V`` interleaves ``V·S``
chunks. ``--engine spmd`` runs one process per rank of a ``--dp`` x
``--stages`` mesh (``Trainer(strategy="spmd_pipeline")``): ``--nproc``
spawns them (rank r on ``cuda:r`` over NCCL; ``--backend gloo`` to share
cards; ``--device cpu`` runs gloo), or torchrun starts them. Stage
boundaries: ``--boundaries 0,4,10,16,19`` (the reference's 4-GPU cut of
MobileNetV2), ``--auto-partition`` (the cost-balanced cut), or equal unit
counts. The JAX script's refusals hold: ``--dp`` with the runner, and
virtual stages with spmd. ``--device`` defaults to ``cuda`` (bf16 over
f32 parameters, cuDNN's autotuner on); ``cpu`` runs f32. Prints one JSON
record per epoch (rank 0's under spmd). Resume and the resilience hooks
are not ported yet and are refused.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

_REFUSED = {
    "resume": (bool, "A5: checkpoint/resume"),
    "emergency_every": (lambda v: v != 0, "A11: resilience hooks"),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("data", nargs="?", default="./data", help="dataset root")
    p.add_argument("--dataset-type", "-type", default="synthetic",
                   choices=("synthetic", "cifar10"))
    p.add_argument("--device", default="cuda")
    p.add_argument("--devices", default=None,
                   help="runner: comma-separated stage devices (default: "
                        "the first --stages cards)")
    p.add_argument("--model", default="mobilenetv2",
                   choices=("mobilenetv2", "mobilenetv2_nobn", "tinycnn"))
    p.add_argument("--dtype", default=None, choices=("float32", "bfloat16"))
    p.add_argument("--stages", "--world-size", default=4, type=int)
    p.add_argument("--microbatches", default=1, type=int,
                   help="1 = the reference's naive schedule; >1 = GPipe/1F1B")
    p.add_argument("--schedule", default="gpipe", choices=("gpipe", "1f1b"))
    p.add_argument("--virtual-stages", default=1, type=int,
                   help=">1 = interleaved placement (runner): each device "
                        "owns that many non-contiguous chunks")
    p.add_argument("--boundaries", default=None,
                   help="comma-separated unit boundaries, e.g. 0,4,10,16,19")
    p.add_argument("--auto-partition", action="store_true",
                   help="cost-balanced boundaries instead of equal counts")
    p.add_argument("--engine", default="runner", choices=("runner", "spmd"))
    p.add_argument("--dp", default=1, type=int,
                   help="data-axis width for --engine spmd (ranks = dp x "
                        "stages)")
    p.add_argument("--nproc", default=None, type=int,
                   help="spmd: ranks to spawn (default dp x stages)")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    p.add_argument("--lr", default=0.4, type=float)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--wd", default=1e-4, type=float)
    p.add_argument("--fused", action="store_true",
                   help="the fused SGD kernel, one FusedSGD per stage")
    p.add_argument("--epochs", default=1, type=int)
    p.add_argument("--batch-size", "-b", default=512, type=int)
    p.add_argument("--warmup-steps", default=10, type=int)
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--synthetic-train-size", default=2048, type=int)
    p.add_argument("--synthetic-eval-size", default=512, type=int)
    p.add_argument("--seed", default=0, type=int)
    # Accepted so they can be refused by name (not ported yet).
    p.add_argument("--resume", "-r", action="store_true")
    p.add_argument("--emergency-every", default=0, type=int)
    return p.parse_args(argv)


def _config(args):
    from distributed_model_parallel_tpu_torch.config import (
        DataConfig,
        MeshConfig,
        ModelConfig,
        OptimizerConfig,
        TrainConfig,
    )

    on_cpu = torch.device(args.device).type == "cpu"
    boundaries = (None if args.boundaries is None else
                  tuple(int(x) for x in args.boundaries.split(",")))
    return TrainConfig(
        model=ModelConfig(name=args.model,
                          dtype=args.dtype or ("float32" if on_cpu
                                               else "bfloat16")),
        data=DataConfig(name=args.dataset_type, root=args.data,
                        batch_size=args.batch_size,
                        eval_batch_size=args.batch_size,
                        augment=not args.no_augment,
                        synthetic_train_size=args.synthetic_train_size,
                        synthetic_eval_size=args.synthetic_eval_size),
        optimizer=OptimizerConfig(learning_rate=args.lr,
                                  momentum=args.momentum,
                                  weight_decay=args.wd,
                                  warmup_steps=args.warmup_steps,
                                  fused=args.fused),
        mesh=MeshConfig(data=args.dp, stage=args.stages),
        strategy="spmd_pipeline" if args.engine == "spmd" else "gspmd",
        num_microbatches=args.microbatches, stage_boundaries=boundaries,
        auto_partition=args.auto_partition,
        pipeline_schedule=args.schedule,
        virtual_stages=args.virtual_stages, epochs=args.epochs,
        seed=args.seed, device=args.device)


def _fit_rank(spec, args) -> list[dict]:
    from distributed_model_parallel_tpu_torch.train.trainer import Trainer

    if spec.device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    return Trainer(_config(args), spec=spec).fit()


def main(argv=None):
    args = parse_args(argv)
    refused = [f"--{k.replace('_', '-')} (ROADMAP {item})"
               for k, (bad, item) in _REFUSED.items()
               if bad(getattr(args, k))]
    if refused:
        raise SystemExit(f"not ported yet: {', '.join(refused)}")
    if args.boundaries is not None and args.auto_partition:
        print("warning: explicit --boundaries override --auto-partition",
              file=sys.stderr)
    if args.engine == "runner" and args.dp != 1:
        raise SystemExit(
            "--dp is an --engine spmd knob; the single-controller runner "
            "pipelines over stages only (PipelineTrainer ignores the data "
            "axis — refusing to silently drop your requested data "
            "parallelism)")
    config = _config(args)
    if args.engine == "runner":
        from distributed_model_parallel_tpu_torch.train.pipeline_trainer import (  # noqa: E501
            PipelineTrainer,
        )

        devices = (None if args.devices is None
                   else args.devices.split(","))
        if torch.device(args.device).type == "cuda":
            torch.backends.cudnn.benchmark = True
        records = PipelineTrainer(config, devices).fit()
    else:
        if args.virtual_stages != 1:
            raise SystemExit(
                "--engine spmd runs one stage per rank; virtual stages are "
                "a runner-engine schedule (interleaved 1F1B over ranks is "
                "not ported yet: ROADMAP A7)")
        from distributed_model_parallel_tpu_torch import mesh
        from distributed_model_parallel_tpu_torch.train.trainer import (
            check_train_config,
        )

        check_train_config(config)
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            spec = mesh.init_process_group(config.mesh, device=args.device,
                                           backend=args.backend)
            try:
                records = _fit_rank(spec, args)
            finally:
                torch.distributed.destroy_process_group()
            if spec.rank != 0:
                return
        else:
            n = args.nproc or args.dp * args.stages
            records = mesh.spawn(_fit_rank, n, args, device=args.device,
                                 backend=args.backend,
                                 config=config.mesh)[0]
    for record in records:
        print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
