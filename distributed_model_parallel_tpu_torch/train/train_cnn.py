"""CNN training on one device — the port's counterpart of
``scripts/train_data_parallel.py``.

    python -m distributed_model_parallel_tpu_torch.train.train_cnn \\
        --device cpu --model tinycnn --epochs 2 --batch-size 32 \\
        --synthetic-train-size 96 --synthetic-eval-size 32
    python -m distributed_model_parallel_tpu_torch.train.train_cnn \\
        --device cuda --batch-size 512 --fused --device-data \\
        --steps-per-dispatch 10 --epochs 1

``--device`` defaults to ``cuda``, where the model computes in bf16 over
f32 parameters (``--dtype`` overrides) with cuDNN's autotuner on; on
``cpu`` it runs in f32. ``--fused`` takes the fused SGD kernel. Prints one
JSON record per epoch. Multi-device meshes, resume, the recovery plane
and the other optimizers are not ported yet and are refused.
"""

from __future__ import annotations

import argparse
import json

import torch

# flag -> (value that is refused, ROADMAP item), for what is not ported.
_REFUSED = {
    "num_devices": (lambda v: v > 1, "A6: multi-GPU data parallelism"),
    "resume": (bool, "A5: checkpoint/resume"),
    "ema_decay": (lambda v: v is not None, "A4: EMA"),
    "accum_steps": (lambda v: v != 1, "A4: gradient accumulation"),
    "emergency_every": (lambda v: v != 0, "A11: resilience hooks"),
    "elastic": (bool, "A11: resilience hooks"),
    "check_finite_every": (lambda v: v != 0, "A11: resilience hooks"),
    "inject_faults": (lambda v: v is not None, "A11: resilience hooks"),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("data", nargs="?", default="./data", help="dataset root")
    p.add_argument("--dataset-type", "-type", default="synthetic",
                   choices=("synthetic", "cifar10"))
    p.add_argument("--device", default="cuda")
    p.add_argument("--model", default="mobilenetv2",
                   choices=("mobilenetv2", "mobilenetv2_nobn", "tinycnn"))
    p.add_argument("--dtype", default=None, choices=("float32", "bfloat16"),
                   help="compute dtype (default: bfloat16 on cuda, float32 "
                        "on cpu)")
    p.add_argument("--lr", default=0.4, type=float)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--wd", default=1e-4, type=float)
    p.add_argument("--fused", action="store_true",
                   help="the fused SGD kernel over flat parameter buckets")
    p.add_argument("--epochs", default=1, type=int)
    p.add_argument("--batch-size", "-b", default=512, type=int)
    p.add_argument("--warmup-steps", default=10, type=int)
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--synthetic-train-size", default=2048, type=int)
    p.add_argument("--synthetic-eval-size", default=512, type=int)
    p.add_argument("--device-data", action="store_true",
                   help="keep the training set on the device")
    p.add_argument("--steps-per-dispatch", default=1, type=int)
    p.add_argument("--seed", default=0, type=int)
    # Accepted so they can be refused by name (not ported yet).
    p.add_argument("--num-devices", default=1, type=int)
    p.add_argument("--accum-steps", default=1, type=int)
    p.add_argument("--ema-decay", default=None, type=float)
    p.add_argument("--emergency-every", default=0, type=int)
    p.add_argument("--check-finite-every", default=0, type=int)
    p.add_argument("--resume", "-r", action="store_true")
    p.add_argument("--elastic", action="store_true")
    p.add_argument("--inject-faults", default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    refused = [f"--{k.replace('_', '-')} (ROADMAP {item})"
               for k, (bad, item) in _REFUSED.items()
               if bad(getattr(args, k))]
    if refused:
        raise SystemExit(f"not ported yet: {', '.join(refused)}")
    from distributed_model_parallel_tpu_torch.config import (
        DataConfig,
        ModelConfig,
        OptimizerConfig,
        TrainConfig,
    )
    from distributed_model_parallel_tpu_torch.train.trainer import Trainer

    on_cpu = torch.device(args.device).type == "cpu"
    dtype = args.dtype or ("float32" if on_cpu else "bfloat16")
    if not on_cpu:
        torch.backends.cudnn.benchmark = True
    config = TrainConfig(
        model=ModelConfig(name=args.model, dtype=dtype),
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
        epochs=args.epochs, seed=args.seed,
        device_resident_data=args.device_data,
        steps_per_dispatch=args.steps_per_dispatch, device=args.device)
    for record in Trainer(config).fit():
        print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
