"""CNN training, on one device or data-parallel over ranks — the port's
counterpart of ``scripts/train_data_parallel.py``.

    python -m distributed_model_parallel_tpu_torch.train.train_cnn \\
        --device cpu --model tinycnn --epochs 2 --batch-size 32 \\
        --synthetic-train-size 96 --synthetic-eval-size 32
    python -m distributed_model_parallel_tpu_torch.train.train_cnn \\
        --device cuda --batch-size 512 --fused --device-data \\
        --steps-per-dispatch 10 --epochs 1
    python -m distributed_model_parallel_tpu_torch.train.train_cnn \\
        --device cpu --model tinycnn --nproc 2 --strategy ddp \\
        --bn-mode sync --allreduce bucketed --batch-size 32
    python -m distributed_model_parallel_tpu_torch.train.train_cnn \\
        --device cpu --model tinycnn --nproc 2 --strategy fsdp \\
        --batch-size 32
    python -m distributed_model_parallel_tpu_torch.train.train_cnn \\
        --device cuda --model resnet50 --batch-size 512 --fused \\
        --device-data --steps-per-dispatch 10
    python -m distributed_model_parallel_tpu_torch.train.train_cnn \\
        --device cpu --model tinycnn --optimizer lars --accum-steps 2 \\
        --ema-decay 0.99 --batch-size 32
    python -m distributed_model_parallel_tpu_torch.train.train_cnn \\
        --device cpu --model tinycnn --nproc 4 --dcn-data 2 \\
        --strategy ddp --allreduce hierarchical --batch-size 32
    python -m distributed_model_parallel_tpu_torch.train.train_cnn \\
        --device cpu --model shufflenetv2 --epochs 2 --batch-size 32 \\
        --synthetic-train-size 96 --synthetic-eval-size 32 --resume
    torchrun --nproc-per-node 4 -m \\
        distributed_model_parallel_tpu_torch.train.train_cnn --fused

``--device`` defaults to ``cuda``, where the model computes in bf16 over
f32 parameters (``--dtype`` overrides) with cuDNN's autotuner on; on
``cpu`` it runs in f32. ``--model`` takes MobileNetV2, ResNet-18/34/50
(the CIFAR layout; the JAX CLI has no layout flag either), tinycnn and
the 16 architectures of the zoo (``models/zoo.py``: vgg11/13/16/19,
preactresnet18, senet18, googlenet, densenet121, resnext29_2x64d,
mobilenetv1, dpn92, shufflenetg2, shufflenetv2, efficientnetb0,
regnetx_200mf, simpledla). ``--fused`` takes the fused SGD kernel;
``--optimizer`` adam, adamw, lamb, lars or adafactor another optimizer
(not with ``--fused``); ``--accum-steps k`` applies one update per k
batches from their mean gradient; ``--ema-decay d`` keeps an average of
the weights that eval and the best-accuracy save read (gspmd, fsdp).
``--strategy fsdp`` shards the parameters and optimizer state over the
ranks (no ``--fused``); ``--strategy zero`` shards the optimizer state
only; ``--allreduce ring`` sends ddp's gradient buckets round the
explicit neighbour ring; ``--dcn-data H`` lays the ranks out as H host
rows, and ``--allreduce hierarchical`` reduces ddp's gradients within the
rows, across them, and back.
``--nproc N`` spawns N ranks (a ``file://`` store in a temporary
directory): rank r runs on ``cuda:r`` over NCCL, so N may not exceed the
cards unless ``--backend gloo`` is given; ``--device cpu`` runs gloo.
Under torchrun the ranks come from its environment. ``--batch-size`` is
the global batch. Prints one JSON record per epoch, from rank 0; the
text log (one line per epoch, the reference's) and a JSON-lines log go
to ``--log-dir``/``--log-name``.txt/.jsonl (default ``./log/
data_para_{batch}``), and every improvement of eval top-1 saves the
whole state to ``--checkpoint-dir`` (default ``./checkpoint``, slot
``ckpt-{v}``). SIGTERM or Ctrl-C stops at the next step and saves to the
``preempt`` slot; ``--resume`` continues from the newest valid of the
two, mid-epoch. ``--dataset-type`` takes the reference's datasets
(``imagenet``/``place365`` ImageFolder trees, ``cub200``, ``cifar10``
under the data root, the synthetic stand-in of their class count when
absent); ``--image-size`` other than the data's resizes every batch on
the device (224: the reference's finetune recipe); ``--prefetch`` and
``--device-prefetch`` set the host-thread and side-stream upload depths;
``--use-native`` gathers batches with the C++ row gather. The recovery
plane is not ported yet and is refused.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from distributed_model_parallel_tpu_torch.models.zoo import ZOO_BUILDERS

# flag -> (value that is refused, ROADMAP item), for what is not ported.
_REFUSED = {
    "emergency_every": (lambda v: v != 0, "A11: resilience hooks"),
    "elastic": (bool, "A11: resilience hooks"),
    "check_finite_every": (lambda v: v != 0, "A11: resilience hooks"),
    "inject_faults": (lambda v: v is not None, "A11: resilience hooks"),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("data", nargs="?", default="./data", help="dataset root")
    p.add_argument("--dataset-type", "-type", default="synthetic",
                   choices=("synthetic", "cifar10", "imagenet", "cub200",
                            "place365"))
    p.add_argument("--image-size", default=32, type=int,
                   help="train/eval input resolution; when it differs from "
                        "the dataset's the batch is resized on the device "
                        "(224 = the reference's finetune recipe)")
    p.add_argument("--prefetch", default=2, type=int,
                   help="host prefetch depth (0 disables)")
    p.add_argument("--device-prefetch", default=2, type=int,
                   help="batches uploaded ahead on a side stream (0: one "
                        "upload a step)")
    p.add_argument("--use-native", action="store_true",
                   help="assemble batches with the C++ row gather")
    p.add_argument("--device", default="cuda")
    p.add_argument("--model", default="mobilenetv2",
                   choices=("mobilenetv2", "mobilenetv2_nobn", "resnet18",
                            "resnet34", "resnet50", "tinycnn",
                            *ZOO_BUILDERS),
                   help="mobilenetv2[_nobn], resnet18/34/50, tinycnn, or "
                        "a zoo architecture: " + ", ".join(ZOO_BUILDERS))
    p.add_argument("--dtype", default=None, choices=("float32", "bfloat16"),
                   help="compute dtype (default: bfloat16 on cuda, float32 "
                        "on cpu)")
    p.add_argument("--lr", default=0.4, type=float)
    p.add_argument("--optimizer", default="sgd",
                   choices=("sgd", "adam", "adamw", "adafactor", "lamb",
                            "lars"),
                   help="lars/lamb: layerwise-adaptive large-batch training; "
                        "adafactor: sub-linear optimizer memory")
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--wd", default=1e-4, type=float)
    p.add_argument("--fused", action="store_true",
                   help="the fused SGD kernel over flat parameter buckets")
    p.add_argument("--epochs", default=1, type=int)
    p.add_argument("--batch-size", "-b", default=512, type=int,
                   help="global batch, split over the ranks")
    p.add_argument("--warmup-steps", default=10, type=int)
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--synthetic-train-size", default=2048, type=int)
    p.add_argument("--synthetic-eval-size", default=512, type=int)
    p.add_argument("--device-data", action="store_true",
                   help="keep the training set on the device")
    p.add_argument("--steps-per-dispatch", default=1, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--nproc", default=1, type=int,
                   help="ranks to spawn (data parallelism)")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="default: nccl on cuda, gloo on cpu")
    p.add_argument("--strategy", default="gspmd",
                   choices=("gspmd", "ddp", "fsdp", "zero"))
    p.add_argument("--bn-mode", default="local",
                   choices=("local", "sync", "none"))
    p.add_argument("--allreduce", default="psum",
                   choices=("psum", "bucketed", "ring", "hierarchical"),
                   help="ddp's gradient transport")
    p.add_argument("--bucket-mb", default=None, type=float,
                   help="ddp's all-reduce bucket cap (grad_bucket_mb)")
    p.add_argument("--resume", "-r", action="store_true",
                   help="continue from the newest valid checkpoint")
    p.add_argument("--async-checkpoint", action="store_true",
                   help="persist checkpoints on a background thread")
    p.add_argument("--log-dir", default="./log")
    p.add_argument("--log-name", default=None,
                   help="default: data_para_{batch size}")
    p.add_argument("--checkpoint-dir", default="./checkpoint")
    p.add_argument("--ema-decay", default=None, type=float,
                   help="weight EMA decay (e.g. 0.999); eval and best-acc "
                        "selection use the averaged weights")
    p.add_argument("--accum-steps", default=1, type=int,
                   help="gradient accumulation: one optimizer update per k "
                        "batches (size-b batch at k == size-k*b batch)")
    p.add_argument("--dcn-data", default=1, type=int,
                   help="how many data-parallel ways cross the host "
                        "boundary; must divide --nproc. Lays the ranks out "
                        "host-major (--allreduce hierarchical reduces over "
                        "the two levels)")
    # Accepted so they can be refused by name (not ported yet).
    p.add_argument("--emergency-every", default=0, type=int)
    p.add_argument("--check-finite-every", default=0, type=int)
    p.add_argument("--elastic", action="store_true")
    p.add_argument("--inject-faults", default=None)
    return p.parse_args(argv)


def _config(args, world: int):
    from distributed_model_parallel_tpu_torch.config import (
        DataConfig,
        MeshConfig,
        ModelConfig,
        OptimizerConfig,
        TrainConfig,
    )

    on_cpu = torch.device(args.device).type == "cpu"
    dtype = args.dtype or ("float32" if on_cpu else "bfloat16")
    return TrainConfig(
        model=ModelConfig(name=args.model, dtype=dtype,
                          batchnorm=args.bn_mode),
        data=DataConfig(name=args.dataset_type, root=args.data,
                        image_size=args.image_size, prefetch=args.prefetch,
                        device_prefetch=args.device_prefetch,
                        use_native=args.use_native,
                        batch_size=args.batch_size,
                        eval_batch_size=args.batch_size,
                        augment=not args.no_augment,
                        synthetic_train_size=args.synthetic_train_size,
                        synthetic_eval_size=args.synthetic_eval_size),
        optimizer=OptimizerConfig(name=args.optimizer, learning_rate=args.lr,
                                  momentum=args.momentum,
                                  weight_decay=args.wd,
                                  warmup_steps=args.warmup_steps,
                                  accum_steps=args.accum_steps,
                                  ema_decay=args.ema_decay,
                                  fused=args.fused),
        mesh=_mesh(args, world), strategy=args.strategy,
        ddp_allreduce=args.allreduce, grad_bucket_mb=args.bucket_mb,
        epochs=args.epochs, seed=args.seed, resume=args.resume,
        async_checkpoint=args.async_checkpoint, log_dir=args.log_dir,
        log_name=args.log_name or f"data_para_{args.batch_size}",
        checkpoint_dir=args.checkpoint_dir,
        device_resident_data=args.device_data,
        steps_per_dispatch=args.steps_per_dispatch, device=args.device)


def _mesh(args, world: int):
    from distributed_model_parallel_tpu_torch.config import MeshConfig

    return MeshConfig(data=world, dcn_data=args.dcn_data)


def _fit(spec, args) -> list[dict]:
    """One rank's run: the Trainer's history (the same on every rank)."""
    from distributed_model_parallel_tpu_torch.train.trainer import Trainer

    if spec.device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    return Trainer(_config(args, spec.num_data), spec=spec).fit()


def main(argv=None):
    args = parse_args(argv)
    refused = [f"--{k.replace('_', '-')} (ROADMAP {item})"
               for k, (bad, item) in _REFUSED.items()
               if bad(getattr(args, k))]
    if refused:
        raise SystemExit(f"not ported yet: {', '.join(refused)}")
    from distributed_model_parallel_tpu_torch import mesh

    check = _config(args, args.nproc)
    from distributed_model_parallel_tpu_torch.train.trainer import (
        check_train_config,
    )

    check_train_config(check)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        spec = mesh.init_process_group(
            _mesh(args, int(os.environ["WORLD_SIZE"])), device=args.device,
            backend=args.backend)
        try:
            records = _fit(spec, args)
        finally:
            torch.distributed.destroy_process_group()
        if spec.rank != 0:
            return
    elif args.nproc > 1:
        records = mesh.spawn(_fit, args.nproc, args, device=args.device,
                             backend=args.backend,
                             config=_mesh(args, args.nproc))[0]
    else:
        records = _fit(mesh.make_mesh(device=args.device), args)
    for record in records:
        print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
