"""distributed_model_parallel_tpu_torch — the PyTorch/CUDA port.

A second package beside ``distributed_model_parallel_tpu`` (the JAX
reference, which stays as it is). It mirrors the reference's module names
so each counterpart is easy to find, and every Pallas TPU kernel on a
ported path becomes a kernel written by hand for Hopper (``sm_90a``),
kept beside a plain PyTorch version of the same function.

Ported so far — the serving path, single-device LM training, and CNN
training on one device, data-parallel over ranks, or pipelined over
stages:

* :mod:`.models.transformer` — the Transformer LM's serving subset
  (config, parameter layout, layer norm, RoPE, projections, sampling)
  and its training forward and loss;
* :mod:`.ops.paged_attention` — paged decode attention: the plain gather
  path and the CUDA kernel (``ops/csrc/paged_decode.cu``);
* :mod:`.ops.flash_attention` — flash attention for training: the
  forward, dq and dk/dv CUDA kernels (``ops/csrc/flash_*.cu``) and their
  plain versions;
* :mod:`.ops.fused_sgd` — the fused SGD update over flat parameter
  buckets: the CUDA kernel (``ops/csrc/fused_sgd.cu``) and its plain
  version;
* :mod:`.models` — MobileNetV2, ResNet-18/34/50 and tinycnn as staged
  unit sequences (``layers``, ``staged``, ``mobilenetv2``, ``resnet``,
  ``tinycnn``, ``get_model``) and the sparse bag-of-words classifier
  (``embedding``);
* :mod:`.data` — the dataset registry (synthetic, CIFAR-10, ImageFolder
  and CUB-200 trees) and the loader (batch order on the host, the native
  row gather, host and device prefetch; resize, crop/flip and normalize
  on the device);
* :mod:`.serve` — paged KV cache, continuous-batching scheduler, the
  paged prefill/decode steps and the engine loop;
* :mod:`.train` — the LM and CNN trainers, the pipeline trainer, SGD
  (per leaf or fused) with its schedule, metrics, and three CLIs;
* :mod:`.mesh` — the process group of the ``(data, stage)`` mesh (NCCL
  on the card, gloo on the CPU), a rank's coordinates, rows and
  sub-groups, and ``spawn``, the launcher of ranks;
* :mod:`.ops.collectives` — the collectives over the data axis, the
  bucket plan, the flat padded vector of a tree, and the pipeline's
  point-to-point hops; :mod:`.ops.ring_reduce` — the explicit ring
  all-reduce; :mod:`.ops.sparse` — the COO embedding gradient and its
  sparse all-reduce;
* :mod:`.parallel` — DataParallel's phases, DDP (per-replica or
  synchronized BatchNorm, the replication check), ZeRO (the fused SGD
  kernel on each rank's slice), FSDP, the pipeline runner, the SPMD
  pipeline engine and the cost-balanced stage cut;
* :mod:`.config` — the typed configuration the ported slices read.

The package imports ``torch`` and numpy only: never ``jax``, and nothing
of the JAX package. Entry points default to ``device="cuda"`` and raise
when no card is present unless the caller asks for ``device="cpu"``.
"""

__version__ = "0.1.0"
