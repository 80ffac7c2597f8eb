"""Parallel strategies of the port over a ``torch.distributed`` process
group (``mesh.py``) or an explicit device list:

* :mod:`.data_parallel` — DataParallel's scatter → replicate → apply →
  gather, one rank per process;
* :mod:`.ddp` — explicit DDP: per-replica programs and BN state, the
  gradient all-reduce (per leaf, bucketed, or round the explicit ring),
  the replication check;
* :mod:`.zero` — ZeRO: the reduce-scattered gradient, each rank's slice
  of the momentum updated by the fused SGD kernel, the gathered params;
* :mod:`.fsdp` — FSDP: parameters and momentum sharded at rest, gathered
  for each use, gradients reduce-scattered;
* :mod:`.pipeline` — the pipeline runner: chunks over an explicit device
  list, the naive, GPipe, 1F1B and interleaved schedules, and the
  per-chunk functions both pipeline engines run;
* :mod:`.spmd_cnn_pipeline` — the SPMD pipeline engine, one process per
  stage over point-to-point hops;
* :mod:`.schedule` — the static tick tables both SPMD pipelines run;
* :mod:`.spmd_pipeline`, :mod:`.spmd_lm`, :mod:`.tensor_parallel` — the
  Transformer LM's stage ring, its step over the whole mesh, and each
  leaf's cuts over the stage, model and expert axes;
* :mod:`.auto_partition` — cost-balanced stage boundaries (XLA's FLOP
  count, the JAX package's cuts);
* :mod:`.workers` — rank functions for ``mesh.spawn`` that run pieces of
  the data-parallel and pipeline paths and return numpy results.
"""
