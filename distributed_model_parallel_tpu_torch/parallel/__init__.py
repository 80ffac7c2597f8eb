"""Parallel strategies of the port over a ``torch.distributed`` process
group (``mesh.py``):

* :mod:`.data_parallel` — DataParallel's scatter → replicate → apply →
  gather, one rank per process;
* :mod:`.ddp` — explicit DDP: per-replica programs and BN state, the
  gradient all-reduce (per leaf or bucketed), the replication check;
* :mod:`.workers` — rank functions for ``mesh.spawn`` that run pieces of
  the data-parallel path and return numpy results.
"""
