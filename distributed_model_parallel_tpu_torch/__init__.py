"""distributed_model_parallel_tpu_torch — the PyTorch/CUDA port.

A second package beside ``distributed_model_parallel_tpu`` (the JAX
reference, which stays as it is). It mirrors the reference's module names
so each counterpart is easy to find, and every Pallas TPU kernel on a
ported path becomes a kernel written by hand for Hopper (``sm_90a``),
kept beside a plain PyTorch version of the same function.

Ported so far — the serving path and single-device LM training:

* :mod:`.models.transformer` — the Transformer LM's serving subset
  (config, parameter layout, layer norm, RoPE, projections, sampling)
  and its training forward and loss;
* :mod:`.ops.paged_attention` — paged decode attention: the plain gather
  path and the CUDA kernel (``ops/csrc/paged_decode.cu``);
* :mod:`.ops.flash_attention` — flash attention for training: the
  forward, dq and dk/dv CUDA kernels (``ops/csrc/flash_*.cu``) and their
  plain versions;
* :mod:`.serve` — paged KV cache, continuous-batching scheduler, the
  paged prefill/decode steps and the engine loop;
* :mod:`.train` — the LM trainer, SGD with its schedule, and a CLI;
* :mod:`.config` — the typed configuration the ported slices read.

The package imports ``torch`` and numpy only: never ``jax``, and nothing
of the JAX package. Entry points default to ``device="cuda"`` and raise
when no card is present unless the caller asks for ``device="cpu"``.
"""

__version__ = "0.1.0"
