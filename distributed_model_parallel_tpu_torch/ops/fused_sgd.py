"""Fused SGD update over flat parameter buckets — the counterpart of
``distributed_model_parallel_tpu/ops/pallas_optim.py``.

One pass per bucket applies weight decay, the momentum trace (in place),
nesterov, the learning rate and the update itself:

    g' = g + wd·p;  m' = μ·m + g';  d = g' + μ·m' (nesterov) | m' | g';
    p' = p + (-lr)·d

* :func:`sgd_delta_plain` — the JAX ``_run_xla`` (delta, momentum in
  place), in its operation order;
* :func:`fused_sgd_plain` — the plain version of the kernel: the delta,
  then the apply (``optax.apply_updates``), eager ops rounded one by one;
* :func:`fused_sgd_kernel` / :func:`plain_sgd_kernel` — the wrappers of
  the hand-written CUDA kernel ``csrc/fused_sgd.cu`` with and without a
  momentum buffer (the TPU's ``_fused_sgd_kernel`` and
  ``_plain_sgd_kernel``). The kernel rounds every product and sum on its
  own, so it equals the plain version bit for bit.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
on its own card (made the current device for the launch) or raises. Each
wrapper counts its launches in ``.launches``.
:class:`BucketLauncher` is the launch that ``train/optim.FusedSGD`` keeps
per bucket: its buffers are checked once when it is built
(:func:`check_bucket`, device, 16-byte alignment), so a step passes the
kept pointers straight to the kernel; it counts on the same two
counters.
"""

from __future__ import annotations

import ctypes

import torch

from distributed_model_parallel_tpu_torch.ops import _build


def sgd_delta_plain(p: torch.Tensor, m: torch.Tensor | None,
                    g: torch.Tensor, lr: float, momentum: float,
                    weight_decay: float, nesterov: bool) -> torch.Tensor:
    """``-lr · d`` for flat f32 ``p``, ``m``, ``g``; ``m`` (None when
    momentum is 0: no trace) is updated in place."""
    if weight_decay:
        g = g + weight_decay * p
    if m is None:
        return g * -lr
    m.copy_(momentum * m + g)
    d = g + momentum * m if nesterov else m
    return d * -lr


def fused_sgd_plain(p: torch.Tensor, m: torch.Tensor | None,
                    g: torch.Tensor, lr: float, momentum: float,
                    weight_decay: float, nesterov: bool) -> None:
    """The kernel's function in plain PyTorch: ``p`` and ``m`` in place."""
    p.add_(sgd_delta_plain(p, m, g, lr, momentum, weight_decay, nesterov))


def _kernel_fn():
    fn = _build.load("fused_sgd").fused_sgd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                       + [ctypes.c_float] * 3 + [ctypes.c_int,
                                                 ctypes.c_void_p])
    return fn


def kernel_grid(n: int, momentum: bool) -> dict:
    """The grid the kernel launches on the current CUDA device for a
    16-byte aligned bucket of ``n`` f32 (with a trace when ``momentum``):
    CTAs, threads per CTA, float4 of each operand a thread keeps in
    flight."""
    fn = _build.load("fused_sgd").fused_sgd_grid
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_longlong, ctypes.c_int] + [
            ctypes.POINTER(ctypes.c_int)] * 3
    out = [ctypes.c_int() for _ in range(3)]
    rc = fn(int(n), int(bool(momentum)), *(ctypes.byref(x) for x in out))
    if rc != 0:
        raise RuntimeError(f"fused_sgd_grid failed: CUDA error {rc}")
    return dict(zip(("blocks", "threads", "unroll"), (x.value for x in out)))


def check_bucket(p: torch.Tensor, m: torch.Tensor | None,
                 g: torch.Tensor) -> None:
    """Raises unless ``p``, ``m`` (None: no trace) and ``g`` are float32,
    contiguous 1-D buckets of one length on one device."""
    bufs = [x for x in (p, m, g) if x is not None]
    if any(x.device != p.device for x in bufs):
        raise ValueError("p, m and g must all lie on the same CUDA device")
    if any(x.dtype != torch.float32 for x in bufs):
        raise TypeError(f"the fused SGD kernel takes float32 buckets, got "
                        f"{[x.dtype for x in bufs]} (train/optim.FusedSGD "
                        f"stages other leaf types into f32 buckets)")
    if any(x.ndim != 1 or not x.is_contiguous() or x.numel() != p.numel()
           for x in bufs):
        raise ValueError("p, m and g must be contiguous 1-D buckets of one "
                         "length")


def _require_cuda(p: torch.Tensor) -> None:
    if p.device.type != "cuda":
        raise ValueError("p, m and g must all lie on the same CUDA device")


def _call(fn, p_ptr, m_ptr, g_ptr, n, lr, momentum, weight_decay, nesterov,
          device) -> None:
    # The kernel launches on the current device: make it the bucket's, so
    # that a bucket on cuda:k (a pipeline chunk's) runs on card k, on that
    # card's current stream, ordered after the backward that filled g.
    with torch.cuda.device(device):
        rc = fn(p_ptr, m_ptr, g_ptr, n, lr, momentum, weight_decay,
                nesterov, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_sgd kernel launch failed: CUDA error {rc}")


def _launch(p, m, g, lr, momentum, weight_decay, nesterov) -> None:
    _require_cuda(p)
    check_bucket(p, m, g)
    _call(_kernel_fn(), p.data_ptr(), None if m is None else m.data_ptr(),
          g.data_ptr(), p.numel(), float(lr), float(momentum),
          float(weight_decay), int(nesterov), p.device)


class BucketLauncher:
    """One bucket's kernel launch, checked once: ``p``, ``m`` (None: the
    ``plain_sgd`` variant) and ``g`` pass :func:`check_bucket`, start on a
    16-byte boundary (the kernel's float4 body then covers all but the
    last n % 4 elements) and lie on a CUDA device. The buffers must stay
    the bucket's for the launcher's life (``FusedSGD`` owns them); a call
    launches with the kept pointers and counts on ``fused_sgd_kernel`` or
    ``plain_sgd_kernel``."""

    def __init__(self, p: torch.Tensor, m: torch.Tensor | None,
                 g: torch.Tensor):
        self.check(p, m, g)
        self._bufs = (p, m, g)              # kept alive with the pointers
        self._ptrs = (p.data_ptr(), None if m is None else m.data_ptr(),
                      g.data_ptr(), p.numel())
        self._device = p.device
        self._fn = _kernel_fn()
        self._counter = plain_sgd_kernel if m is None else fused_sgd_kernel

    @staticmethod
    def check(p: torch.Tensor, m: torch.Tensor | None,
              g: torch.Tensor) -> None:
        """What the launcher takes, without launching (raises)."""
        check_bucket(p, m, g)
        if any(x.data_ptr() % 16 for x in (p, m, g) if x is not None):
            raise ValueError("a prepared bucket must start on a 16-byte "
                             "boundary (p, m and g)")
        _require_cuda(p)

    def __call__(self, lr: float, momentum: float, weight_decay: float,
                 nesterov: bool) -> None:
        _call(self._fn, *self._ptrs, lr, momentum, weight_decay,
              int(nesterov), self._device)
        self._counter.launches += 1


def fused_sgd_kernel(p: torch.Tensor, m: torch.Tensor, g: torch.Tensor,
                     lr: float, momentum: float, weight_decay: float,
                     nesterov: bool = False) -> None:
    """One bucket's update with a momentum trace (the TPU's
    ``_fused_sgd_kernel`` + apply): ``p`` and ``m`` in place."""
    if p.device.type == "cpu":
        fused_sgd_plain(p, m, g, lr, momentum, weight_decay, nesterov)
        return
    _launch(p, m, g, lr, momentum, weight_decay, nesterov)
    fused_sgd_kernel.launches += 1


def plain_sgd_kernel(p: torch.Tensor, g: torch.Tensor, lr: float,
                     weight_decay: float) -> None:
    """One bucket's momentum-free update (the TPU's ``_plain_sgd_kernel``
    + apply): ``p`` in place."""
    if p.device.type == "cpu":
        fused_sgd_plain(p, None, g, lr, 0.0, weight_decay, False)
        return
    _launch(p, None, g, lr, 0.0, weight_decay, False)
    plain_sgd_kernel.launches += 1


fused_sgd_kernel.launches = 0
plain_sgd_kernel.launches = 0
