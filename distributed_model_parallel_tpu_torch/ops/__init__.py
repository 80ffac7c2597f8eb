"""Operators of the port: plain PyTorch versions and the CUDA kernels
beside them (sources under ``csrc/``, built by ``_build``)."""
