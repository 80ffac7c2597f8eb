"""Builds the port's CUDA kernels and loads them with ctypes.

Each source under ``ops/csrc/`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface (no PyTorch headers, so a
build takes seconds, not minutes), at first use, into ``build/kernels/``
at the root of the checkout. The library's name carries a hash of its
source, the shared headers (``*.cuh``) and the flags, so an edited source
is rebuilt and a stale library is never loaded. Nothing is compiled when
a module is imported: this runs inside the first launch (or
``build_all``), on a machine with ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("paged_decode", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
           "fused_sgd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# nvcc's output (ptxas register/shared-memory/spill report) per kernel
# built by this process, and the loaded libraries.
build_logs: dict[str, str] = {}
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA_HOME, PATH, /usr/local/cuda); "
                       "the port's CUDA kernels are built on the machine "
                       "with the card")


def library_path(name: str) -> Path:
    # The shared headers are hashed too: a kernel that includes one is
    # rebuilt when it changes.
    text = b"".join(f.read_bytes() for f in
                    [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names=KERNELS, timeout_s: float = 600.0) -> dict[str, Path]:
    """Compile every kernel of ``names`` not built yet — one ``nvcc`` per
    source, all started together — and return their library paths.
    Raises with nvcc's output if any build fails."""
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failures = []
    for name, (proc, tmp, out) in procs.items():
        try:
            log, _ = proc.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            failures.append(f"{name}: nvcc timed out after {timeout_s}s\n{log}")
            continue
        build_logs[name] = log
        if proc.returncode:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all((name,))[name]))
        _libs[name] = lib
    return lib
