"""The C++ row gather of the host data path — the port of
``distributed_model_parallel_tpu/data/native.py``'s ``gather_rows``.

The source is the port's own copy, ``data/csrc/dmp_native.cpp`` (plain C
interface, loaded with ctypes). It is compiled by the host C++ compiler
(``$CXX``, else ``c++``) at first use into ``build/native/`` at the root
of the checkout, under a name that carries a hash of the source and the
flags, so an edited source is rebuilt. Nothing is compiled when the
module is imported. A build that fails raises with the compiler's
output: a caller that asked for the native gather never gets numpy's in
its place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "dmp_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("use_native: no host C++ compiler ($CXX, c++, g++) "
                           "to build data/csrc/dmp_native.cpp")
    return cxx


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libdmp_native-{digest[:16]}.so"


def build(timeout_s: float = 120.0) -> Path:
    """Compile the source unless built already; returns the library path
    or raises naming the compiler's error."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout_s)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"use_native: building {SOURCE.name} failed: "
                           f"{e}") from e
    if proc.returncode:
        raise RuntimeError(f"use_native: {cmd[0]} exit {proc.returncode} "
                           f"building {SOURCE.name}:\n{proc.stderr}"
                           f"{proc.stdout}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The gather library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.dmp_gather_rows.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
            lib.dmp_gather_rows.restype = None
            _lib = lib
        return _lib


def gather_rows(src: np.ndarray, idx: np.ndarray, *, n_threads: int = 4
                ) -> np.ndarray:
    """``out[i] = src[idx[i]]`` over the leading axis, in C++ threads."""
    lib = load()
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(idx, np.int64)
    if len(idx) and (idx.min() < 0 or idx.max() >= len(src)):
        raise IndexError(f"gather_rows: index out of range [0, {len(src)})")
    out = np.empty((len(idx),) + src.shape[1:], src.dtype)
    item = int(np.prod(src.shape[1:], dtype=np.int64)) * src.itemsize
    lib.dmp_gather_rows(src.ctypes.data, idx.ctypes.data, out.ctypes.data,
                        len(idx), item, max(1, int(n_threads)))
    return out
