"""Kernel cache and kernel build — the port's counterpart of
``spark_rapids_tpu/kernels.py``.

The JAX package keys jitted XLA programs by (expression tree, schema, shape)
and guards their compiles. Eager torch compiles nothing per shape, so the
port keeps only the keyed cache of built callables, and the build of the
hand-written CUDA kernels: each ``csrc/*.cu`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use, into
``build/torch_kernels/`` at the root of the checkout, and loaded with
``ctypes``. A kernel that fails to build raises; nothing falls back.

A build is the port's only compile: it bills the query's ``compile``
ledger phase, is labelled ``stall_phase("compile")`` for the watchdog, and
counts on ``kernel.builds``, ``kernel.compileTimeNs`` and
``kernel.compileHist``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable

_CACHE: dict = {}
_LOCK = threading.RLock()

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: name -> {"seconds": build time, "report": nvcc's stderr (the -Xptxas -v
#: register/shared-memory report), "path": the library}
BUILD_INFO: dict = {}


def kernel(key: tuple, make: Callable):
    """Get-or-make the callable cached under ``key``."""
    with _LOCK:
        fn = _CACHE.get(key)
        if fn is None:
            fn = _CACHE[key] = make()
        return fn


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def build(name: str) -> None:
    """Compile ``csrc/<name>.cu`` with ``nvcc``. A library that already
    exists for the same source and flags is not rebuilt. Raises if the
    build fails."""
    out = _lib_path(name)
    if out.exists():
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "report": "(cached)", "path": str(out)})
        return
    from .obs import ledger as _ledger
    from .obs.metrics import GLOBAL as _M
    from .resilience.watchdog import stall_phase

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter_ns()
    with _ledger.phase("compile"), stall_phase("compile", detail=name):
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ns = time.perf_counter_ns() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: {name}: nvcc exited {proc.returncode}\n{proc.stdout}")
    os.replace(tmp, out)
    _M.counter("kernel.builds").add(1)
    _M.timer("kernel.compileTimeNs").add(ns)
    _M.histogram("kernel.compileHist").observe(ns)
    BUILD_INFO[name] = {"seconds": ns / 1e9, "report": proc.stdout, "path": str(out)}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""

    def make():
        build(name)
        return ctypes.CDLL(str(_lib_path(name)))

    return kernel(("cuda_library", name), make)
