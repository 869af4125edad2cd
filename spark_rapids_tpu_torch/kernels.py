"""Kernel cache and kernel build — the port's counterpart of
``spark_rapids_tpu/kernels.py``.

The JAX package keys jitted XLA programs by (expression tree, schema, shape)
and guards their compiles. Eager torch compiles nothing per shape, so the
port keeps only the keyed cache of built callables, and the build of the
hand-written CUDA kernels: each ``csrc/*.cu`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use, into
``build/torch_kernels/`` at the root of the checkout, and loaded with
``ctypes``. A kernel that fails to build raises; nothing falls back.

The host libraries of ``csrc/host/*.cc`` (the Parquet codec loops of
``io/parquet.py``) and the shared ``native/srt_host.cc`` (``native.py``)
build the same way with ``g++`` (``host_library``), on the card's machine
and on any other, under the same rules.

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


HOST_CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]


def _lib_path(name: str, src: Path, flags: list) -> Path:
    tag = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def _compile(name: str, what: str, compiler, flags: list, src: Path) -> Path:
    """Compile ``src`` into a shared library keyed by the source's and the
    flags' hash. A library that already exists for them is not rebuilt.
    Raises if the build fails."""
    out = _lib_path(name, src, flags)
    if out.exists():
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "report": "(cached)", "path": str(out)})
        return out
    from .obs import ledger as _ledger
    from .obs.metrics import GLOBAL as _M
    from .resilience.watchdog import stall_phase

    cmd = [compiler(), *flags]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter_ns()
    with _ledger.phase("compile"), stall_phase("compile", detail=name):
        proc = subprocess.run([*cmd, "-o", str(tmp), str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    ns = time.perf_counter_ns() - t0
    if proc.returncode != 0:
        tool = os.path.basename(cmd[0])
        raise RuntimeError(f"{what} build failed: {name}: {tool} exited {proc.returncode}\n"
                           f"{proc.stdout}")
    os.replace(tmp, out)
    _M.counter("kernel.builds").add(1)
    _M.timer("kernel.compileTimeNs").add(ns)
    _M.histogram("kernel.compileHist").observe(ns)
    BUILD_INFO[name] = {"seconds": ns / 1e9, "report": proc.stdout, "path": str(out)}
    return out


def build(name: str) -> None:
    """Compile ``csrc/<name>.cu`` with ``nvcc``."""
    _compile(name, "kernel", _nvcc, NVCC_FLAGS, CSRC_DIR / f"{name}.cu")


def _gxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found (set CXX or put g++ on PATH)")
    return cxx


def build_host(name: str, src: Path) -> Path:
    """Compile the C++ source ``src`` with ``g++``; the library's path."""
    return _compile(name, "host library", _gxx, HOST_CXX_FLAGS, src)


def host_library(name: str, src: Path = None) -> ctypes.CDLL:
    """The loaded host library of ``csrc/host/<name>.cc`` (or of ``src``),
    built with ``g++`` at first use."""
    src = src or CSRC_DIR / "host" / f"{name}.cc"
    return kernel(("host_library", name), lambda: ctypes.CDLL(str(build_host(name, src))))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""

    def make():
        build(name)
        return ctypes.CDLL(str(BUILD_INFO[name]["path"]))

    return kernel(("cuda_library", name), make)
