"""Substring search over the padded byte plane — the port of
``spark_rapids_tpu/ops/pallas_strings.py``.

``match_starts`` is the mask behind ``Contains``, ``StringLocate``,
``SubstringIndex`` and ``StringReplace``. On a CUDA tensor it
launches the hand-written kernel in ``csrc/match_starts.cu`` (built for
``sm_90a`` at first use, loaded with ctypes) or raises; on a CPU tensor it
runs ``match_starts_plain``, the same function in plain torch. Nothing falls
back from the card to the plain version: a kernel that fails to build or to
launch raises.

The kernel has two paths in one source. ``vec16`` (16-byte loads and
stores) takes planes with ``W % 16 == 0`` whose data and output start on a
16-byte boundary; every other plane (``W = 8``, ``W = 130``, a view at an
odd storage offset) takes ``bytes``, the same tiling with byte loads and
stores. ``LAUNCHES_BY_PATH`` counts the launches of each, and
``LAUNCHES_BY_CONSUMER`` the same launches by the expression that asked.

The TPU kernel's gating (the Mosaic subprocess probe, its TTL cache, the
process kill switch and ``spark.rapids.sql.pallas.enabled``) has no
counterpart here.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

#: launches of the CUDA kernel in this process (the plain version and the
#: no-launch cases do not count)
LAUNCHES = 0
#: the same launches by kernel path (see :func:`kernel_path`)
LAUNCHES_BY_PATH = {"vec16": 0, "bytes": 0}
#: the same launches by consumer (the expression that asked for the mask;
#: ``"direct"`` for a call from outside the expressions)
LAUNCHES_BY_CONSUMER = {"contains": 0, "locate": 0, "substring_index": 0, "replace": 0,
                        "get_json_object": 0}


def reset_counts() -> None:
    """Set every launch count to 0."""
    global LAUNCHES
    LAUNCHES = 0
    LAUNCHES_BY_PATH.update(dict.fromkeys(LAUNCHES_BY_PATH, 0))
    LAUNCHES_BY_CONSUMER.update(dict.fromkeys(LAUNCHES_BY_CONSUMER, 0))


def match_starts_plain(data: torch.Tensor, lengths: torch.Tensor, pat: bytes) -> torch.Tensor:
    """bool[n, W]: ``pat`` occurs at each byte position and fits inside the
    row — the window-gather form of ``_match_starts`` in
    ``spark_rapids_tpu/expr/strings.py``, in torch."""
    n, w = data.shape
    L = len(pat)
    if L == 0 or L > w:
        return torch.zeros((n, w), dtype=torch.bool, device=data.device)
    S = w - L + 1
    idx = torch.arange(S, device=data.device)[:, None] + torch.arange(L, device=data.device)[None, :]
    windows = data[:, idx]  # [n, S, L]
    pat_t = torch.as_tensor(np.frombuffer(pat, dtype=np.uint8).copy(), device=data.device)
    m = (windows == pat_t[None, None, :]).all(dim=2)
    fits = (torch.arange(S, dtype=torch.int32, device=data.device)[None, :] + L) <= lengths[:, None]
    m = m & fits
    if S < w:
        m = torch.nn.functional.pad(m, (0, w - S))
    return m


def _library():
    from .. import kernels as K

    def make():
        lib = K.library("match_starts")
        fn = lib.srt_match_starts
        fn.argtypes = [
            ctypes.c_void_p,  # data
            ctypes.c_void_p,  # lengths
            ctypes.c_void_p,  # pat
            ctypes.c_int,  # L
            ctypes.c_longlong,  # n
            ctypes.c_int,  # W
            ctypes.c_int,  # vec: 1 for the vec16 path
            ctypes.c_void_p,  # out
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        return fn

    return K.kernel(("match_starts_fn",), make)


@functools.lru_cache(maxsize=256)
def _device_pattern(pat: bytes, device: torch.device) -> torch.Tensor:
    """The pattern's bytes on ``device``, copied once per (pattern, device):
    a launch makes no host-to-device copy."""
    return torch.tensor(list(pat), dtype=torch.uint8).to(device)


def kernel_path(w: int, data_ptr: int, out_ptr: int) -> str:
    """``"vec16"`` where the plane's rows are whole 16-byte chunks and both
    buffers start on a 16-byte boundary, else ``"bytes"``."""
    return "vec16" if w % 16 == 0 and data_ptr % 16 == 0 and out_ptr % 16 == 0 else "bytes"


def match_starts(
    data: torch.Tensor, lengths: torch.Tensor, pat: bytes, consumer: str = "direct"
) -> torch.Tensor:
    """bool[n, W]: element ``[i, j]`` is True iff ``pat`` occurs at byte
    ``j`` of row ``i`` and ``j + len(pat) <= lengths[i]``. ``L == 0`` or
    ``L > W`` gives all False without a launch. ``consumer`` names the
    caller in ``LAUNCHES_BY_CONSUMER``."""
    global LAUNCHES
    if data.ndim != 2:
        raise ValueError(f"match_starts wants a [n, W] byte plane, got shape {tuple(data.shape)}")
    n, w = data.shape
    L = len(pat)
    if L == 0 or L > w:
        return torch.zeros((n, w), dtype=torch.bool, device=data.device)
    if data.device.type == "cpu":
        return match_starts_plain(data, lengths, pat)
    if data.device.type != "cuda":
        raise ValueError(f"match_starts runs on cuda or cpu tensors, not {data.device}")
    if data.dtype != torch.uint8 or lengths.dtype != torch.int32:
        raise TypeError(
            f"match_starts wants uint8 data and int32 lengths, got {data.dtype}, {lengths.dtype}"
        )
    if lengths.shape != (n,) or lengths.device != data.device:
        raise ValueError(
            f"lengths must be [{n}] on {data.device}, got {tuple(lengths.shape)} on {lengths.device}"
        )
    if not (data.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("match_starts wants contiguous data and lengths")
    fn = _library()
    out = torch.empty((n, w), dtype=torch.bool, device=data.device)
    if n == 0:
        return out
    path = kernel_path(w, data.data_ptr(), out.data_ptr())
    with torch.cuda.device(data.device):  # the launch uses the current device
        stream = torch.cuda.current_stream()
        pat_t = _device_pattern(pat, data.device)
        pat_t.record_stream(stream)  # the cache may drop it while this launch runs
        err = fn(
            ctypes.c_void_p(data.data_ptr()),
            ctypes.c_void_p(lengths.data_ptr()),
            ctypes.c_void_p(pat_t.data_ptr()),
            L,
            n,
            w,
            int(path == "vec16"),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(stream.cuda_stream),
        )
    if err != 0:
        raise RuntimeError(f"match_starts kernel launch failed ({path} path): cudaError {err}")
    LAUNCHES += 1
    LAUNCHES_BY_PATH[path] += 1
    LAUNCHES_BY_CONSUMER[consumer] = LAUNCHES_BY_CONSUMER.get(consumer, 0) + 1
    return out
