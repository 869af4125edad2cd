"""The torch array namespace the expression library evaluates against on
the device (``Ctx.xp``).

The JAX package evaluates one expression library over two array modules,
``numpy`` on the CPU engine and ``jax.numpy`` on the device
(``spark_rapids_tpu/expr/base.py``). The port keeps that shape: the CPU
engine still passes ``numpy``, and device operators pass the
``TorchNamespace`` of the batch's device, which gives the numpy names the
expressions call (``asarray``, ``where``, ``arange``, ``astype``,
``take_along_axis``, ``pad``, …) over torch tensors.

Arrays it creates live on its device. Dtypes may be given as numpy dtypes,
python types or torch dtypes; ``astype`` is a function because tensors have
no ``.astype`` (numpy 2 has ``np.astype`` too, so shared code calls
``xp.astype(x, t)``).
"""
from __future__ import annotations

import numpy as np
import torch

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.uint64): torch.uint64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(dtype) -> torch.dtype:
    """numpy dtype / python type / torch dtype → torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _NP_TO_TORCH[np.dtype(dtype)]


def _pyscalar(x):
    """numpy scalars → python scalars (torch ops take python numbers)."""
    return x.item() if isinstance(x, np.generic) else x


class TorchNamespace:
    """numpy-named functions over torch tensors on one device."""

    bool_ = torch.bool
    int8 = torch.int8
    int16 = torch.int16
    int32 = torch.int32
    int64 = torch.int64
    uint8 = torch.uint8
    uint32 = torch.uint32
    float32 = torch.float32
    float64 = torch.float64
    inf = float("inf")
    nan = float("nan")

    def __init__(self, device):
        self.device = torch.device(device)

    def __repr__(self):
        return f"TorchNamespace({self.device})"

    # ── creation ────────────────────────────────────────────────────────
    def asarray(self, x, dtype=None):
        td = None if dtype is None else torch_dtype(dtype)
        if isinstance(x, torch.Tensor):
            x = x.to(self.device)
            return x if td is None else x.to(td)
        if isinstance(x, (np.ndarray, np.generic)):
            a = np.asarray(x)  # keeps 0-d scalars 0-d
            if not (a.flags.c_contiguous and a.flags.writeable):
                a = a.copy()
            t = torch.as_tensor(a)
            return t.to(device=self.device, dtype=td or t.dtype)
        return torch.as_tensor(x, dtype=td, device=self.device)

    def astype(self, x, dtype):
        return self.asarray(x).to(torch_dtype(dtype))

    def zeros(self, shape, dtype=float):
        return torch.zeros(shape, dtype=torch_dtype(dtype), device=self.device)

    def ones(self, shape, dtype=float):
        return torch.ones(shape, dtype=torch_dtype(dtype), device=self.device)

    def ones_like(self, x):
        return torch.ones_like(self.asarray(x))

    def arange(self, *args, dtype=None):
        td = torch.int64 if dtype is None else torch_dtype(dtype)
        return torch.arange(*args, dtype=td, device=self.device)

    # ── shape ───────────────────────────────────────────────────────────
    def concatenate(self, arrays, axis=0):
        return torch.cat([self.asarray(a) for a in arrays], dim=axis)

    def broadcast_to(self, x, shape):
        return torch.broadcast_to(self.asarray(x), shape)

    def pad(self, x, pad_width):
        """numpy ``pad`` with zeros; ``pad_width`` is ((before, after), …)
        per axis, as numpy takes it."""
        flat = []
        for before, after in reversed(pad_width):
            flat.extend([before, after])
        return torch.nn.functional.pad(x, flat)

    # ── elementwise ─────────────────────────────────────────────────────
    def where(self, cond, a, b):
        a, b = _pyscalar(a), _pyscalar(b)
        return torch.where(self.asarray(cond), a, b)

    def isnan(self, x):
        return torch.isnan(self.asarray(x))

    def maximum(self, a, b):
        return torch.maximum(self.asarray(a), self.asarray(b))

    def minimum(self, a, b):
        return torch.minimum(self.asarray(a), self.asarray(b))

    def trunc(self, x):
        return torch.trunc(self.asarray(x))

    def floor(self, x):
        return torch.floor(self.asarray(x))

    def round(self, x):
        """Half to even, as numpy's ``round``."""
        return torch.round(self.asarray(x))

    def abs(self, x):
        return torch.abs(self.asarray(x))

    def sign(self, x):
        return torch.sign(self.asarray(x))

    def sqrt(self, x):
        return torch.sqrt(self.asarray(x))

    def isfinite(self, x):
        return torch.isfinite(self.asarray(x))

    def zeros_like(self, x):
        return torch.zeros_like(self.asarray(x))

    def full_like(self, x, fill):
        return torch.full_like(self.asarray(x), _pyscalar(fill))

    def mod(self, a, b):
        """numpy's ``mod``: the sign of the divisor."""
        return torch.remainder(self.asarray(a), _pyscalar(b))

    def clip(self, x, lo, hi):
        return torch.clamp(self.asarray(x), _pyscalar(lo), _pyscalar(hi))

    def floor_divide(self, a, b):
        """numpy's ``floor_divide``: rounds toward negative infinity, so
        negative operands (dates before 1970) divide as numpy's do."""
        return torch.div(self.asarray(a), _pyscalar(b), rounding_mode="floor")

    # ── reductions and scans ────────────────────────────────────────────
    def cumsum(self, x, axis=None):
        if axis is None:
            return torch.cumsum(x.reshape(-1), 0)
        return torch.cumsum(x, dim=axis)

    def argmax(self, x, axis=None):
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        return torch.argmax(x, dim=axis)

    # ── sorting and searching ───────────────────────────────────────────
    def argsort(self, x, axis=-1, stable=False):
        """numpy's ``argsort``; a bool array sorts as 0/1."""
        x = self.asarray(x)
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        return torch.argsort(x, dim=axis, stable=stable)

    def searchsorted(self, a, v, side="left"):
        """numpy's ``searchsorted`` of ``v`` into the sorted 1-d ``a``."""
        a, v = self.asarray(a), self.asarray(v)
        if v.dtype != a.dtype:
            common = torch.promote_types(a.dtype, v.dtype)
            a, v = a.to(common), v.to(common)
        return torch.searchsorted(a, v.contiguous(), right=side == "right")

    # ── gathers ─────────────────────────────────────────────────────────
    def take_along_axis(self, x, idx, axis):
        return torch.take_along_dim(x, idx.to(torch.int64), dim=axis)


_SPACES: dict = {}


def namespace(device) -> TorchNamespace:
    """The (cached) namespace of ``device``."""
    key = str(torch.device(device))
    ns = _SPACES.get(key)
    if ns is None:
        ns = _SPACES[key] = TorchNamespace(key)
    return ns
