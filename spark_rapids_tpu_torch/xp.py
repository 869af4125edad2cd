"""The torch array namespace the expression library evaluates against on
the device (``Ctx.xp``).

The JAX package evaluates one expression library over two array modules,
``numpy`` on the CPU engine and ``jax.numpy`` on the device
(``spark_rapids_tpu/expr/base.py``). The port keeps that shape: the CPU
engine passes :data:`NUMPY` (numpy), and device operators pass the
``TorchNamespace`` of the batch's device, which gives the numpy names the
expressions call (``asarray``, ``where``, ``arange``, ``astype``,
``take_along_axis``, ``pad``, the math functions, reductions and scans, …)
over torch tensors, with numpy's semantics where torch's differ (python
floats are float64, ``sign(nan)`` is NaN, ``max`` returns values only).

Arrays it creates live on its device. Dtypes may be given as numpy dtypes,
python types or torch dtypes; ``astype`` is a function because tensors have
no ``.astype``, so shared code calls ``xp.astype(x, t)`` (``NUMPY.astype``
also takes numpy scalars, which numpy 2's ``np.astype`` refuses).
"""
from __future__ import annotations

import math

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
        # python numbers and lists take numpy's types (a float is float64,
        # not torch's default float32), as the JAX package's x64 mode does
        a = np.asarray(x)  # keeps 0-d scalars 0-d
        if not (a.flags.c_contiguous and a.flags.writeable):
            a = a.copy()
        t = torch.as_tensor(a)
        return t.to(device=self.device, dtype=td or t.dtype)

    def astype(self, x, dtype):
        return self.asarray(x).to(torch_dtype(dtype))

    def zeros(self, shape, dtype=float):
        return torch.zeros(shape, dtype=torch_dtype(dtype), device=self.device)

    def full(self, shape, fill, dtype=None):
        td = None if dtype is None else torch_dtype(dtype)
        if isinstance(shape, int):
            shape = (shape,)
        return torch.full(tuple(shape), _pyscalar(fill), dtype=td, device=self.device)

    def ones(self, shape, dtype=float):
        return torch.ones(shape, dtype=torch_dtype(dtype), device=self.device)

    def ones_like(self, x, dtype=None):
        td = None if dtype is None else torch_dtype(dtype)
        return torch.ones_like(self.asarray(x), dtype=td)

    def arange(self, *args, dtype=None):
        td = torch.int64 if dtype is None else torch_dtype(dtype)
        return torch.arange(*args, dtype=td, device=self.device)

    # ── shape ───────────────────────────────────────────────────────────
    def concatenate(self, arrays, axis=0):
        return torch.cat([self.asarray(a) for a in arrays], dim=axis)

    def stack(self, arrays, axis=0):
        return torch.stack([self.asarray(a) for a in arrays], dim=axis)

    def flip(self, x, axis):
        """numpy's ``flip`` (torch has no negative-step slices)."""
        return torch.flip(self.asarray(x), dims=(axis,))

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
        if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
            a = self.asarray(a)  # two python numbers: numpy's result type
        return torch.where(self.asarray(cond), a, b)

    def isnan(self, x):
        return torch.isnan(self.asarray(x))

    def isinf(self, x):
        return torch.isinf(self.asarray(x))

    def fmod(self, a, b):
        """C's ``fmod``: the sign of the dividend (Java's ``%`` on floats)."""
        return torch.fmod(self.asarray(a), _tensor_or_scalar(self, b))

    def power(self, a, b):
        return torch.pow(self.asarray(a), _tensor_or_scalar(self, b))

    def hypot(self, a, b):
        a = self.asarray(a)
        return torch.hypot(a, self.asarray(b, dtype=a.dtype))

    def arctan2(self, a, b):
        a = self.asarray(a)
        return torch.atan2(a, self.asarray(b, dtype=a.dtype))

    def cbrt(self, x):
        """The real cube root: ``|x|^(1/3)`` with the sign of ``x``, then one
        Newton step, which lands on numpy's ``cbrt`` (exact on cubes)."""
        x = self.asarray(x)
        y = torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)
        ok = torch.isfinite(y) & (y != 0)
        y2 = torch.where(ok, y, torch.ones_like(y))
        return torch.where(ok, y2 - (y2 * y2 * y2 - x) / (3.0 * y2 * y2), y)

    def rint(self, x):
        """Half to even, as numpy's ``rint``."""
        return torch.round(self.asarray(x))

    def degrees(self, x):
        return self.asarray(x) * (180.0 / math.pi)

    def radians(self, x):
        return self.asarray(x) * (math.pi / 180.0)

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
        """numpy's ``sign``: NaN stays NaN (torch's gives 0)."""
        x = self.asarray(x)
        if x.is_floating_point():
            return torch.where(torch.isnan(x), x, torch.sign(x))
        return torch.sign(x)

    def sqrt(self, x):
        return torch.sqrt(self.asarray(x))

    def isfinite(self, x):
        return torch.isfinite(self.asarray(x))

    def zeros_like(self, x, dtype=None):
        td = None if dtype is None else torch_dtype(dtype)
        return torch.zeros_like(self.asarray(x), dtype=td)

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
    def max(self, x, axis=None):
        """numpy's ``max`` reduction (the values only)."""
        x = self.asarray(x)
        return torch.amax(x) if axis is None else torch.amax(x, dim=axis)

    def min(self, x, axis=None):
        """numpy's ``min`` reduction (the values only)."""
        x = self.asarray(x)
        return torch.amin(x) if axis is None else torch.amin(x, dim=axis)

    def cummax(self, x, axis):
        return torch.cummax(self.asarray(x), dim=axis).values

    def cummin(self, x, axis):
        return torch.cummin(self.asarray(x), dim=axis).values

    def cumprod(self, x, axis):
        return torch.cumprod(self.asarray(x), dim=axis)

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
    def take(self, a, idx):
        """numpy's ``take`` of a 1-d ``a`` (indexes in range)."""
        return self.asarray(a)[self.asarray(idx).to(torch.int64)]

    def take_along_axis(self, x, idx, axis):
        return torch.take_along_dim(x, idx.to(torch.int64), dim=axis)


def _unary(fn):
    def op(self, x):
        return fn(self.asarray(x))

    op.__name__ = fn.__name__
    return op


# numpy-named unary math, each the torch function of the same semantics
for _name, _fn in {
    "ceil": torch.ceil, "exp": torch.exp, "expm1": torch.expm1, "log": torch.log,
    "log10": torch.log10, "log1p": torch.log1p, "log2": torch.log2, "sin": torch.sin,
    "cos": torch.cos, "tan": torch.tan, "arcsin": torch.asin, "arccos": torch.acos,
    "arctan": torch.atan, "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
}.items():
    setattr(TorchNamespace, _name, _unary(_fn))


def _tensor_or_scalar(ns, v):
    return v if isinstance(v, (int, float)) else ns.asarray(_pyscalar(v))


class NumpyNamespace:
    """numpy, as the CPU engine's ``Ctx.xp``: every name is numpy's, but
    ``astype`` also takes the numpy scalars literals evaluate to (numpy 2's
    ``np.astype`` takes arrays only), so shared code can call
    ``xp.astype(x, t)`` on either engine."""

    def __getattr__(self, name):
        value = getattr(np, name)
        setattr(self, name, value)
        return value

    def __repr__(self):
        return "NumpyNamespace()"

    @staticmethod
    def astype(x, dtype):
        return np.asarray(x).astype(dtype)


#: the CPU engine's namespace
NUMPY = NumpyNamespace()


def is_torch(xp) -> bool:
    """True for a torch namespace (or the ``torch`` module), False for
    numpy (the module or :data:`NUMPY`)."""
    return not (xp is np or isinstance(xp, NumpyNamespace))


_SPACES: dict = {}


def namespace(device) -> TorchNamespace:
    """The (cached) namespace of ``device``."""
    key = str(torch.device(device))
    ns = _SPACES.get(key)
    if ns is None:
        ns = _SPACES[key] = TorchNamespace(key)
    return ns
