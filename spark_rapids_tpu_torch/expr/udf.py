"""User-defined functions — the L7 interop layer.

Reference: GpuArrowEvalPythonExec.scala:391 (Arrow-streamed pandas UDFs,
CPU-side python workers), GpuUserDefinedFunction/GpuScalaUDF + the RapidsUDF
interface (user code that produces device columns directly), and the
udf-compiler (bytecode → Catalyst, so simple UDFs run as normal expressions).

TPU-first mapping:

* ``PythonUdf`` — arbitrary per-row python; runs on the CPU engine over the
  host Arrow batches (the Arrow-eval seam without a separate worker process —
  this engine IS python). The planner falls back per-node with a reason,
  exactly like rows the reference can't translate via its udf-compiler.

* ``TorchUdf`` — the RapidsUDF analogue, the port's ``JaxUdf``: the user
  supplies ``fn(*tensors) -> tensor`` written with torch ops, and it runs
  inside the device projection on the batch's own tensors — no transfer,
  no interop layer. On the CPU engine the same ``fn`` gets the numpy
  columns as (shared-memory) CPU tensors, so both engines evaluate one
  function.

Null semantics: UDFs are null-propagating over their inputs (Spark UDFs see
None instead — ``PythonUdf`` passes None through to the callable like
pyspark; ``TorchUdf`` uses validity masks, so the fn sees zero-filled slots
and must be total).

Copied from ``spark_rapids_tpu/expr/udf.py``, with ``TorchUdf`` in place of
``JaxUdf``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np

from ..types import DataType
from .base import Ctx, Expression, Val, and_valid


@dataclass(frozen=True)
class TorchUdf(Expression):
    """Device-capable UDF: ``fn`` maps torch tensors → one torch tensor
    (the JAX package's ``JaxUdf``, whose ``fn`` maps jax arrays).

    Identity-hashed via the function object, as there."""

    fn: Callable
    return_type: DataType
    args: Tuple[Expression, ...]
    name: str = "torch_udf"

    @property
    def data_type(self) -> DataType:
        return self.return_type

    def eval(self, ctx: Ctx) -> Val:
        import torch

        from ..xp import torch_dtype

        vals = [a.eval(ctx) for a in self.args]
        want = torch_dtype(self.return_type.np_dtype)
        if ctx.is_device:
            out = self.fn(*[v.full_data(ctx) for v in vals])
            out = ctx.broadcast(torch.as_tensor(out, device=ctx.xp.device)).to(want)
        else:
            arrays = [
                torch.from_numpy(np.ascontiguousarray(v.full_data(ctx))) for v in vals
            ]
            out = torch.as_tensor(self.fn(*arrays)).to(want)
            out = np.broadcast_to(out.numpy(), (ctx.n,)).copy()
        valid = and_valid(ctx, *[v.valid for v in vals]) if vals else None
        if valid is None:
            valid = ctx.broadcast_bool(True)
        return Val(out, valid)

    def __str__(self):
        return f"{self.name}({', '.join(map(str, self.args))})"


def np_to_series(dt, d: "np.ndarray", m: "np.ndarray"):
    """numpy column (+validity mask) → pandas Series under the Arrow→pandas
    null convention: datetime64/NaT for timestamps and dates, NaN for
    floats, None for objects, int/bool-with-nulls widened to float64.
    ``d`` must be a mutable copy (null slots are overwritten)."""
    import pandas as pd

    from ..types import DateType, TimestampType

    if isinstance(dt, TimestampType):
        s_in = pd.Series(pd.to_datetime(d.astype(np.int64), unit="us"))
        s_in[~m] = pd.NaT
        return s_in
    if isinstance(dt, DateType):
        s_in = pd.Series(pd.to_datetime(d.astype(np.int64), unit="D"))
        s_in[~m] = pd.NaT
        return s_in
    if d.dtype == object:
        d[~m] = None
        return pd.Series(d)
    if np.issubdtype(d.dtype, np.floating):
        d[~m] = np.nan
        return pd.Series(d)
    if (~m).any():
        # Arrow→pandas: integer/bool columns with nulls widen
        f = d.astype(np.float64)
        f[~m] = np.nan
        return pd.Series(f)
    return pd.Series(d)


def scalar_from_agg_result(dt, value):
    """One grouped-agg UDF result scalar → (np value, valid) under the
    declared return type (NaN/None/NaT → null)."""
    import pandas as pd

    from ..types import DateType, StringType, TimestampType

    if value is None or (
        isinstance(value, (float, np.floating)) and np.isnan(value)
    ) or (value is pd.NaT):
        return np.zeros((), dtype=object if isinstance(dt, StringType) else dt.np_dtype), False
    if isinstance(dt, StringType):
        return str(value), True
    if isinstance(dt, (TimestampType, DateType)):
        unit = "us" if isinstance(dt, TimestampType) else "D"
        ts = pd.to_datetime(value)
        if ts is pd.NaT:
            return np.zeros((), dtype=dt.np_dtype), False
        return np.datetime64(ts).astype(f"datetime64[{unit}]").astype(np.int64).astype(dt.np_dtype), True
    return np.asarray(value).astype(dt.np_dtype), True


@dataclass(frozen=True)
class GroupedAggUdf(Expression):
    """Grouped-aggregate pandas UDF (pyspark ``pandas_udf`` GROUPED_AGG
    flavor): ``fn`` receives pandas Series covering ONE key group (or one
    window frame) and returns a scalar. Consumed by
    CpuAggregateInPandasExec and the CPU window exec — the reference's
    GpuAggregateInPandasExec / GpuWindowInPandasExecBase pair."""

    fn: Callable
    return_type: DataType
    args: Tuple[Expression, ...]
    name: str = "pandas_agg_udf"

    @property
    def data_type(self) -> DataType:
        return self.return_type

    def eval(self, ctx: Ctx) -> Val:  # pragma: no cover - planner routes
        raise AssertionError(
            "grouped-agg pandas UDFs are evaluated by AggregateInPandas / "
            "window execs, not as row expressions"
        )

    def __str__(self):
        return f"{self.name}({', '.join(map(str, self.args))})"


@dataclass(frozen=True)
class VectorizedUdf(Expression):
    """Batch-vectorized (pandas-style) python UDF: ``fn`` receives pandas
    Series covering the WHOLE batch and returns a Series/array — one
    python call per batch instead of per row (the GpuArrowEvalPythonExec
    data path without the separate worker process; pyspark's
    ``pandas_udf`` scalar flavor). Null convention mirrors Arrow→pandas:
    float NaN for numeric nulls (ints with nulls widen to float64),
    ``None`` for strings/objects; result nulls are taken from
    ``Series.isna``."""

    fn: Callable
    return_type: DataType
    args: Tuple[Expression, ...]
    name: str = "pandas_udf"

    @property
    def data_type(self) -> DataType:
        return self.return_type

    def eval(self, ctx: Ctx) -> Val:
        assert not ctx.is_device, "vectorized python UDFs run on the CPU engine"
        import pandas as pd

        from ..types import DateType, StringType, TimestampType

        series = []
        for a in self.args:
            v = a.eval(ctx)
            d = np.array(
                np.broadcast_to(np.asarray(v.data), (ctx.n,)), copy=True
            )
            m = ctx.broadcast_bool(v.valid)
            series.append(np_to_series(a.data_type, d, m))
        out = self.fn(*series)
        s = pd.Series(out) if not isinstance(out, pd.Series) else out
        if len(s) != ctx.n:
            raise ValueError(
                f"pandas UDF {self.name} returned {len(s)} rows for a "
                f"{ctx.n}-row batch"
            )
        ok = (~s.isna()).to_numpy()
        if isinstance(self.return_type, StringType):
            data = np.array(s.astype(object).to_numpy(), copy=True)
            data[~ok] = None
            return Val(data, ok)
        if isinstance(self.return_type, (TimestampType, DateType)):
            ts = pd.to_datetime(s)
            unit = "us" if isinstance(self.return_type, TimestampType) else "D"
            conv = ts.astype(f"datetime64[{unit}]").astype(np.int64)
            data = np.zeros(ctx.n, dtype=self.return_type.np_dtype)
            data[ok] = conv.to_numpy()[ok].astype(self.return_type.np_dtype)
            return Val(data, ok)
        if pd.api.types.is_numeric_dtype(s):
            vals = s
        else:
            vals = pd.to_numeric(s, errors="coerce")
            bad = ok & vals.isna().to_numpy()
            if bad.any():
                raise TypeError(
                    f"pandas UDF {self.name} returned non-numeric value "
                    f"{s[bad].iloc[0]!r} for {self.return_type.simple_string}"
                )
        data = np.zeros(ctx.n, dtype=self.return_type.np_dtype)
        data[ok] = vals.to_numpy()[ok].astype(self.return_type.np_dtype)
        return Val(data, ok)

    def __str__(self):
        return f"{self.name}({', '.join(map(str, self.args))})"


@dataclass(frozen=True)
class PythonUdf(Expression):
    """Row-at-a-time python UDF (CPU engine; planner falls back)."""

    fn: Callable
    return_type: DataType
    args: Tuple[Expression, ...]
    name: str = "udf"

    @property
    def data_type(self) -> DataType:
        return self.return_type

    def eval(self, ctx: Ctx) -> Val:
        assert not ctx.is_device, "python UDFs execute on the CPU engine"
        from ..types import StringType

        vals = [a.eval(ctx) for a in self.args]
        cols = []
        for v in vals:
            d = np.broadcast_to(np.asarray(v.data), (ctx.n,))
            m = ctx.broadcast_bool(v.valid)
            cols.append((d, m))
        is_str = isinstance(self.return_type, StringType)
        out = np.empty(ctx.n, dtype=object if is_str else self.return_type.np_dtype)
        if not is_str:
            out[:] = 0
        ok = np.zeros(ctx.n, dtype=bool)
        for i in range(ctx.n):
            row = [
                (d[i].item() if hasattr(d[i], "item") else d[i]) if m[i] else None
                for d, m in cols
            ]
            r = self.fn(*row)
            if r is not None:
                out[i] = r
                ok[i] = True
        return Val(out, ok)

    def __str__(self):
        return f"{self.name}({', '.join(map(str, self.args))})"
