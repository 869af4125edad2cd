"""Spark SQL type system for the TPU accelerator.

Mirrors the subset of ``org.apache.spark.sql.types`` the reference supports on
device (reference: sql-plugin TypeChecks.scala:129 ``TypeSig`` — BOOLEAN..DECIMAL_64).
Each type knows its storage dtype (Arrow-layout device buffers) and its
Arrow logical type (host currency).

Decimal follows the reference's DECIMAL64 restriction (precision <= 18,
unscaled int64 storage — TypeChecks.scala "DECIMAL" gating).

Copied from ``spark_rapids_tpu/types.py``. pyarrow is imported only when an
Arrow type is asked for: the port's host batches are numpy, and its runtime
path runs without pyarrow.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


class _LazyArrow:
    """``pa`` for the ``to_arrow``/``from_arrow`` helpers, imported on first
    use so that importing the port never needs pyarrow."""

    def __getattr__(self, name):
        import pyarrow

        return getattr(pyarrow, name)


pa = _LazyArrow()


class DataType:
    """Base of the SQL type lattice. Instances are value objects."""

    #: numpy storage dtype of the data buffer (torch dtype on the device).
    np_dtype: np.dtype = None  # type: ignore

    @property
    def simple_string(self) -> str:
        return type(self).__name__.replace("Type", "").lower()

    def to_arrow(self) -> pa.DataType:
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return self.simple_string

    def __eq__(self, other: Any) -> bool:
        return type(self) is type(other)

    def __hash__(self) -> int:
        return hash(type(self))


class NumericType(DataType):
    pass


class IntegralType(NumericType):
    pass


class FractionalType(NumericType):
    pass


class BooleanType(DataType):
    np_dtype = np.dtype(np.bool_)

    def to_arrow(self) -> pa.DataType:
        return pa.bool_()


class ByteType(IntegralType):
    np_dtype = np.dtype(np.int8)

    def to_arrow(self) -> pa.DataType:
        return pa.int8()


class ShortType(IntegralType):
    np_dtype = np.dtype(np.int16)

    def to_arrow(self) -> pa.DataType:
        return pa.int16()


class IntegerType(IntegralType):
    np_dtype = np.dtype(np.int32)

    def to_arrow(self) -> pa.DataType:
        return pa.int32()


class LongType(IntegralType):
    np_dtype = np.dtype(np.int64)

    def to_arrow(self) -> pa.DataType:
        return pa.int64()


class FloatType(FractionalType):
    np_dtype = np.dtype(np.float32)

    def to_arrow(self) -> pa.DataType:
        return pa.float32()


class DoubleType(FractionalType):
    np_dtype = np.dtype(np.float64)

    def to_arrow(self) -> pa.DataType:
        return pa.float64()


class StringType(DataType):
    # Device representation is (uint8[capacity, width], int32 lengths); host is
    # Arrow string. np_dtype marks the per-byte storage.
    np_dtype = np.dtype(np.uint8)

    def to_arrow(self) -> pa.DataType:
        return pa.string()


class DateType(IntegralType):
    """Days since epoch, int32 — Spark's internal representation."""

    np_dtype = np.dtype(np.int32)

    def to_arrow(self) -> pa.DataType:
        return pa.date32()


class TimestampType(IntegralType):
    """Microseconds since epoch UTC, int64 — Spark's internal representation."""

    np_dtype = np.dtype(np.int64)

    def to_arrow(self) -> pa.DataType:
        return pa.timestamp("us", tz="UTC")


class NullType(DataType):
    np_dtype = np.dtype(np.int8)

    def to_arrow(self) -> pa.DataType:
        return pa.null()


class CalendarInterval(tuple):
    """Spark's CalendarInterval value: (months, days, microseconds).

    Appears only as a literal operand of interval arithmetic (the reference
    gates GpuTimeAdd/GpuDateAddInterval to literal intervals too —
    GpuOverrides.scala:1348,1369)."""

    def __new__(cls, months: int = 0, days: int = 0, microseconds: int = 0):
        return super().__new__(cls, (int(months), int(days), int(microseconds)))

    months = property(lambda self: self[0])
    days = property(lambda self: self[1])
    microseconds = property(lambda self: self[2])

    def __repr__(self) -> str:
        return (
            f"INTERVAL {self.months} MONTHS {self.days} DAYS "
            f"{self.microseconds} MICROSECONDS"
        )


class CalendarIntervalType(DataType):
    """Interval literals for date/timestamp arithmetic. Not a storable column
    type on device (matches the reference: CALENDAR appears in TypeSigs only
    as a literal-gated operand)."""

    np_dtype = np.dtype(np.int64)  # placeholder; never stored columnar

    def to_arrow(self) -> pa.DataType:
        return pa.month_day_nano_interval()


@dataclasses.dataclass(frozen=True)
class DecimalType(FractionalType):
    """DECIMAL64 only, like the reference (unscaled int64 storage).

    Reference: TypeChecks.scala DECIMAL_64 gating; DecimalUtil.scala.
    """

    precision: int = 10
    scale: int = 0

    MAX_PRECISION = 18  # decimal64

    def __post_init__(self):
        if self.precision > self.MAX_PRECISION:
            raise ValueError(
                f"decimal precision {self.precision} > {self.MAX_PRECISION} "
                "(DECIMAL64 only, matching the reference's gating)"
            )

    @property
    def np_dtype(self) -> np.dtype:  # type: ignore[override]
        return np.dtype(np.int64)

    @property
    def simple_string(self) -> str:
        return f"decimal({self.precision},{self.scale})"

    def to_arrow(self) -> pa.DataType:
        return pa.decimal128(self.precision, self.scale)

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, DecimalType)
            and other.precision == self.precision
            and other.scale == self.scale
        )

    def __hash__(self) -> int:
        return hash((DecimalType, self.precision, self.scale))


@dataclasses.dataclass(frozen=True, eq=False)
class ArrayType(DataType):
    """Variable-length list. Device layout mirrors strings: a padded
    element buffer [capacity, width] + per-row lengths, with a per-element
    validity plane (reference: TypeChecks.scala ARRAY; cudf LIST columns)."""

    element_type: DataType
    contains_null: bool = True

    @property
    def np_dtype(self) -> np.dtype:  # element storage dtype
        return self.element_type.np_dtype

    @property
    def simple_string(self) -> str:
        return f"array<{self.element_type.simple_string}>"

    def to_arrow(self) -> pa.DataType:
        return pa.list_(self.element_type.to_arrow())

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, ArrayType)
            and other.element_type == self.element_type
        )

    def __hash__(self) -> int:
        return hash((ArrayType, self.element_type))


@dataclasses.dataclass(frozen=True, eq=False)
class StructType(DataType):
    """Nested record: a bundle of named child columns sharing the row axis
    (reference: TypeChecks.scala STRUCT; complexTypeCreator.scala)."""

    fields: tuple = ()

    @property
    def simple_string(self) -> str:
        inner = ",".join(f"{f.name}:{f.data_type.simple_string}" for f in self.fields)
        return f"struct<{inner}>"

    def to_arrow(self) -> pa.DataType:
        return pa.struct(
            [pa.field(f.name, f.data_type.to_arrow(), f.nullable) for f in self.fields]
        )

    def field_index(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(name)

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, StructType) and other.fields == self.fields

    def __hash__(self) -> int:
        return hash((StructType, self.fields))


@dataclasses.dataclass(frozen=True, eq=False)
class MapType(DataType):
    """Key→value map, stored as parallel padded key/value element buffers
    (Spark: MapType; arrow: map<k, v>). Keys are non-null by construction."""

    key_type: DataType = None  # type: ignore
    value_type: DataType = None  # type: ignore
    value_contains_null: bool = True

    @property
    def simple_string(self) -> str:
        return f"map<{self.key_type.simple_string},{self.value_type.simple_string}>"

    def to_arrow(self) -> pa.DataType:
        return pa.map_(self.key_type.to_arrow(), self.value_type.to_arrow())

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, MapType)
            and other.key_type == self.key_type
            and other.value_type == self.value_type
        )

    def __hash__(self) -> int:
        return hash((MapType, self.key_type, self.value_type))


def parse_ddl_type(s: str) -> DataType:
    """One Spark DDL type name → DataType (``long``, ``decimal(10,2)``,
    ``array<int>``, ``map<string,int>``, ``struct<a:int,b:string>``)."""
    s = s.strip()
    low = s.lower()  # type NAMES are case-insensitive; field names keep case
    simple = {
        "boolean": BooleanType(), "byte": ByteType(), "tinyint": ByteType(),
        "short": ShortType(), "smallint": ShortType(),
        "int": IntegerType(), "integer": IntegerType(),
        "long": LongType(), "bigint": LongType(),
        "float": FloatType(), "real": FloatType(),
        "double": DoubleType(), "string": StringType(),
        "date": DateType(), "timestamp": TimestampType(),
        "decimal": DecimalType(10, 0), "void": NullType(),
        "null": NullType(),
    }
    if low in simple:
        return simple[low]
    if low.startswith("decimal(") and low.endswith(")"):
        p, sc = s[len("decimal(") : -1].split(",")
        return DecimalType(int(p), int(sc))
    if low.startswith("array<") and low.endswith(">"):
        return ArrayType(parse_ddl_type(s[len("array<") : -1]))
    if low.startswith("map<") and low.endswith(">"):
        k, v = _split_top(s[len("map<") : -1])
        return MapType(parse_ddl_type(k), parse_ddl_type(v))
    if low.startswith("struct<") and low.endswith(">"):
        fields = []
        for part in _split_top_all(s[len("struct<") : -1]):
            name, dt = part.split(":", 1)
            fields.append(StructField(name.strip(), parse_ddl_type(dt), True))
        return StructType(tuple(fields))
    raise ValueError(f"cannot parse DDL type {s!r}")


def _split_top_all(s: str) -> list:
    """Split on top-level commas (angle-bracket and paren aware)."""
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return parts


def _split_top(s: str):
    parts = _split_top_all(s)
    if len(parts) != 2:
        raise ValueError(f"expected two type args in {s!r}")
    return parts[0], parts[1]


def parse_ddl_schema(s: str) -> "Schema":
    """``"a long, b double"`` (pyspark DDL schema string) → Schema."""
    fields = []
    for part in _split_top_all(s):
        part = part.strip()
        if not part:
            continue
        bits = part.split(None, 1)
        if len(bits) != 2:
            raise ValueError(f"cannot parse DDL field {part!r}")
        fields.append(StructField(bits[0], parse_ddl_type(bits[1]), True))
    return Schema(fields)


def is_complex(dt: DataType) -> bool:
    return isinstance(dt, (ArrayType, StructType, MapType))


# Singletons (Spark convention).
BOOLEAN = BooleanType()
BYTE = ByteType()
SHORT = ShortType()
INT = IntegerType()
LONG = LongType()
FLOAT = FloatType()
DOUBLE = DoubleType()
STRING = StringType()
DATE = DateType()
TIMESTAMP = TimestampType()
NULL = NullType()
CALENDAR_INTERVAL = CalendarIntervalType()

_INTEGRAL_ORDER = [ByteType, ShortType, IntegerType, LongType]
_NUMERIC_ORDER = _INTEGRAL_ORDER + [FloatType, DoubleType]


def is_numeric(dt: DataType) -> bool:
    return isinstance(dt, NumericType)


def is_integral(dt: DataType) -> bool:
    return isinstance(dt, IntegralType) and not isinstance(dt, (DateType, TimestampType))


def numeric_promote(a: DataType, b: DataType) -> DataType:
    """Spark's binary-arithmetic common type (tightest common numeric type).

    Decimal promotion follows Spark's DecimalPrecision rules, applied by the
    arithmetic expressions themselves; here decimals only unify with equal
    decimals.
    """
    if a == b:
        return a
    if isinstance(a, DecimalType) or isinstance(b, DecimalType):
        raise TypeError(f"no implicit promotion between {a} and {b}")
    order = {t: i for i, t in enumerate(_NUMERIC_ORDER)}
    ta, tb = type(a), type(b)
    if ta in order and tb in order:
        return (_NUMERIC_ORDER[max(order[ta], order[tb])])()
    raise TypeError(f"no common type for {a} and {b}")


def from_arrow(at: pa.DataType) -> DataType:
    """Arrow → SQL type. Inverse of ``DataType.to_arrow`` plus widening of
    arrow variants (large_string, date64, non-UTC timestamps)."""
    if pa.types.is_boolean(at):
        return BOOLEAN
    if pa.types.is_int8(at):
        return BYTE
    if pa.types.is_int16(at):
        return SHORT
    if pa.types.is_int32(at):
        return INT
    if pa.types.is_int64(at):
        return LONG
    if pa.types.is_uint8(at) or pa.types.is_uint16(at) or pa.types.is_uint32(at):
        # Spark has no unsigned types; widen like Spark's Parquet reader.
        return {1: SHORT, 2: INT, 4: LONG}[at.bit_width // 8]
    if pa.types.is_float32(at):
        return FLOAT
    if pa.types.is_float64(at):
        return DOUBLE
    if pa.types.is_string(at) or pa.types.is_large_string(at):
        return STRING
    if pa.types.is_date32(at):
        return DATE
    if pa.types.is_timestamp(at):
        return TIMESTAMP
    if pa.types.is_decimal(at):
        return DecimalType(at.precision, at.scale)
    if pa.types.is_null(at):
        return NULL
    if pa.types.is_map(at):
        return MapType(from_arrow(at.key_type), from_arrow(at.item_type))
    if pa.types.is_list(at) or pa.types.is_large_list(at):
        return ArrayType(from_arrow(at.value_type))
    if pa.types.is_struct(at):
        return StructType(
            tuple(
                StructField(f.name, from_arrow(f.type), f.nullable)
                for f in at
            )
        )
    raise TypeError(f"unsupported arrow type {at}")


@dataclasses.dataclass(frozen=True)
class StructField:
    name: str
    data_type: DataType
    nullable: bool = True


class Schema:
    """Ordered named fields; the planner's row type."""

    def __init__(self, fields: list[StructField]):
        self.fields = list(fields)
        self._index = {f.name: i for i, f in enumerate(self.fields)}

    @property
    def names(self) -> list[str]:
        return [f.name for f in self.fields]

    @property
    def types(self) -> list[DataType]:
        return [f.data_type for f in self.fields]

    def index_of(self, name: str) -> int:
        return self._index[name]

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __getitem__(self, i):
        if isinstance(i, str):
            return self.fields[self._index[i]]
        return self.fields[i]

    def __eq__(self, other):
        return isinstance(other, Schema) and self.fields == other.fields

    def __hash__(self):
        return hash(tuple(self.fields))

    def __repr__(self):
        inner = ", ".join(f"{f.name}:{f.data_type}" for f in self.fields)
        return f"Schema({inner})"

    def to_arrow(self) -> pa.Schema:
        return pa.schema(
            [pa.field(f.name, f.data_type.to_arrow(), f.nullable) for f in self.fields]
        )

    @staticmethod
    def from_arrow(schema: pa.Schema) -> "Schema":
        return Schema(
            [StructField(f.name, from_arrow(f.type), f.nullable) for f in schema]
        )
