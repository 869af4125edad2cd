"""User-facing column functions — the pyspark.sql.functions-shaped facade.

The reference has no such layer (it plugs under Spark SQL); standalone, this
is the query-authoring surface. Names follow pyspark so TPC-H/DS workloads
translate one-to-one.

Copied from ``spark_rapids_tpu/functions.py``.
"""
from __future__ import annotations

from typing import Any, Optional, Union

from .expr import (
    Abs,
    Add,
    Alias,
    And,
    CaseWhen,
    Cast,
    Coalesce,
    Divide,
    EqualNullSafe,
    EqualTo,
    Expression,
    GreaterThan,
    GreaterThanOrEqual,
    If,
    In,
    IntegralDivide,
    IsNaN,
    IsNotNull,
    IsNull,
    LessThan,
    LessThanOrEqual,
    Literal,
    Multiply,
    Not,
    Or,
    Pmod,
    Remainder,
    Subtract,
    UnaryMinus,
    UnresolvedAttribute,
    to_expr,
)
from .expr.aggregates import Average, Count, First, Last, Max, Min, Sum
from .expr.bitwise import (
    BitwiseAnd,
    BitwiseNot,
    BitwiseOr,
    BitwiseXor,
    ShiftLeft,
    ShiftRight,
    ShiftRightUnsigned,
)
from .expr.math import (
    Acos,
    Acosh,
    Asin,
    Asinh,
    Atan,
    Atan2,
    Atanh,
    Cot,
    Logarithm,
    BRound,
    Cbrt,
    Ceil,
    Cos,
    Cosh,
    Exp,
    Expm1,
    Floor,
    Hypot,
    Log,
    Log1p,
    Log2,
    Log10,
    Pow,
    Rint,
    Round,
    Signum,
    Sin,
    Sinh,
    Sqrt,
    Tan,
    Tanh,
    ToDegrees,
    ToRadians,
)
from .expr.nullexprs import AtLeastNNonNulls, Greatest, Least, NaNvl, Nvl2
from .expr.datetime import (
    AddMonths,
    DateAdd,
    DateDiff,
    DateSub,
    DayOfMonth,
    DayOfWeek,
    DayOfYear,
    Hour,
    LastDay,
    Minute,
    Month,
    Quarter,
    Second,
    UnixTimestamp,
    WeekDay,
    Year,
)
from .expr.strings import (
    Ascii,
    Concat,
    Contains,
    EndsWith,
    InitCap,
    Length,
    Like,
    Lower,
    Reverse,
    StartsWith,
    StringLPad,
    StringLocate,
    StringRPad,
    StringRepeat,
    StringReplace,
    StringTrim,
    StringTrimLeft,
    StringTrimRight,
    Substring,
    Upper,
)
from .types import INT, DataType


class Column:
    """Expression wrapper with operator overloading (pyspark's Column)."""

    def __init__(self, expr: Expression):
        self.expr = expr

    # arithmetic
    def __add__(self, o):
        return Column(Add(self.expr, _e(o)))

    def __radd__(self, o):
        return Column(Add(_e(o), self.expr))

    def __sub__(self, o):
        return Column(Subtract(self.expr, _e(o)))

    def __rsub__(self, o):
        return Column(Subtract(_e(o), self.expr))

    def __mul__(self, o):
        return Column(Multiply(self.expr, _e(o)))

    def __rmul__(self, o):
        return Column(Multiply(_e(o), self.expr))

    def __truediv__(self, o):
        return Column(Divide(self.expr, _e(o)))

    def __rtruediv__(self, o):
        return Column(Divide(_e(o), self.expr))

    def __mod__(self, o):
        return Column(Remainder(self.expr, _e(o)))

    def __neg__(self):
        return Column(UnaryMinus(self.expr))

    # comparisons
    def __eq__(self, o):  # type: ignore[override]
        return Column(EqualTo(self.expr, _e(o)))

    def __ne__(self, o):  # type: ignore[override]
        return Column(Not(EqualTo(self.expr, _e(o))))

    def __lt__(self, o):
        return Column(LessThan(self.expr, _e(o)))

    def __le__(self, o):
        return Column(LessThanOrEqual(self.expr, _e(o)))

    def __gt__(self, o):
        return Column(GreaterThan(self.expr, _e(o)))

    def __ge__(self, o):
        return Column(GreaterThanOrEqual(self.expr, _e(o)))

    # logic
    def __and__(self, o):
        return Column(And(self.expr, _e(o)))

    def __or__(self, o):
        return Column(Or(self.expr, _e(o)))

    def __invert__(self):
        return Column(Not(self.expr))

    # misc
    def alias(self, name: str) -> "Column":
        return Column(Alias(self.expr, name))

    def cast(self, dt: DataType) -> "Column":
        return Column(Cast(self.expr, dt))

    def getItem(self, key) -> "Column":
        from .expr.complex import UnresolvedExtractValue

        return Column(UnresolvedExtractValue(self.expr, _e(key)))

    getField = getItem

    def __getitem__(self, key) -> "Column":
        return self.getItem(key)

    def isin(self, *values) -> "Column":
        # a DataFrame argument is `x IN (subquery)` (GpuInSet via the
        # session's subquery resolution); literal lists stay an In chain
        if len(values) == 1 and hasattr(values[0], "_plan"):
            from .expr.subquery import InSubquery

            return Column(InSubquery(self.expr, values[0]._plan))
        if len(values) == 1 and isinstance(values[0], (list, tuple, set)):
            values = tuple(values[0])
        return Column(In(self.expr, tuple(_e(v) for v in values)))

    def is_null(self) -> "Column":
        return Column(IsNull(self.expr))

    isNull = is_null

    def is_not_null(self) -> "Column":
        return Column(IsNotNull(self.expr))

    isNotNull = is_not_null

    def eq_null_safe(self, o) -> "Column":
        return Column(EqualNullSafe(self.expr, _e(o)))

    # bitwise (pyspark Column API)
    def bitwiseAND(self, o) -> "Column":
        return Column(BitwiseAnd(self.expr, _e(o)))

    def bitwiseOR(self, o) -> "Column":
        return Column(BitwiseOr(self.expr, _e(o)))

    def bitwiseXOR(self, o) -> "Column":
        return Column(BitwiseXor(self.expr, _e(o)))

    # strings (pyspark Column API)
    def rlike(self, pattern: str) -> "Column":
        from .expr.strings_ext import RLike

        return Column(RLike(self.expr, _e(pattern)))

    def like(self, pattern: str) -> "Column":
        return Column(Like(self.expr, _e(pattern)))

    def startswith(self, o) -> "Column":
        return Column(StartsWith(self.expr, _e(o)))

    def endswith(self, o) -> "Column":
        return Column(EndsWith(self.expr, _e(o)))

    def contains(self, o) -> "Column":
        return Column(Contains(self.expr, _e(o)))

    def substr(self, start, length) -> "Column":
        return Column(Substring(self.expr, _e(start), _e(length)))

    # sorting direction markers (consumed by sort()/Window.order_by)
    def desc(self) -> "Column":
        c = Column(self.expr)
        c._sort_desc = True
        return c

    def asc(self) -> "Column":
        return Column(self.expr)

    # windowing
    def over(self, window) -> "Column":
        from .expr.windows import WindowExpression, WindowSpec

        spec = window.spec if hasattr(window, "spec") else window
        assert isinstance(spec, WindowSpec)
        return Column(WindowExpression(self.expr, spec))

    def __hash__(self):
        return hash(self.expr)


def _e(v: Union[Column, Any]) -> Expression:
    if isinstance(v, Column):
        return v.expr
    return to_expr(v)


def row_number() -> Column:
    from .expr.windows import RowNumber

    return Column(RowNumber())


def rank() -> Column:
    from .expr.windows import Rank

    return Column(Rank())


def dense_rank() -> Column:
    from .expr.windows import DenseRank

    return Column(DenseRank())


def percent_rank() -> Column:
    from .expr.windows import PercentRank

    return Column(PercentRank())


def cume_dist() -> Column:
    from .expr.windows import CumeDist

    return Column(CumeDist())


def ntile(n: int) -> Column:
    from .expr.windows import NTile

    if n < 1:
        raise ValueError("ntile buckets must be >= 1")
    return Column(NTile(int(n)))


def lag(c, offset: int = 1, default=None) -> Column:
    from .expr.windows import Lag

    return Column(Lag(_e(c), offset, to_expr(default)))


def lead(c, offset: int = 1, default=None) -> Column:
    from .expr.windows import Lead

    return Column(Lead(_e(c), offset, to_expr(default)))


def broadcast(df):
    """Mark a DataFrame for broadcast in joins (pyspark parity; reference:
    broadcast hint → GpuBroadcastHashJoinExec build side)."""
    from .plan import logical as L
    from .session import DataFrame

    return DataFrame(df._session, L.Hint("broadcast", df._plan))


def scalar_subquery(df) -> Column:
    """A single-value subquery usable inside any expression — e.g.
    ``df.filter(col("y") > scalar_subquery(other.agg(avg(col("y")))))``.
    Executed before the main query and inlined as a literal
    (GpuScalarSubquery.scala analogue)."""
    from .expr.subquery import ScalarSubquery

    return Column(ScalarSubquery(df._plan))


def col(name: str) -> Column:
    return Column(UnresolvedAttribute(name))


def lit(v: Any) -> Column:
    return Column(to_expr(v))


def expr_col(e: Expression) -> Column:
    return Column(e)


# aggregates
def sum(c) -> Column:  # noqa: A001 - pyspark parity
    return Column(Sum(_e(c)))


def count(c="*") -> Column:
    # isinstance guard first: ``c == "*"`` on a Column builds a comparison
    # EXPRESSION (truthy), which silently turned count(col) into count(*)
    # and made COUNT include nulls — caught by the whole-query golden corpus
    if isinstance(c, str) and c == "*":
        return Column(Count(Literal(1, INT)))
    return Column(Count(_e(c)))


def avg(c) -> Column:
    return Column(Average(_e(c)))


mean = avg


def min(c) -> Column:  # noqa: A001
    return Column(Min(_e(c)))


def max(c) -> Column:  # noqa: A001
    return Column(Max(_e(c)))


def first(c, ignorenulls: bool = False) -> Column:
    return Column(First(_e(c), ignorenulls))


def last(c, ignorenulls: bool = False) -> Column:
    return Column(Last(_e(c), ignorenulls))


def count_distinct(c) -> Column:
    return Column(Count(_e(c), distinct=True))


countDistinct = count_distinct


def sum_distinct(c) -> Column:
    return Column(Sum(_e(c), distinct=True))


sumDistinct = sum_distinct


def stddev(c) -> Column:
    from .expr.aggregates import StddevSamp

    return Column(StddevSamp(_e(c)))


stddev_samp = stddev


def stddev_pop(c) -> Column:
    from .expr.aggregates import StddevPop

    return Column(StddevPop(_e(c)))


def variance(c) -> Column:
    from .expr.aggregates import VarianceSamp

    return Column(VarianceSamp(_e(c)))


var_samp = variance


def var_pop(c) -> Column:
    from .expr.aggregates import VariancePop

    return Column(VariancePop(_e(c)))


def covar_pop(x, y) -> Column:
    from .expr.aggregates import CovarPop

    return Column(CovarPop(_e(x), _e(y)))


def covar_samp(x, y) -> Column:
    from .expr.aggregates import CovarSamp

    return Column(CovarSamp(_e(x), _e(y)))


def corr(x, y) -> Column:
    from .expr.aggregates import Corr

    return Column(Corr(_e(x), _e(y)))


def collect_list(c) -> Column:
    from .expr.aggregates import CollectList

    return Column(CollectList(_e(c)))


def collect_set(c) -> Column:
    from .expr.aggregates import CollectSet

    return Column(CollectSet(_e(c)))


def when(condition: Column, value) -> "WhenBuilder":
    return WhenBuilder([(condition.expr, _e(value))])


class WhenBuilder(Column):
    def __init__(self, branches):
        self.branches = branches
        from .types import NULL

        super().__init__(CaseWhen(tuple(branches), Literal(None, NULL)))

    def when(self, condition: Column, value) -> "WhenBuilder":
        return WhenBuilder(self.branches + [(condition.expr, _e(value))])

    def otherwise(self, value) -> Column:
        return Column(CaseWhen(tuple(self.branches), _e(value)))


def coalesce(*cols) -> Column:
    return Column(Coalesce(tuple(_e(c) for c in cols)))


def isnan(c) -> Column:
    return Column(IsNaN(_e(c)))


def abs(c) -> Column:  # noqa: A001
    return Column(Abs(_e(c)))


# string functions (pyspark.sql.functions parity)
def length(c) -> Column:
    return Column(Length(_e(c)))


def upper(c) -> Column:
    return Column(Upper(_e(c)))


def lower(c) -> Column:
    return Column(Lower(_e(c)))


def initcap(c) -> Column:
    return Column(InitCap(_e(c)))


def reverse(c) -> Column:
    return Column(Reverse(_e(c)))


def ascii(c) -> Column:  # noqa: A001
    return Column(Ascii(_e(c)))


def substring(c, pos, length) -> Column:  # noqa: A002
    return Column(Substring(_e(c), _e(pos), _e(length)))


def substring_index(c, delim: str, count: int) -> Column:
    from .expr.strings import SubstringIndex

    return Column(SubstringIndex(_e(c), _e(delim), _e(count)))


def concat(*cols) -> Column:
    return Column(Concat(tuple(_e(c) for c in cols)))


def trim(c) -> Column:
    return Column(StringTrim(_e(c)))


def ltrim(c) -> Column:
    return Column(StringTrimLeft(_e(c)))


def rtrim(c) -> Column:
    return Column(StringTrimRight(_e(c)))


def lpad(c, len_: int, pad: str = " ") -> Column:
    return Column(StringLPad(_e(c), _e(len_), _e(pad)))


def rpad(c, len_: int, pad: str = " ") -> Column:
    return Column(StringRPad(_e(c), _e(len_), _e(pad)))


def repeat(c, n: int) -> Column:
    return Column(StringRepeat(_e(c), _e(n)))


def regexp_replace(c, pattern: str, replacement: str) -> Column:
    from .expr.strings_ext import RegExpReplace

    return Column(RegExpReplace(_e(c), _e(pattern), _e(replacement)))


def regexp_extract(c, pattern: str, idx: int = 1) -> Column:
    from .expr.strings_ext import RegExpExtract

    return Column(RegExpExtract(_e(c), _e(pattern), idx))


def split(c, pattern: str, limit: int = -1) -> Column:
    from .expr.strings_ext import StringSplit

    return Column(StringSplit(_e(c), _e(pattern), limit))


def concat_ws(sep: str, *cols) -> Column:
    from .expr.strings_ext import ConcatWs
    from .types import STRING

    # Spark coerces concat_ws args to string (a string→string cast is the
    # identity at eval time, so wrapping unconditionally is free)
    args = tuple(Cast(_e(c), STRING) for c in cols)
    return Column(ConcatWs(_e(sep), args))


def translate(c, matching: str, replace_: str) -> Column:
    from .expr.strings_ext import StringTranslate

    return Column(StringTranslate(_e(c), _e(matching), _e(replace_)))


def get_json_object(c, path: str) -> Column:
    from .expr.strings_ext import GetJsonObject

    return Column(GetJsonObject(_e(c), _e(path)))


def date_format(c, fmt: str) -> Column:
    from .expr.datetime_fmt import DateFormatClass

    return Column(DateFormatClass(_e(c), _e(fmt)))


def from_unixtime(c, fmt: str = "yyyy-MM-dd HH:mm:ss") -> Column:
    from .expr.datetime_fmt import FromUnixTime

    return Column(FromUnixTime(_e(c), _e(fmt)))


def to_date(c, fmt=None) -> Column:
    from .types import DATE

    if fmt is None:
        return Column(Cast(_e(c), DATE))
    from .expr.datetime_fmt import ParseToDate

    return Column(ParseToDate(_e(c), _e(fmt)))


def to_timestamp(c, fmt=None) -> Column:
    from .types import TIMESTAMP

    if fmt is None:
        return Column(Cast(_e(c), TIMESTAMP))
    from .expr.datetime_fmt import ToUnixTimestamp

    return Column(Cast(ToUnixTimestamp(_e(c), _e(fmt)), TIMESTAMP))


def replace(c, search, replacement) -> Column:
    return Column(StringReplace(_e(c), _e(search), _e(replacement)))


def locate(substr: str, c, pos: int = 1) -> Column:
    return Column(StringLocate(_e(substr), _e(c), _e(pos)))


def instr(c, substr: str) -> Column:
    return Column(StringLocate(_e(substr), _e(c), _e(1)))


# date/time functions
def year(c) -> Column:
    return Column(Year(_e(c)))


def month(c) -> Column:
    return Column(Month(_e(c)))


def dayofmonth(c) -> Column:
    return Column(DayOfMonth(_e(c)))


def quarter(c) -> Column:
    return Column(Quarter(_e(c)))


def dayofweek(c) -> Column:
    return Column(DayOfWeek(_e(c)))


def weekday(c) -> Column:
    return Column(WeekDay(_e(c)))


def weekofyear(c) -> Column:
    from .expr.datetime import WeekOfYear

    return Column(WeekOfYear(_e(c)))


def dayofyear(c) -> Column:
    return Column(DayOfYear(_e(c)))


def last_day(c) -> Column:
    return Column(LastDay(_e(c)))


def make_interval(
    years: int = 0,
    months: int = 0,
    weeks: int = 0,
    days: int = 0,
    hours: int = 0,
    mins: int = 0,
    secs: float = 0.0,
) -> Column:
    """A literal CalendarInterval (pyspark ``make_interval``). Adding it to a
    date/timestamp column resolves to DateAddInterval/TimeAdd, the reference's
    interval arithmetic (GpuOverrides.scala:1348,1369)."""
    from .expr.base import Literal
    from .types import CALENDAR_INTERVAL, CalendarInterval

    import builtins

    iv = CalendarInterval(
        years * 12 + months,
        weeks * 7 + days,
        int(builtins.round((hours * 3600 + mins * 60 + secs) * 1_000_000)),
    )
    return Column(Literal(iv, CALENDAR_INTERVAL))


def expr_interval(months: int = 0, days: int = 0, microseconds: int = 0) -> Column:
    """A literal CalendarInterval from Spark's internal (months, days, us)."""
    from .expr.base import Literal
    from .types import CALENDAR_INTERVAL, CalendarInterval

    return Column(Literal(CalendarInterval(months, days, microseconds), CALENDAR_INTERVAL))


def date_add(c, days) -> Column:
    return Column(DateAdd(_e(c), _e(days)))


def date_sub(c, days) -> Column:
    return Column(DateSub(_e(c), _e(days)))


def datediff(end, start) -> Column:
    return Column(DateDiff(_e(end), _e(start)))


def add_months(c, months) -> Column:
    return Column(AddMonths(_e(c), _e(months)))


def hour(c) -> Column:
    return Column(Hour(_e(c)))


def minute(c) -> Column:
    return Column(Minute(_e(c)))


def second(c) -> Column:
    return Column(Second(_e(c)))


def unix_timestamp(c=None, fmt: str = None) -> Column:
    if c is None:
        raise NotImplementedError(
            "unix_timestamp() of the current time is not supported; pass a "
            "timestamp/string column"
        )
    if fmt is None:
        return Column(UnixTimestamp(_e(c)))
    from .expr.datetime_fmt import ToUnixTimestamp

    return Column(ToUnixTimestamp(_e(c), _e(fmt)))


# math functions
def _unary_fn(cls):
    def f(c) -> Column:
        return Column(cls(_e(c)))

    f.__name__ = cls.__name__.lower()
    return f


sqrt = _unary_fn(Sqrt)
cbrt = _unary_fn(Cbrt)
exp = _unary_fn(Exp)
expm1 = _unary_fn(Expm1)
sin = _unary_fn(Sin)
cos = _unary_fn(Cos)
tan = _unary_fn(Tan)
asin = _unary_fn(Asin)
acos = _unary_fn(Acos)
atan = _unary_fn(Atan)
sinh = _unary_fn(Sinh)
cosh = _unary_fn(Cosh)
tanh = _unary_fn(Tanh)
asinh = _unary_fn(Asinh)
acosh = _unary_fn(Acosh)
atanh = _unary_fn(Atanh)
cot = _unary_fn(Cot)
degrees = _unary_fn(ToDegrees)
radians = _unary_fn(ToRadians)
rint = _unary_fn(Rint)
signum = _unary_fn(Signum)
log10 = _unary_fn(Log10)
log2 = _unary_fn(Log2)
log1p = _unary_fn(Log1p)
floor = _unary_fn(Floor)
ceil = _unary_fn(Ceil)


def log(arg1, arg2=None) -> Column:
    """``log(x)`` natural log, or ``log(base, x)`` (pyspark's two-arg form,
    Spark's Logarithm)."""
    if arg2 is None:
        return Column(Log(_e(arg1)))
    return Column(Logarithm(_e(arg1), _e(arg2)))


def pow(l, r) -> Column:  # noqa: A001
    return Column(Pow(_e(l), _e(r)))


def atan2(l, r) -> Column:
    return Column(Atan2(_e(l), _e(r)))


def hypot(l, r) -> Column:
    return Column(Hypot(_e(l), _e(r)))


def pmod(dividend, divisor) -> Column:
    from .expr.arithmetic import Pmod

    return Column(Pmod(_e(dividend), _e(divisor)))


def round(c, scale: int = 0) -> Column:  # noqa: A001
    return Column(Round(_e(c), _e(scale)))


def bround(c, scale: int = 0) -> Column:
    return Column(BRound(_e(c), _e(scale)))


# bitwise
def shiftleft(c, n) -> Column:
    return Column(ShiftLeft(_e(c), _e(n)))


def shiftright(c, n) -> Column:
    return Column(ShiftRight(_e(c), _e(n)))


def shiftrightunsigned(c, n) -> Column:
    return Column(ShiftRightUnsigned(_e(c), _e(n)))


def bitwise_not(c) -> Column:
    return Column(BitwiseNot(_e(c)))


# null handling
def greatest(*cols) -> Column:
    return Column(Greatest(tuple(_e(c) for c in cols)))


def least(*cols) -> Column:
    return Column(Least(tuple(_e(c) for c in cols)))


def nanvl(a, b) -> Column:
    return Column(NaNvl(_e(a), _e(b)))


def nvl(a, b) -> Column:
    return Column(Coalesce((_e(a), _e(b))))


def nvl2(a, b, c) -> Column:
    return Column(Nvl2(_e(a), _e(b), _e(c)))


def grouping_id() -> Column:
    """The grouping-set id column inside rollup/cube aggregates."""
    return Column(UnresolvedAttribute("__grouping_id"))


# hash / task-context functions (HashFunctions.scala, GpuSparkPartitionID,
# GpuMonotonicallyIncreasingID, GpuInputFileBlock, GpuRand)
def hash(*cols) -> Column:  # noqa: A001 - pyspark parity
    from .expr.misc import Murmur3Hash

    return Column(Murmur3Hash(tuple(_e(c) for c in cols)))


def md5(c) -> Column:
    from .expr.misc import Md5

    return Column(Md5(_e(c)))


def spark_partition_id() -> Column:
    from .expr.misc import SparkPartitionID

    return Column(SparkPartitionID())


def monotonically_increasing_id() -> Column:
    from .expr.misc import MonotonicallyIncreasingID

    return Column(MonotonicallyIncreasingID())


def input_file_name() -> Column:
    from .expr.misc import InputFileName

    return Column(InputFileName())


def input_file_block_start() -> Column:
    from .expr.misc import InputFileBlockStart

    return Column(InputFileBlockStart())


def input_file_block_length() -> Column:
    from .expr.misc import InputFileBlockLength

    return Column(InputFileBlockLength())


def rand(seed: int = 0) -> Column:
    from .expr.misc import Rand

    return Column(Rand(seed))


# ── complex types (complexTypeCreator/Extractors, collectionOperations) ────


def array(*cols) -> Column:
    from .expr.complex import CreateArray

    return Column(CreateArray(tuple(_e(c) for c in cols)))


def struct(*cols) -> Column:
    from .expr.base import Alias as _Alias
    from .expr.base import UnresolvedAttribute as _UA
    from .expr.complex import CreateNamedStruct

    names, values = [], []
    for i, c in enumerate(cols):
        e = _e(c)
        if isinstance(e, _Alias):
            names.append(e.name)
            values.append(e.child)
        elif isinstance(e, _UA):
            names.append(e.name)
            values.append(e)
        else:
            names.append(f"col{i + 1}")
            values.append(e)
    return Column(CreateNamedStruct(tuple(names), tuple(values)))


def size(c) -> Column:
    from .expr.complex import Size

    return Column(Size(_e(c)))


def element_at(c, key) -> Column:
    from .expr.complex import ElementAt

    return Column(ElementAt(_e(c), _e(key)))


def array_contains(c, value) -> Column:
    from .expr.complex import ArrayContains

    return Column(ArrayContains(_e(c), _e(value)))


def explode(c) -> Column:
    from .expr.complex import Explode

    return Column(Explode(_e(c)))


def posexplode(c) -> Column:
    from .expr.complex import Explode

    return Column(Explode(_e(c), position=True))


# ── user-defined functions (L7; reference GpuArrowEvalPythonExec/RapidsUDF) ─
def udf(f=None, returnType=None):
    """Row-at-a-time python UDF (CPU engine; the plan falls back per-node).
    Usable directly or as a decorator: ``@udf(returnType=DOUBLE)``."""
    from .types import STRING as _S

    rt = returnType if returnType is not None else _S

    def wrap(fn):
        from .expr.udf import PythonUdf

        def call(*cols) -> Column:
            return Column(
                PythonUdf(fn, rt, tuple(_e(c) for c in cols), fn.__name__)
            )

        call.__name__ = fn.__name__
        return call

    if f is None:
        return wrap
    return wrap(f)


def pandas_udf(f=None, returnType=None, functionType="scalar"):
    """Batch-vectorized python UDF (pyspark ``pandas_udf``). Flavors:

    * ``"scalar"`` (default): ``fn(*series) -> series`` once per batch —
      the GpuArrowEvalPythonExec data path.
    * ``"grouped_agg"``: ``fn(*series) -> scalar`` once per key group or
      window frame — usable in ``groupBy().agg(...)`` (reference
      GpuAggregateInPandasExec) and ``.over(window)`` (reference
      GpuWindowInPandasExecBase).

    CPU engine; the plan falls back per-node with a reason."""
    from .types import DOUBLE as _D

    rt = returnType if returnType is not None else _D
    flavor = functionType.lower().replace("_", "")
    if flavor not in ("scalar", "groupedagg"):
        raise ValueError(
            f"unsupported pandas_udf functionType {functionType!r}; "
            "supported: 'scalar', 'grouped_agg' (use mapInPandas/"
            "applyInPandas for the map/grouped-map flavors)"
        )

    def wrap(fn):
        from .expr.udf import GroupedAggUdf, VectorizedUdf

        cls = GroupedAggUdf if flavor == "groupedagg" else VectorizedUdf

        def call(*cols) -> Column:
            return Column(
                cls(fn, rt, tuple(_e(c) for c in cols), fn.__name__)
            )

        call.__name__ = fn.__name__
        return call

    if f is None:
        return wrap
    return wrap(f)


vectorized_udf = pandas_udf


def torch_udf(f=None, returnType=None):
    """Device UDF: ``fn(*tensors) -> tensor`` written with torch ops; runs
    inside the device projection on the batch's tensors (the RapidsUDF
    analogue; the JAX package's ``jax_udf``). On the CPU engine the same
    ``fn`` receives the columns as CPU tensors."""
    from .types import DOUBLE as _D

    rt = returnType if returnType is not None else _D

    def wrap(fn):
        from .expr.udf import TorchUdf

        def call(*cols) -> Column:
            return Column(TorchUdf(fn, rt, tuple(_e(c) for c in cols), fn.__name__))

        call.__name__ = fn.__name__
        return call

    if f is None:
        return wrap
    return wrap(f)
