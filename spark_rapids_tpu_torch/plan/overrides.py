"""Plan-rewrite layer: replace CPU execs with device execs where supported.

Reference: GpuOverrides.scala (rule registries + apply pipeline :2998-3098),
RapidsMeta.scala (tagging with ``willNotWorkOnGpu`` reason bookkeeping),
GpuTransitionOverrides.scala (transition insertion).

The port's own table, after ``spark_rapids_tpu/plan/overrides.py``: the same
tagging walk, kill-switch conf keys (``spark.rapids.sql.exec.<Name>`` /
``spark.rapids.sql.expression.<Name>``), explain reasons and transition
pass. Its exec rules cover project, filter, grouped and ungrouped
aggregation (the collect family included), sort, top-N, expand, the
coalesce, the shuffle exchange, union, limit, the shuffled and broadcast
hash joins, the broadcast exchange, the nested-loop and cartesian joins,
the window, generate (explode) and range. Its expression rules are the
JAX package's, check and reason for check and reason: arithmetic (decimal
included), predicates, null handling, the GpuCast matrix
(``can_cast_on_device``; ANSI casts raise through the device error
channel of the project and filter), dates, date patterns, math, bitwise,
strings (over the ``match_starts`` kernel where they search; split;
``get_json_object`` behind its key), ``md5``, ``rand``, the task-context
expressions, the aggregates, the windows, the complex-type expressions
over one level of array, struct and map nesting, and the device UDF
(``TorchUdf``, the JAX package's ``JaxUdf``). The input-file expressions
have no rule (they wait for the file scans); python UDFs, ``RLike`` and
the regex functions keep the JAX package's CPU-engine rule. Nested
columns cannot be sort, group, join or partition keys on the device
(``_no_complex_keys``). Every other node stays on the CPU engine with its
reason in the explain, which is the system's own per-node fallback. (The JAX table binds ``exec.tpu``
directly, so it cannot be shared.)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

from .. import config as cfg
from ..config import TpuConf
from ..exec import cpu as C
from ..exec import cpu_join as CJ
from ..exec import gpu as G
from ..exec import gpu_join as GJ
from ..exec import gpu_window as GW
from ..exec.cpu_window import CpuWindowExec
from ..expr import Expression, bind
from ..expr import aggregates as agg
from ..expr import arithmetic as ar
from ..expr import conditional as cond
from ..expr import bitwise as bw
from ..expr import datetime as dtx
from ..expr import datetime_fmt as dfmt
from ..expr import math as mx
from ..expr import misc as msc
from ..expr import nullexprs as nx
from ..expr import predicates as pred
from ..expr import strings as st
from ..expr import strings_ext as sx
from ..expr import subquery as sq
from ..expr import windows as W
from ..expr.base import Alias, BoundReference, Literal
from ..expr.cast import Cast, can_cast_on_device
from ..types import (
    BooleanType,
    DataType,
    DateType,
    DecimalType,
    Schema,
    StringType,
    TimestampType,
)
from .physical import Exec

# ── TypeSig algebra (TypeChecks.scala:129-367) ─────────────────────────────


class TypeSig:
    """Which data types a rule's inputs may have — the reference's
    type-signature algebra, compacted to a set of type classes combinable
    with ``+``. Rules carry a sig; the tagging walk rejects mismatches with
    a reason naming the offending type, exactly like ``ExprChecks.tag``.
    Copied from the JAX package's ``plan/overrides.py:52-105``."""

    def __init__(self, *classes, note: str = ""):
        self.classes = frozenset(classes)
        self.note = note

    def __add__(self, other: "TypeSig") -> "TypeSig":
        return TypeSig(*(self.classes | other.classes), note=self.note or other.note)

    def supports(self, dt: DataType) -> bool:
        return isinstance(dt, tuple(self.classes)) if self.classes else True

    def describe(self) -> str:
        names = sorted(c.__name__.replace("Type", "") for c in self.classes)
        return "+".join(names) if names else "any"


def _mk_sigs():
    from ..types import (
        ArrayType,
        ByteType,
        DoubleType,
        FloatType,
        IntegerType,
        LongType,
        MapType,
        NullType,
        ShortType,
        StructType,
    )

    integral = TypeSig(ByteType, ShortType, IntegerType, LongType)
    fp = TypeSig(FloatType, DoubleType)
    numeric = integral + fp + TypeSig(DecimalType)
    temporal = TypeSig(DateType, TimestampType)
    basic = numeric + temporal + TypeSig(BooleanType, StringType, NullType)
    nested = TypeSig(ArrayType, StructType, MapType)
    return {
        "integral": integral,
        # the two the JAX table composes inline; the port's narrower
        # checks below name them
        "fp": fp,
        "temporal": temporal,
        "numeric": numeric,
        "orderable": basic,
        "basic": basic,
        "all": basic + nested,
    }


SIGS = _mk_sigs()

# the port's narrower device surfaces, composed from SIGS: fixed-width
# numbers without decimal (float aggregates, min/max)
_INTEGRAL = SIGS["integral"]
_FLOATING = SIGS["fp"]
_NUMERIC = _INTEGRAL + _FLOATING
_MINMAX = _NUMERIC + SIGS["temporal"] + TypeSig(BooleanType, StringType)


def _device_type_ok(dt: DataType) -> bool:
    """Types with a device layout: primitives/strings/decimal64, plus ONE
    level of array/struct/map nesting over them (deeper nesting has no
    padded-plane encoding — those plans stay on the CPU engine). The JAX
    package's ``_device_type_ok``."""
    from ..types import ArrayType, MapType, StructType, is_complex

    if isinstance(dt, ArrayType):
        return not is_complex(dt.element_type)
    if isinstance(dt, MapType):
        return not is_complex(dt.key_type) and not is_complex(dt.value_type)
    if isinstance(dt, StructType):
        return all(not is_complex(f.data_type) for f in dt.fields)
    return True

# ── expression rules ───────────────────────────────────────────────────────


class ExprRule:
    def __init__(
        self,
        cls,
        name: str,
        check: Optional[Callable] = None,
        sig: Optional[TypeSig] = None,
    ):
        self.cls = cls
        self.name = name
        self.conf_key = f"spark.rapids.sql.expression.{name}"
        self.check = check  # (expr, conf) -> Optional[str] (reason if bad)
        self.sig = sig  # TypeSig over the expression's child types


def _float_agg_check(e, conf: TpuConf) -> Optional[str]:
    """variableFloatAgg gate (reference RapidsConf.scala): float sums/avgs
    are evaluation-order dependent; when disabled they stay on CPU so the
    row-order result is Spark's."""
    if _FLOATING.supports(e.child.data_type) and not conf.is_enabled(
        cfg.VARIABLE_FLOAT_AGG
    ):
        return (
            "float/double sum/avg varies with evaluation order; disabled by "
            f"{cfg.VARIABLE_FLOAT_AGG.key}"
        )
    if not _NUMERIC.supports(e.child.data_type):
        return (
            f"{type(e).__name__} over {e.child.data_type.simple_string} is not "
            "in the torch port yet"
        )
    return None


def _cast_check(e: Cast, conf: TpuConf) -> Optional[str]:
    """The JAX package's GpuCast type matrix (``can_cast_on_device``); an
    ANSI cast raises through the device error channel of the project and
    filter (``exec/gpu.py``), and keeps any other exec on the CPU engine
    (``GpuOverrides._convert``)."""
    if not can_cast_on_device(e.c.data_type, e.to, conf):
        return f"cast {e.c.data_type} -> {e.to} is not supported on device (config-gated)"
    return None


def _minmax_check(e, conf: TpuConf) -> Optional[str]:
    if not _MINMAX.supports(e.child.data_type):
        return (
            f"{type(e).__name__} input type {e.child.data_type.simple_string} is "
            "not in the torch port yet"
        )
    return None


# the string rules the reference gates on a scalar pattern
# (spark_rapids_tpu/plan/overrides.py's string rules)
def _lit_check(attr: str, what: str):
    def check(e, conf: TpuConf) -> Optional[str]:
        if not st.is_string_literal(getattr(e, attr)):
            return f"{what} must be a string literal for the device path"
        return None

    return check


def _like_check(e, conf: TpuConf) -> Optional[str]:
    if not st.is_string_literal(e.pattern):
        return "LIKE pattern must be a string literal for the device path"
    try:
        st.like_tokens(e.pattern.value, e.escape)
    except ValueError as ex:
        return str(ex)
    return None


def _pad_check(e, conf: TpuConf) -> Optional[str]:
    p = e.pad
    if not st.is_string_literal(p):
        return "pad must be a string literal for the device path"
    if len(p.value.encode("utf-8")) != 1:
        return "device pad requires a single-byte pad string"
    if not isinstance(e.length, Literal):
        return "pad length must be a literal for the device path"
    return None


def _locate_check(e, conf: TpuConf) -> Optional[str]:
    if not st.is_string_literal(e.substr):
        return "locate substring must be a string literal for the device path"
    if not isinstance(e.start, Literal):
        return "locate start must be a literal for the device path"
    return None


def _repeat_check(e, conf: TpuConf) -> Optional[str]:
    if not isinstance(e.times, Literal):
        return "repeat count must be a literal for the device path"
    return None


def _replace_check(e, conf: TpuConf) -> Optional[str]:
    if not st.is_string_literal(e.search) or not st.is_string_literal(e.replacement):
        return "replace search/replacement must be string literals for the device path"
    return None


def _trim_check(e, conf: TpuConf) -> Optional[str]:
    if e.trim_str is not None and not st.is_string_literal(e.trim_str):
        return "trim character set must be a string literal for the device path"
    return None


def _substring_index_check(e, conf: TpuConf) -> Optional[str]:
    if not st.is_string_literal(e.delim):
        return "substring_index delimiter must be a string literal for the device path"
    if not isinstance(e.count, Literal):
        return "substring_index count must be a literal for the device path"
    return None


def _greatest_check(e, conf: TpuConf) -> Optional[str]:
    if any(isinstance(x.data_type, StringType) for x in e.exprs):
        return "greatest/least over strings is CPU-only"
    return None


def _translate_check(e, conf: TpuConf) -> Optional[str]:
    if not sx.translate_args_ascii(e):
        return "translate on device requires ASCII literal from/to arguments"
    return None


def _cpu_regex_check(what: str):
    def check(e, conf: TpuConf) -> Optional[str]:
        return (
            f"{what} executes on the CPU engine (the reference leans on "
            "cuDF's device regex/JSON engines — no XLA analogue)"
        )

    return check


def _fmt_check(e, conf: TpuConf) -> Optional[str]:
    if not st.is_string_literal(e.fmt):
        return "datetime pattern must be a string literal"
    # parsers scan fixed offsets, so unpadded single-letter tokens are
    # format-only (ToUnixTimestamp/ParseToDate reject them)
    if not dfmt.pattern_supported(e.fmt.value):
        return (
            f"datetime pattern {e.fmt.value!r} is outside the device-"
            "supported token subset (yyyy MM dd HH mm ss + literals; "
            "y M d H m s when formatting)"
        )
    return None


def _interval_check(e, conf: TpuConf) -> Optional[str]:
    """Literal-interval gate, the reference's GpuTimeAdd/GpuDateAddInterval
    restriction (GpuOverrides.scala:1348,1369)."""
    from ..types import CalendarIntervalType

    itv = e.interval
    if not (isinstance(itv, Literal) and isinstance(itv.data_type, CalendarIntervalType)):
        return "interval operand must be a literal CalendarInterval for the device path"
    if isinstance(e, dtx.DateAddInterval) and itv.value[2] != 0:
        return "date + interval with a sub-day component is an error in Spark"
    return None


def _round_check(e, conf: TpuConf) -> Optional[str]:
    if not isinstance(e.scale, Literal):
        return "round scale must be a literal for the device path"
    if not _INTEGRAL.supports(e.child.data_type) and not cfg.INCOMPATIBLE_OPS.get(conf):
        # the reference gates float round the same way: "may round slightly
        # differently" under isIncompatEnabled (GpuOverrides.scala:2036-2077)
        return (
            "round on floating point may round slightly differently than "
            "Spark's java BigDecimal semantics; enable "
            "spark.rapids.sql.incompatibleOps.enabled"
        )
    return None


_EXPR_RULES: dict = {}


def _expr(cls, name=None, check=None, sig=None):
    _EXPR_RULES[cls] = ExprRule(cls, name or cls.__name__, check, sig)


def expr_rules() -> dict:
    """The expression rule registry (class → rule), as the JAX package's
    ``expr_rules()`` gives it to the docs generator."""
    return dict(_EXPR_RULES)


# the JAX package's expression rules (spark_rapids_tpu/plan/overrides.py),
# with its checks and reasons, for every expression the port runs on the
# device
for _cls in (
    BoundReference,
    Literal,
    Alias,
    ar.Add,
    ar.Subtract,
    ar.Multiply,
    ar.Divide,
    ar.IntegralDivide,
    ar.Remainder,
    ar.Pmod,
    ar.UnaryMinus,
    ar.UnaryPositive,
    ar.Abs,
    pred.EqualTo,
    pred.EqualNullSafe,
    pred.LessThan,
    pred.LessThanOrEqual,
    pred.GreaterThan,
    pred.GreaterThanOrEqual,
    pred.And,
    pred.Or,
    pred.Not,
    pred.IsNull,
    pred.IsNotNull,
    pred.IsNaN,
    pred.In,
    sq.InSet,
    cond.If,
    cond.CaseWhen,
    cond.Coalesce,
    agg.Count,
    agg.First,
    agg.Last,
    agg.StddevSamp,
    agg.StddevPop,
    agg.VarianceSamp,
    agg.VariancePop,
    agg.CovarPop,
    agg.CovarSamp,
    agg.Corr,
):
    _expr(_cls)
_expr(agg.Sum, check=_float_agg_check, sig=SIGS["numeric"])
_expr(agg.Average, check=_float_agg_check, sig=SIGS["numeric"])
_expr(agg.Min, check=_minmax_check, sig=SIGS["orderable"])
_expr(agg.Max, check=_minmax_check, sig=SIGS["orderable"])
_expr(Cast, check=_cast_check)

for _cls in (st.Length, st.Upper, st.Lower, st.InitCap, st.Reverse, st.Ascii, st.Substring,
             st.Concat):
    _expr(_cls)
_expr(st.StartsWith, check=_lit_check("pattern", "startswith pattern"))
_expr(st.EndsWith, check=_lit_check("pattern", "endswith pattern"))
_expr(st.Contains, check=_lit_check("pattern", "contains pattern"))
_expr(st.Like, check=_like_check)
_expr(st.StringReplace, check=_replace_check)
_expr(st.StringRepeat, check=_repeat_check)
_expr(st.StringLocate, check=_locate_check)
_expr(st.SubstringIndex, check=_substring_index_check)
_expr(st.StringLPad, check=_pad_check)
_expr(st.StringRPad, check=_pad_check)
_expr(st.StringTrim, check=_trim_check)
_expr(st.StringTrimLeft, check=_trim_check)
_expr(st.StringTrimRight, check=_trim_check)

_expr(dtx.TimeAdd, check=_interval_check)
_expr(dtx.DateAddInterval, check=_interval_check)
for _cls in (
    dtx.Year, dtx.Month, dtx.DayOfMonth, dtx.Quarter, dtx.DayOfWeek, dtx.WeekDay,
    dtx.WeekOfYear, dtx.DayOfYear, dtx.LastDay, dtx.DateAdd, dtx.DateSub, dtx.DateDiff,
    dtx.AddMonths, dtx.Hour, dtx.Minute, dtx.Second, dtx.UnixTimestamp,
):
    _expr(_cls)

for _cls in (
    mx.Sqrt, mx.Cbrt, mx.Exp, mx.Expm1, mx.Sin, mx.Cos, mx.Tan,
    mx.Asin, mx.Acos, mx.Atan, mx.Sinh, mx.Cosh, mx.Tanh,
    mx.Asinh, mx.Acosh, mx.Atanh, mx.Cot,
    mx.ToDegrees, mx.ToRadians, mx.Rint, mx.Signum,
    mx.Log, mx.Log10, mx.Log2, mx.Log1p, mx.Logarithm,
    mx.Pow, mx.Atan2, mx.Hypot, mx.Floor, mx.Ceil,
    nx.NaNvl, nx.Nvl2, nx.AtLeastNNonNulls,
):
    _expr(_cls)
for _cls in (
    bw.BitwiseAnd, bw.BitwiseOr, bw.BitwiseXor, bw.BitwiseNot,
    bw.ShiftLeft, bw.ShiftRight, bw.ShiftRightUnsigned,
):
    _expr(_cls, sig=SIGS["integral"])
_expr(mx.Round, check=_round_check)
_expr(mx.BRound, check=_round_check)
_expr(nx.Greatest, check=_greatest_check)
_expr(nx.Least, check=_greatest_check)

for _cls in (msc.Murmur3Hash, msc.Md5, msc.SparkPartitionID, msc.MonotonicallyIncreasingID,
             msc.InputFileName, msc.InputFileBlockStart, msc.InputFileBlockLength,
             msc.NormalizeNaNAndZero):
    _expr(_cls)


def _rand_check(e, conf: TpuConf) -> Optional[str]:
    """The JAX package's gate and reason (its ``overrides.py:463-469``)."""
    if not cfg.INCOMPATIBLE_OPS.get(conf):
        return (
            "rand() on device is not bit-identical to Spark's XORShiftRandom "
            "stream; enable spark.rapids.sql.incompatibleOps.enabled"
        )
    return None


_expr(msc.Rand, check=_rand_check)


def _collect_check(e, conf: TpuConf) -> Optional[str]:
    from ..types import is_complex

    if is_complex(e.child.data_type):
        return "collect over nested element types is not supported on device"
    return None


_expr(agg.CollectList, check=_collect_check)
_expr(agg.CollectSet, check=_collect_check)


def _merge_lists_check(e, conf: TpuConf) -> Optional[str]:
    return (
        "merging partial collect arrays (collect alongside DISTINCT "
        "aggregates) runs on the CPU engine"
    )


_expr(agg.MergeLists, check=_merge_lists_check)
_expr(agg.MergeSets, check=_merge_lists_check)

# ── complex-type expressions (complexTypeCreator/Extractors,
#    collectionOperations.scala) ──────────────────────────────────────────
from ..expr import complex as cx  # noqa: E402


def _complex_child_check(e, conf: TpuConf) -> Optional[str]:
    dt = e.child.data_type
    if not _device_type_ok(dt):
        return f"{dt.simple_string} exceeds the device nesting support"
    return None


for _cls in (cx.CreateArray, cx.CreateNamedStruct):
    _expr(_cls)
for _cls in (cx.Size, cx.GetStructField, cx.GetArrayItem, cx.ElementAt, cx.GetMapValue,
             cx.ArrayContains, cx.Explode):
    _expr(_cls, check=_complex_child_check)

def _split_check(e, conf: TpuConf) -> Optional[str]:
    if not st.is_string_literal(e.pattern):
        return "split pattern must be a string literal for the device path"
    if sx.split_device_pattern(e.pattern.value) is None:
        return (
            "only literal / plain char-class split patterns run on device "
            "(full regex is CPU-only, like the reference's "
            "GpuStringSplitMeta gate)"
        )
    return None


def _get_json_check(e, conf: TpuConf) -> Optional[str]:
    if not st.is_string_literal(e.path):
        return "get_json_object path must be a string literal"
    if not cfg.GET_JSON_OBJECT_DEVICE.get(conf):
        return (
            "device get_json_object returns raw value spans (no Jackson "
            "re-serialization / unescaping, like the reference's cudf "
            f"kernel); enable {cfg.GET_JSON_OBJECT_DEVICE.key} to accept "
            "the divergence (docs/compatibility.md)"
        )
    return None


_expr(sx.ConcatWs)
_expr(sx.StringTranslate, check=_translate_check)
_expr(sx.StringSplit, check=_split_check)
_expr(sx.GetJsonObject, check=_get_json_check)
_expr(sx.RLike, check=_cpu_regex_check("rlike"))
_expr(sx.RegExpReplace, check=_cpu_regex_check("regexp_replace"))
_expr(sx.RegExpExtract, check=_cpu_regex_check("regexp_extract"))
_expr(dfmt.DateFormatClass, check=_fmt_check)
_expr(dfmt.FromUnixTime, check=_fmt_check)
_expr(dfmt.ToUnixTimestamp, check=_fmt_check)
_expr(dfmt.ParseToDate, check=_fmt_check)


def _window_check(e, conf: TpuConf) -> Optional[str]:
    """GpuWindowExpression gating, as in the JAX package."""
    fn = e.function
    fr = e.spec.resolved_frame()
    if isinstance(fn, (W.Rank, W.DenseRank, W.RowNumber, W.PercentRank, W.CumeDist, W.NTile)):
        if not e.spec.order_by:
            return "ranking window functions require ORDER BY"
        return None
    if isinstance(fn, (W.Lead, W.Lag)):
        return None
    if isinstance(fn, (agg.Sum, agg.Count, agg.Min, agg.Max, agg.Average)):
        sentinels = (W.UNBOUNDED_PRECEDING, W.CURRENT_ROW, W.UNBOUNDED_FOLLOWING)
        if fr.frame_type == "range" and not (
            fr.lower in sentinels and fr.upper in sentinels
        ):
            # numeric RANGE frames: value-space binary searches over ONE
            # numeric/temporal order key (Spark's own restriction)
            if len(e.spec.order_by) != 1:
                return "numeric RANGE frames require exactly one ORDER BY key"
            ot = e.spec.order_by[0].child.data_type
            # decimal keys compare unscaled with scale-adjusted bounds
            if not (SIGS["numeric"] + SIGS["temporal"]).supports(ot):
                return f"numeric RANGE frame over {ot.simple_string} is CPU-only"
        return None
    return f"window function {type(fn).__name__} has no device implementation"


_expr(W.WindowExpression, check=_window_check)
for _cls in (W.RowNumber, W.Rank, W.DenseRank, W.Lead, W.Lag, W.PercentRank, W.CumeDist, W.NTile):
    _expr(_cls)


# ── UDFs (GpuUserDefinedFunction / GpuArrowEvalPythonExec seam) ───────────
from ..expr import udf as _udf  # noqa: E402

_expr(_udf.TorchUdf)
_expr(
    _udf.PythonUdf,
    check=lambda e, conf: (
        "python row UDFs execute on the CPU engine (register a torch_udf for "
        "device execution — it runs inside the device projection)"
    ),
)


def _check_expr_tree(e: Expression, conf: TpuConf, reasons: List[str]) -> bool:
    ok = True
    rule = _EXPR_RULES.get(type(e))
    if rule is None:
        reasons.append(f"expression {type(e).__name__} has no device implementation")
        ok = False
    elif not conf.rule_enabled(rule.conf_key):
        reasons.append(f"expression {rule.name} disabled by {rule.conf_key}")
        ok = False
    else:
        if rule.sig is not None:
            for c in e.children():
                dt = c.data_type
                if not rule.sig.supports(dt):
                    reasons.append(
                        f"{rule.name} input type {dt.simple_string} is "
                        f"outside its device signature ({rule.sig.describe()})"
                    )
                    ok = False
        if ok and rule.check is not None:
            why = rule.check(e, conf)
            if why:
                reasons.append(why)
                ok = False
    for c in e.children():
        ok = _check_expr_tree(c, conf, reasons) and ok
    return ok


def _check_schema(schema: Schema, conf: TpuConf, reasons: List[str], where: str) -> bool:
    ok = True
    for f in schema:
        dt = f.data_type
        if isinstance(dt, DecimalType) and not conf.is_enabled(cfg.DECIMAL_ENABLED):
            reasons.append(f"{where}: decimal disabled by {cfg.DECIMAL_ENABLED.key}")
            ok = False
        if not _device_type_ok(dt):
            reasons.append(
                f"{where}: {dt.simple_string} exceeds the device nesting support"
            )
            ok = False
    return ok


# ── exec rules ─────────────────────────────────────────────────────────────


class ExecRule:
    def __init__(self, cls, name: str, convert, exprs_of, check=None):
        self.cls = cls
        self.name = name
        self.conf_key = f"spark.rapids.sql.exec.{name}"
        self.convert = convert  # (cpu_exec, children) -> Exec
        self.exprs_of = exprs_of  # (cpu_exec) -> list[Expression]
        self.check = check  # (cpu_exec, conf) -> Optional[str]


_EXEC_RULES: dict = {}


def _rule(cls, name, convert, exprs_of, check=None):
    _EXEC_RULES[cls] = ExecRule(cls, name, convert, exprs_of, check=check)


def exec_rules() -> dict:
    """The exec rule registry (CPU exec class → rule)."""
    return dict(_EXEC_RULES)


def _conv_agg(e: C.CpuHashAggregateExec, ch):
    g = G.GpuHashAggregateExec(
        e.mode, e.grouping, e.agg_fns, e.result_exprs, e.result_names, ch[0]
    )
    g._schema = e.output
    return g


def _no_complex_keys(exprs, what: str):
    """Exec-level check: complex types cannot be sort/group/join/partition
    keys on device (no radix-word encoding — reference gates these the same
    way via TypeSig key signatures). The JAX package's ``_no_complex_keys``."""
    from ..types import is_complex

    def check(e, conf: TpuConf) -> Optional[str]:
        for k in exprs(e):
            if is_complex(k.data_type):
                return f"{what} of type {k.data_type.simple_string} is not supported on device"
        return None

    return check


_rule(
    C.CpuProjectExec,
    "ProjectExec",
    lambda e, ch: G.GpuProjectExec(e.exprs, ch[0], schema=e.output),
    lambda e: e.exprs,
)
_rule(
    C.CpuFilterExec,
    "FilterExec",
    lambda e, ch: G.GpuFilterExec(e.condition, ch[0]),
    lambda e: [e.condition],
)
_rule(
    C.CpuHashAggregateExec,
    "HashAggregateExec",
    _conv_agg,
    lambda e: e.grouping + list(e.agg_fns) + (e.result_exprs or []),
    check=_no_complex_keys(lambda e: e.grouping, "grouping key"),
)
_rule(
    C.CpuSortExec,
    "SortExec",
    lambda e, ch: G.GpuSortExec(e.order, ch[0]),
    lambda e: [o.child for o in e.order],
    check=_no_complex_keys(lambda e: [o.child for o in e.order], "sort key"),
)
_rule(
    C.CpuCoalescePartitionsExec,
    "CoalescePartitionsExec",
    lambda e, ch: G.GpuCoalescePartitionsExec(ch[0]),
    lambda e: [],
)


_exchange_check = _no_complex_keys(lambda e: e.partitioning.exprs(), "partition key")


_rule(
    C.CpuShuffleExchangeExec,
    "ShuffleExchangeExec",
    lambda e, ch: G.GpuShuffleExchangeExec(e.partitioning, ch[0]),
    lambda e: e.partitioning.exprs(),
    check=_exchange_check,
)
_rule(C.CpuUnionExec, "UnionExec", lambda e, ch: G.GpuUnionExec(ch), lambda e: [])
_rule(C.CpuLimitExec, "CollectLimitExec", lambda e, ch: G.GpuLimitExec(e.n, ch[0]), lambda e: [])
_rule(
    C.CpuTakeOrderedAndProjectExec,
    "TakeOrderedAndProjectExec",
    lambda e, ch: G.GpuTakeOrderedAndProjectExec(e.n, e.order, ch[0]),
    lambda e: [o.child for o in e.order],
    check=_no_complex_keys(lambda e: [o.child for o in e.order], "sort key"),
)
_rule(
    C.CpuExpandExec,
    "ExpandExec",
    lambda e, ch: G.GpuExpandExec(e.projections, e.output.names, ch[0]),
    lambda e: [x for proj in e.projections for x in proj],
)


def _join_exprs_of(e):
    out = list(e.left_keys) + list(e.right_keys)
    if e.residual is not None:
        # the residual reads the pair of rows: bind it over both sides
        left, right = e.children
        pair = Schema(list(left.output.fields) + list(right.output.fields))
        out.append(bind(e.residual, pair))
    return out


def _conv_join(cls):
    return lambda e, ch: cls(
        e.join_type, e.left_keys, e.right_keys, e.residual, ch[0], ch[1], e.drop_right_keys
    )


_join_key_check = _no_complex_keys(
    lambda e: list(e.left_keys) + list(e.right_keys), "join key"
)
_rule(
    CJ.CpuShuffledHashJoinExec,
    "ShuffledHashJoinExec",
    _conv_join(GJ.GpuShuffledHashJoinExec),
    _join_exprs_of,
    check=_join_key_check,
)
_rule(
    CJ.CpuBroadcastHashJoinExec,
    "BroadcastHashJoinExec",
    _conv_join(GJ.GpuBroadcastHashJoinExec),
    _join_exprs_of,
    check=_join_key_check,
)
_rule(
    CJ.CpuBroadcastExchangeExec,
    "BroadcastExchangeExec",
    lambda e, ch: GJ.GpuBroadcastExchangeExec(ch[0]),
    lambda e: [],
)




def _pair_condition_of(e):
    """The nested-loop/cartesian condition, bound over the pair of rows."""
    if e.condition is None:
        return []
    left, right = e.children
    pair = Schema(list(left.output.fields) + list(right.output.fields))
    return [bind(e.condition, pair)]


_rule(
    CJ.CpuNestedLoopJoinExec,
    "BroadcastNestedLoopJoinExec",
    lambda e, ch: GJ.GpuBroadcastNestedLoopJoinExec(e.join_type, e.condition, ch[0], ch[1]),
    _pair_condition_of,
)
_rule(
    CJ.CpuCartesianProductExec,
    "CartesianProductExec",
    lambda e, ch: GJ.GpuCartesianProductExec(e.condition, ch[0], ch[1]),
    _pair_condition_of,
)


_rule(
    CpuWindowExec,
    "WindowExec",
    lambda e, ch: GW.GpuWindowExec(e.window_cols, ch[0]),
    lambda e: [we for _, we in e.window_cols]
    + list(e.spec.partition_by)
    + [o.child for o in e.spec.order_by],
    check=_no_complex_keys(
        lambda e: list(e.spec.partition_by) + [o.child for o in e.spec.order_by],
        "window key",
    ),
)
_rule(C.CpuRangeExec, "RangeExec", lambda e, ch: G.GpuRangeExec(e), lambda e: [])
_rule(
    C.CpuGenerateExec,
    "GenerateExec",
    lambda e, ch: G.GpuGenerateExec(e, ch[0]),
    lambda e: [e.generator],
)


# ── the override pass ──────────────────────────────────────────────────────


def _fused_filters(island: List[Exec]) -> set:
    """ids of the island's filters that the operator above folds in as a
    liveness mask when it runs (the aggregate's ``_fused_child``, the hash
    and range exchange's ``pre_filter``): such a filter never runs, and is
    never measured, on its own."""
    out = set()
    for n in island:
        if isinstance(n, G.GpuHashAggregateExec):
            if n._fused_child()[1] is not None:
                out.add(id(n.children[0]))
        elif isinstance(n, G.GpuShuffleExchangeExec):
            c = n.children[0]
            if (isinstance(c, G.GpuFilterExec) and n._kind() in ("hash", "range")
                    and G.fusable_filter(c.condition)):
                out.add(id(c))
    return out



@dataclasses.dataclass
class ExplainEntry:
    node: str
    on_device: bool
    reasons: List[str]


class GpuOverrides:
    """GpuOverrides + GpuTransitionOverrides, applied to a CPU physical plan
    (the port's ``TpuOverrides``).

    ``breaker`` (resilience/breaker.py) is the session's CPU-fallback
    circuit breaker: op signatures whose device operators failed repeatedly
    at RUNTIME are planned on the CPU engine at the next planning pass, with
    the breaker's reason in the explain output — the same surface a
    plan-time fallback uses (the JAX package's ``overrides.py:1205-1211``)."""

    def __init__(self, conf: TpuConf, breaker=None):
        self.conf = conf
        self.breaker = breaker
        self.explain: List[ExplainEntry] = []
        # stages formed by the fusion pass that follows (set by the session)
        self.fused_stages = 0
        # exchanges shared by the reuse pass that follows (set by the session)
        self.reused_exchanges = 0
        # cost-model source: the hardcoded per-op weights, or — when
        # spark.rapids.tpu.cbo.measuredWeights holds and the persisted
        # calibration table (obs/calibration.py) has measured device
        # costs — measured ns/row normalized into the same integer-weight
        # currency. With the conf off or the table absent/empty this is
        # EXACTLY the hardcoded dict: planning stays bit-identical.
        self._cbo_weights = self._CBO_WEIGHTS
        self._cbo_source = "default"
        if cfg.CBO_MEASURED_WEIGHTS.get(conf):
            from ..obs.calibration import load_weights

            measured = load_weights(cfg.CBO_CALIBRATION_FILE.get(conf))
            if measured:
                self._cbo_weights = measured
                self._cbo_source = "measured"
        # calibrated engine routing: with measured per-op ns/row present,
        # predict each device island's device-vs-host time and route
        # sub-threshold islands (tiny input, full dispatch+transfer tax —
        # the q6/q15 shape) back to the CPU engine. No calibration data or
        # conf off: planning is unchanged.
        self._routing_cal = None
        if cfg.ROUTING_ENABLED.get(conf):
            from ..obs import calibration as obs_cal

            cal = obs_cal.get(cfg.CBO_CALIBRATION_FILE.get(conf))
            if cal.snapshot():
                self._routing_cal = cal

    def apply(self, plan: Exec) -> Exec:
        if not self.conf.is_enabled(cfg.SQL_ENABLED):
            return plan
        converted = self._convert(plan)
        if self.conf.is_enabled(cfg.CBO_ENABLED):
            converted = self._cost_optimize(converted)
        if self._routing_cal is not None:
            converted = self._route(converted)
        if converted.is_device:
            # the query root funnels to the host anyway (collect); merging
            # partitions on the device first is the JAX package's plan shape
            converted = G.GpuCoalescePartitionsExec(converted)
        out = self._insert_transitions(converted, want_device=False)
        self._maybe_log()
        return out

    # conversion walk (meta.tagForGpu + convertIfNeeded)
    def _convert(self, plan: Exec) -> Exec:
        children = [self._convert(c) for c in plan.children]
        rule = _EXEC_RULES.get(type(plan))
        reasons: List[str] = []
        if rule is None:
            reasons.append(_HOST_BY_DESIGN.get(
                type(plan).__name__,
                f"exec {type(plan).__name__} has no device implementation"))
            self.explain.append(ExplainEntry(plan.node_string(), False, reasons))
            return plan.with_new_children(children)
        breaker_reason = (
            self.breaker.check(rule.name) if self.breaker is not None else None
        )
        if not self.conf.rule_enabled(rule.conf_key):
            reasons.append(f"disabled by {rule.conf_key}")
        elif breaker_reason:
            reasons.append(breaker_reason)
        else:
            _check_schema(plan.output, self.conf, reasons, rule.name)
            if rule.check is not None:
                why = rule.check(plan, self.conf)
                if why:
                    reasons.append(why)
            for e in rule.exprs_of(plan):
                _check_expr_tree(e, self.conf, reasons)
            if not isinstance(plan, (C.CpuProjectExec, C.CpuFilterExec)):
                # the ANSI error channel is read by the device project and
                # filter only; an error site anywhere else (a grouping key,
                # an aggregate input, a sort key, a join condition) keeps
                # its exec on the CPU engine, whose eval raises inline
                if any(G.has_error_site(e) for e in rule.exprs_of(plan)):
                    reasons.append(
                        "ANSI-mode cast or arithmetic outside project/filter "
                        "runs on CPU (device error channel not wired here)"
                    )
        if reasons:
            self.explain.append(ExplainEntry(plan.node_string(), False, reasons))
            return plan.with_new_children(children)
        self.explain.append(ExplainEntry(plan.node_string(), True, []))
        converted = rule.convert(plan, children)
        converted._cpu_original = plan  # CBO un-conversion seam
        return converted

    # cost-based un-conversion (CostBasedOptimizer.scala:29-310) ───────────
    # DefaultCostModel stand-in: per-node compute weights; a contiguous
    # device island pays two transitions, so islands whose total weight is
    # below the threshold go back to the CPU engine (the JAX package's
    # TpuOverrides._cost_optimize, with the port's operator names).
    _CBO_WEIGHTS = {
        "GpuProjectExec": 1,
        "GpuFilterExec": 1,
        "GpuLimitExec": 1,
        "GpuCoalescePartitionsExec": 0,
    }
    _CBO_TRANSITION_COST = 3

    def _island_weight(self, plan: Exec) -> int:
        """Total weight of the contiguous device region rooted here (host
        children are the island's boundaries). Weights come from the
        active cost table: hardcoded, or measured (calibration) when the
        conf selected it — unknown ops default heavy either way."""
        w = self._cbo_weights.get(type(plan).__name__, 10)
        for c in plan.children:
            if c.is_device:
                w += self._island_weight(c)
        return w

    def _unconvert_island(
        self,
        plan: Exec,
        weight: Optional[int] = None,
        reason: Optional[str] = None,
        again: Optional[Callable] = None,
    ) -> Exec:
        """Put a device island back on the CPU engine via each node's
        ``_cpu_original`` seam. ``reason`` is the explain message (default:
        the CBO island-weight wording, with the weights that decided only
        at the root where ``weight`` is passed); ``again`` is the pass to
        resume on the island's host children (default: CBO cost analysis —
        the routing pass hands itself in)."""
        if again is None:
            again = self._cost_optimize
        if not plan.is_device:
            return again(plan)
        kids = [self._unconvert_island(c, reason=reason, again=again) for c in plan.children]
        orig = getattr(plan, "_cpu_original", None)
        if orig is None:
            return plan.with_new_children(kids)
        if reason is None:
            detail = (
                f" ({self._cbo_source} weights: island {weight} < "
                f"transition cost {self._CBO_TRANSITION_COST})"
                if weight is not None
                else ""
            )
            reason = f"cost-based optimizer: island too small to pay transitions{detail}"
        self.explain.append(ExplainEntry(orig.node_string(), False, [reason]))
        return orig.with_new_children(kids)

    def _keep_island(self, plan: Exec, again: Optional[Callable] = None) -> Exec:
        """Inside a kept island: never re-evaluate interior sub-islands (the
        transition boundary wouldn't move, only device work would be lost);
        resume cost analysis below the island's host boundaries."""
        if again is None:
            again = self._cost_optimize
        kids = [
            self._keep_island(c, again) if c.is_device else again(c)
            for c in plan.children
        ]
        return plan.with_new_children(kids)

    def _cost_optimize(self, plan: Exec) -> Exec:
        if plan.is_device:
            w = self._island_weight(plan)
            if w < self._CBO_TRANSITION_COST:
                return self._unconvert_island(plan, w)
            return self._keep_island(plan)
        return plan.with_new_children([self._cost_optimize(c) for c in plan.children])

    # calibrated engine routing ────────────────────────────────────────────
    # The CBO above reasons in unitless weights; this pass reasons in
    # nanoseconds. With a measured cost table (obs/calibration.py) it
    # predicts each device island's wall time on both engines — per-op
    # ns/row times the island's estimated input rows, plus the fixed
    # per-launch and transfer overheads of the routing confs — and sends the
    # island to whichever engine is predicted faster. The q6/q15 shape (one
    # tiny filter+agg over a small scan) loses more to dispatch and
    # transfer than the device saves in compute. The JAX package's
    # ``TpuOverrides._route``/``_route_verdict`` (``:1100-1190``), with the
    # port's operator names.

    #: plumbing nodes with no per-row ns of their own — they ride along
    #: with whatever engine the island lands on
    _ROUTING_FREE = frozenset({"GpuCoalescePartitionsExec", "GpuCoalesceBatchesExec"})

    def _route(self, plan: Exec) -> Exec:
        if plan.is_device:
            reason = self._route_verdict(plan)
            if reason is not None:
                return self._unconvert_island(plan, reason=reason, again=self._route)
            return self._keep_island(plan, again=self._route)
        return plan.with_new_children([self._route(c) for c in plan.children])

    def _route_verdict(self, plan: Exec) -> Optional[str]:
        """Predicted-time comparison for the island rooted at ``plan``.
        Returns the explain reason when the HOST engine is predicted
        faster (island should be unconverted), None to stay on device.
        Conservative by construction: any node either engine has no
        measurement for, or an island with no estimable input rows, stays
        on device — routing only ever acts on numbers it actually has. A
        filter its parent folds in costs its host ns/row and no device time
        or launch of its own (the JAX package looks for a device measurement
        it never gets, and so keeps every such island, q6's among them, on
        the device)."""
        from ..sched.estimate import _leaf_bytes_rows
        from ..sched.estimate import _walk as _est_walk

        cal = self._routing_cal
        island: List[Exec] = []
        boundary_rows = 0

        def collect(n: Exec) -> None:
            island.append(n)
            for c in n.children:
                if c.is_device:
                    collect(c)

        collect(plan)
        fused = _fused_filters(island)
        # input rows: what the host boundaries feed the island
        for n in island:
            lb = _leaf_bytes_rows(n)
            if lb is not None:
                boundary_rows += lb[1]
            for c in n.children:
                if not c.is_device:
                    boundary_rows += sum(
                        r
                        for leaf in _est_walk(c)
                        for (_b, r) in [_leaf_bytes_rows(leaf) or (0, 0)]
                    )
        if boundary_rows <= 0:
            return None
        device_ns = 0.0
        host_ns = 0.0
        launches = 0
        op_detail = []
        for n in island:
            dev_name = type(n).__name__
            if dev_name in self._ROUTING_FREE:
                continue
            orig = getattr(n, "_cpu_original", None)
            if orig is None:
                return None  # no CPU form to route to
            cpu_name = type(orig).__name__
            h = cal.ns_per_row(cpu_name, device=False)
            if id(n) in fused:
                # folded into the operator above as its liveness mask: it
                # never runs (nor is measured) on its own, and its device
                # time is inside that operator's
                if h is None:
                    return None
                host_ns += h * boundary_rows
                op_detail.append(f"{dev_name} fused vs {cpu_name} {h:g}ns/row")
                continue
            d = cal.ns_per_row(dev_name, device=True)
            if d is None or h is None:
                return None  # unmeasured op: keep on device
            device_ns += d * boundary_rows
            host_ns += h * boundary_rows
            launches += 1
            op_detail.append(f"{dev_name} {d:g}ns/row vs {cpu_name} {h:g}ns/row")
        if not launches:
            return None
        device_ns += (
            launches * cfg.ROUTING_LAUNCH_OVERHEAD_NS.get(self.conf)
            + cfg.ROUTING_TRANSFER_OVERHEAD_NS.get(self.conf)
        )
        if device_ns <= host_ns:
            return None
        return (
            "calibrated routing: predicted device "
            f"{device_ns / 1e6:.3f}ms > host {host_ns / 1e6:.3f}ms "
            f"for ~{boundary_rows} rows over {launches} launches "
            f"({'; '.join(op_detail)})"
        )

    # transition insertion (GpuTransitionOverrides)
    def _insert_transitions(self, plan: Exec, want_device: bool,
                            under_input_file: bool = False) -> Exec:
        # input_file_name()/_block_*() read per-batch task state, so the
        # scan→expression path must keep per-file batches: the coalesce
        # disable propagates DOWN from the expression-bearing node and
        # resets at exchanges (batches above a shuffle are mixed-file
        # already — Spark reports "" there), as in the JAX package
        # (GpuTransitionOverrides' input-file handling, :84-170)
        local = _node_has_input_file_expr(plan)
        is_exchange = isinstance(plan, (G.GpuShuffleExchangeExec, C.CpuShuffleExchangeExec))
        child_flag = False if is_exchange else (under_input_file or local)
        new_children = [
            self._insert_transitions(c, want_device=plan.is_device, under_input_file=child_flag)
            for c in plan.children
        ]
        plan = plan.with_new_children(new_children)
        if plan.is_device and not want_device:
            return G.DeviceToHostExec(plan)
        if not plan.is_device and want_device:
            h2d = G.HostToDeviceExec(plan)
            if under_input_file or local:
                return h2d
            # post-transition coalesce (GpuTransitionOverrides:84-91 +
            # GpuCoalesceBatches)
            return G.GpuCoalesceBatchesExec(
                h2d,
                G.CoalesceGoal(cfg.BATCH_SIZE_BYTES.get(self.conf)),
            )
        return plan

    def _maybe_log(self):
        mode = cfg.EXPLAIN.get(self.conf).upper()
        if mode == "NONE":
            return
        import sys

        for e in self.explain:
            if e.on_device and mode != "ALL":
                continue
            marker = "will run on device" if e.on_device else "cannot run on device"
            print(f"! {e.node}: {marker}", file=sys.stderr)
            for r in e.reasons:
                print(f"    because {r}", file=sys.stderr)

    def fallback_execs(self) -> List[str]:
        return [e.node for e in self.explain if not e.on_device]


#: host execs that are off the device by design, with their explain reason
_HOST_BY_DESIGN = {
    "CpuFileScanExec": "file scans decode on the host (there is no device Parquet or CSV "
                       "decode); their batches reach the device through HostToDevice",
    "CpuWriteFilesExec": "file writes encode on the host side of DeviceToHost (there is no "
                         "device Parquet or CSV encode)",
}


def _node_has_input_file_expr(node: Exec) -> bool:
    """Whether THIS node's own expressions read the input-file task state
    (input_file_name / input_file_block_start / input_file_block_length) —
    the GpuTransitionOverrides condition that disables batch coalescing so
    file boundaries survive to the expression."""
    targets = (msc.InputFileName, msc.InputFileBlockStart, msc.InputFileBlockLength)

    def expr_has(e) -> bool:
        if isinstance(e, targets):
            return True
        try:
            kids = e.children()
        except Exception:
            return False
        return any(expr_has(c) for c in kids)

    def scan_value(v) -> bool:
        if isinstance(v, Expression):
            return expr_has(v)
        if isinstance(v, (list, tuple)):
            return any(scan_value(x) for x in v)
        return False

    return any(scan_value(v) for k, v in vars(node).items() if k != "_children")
