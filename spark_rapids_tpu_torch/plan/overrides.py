"""Plan-rewrite layer: replace CPU execs with device execs where supported.

Reference: GpuOverrides.scala (rule registries + apply pipeline :2998-3098),
RapidsMeta.scala (tagging with ``willNotWorkOnGpu`` reason bookkeeping),
GpuTransitionOverrides.scala (transition insertion).

The port's own table, after ``spark_rapids_tpu/plan/overrides.py``: the same
tagging walk, kill-switch conf keys (``spark.rapids.sql.exec.<Name>`` /
``spark.rapids.sql.expression.<Name>``), explain reasons and transition
pass, but its rules cover only what the port runs on the device so far —
project, filter, grouped and ungrouped aggregation, sort, top-N, expand,
the coalesce, the shuffle exchange, union, limit, the shuffled and
broadcast hash joins, the broadcast exchange, the nested-loop and cartesian
joins and the window, over the expressions of the 22 TPC-H and 96 TPC-DS
queries (``InSet`` for a resolved IN-subquery, ``Like``, ``Substring``,
``StartsWith``/``EndsWith``, rounding, interval date arithmetic, the
stddev family and the window functions among them), ``contains`` and
``hash``. Each added expression rule copies its check and reason from
``spark_rapids_tpu/plan/overrides.py``. Every other node stays on the CPU
engine with its reason in the explain, which is the system's own per-node
fallback. (The JAX table binds ``exec.tpu`` directly, so it cannot be
shared.)
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
from ..expr import datetime as dtx
from ..expr import math as mx
from ..expr import windows as W
from ..expr import misc as msc
from ..expr import predicates as pred
from ..expr import strings as st
from ..expr import subquery as sq
from ..expr.base import Alias, BoundReference, Literal
from ..expr.cast import Cast
from ..types import (
    BooleanType,
    ByteType,
    DateType,
    DecimalType,
    DoubleType,
    FloatType,
    IntegerType,
    LongType,
    Schema,
    ShortType,
    StringType,
    TimestampType,
)
from .physical import Exec

# ── expression rules ───────────────────────────────────────────────────────

_INTEGRAL = (ByteType, ShortType, IntegerType, LongType)
_FLOATING = (FloatType, DoubleType)
_NUMERIC = _INTEGRAL + _FLOATING


class ExprRule:
    def __init__(self, cls, name: str, check: Optional[Callable] = None):
        self.cls = cls
        self.name = name
        self.conf_key = f"spark.rapids.sql.expression.{name}"
        self.check = check  # (expr, conf) -> Optional[str] (reason if bad)


def _float_agg_check(e, conf: TpuConf) -> Optional[str]:
    """variableFloatAgg gate (reference RapidsConf.scala): float sums/avgs
    are evaluation-order dependent; when disabled they stay on CPU so the
    row-order result is Spark's."""
    if isinstance(e.child.data_type, _FLOATING) and not conf.is_enabled(
        cfg.VARIABLE_FLOAT_AGG
    ):
        return (
            "float/double sum/avg varies with evaluation order; disabled by "
            f"{cfg.VARIABLE_FLOAT_AGG.key}"
        )
    if not isinstance(e.child.data_type, _NUMERIC):
        return (
            f"{type(e).__name__} over {e.child.data_type.simple_string} is not "
            "in the torch port yet"
        )
    return None


def _cast_check(e: Cast, conf: TpuConf) -> Optional[str]:
    frm, to = e.c.data_type, e.to
    if e.ansi:
        return "ANSI-mode cast runs on CPU (device error channel not in the torch port yet)"
    # numeric → integral truncates toward zero and saturates (Java's
    # double → long), as the JAX package's ``_float_to_int``
    ok = isinstance(to, _FLOATING) and isinstance(frm, _NUMERIC) or (
        isinstance(to, _INTEGRAL) and isinstance(frm, _NUMERIC)
    )
    if not ok:
        return f"cast {frm} -> {to} is not supported on device in the torch port yet"
    return None


def _minmax_check(e, conf: TpuConf) -> Optional[str]:
    if not isinstance(
        e.child.data_type, _NUMERIC + (DateType, TimestampType, BooleanType, StringType)
    ):
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


def _no_decimal_arith(e, conf: TpuConf) -> Optional[str]:
    if isinstance(e.data_type, DecimalType):
        return f"decimal {type(e).__name__} is not in the torch port yet"
    return None


def _integral_only(e, conf: TpuConf) -> Optional[str]:
    if not isinstance(e.data_type, _INTEGRAL):
        return f"{type(e).__name__} over {e.data_type.simple_string} is not in the torch port yet"
    return None


_EXPR_RULES: dict = {}


def _expr(cls, name=None, check=None):
    _EXPR_RULES[cls] = ExprRule(cls, name or cls.__name__, check)


for _cls in (
    BoundReference,
    Literal,
    Alias,
    pred.EqualTo,
    pred.LessThan,
    pred.LessThanOrEqual,
    pred.GreaterThan,
    pred.GreaterThanOrEqual,
    pred.And,
    pred.Or,
    pred.Not,
    pred.IsNull,
    pred.IsNotNull,
    pred.In,
    sq.InSet,
    dtx.Year,
    agg.Count,
    agg.First,
    agg.Last,
):
    _expr(_cls)
for _cls in (ar.Add, ar.Subtract, ar.Multiply, ar.Divide):
    _expr(_cls, check=_no_decimal_arith)
_expr(ar.Remainder, check=_integral_only)
_expr(cond.CaseWhen)
_expr(cond.If)
_expr(cond.Coalesce)
_expr(agg.Sum, check=_float_agg_check)
_expr(agg.Average, check=_float_agg_check)
_expr(agg.Min, check=_minmax_check)
_expr(agg.Max, check=_minmax_check)
_expr(Cast, check=_cast_check)
_expr(st.Contains, check=_lit_check("pattern", "contains pattern"))
_expr(st.Substring)
_expr(st.StartsWith, check=_lit_check("pattern", "startswith pattern"))
_expr(st.EndsWith, check=_lit_check("pattern", "endswith pattern"))
_expr(st.Like, check=_like_check)
_expr(msc.Murmur3Hash)
for _cls in (ar.UnaryMinus, ar.Abs):
    _expr(_cls, check=_no_decimal_arith)
_expr(st.Upper)
_expr(st.Concat)
for _cls in (agg.StddevSamp, agg.StddevPop, agg.VarianceSamp, agg.VariancePop):
    _expr(_cls)


def _interval_check(e, conf: TpuConf) -> Optional[str]:
    """Literal-interval gate, the reference's GpuDateAddInterval restriction
    (GpuOverrides.scala:1348,1369)."""
    from ..types import CalendarIntervalType

    itv = e.interval
    if not (isinstance(itv, Literal) and isinstance(itv.data_type, CalendarIntervalType)):
        return "interval operand must be a literal CalendarInterval for the device path"
    if itv.value[2] != 0:
        return "date + interval with a sub-day component is an error in Spark"
    return None


_expr(dtx.DateAddInterval, check=_interval_check)


def _round_check(e, conf: TpuConf) -> Optional[str]:
    if not isinstance(e.scale, Literal):
        return "round scale must be a literal for the device path"
    if not isinstance(e.child.data_type, _INTEGRAL) and not cfg.INCOMPATIBLE_OPS.get(conf):
        # the reference gates float round the same way: "may round slightly
        # differently" under isIncompatEnabled (GpuOverrides.scala:2036-2077)
        return (
            "round on floating point may round slightly differently than "
            "Spark's java BigDecimal semantics; enable "
            "spark.rapids.sql.incompatibleOps.enabled"
        )
    if isinstance(e.child.data_type, DecimalType):
        return "decimal round is not in the torch port yet"
    return None


_expr(mx.Round, check=_round_check)
_expr(mx.BRound, check=_round_check)


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
            if not isinstance(ot, _NUMERIC + (DecimalType, DateType, TimestampType)):
                return f"numeric RANGE frame over {ot.simple_string} is CPU-only"
        return None
    return f"window function {type(fn).__name__} has no device implementation"


_expr(W.WindowExpression, check=_window_check)
for _cls in (W.RowNumber, W.Rank, W.DenseRank, W.Lead, W.Lag, W.PercentRank, W.CumeDist, W.NTile):
    _expr(_cls)


def _check_expr_tree(e: Expression, conf: TpuConf, reasons: List[str]) -> bool:
    ok = True
    rule = _EXPR_RULES.get(type(e))
    if rule is None:
        reasons.append(f"expression {type(e).__name__} has no device implementation")
        ok = False
    elif not conf.rule_enabled(rule.conf_key):
        reasons.append(f"expression {rule.name} disabled by {rule.conf_key}")
        ok = False
    elif rule.check is not None:
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
        if not isinstance(
            dt, _NUMERIC + (BooleanType, StringType, DateType, TimestampType, DecimalType)
        ):
            reasons.append(
                f"{where}: {dt.simple_string} columns are not in the torch port yet"
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


def _conv_agg(e: C.CpuHashAggregateExec, ch):
    g = G.GpuHashAggregateExec(
        e.mode, e.grouping, e.agg_fns, e.result_exprs, e.result_names, ch[0]
    )
    g._schema = e.output
    return g


def _no_collect(e: C.CpuHashAggregateExec, conf: TpuConf) -> Optional[str]:
    if any(isinstance(f, (agg.CollectList, agg.MergeLists)) for f in e.agg_fns):
        return (
            "the collect family (collect_list, collect_set) is not in the torch "
            "port yet"
        )
    return None


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
    check=_no_collect,
)
_rule(
    C.CpuSortExec,
    "SortExec",
    lambda e, ch: G.GpuSortExec(e.order, ch[0]),
    lambda e: [o.child for o in e.order],
)
_rule(
    C.CpuCoalescePartitionsExec,
    "CoalescePartitionsExec",
    lambda e, ch: G.GpuCoalescePartitionsExec(ch[0]),
    lambda e: [],
)


def _exchange_check(e: C.CpuShuffleExchangeExec, conf: TpuConf) -> Optional[str]:
    """The port's exchange is the JAX package's in-process path only."""
    for key in (cfg.ADAPTIVE_ENABLED, cfg.SHUFFLE_MANAGER_ENABLED):
        if key.get(conf):
            return (
                f"{key.key} is set: the device exchange has no adaptive "
                "coalescing or shuffle manager in the torch port yet"
            )
    return None


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


_rule(
    CJ.CpuShuffledHashJoinExec,
    "ShuffledHashJoinExec",
    _conv_join(GJ.GpuShuffledHashJoinExec),
    _join_exprs_of,
)
_rule(
    CJ.CpuBroadcastHashJoinExec,
    "BroadcastHashJoinExec",
    _conv_join(GJ.GpuBroadcastHashJoinExec),
    _join_exprs_of,
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


def _window_keys_check(e: CpuWindowExec, conf: TpuConf) -> Optional[str]:
    """Complex types cannot be window keys on the device (no radix-word
    encoding), as in the JAX package's ``_no_complex_keys``."""
    from ..types import is_complex

    for k in list(e.spec.partition_by) + [o.child for o in e.spec.order_by]:
        if is_complex(k.data_type):
            return f"window key of type {k.data_type.simple_string} is not supported on device"
    return None


_rule(
    CpuWindowExec,
    "WindowExec",
    lambda e, ch: GW.GpuWindowExec(e.window_cols, ch[0]),
    lambda e: [we for _, we in e.window_cols]
    + list(e.spec.partition_by)
    + [o.child for o in e.spec.order_by],
    check=_window_keys_check,
)


# ── the override pass ──────────────────────────────────────────────────────


@dataclasses.dataclass
class ExplainEntry:
    node: str
    on_device: bool
    reasons: List[str]


class GpuOverrides:
    """GpuOverrides + GpuTransitionOverrides, applied to a CPU physical plan
    (the port's ``TpuOverrides``)."""

    def __init__(self, conf: TpuConf):
        self.conf = conf
        self.explain: List[ExplainEntry] = []

    def apply(self, plan: Exec) -> Exec:
        if not self.conf.is_enabled(cfg.SQL_ENABLED):
            return plan
        converted = self._convert(plan)
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
            reasons.append(f"exec {type(plan).__name__} has no device implementation")
            self.explain.append(ExplainEntry(plan.node_string(), False, reasons))
            return plan.with_new_children(children)
        if not self.conf.rule_enabled(rule.conf_key):
            reasons.append(f"disabled by {rule.conf_key}")
        else:
            _check_schema(plan.output, self.conf, reasons, rule.name)
            if rule.check is not None:
                why = rule.check(plan, self.conf)
                if why:
                    reasons.append(why)
            for e in rule.exprs_of(plan):
                _check_expr_tree(e, self.conf, reasons)
        if reasons:
            self.explain.append(ExplainEntry(plan.node_string(), False, reasons))
            return plan.with_new_children(children)
        self.explain.append(ExplainEntry(plan.node_string(), True, []))
        return rule.convert(plan, children)

    # transition insertion (GpuTransitionOverrides)
    def _insert_transitions(self, plan: Exec, want_device: bool) -> Exec:
        new_children = [
            self._insert_transitions(c, want_device=plan.is_device)
            for c in plan.children
        ]
        plan = plan.with_new_children(new_children)
        if plan.is_device and not want_device:
            return G.DeviceToHostExec(plan)
        if not plan.is_device and want_device:
            # post-transition coalesce (GpuTransitionOverrides:84-91 +
            # GpuCoalesceBatches)
            return G.GpuCoalesceBatchesExec(
                G.HostToDeviceExec(plan),
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
