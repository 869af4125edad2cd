"""Python UDF → expression-tree translation (the udf-compiler analogue).

Reference: udf-compiler translates JVM bytecode of simple lambdas into
Catalyst expressions so they run on device as ordinary expression kernels
(Instruction.scala:1-953, CatalystExpressionBuilder.scala:1-430). The
python equivalent works on the AST: ``inspect.getsource`` → ``ast`` →
this engine's Expression classes. Coverage mirrors the reference's core
patterns — arithmetic, comparisons, boolean logic, conditionals, a math
whitelist, and simple string methods — and anything outside the subset
returns None so the UDF keeps its row-at-a-time CPU fallback (same
contract as the reference: translate-or-fallback, never translate-wrong).

The session applies translation at plan time (``TpuSession`` rewrite pass)
under ``spark.rapids.sql.udfCompiler.enabled``, so a translated
``lambda r: r * 2 + 1`` shows up as a ``*``-prefixed device projection in
explain, exactly like any hand-written expression.

Copied from ``spark_rapids_tpu/expr/udf_compiler.py``.
"""
from __future__ import annotations

import ast
import inspect
import math
import textwrap
from typing import Optional, Sequence

from ..types import BOOLEAN, DOUBLE, LONG, STRING, DataType
from .base import Expression, Literal, to_expr


class _Untranslatable(Exception):
    pass


#: a local variable defined on only one branch of an ``if`` — readable on
#: no path-independent basis, so any later read aborts translation
_POISON = object()


def _fn_ast(fn) -> Optional[ast.AST]:
    """The Lambda or FunctionDef node of ``fn``, or None."""
    try:
        src = textwrap.dedent(inspect.getsource(fn))
    except (OSError, TypeError):
        return None
    try:
        tree = ast.parse(src)
    except SyntaxError:
        # a lambda inside a larger expression (e.g. udf(lambda x: ...))
        # can dedent into invalid syntax; try to find the lambda text
        idx = src.find("lambda")
        if idx < 0:
            return None
        for end in range(len(src), idx, -1):
            try:
                tree = ast.parse(src[idx:end], mode="eval")
                break
            except SyntaxError:
                continue
        else:
            return None
    lambdas = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Lambda):
            lambdas.append(node)
        if isinstance(node, ast.FunctionDef) and node.name == getattr(
            fn, "__name__", None
        ):
            return node
    # disambiguate multiple lambdas sharing one source line by parameter
    # names; still ambiguous → None (translate-or-fallback, never guess)
    want = fn.__code__.co_varnames[: fn.__code__.co_argcount]
    matches = [
        n for n in lambdas if tuple(a.arg for a in n.args.args) == tuple(want)
    ]
    if len(matches) == 1:
        return matches[0]
    return None


def _closure_value(fn, name: str):
    """Resolve a free variable to a python constant (closure or global)."""
    code = fn.__code__
    if fn.__closure__ and name in code.co_freevars:
        cell = fn.__closure__[code.co_freevars.index(name)]
        return cell.cell_contents
    if name in fn.__globals__:
        return fn.__globals__[name]
    raise _Untranslatable(name)


def try_translate(
    fn, args: Sequence[Expression], return_type: DataType
) -> Optional[Expression]:
    """Translate ``fn(*args)`` into an Expression tree, or None when the
    function falls outside the supported subset."""
    node = _fn_ast(fn)
    if node is None:
        return None
    params = [a.arg for a in node.args.args]
    if len(params) != len(args) or node.args.vararg or node.args.kwarg:
        return None
    env = dict(zip(params, args))
    try:
        if isinstance(node, ast.Lambda):
            out = _tx(node.body, env, fn)
        else:
            # multi-statement bodies: local assignments and if/elif/else
            # control flow translate through the block walker — the AST
            # analogue of the reference's bytecode CFG → Catalyst
            # translation (CFG.scala + CatalystExpressionBuilder.scala)
            kind, out = _tx_block(list(node.body), env, fn)
            if kind != "value":
                return None  # fell off the end without a return
    except _Untranslatable:
        return None
    from .cast import Cast

    try:
        needs_cast = out.data_type != return_type
    except TypeError:
        needs_cast = True  # unresolved args: cast to the declared type
    if needs_cast:
        out = Cast(out, return_type)
    return out


def _tx_block(stmts, env: dict, fn):
    """Translate a statement list. Returns ('value', expr) when every path
    through the block returns, or ('env', new_env) when control falls off
    the end with updated local bindings. Branches merge SSA-style: a
    variable assigned under an ``if`` becomes ``If(cond, then_val,
    else_val)`` in the continuation — the same φ-node construction the
    reference's CFG walk performs on JVM bytecode."""
    from .conditional import If

    i = 0
    while i < len(stmts):
        s = stmts[i]
        if isinstance(s, ast.Expr) and isinstance(s.value, ast.Constant):
            i += 1  # docstring
            continue
        if isinstance(s, ast.Return):
            if s.value is None:
                raise _Untranslatable("bare return")
            return "value", _tx(s.value, env, fn)
        if isinstance(s, ast.Assign):
            if len(s.targets) != 1 or not isinstance(s.targets[0], ast.Name):
                raise _Untranslatable("assignment target")
            env = {**env, s.targets[0].id: _tx(s.value, env, fn)}
            i += 1
            continue
        if isinstance(s, ast.AugAssign):
            if not isinstance(s.target, ast.Name):
                raise _Untranslatable("augassign target")
            synth = ast.BinOp(
                left=ast.Name(id=s.target.id, ctx=ast.Load()),
                op=s.op,
                right=s.value,
            )
            env = {**env, s.target.id: _tx(synth, env, fn)}
            i += 1
            continue
        if isinstance(s, ast.If):
            cond = _tx(s.test, env, fn)
            rest = stmts[i + 1 :]
            t_kind, t_out = _tx_block(list(s.body), dict(env), fn)
            e_kind, e_out = (
                _tx_block(list(s.orelse), dict(env), fn)
                if s.orelse
                else ("env", dict(env))
            )
            if t_kind == "value" and e_kind == "value":
                return "value", If(cond, t_out, e_out)
            if t_kind == "value":
                k2, v2 = _tx_block(rest, e_out, fn)
                if k2 != "value":
                    raise _Untranslatable("missing return on else path")
                return "value", If(cond, t_out, v2)
            if e_kind == "value":
                k2, v2 = _tx_block(rest, t_out, fn)
                if k2 != "value":
                    raise _Untranslatable("missing return on then path")
                return "value", If(cond, v2, e_out)
            # both fall through: φ-merge every binding that changed. A name
            # defined on ONE path only is POISONED — a later read must not
            # fall through to a same-named global (never translate-wrong);
            # t_out/e_out are supersets of env, so a missing side really
            # means branch-only definition.
            merged = dict(env)
            for name in set(t_out) | set(e_out):
                tv = t_out.get(name)
                ev = e_out.get(name)
                if tv is None or ev is None or tv is _POISON or ev is _POISON:
                    # a nested if can leave _POISON on one side; embedding
                    # the sentinel in If(cond, _POISON, expr) would crash at
                    # plan time instead of falling back to the python UDF
                    merged[name] = _POISON
                    continue
                merged[name] = tv if tv is ev else If(cond, tv, ev)
            env = merged
            i += 1
            continue
        raise _Untranslatable(type(s).__name__)
    return "env", env


_MATH_CALLS = {
    "sqrt": "Sqrt",
    "log": "Log",
    "exp": "Exp",
    "sin": "Sin",
    "cos": "Cos",
    "tan": "Tan",
    "floor": "Floor",
    "ceil": "Ceil",
}

_STR_METHODS = {"upper": "Upper", "lower": "Lower"}


def _tx(node: ast.AST, env: dict, fn) -> Expression:
    from . import arithmetic as ar
    from . import math as mx
    from . import predicates as pred
    from . import strings as st
    from .conditional import If

    if isinstance(node, ast.Name):
        if node.id in env:
            if env[node.id] is _POISON:
                raise _Untranslatable(
                    f"{node.id} is defined on only one branch"
                )
            return env[node.id]
        return to_expr(_const(_closure_value(fn, node.id)))
    if isinstance(node, ast.Constant):
        return to_expr(_const(node.value))
    if isinstance(node, ast.BinOp):
        l, r = _tx(node.left, env, fn), _tx(node.right, env, fn)
        table = {
            ast.Add: ar.Add,
            ast.Sub: ar.Subtract,
            ast.Mult: ar.Multiply,
        }
        cls = table.get(type(node.op))
        if cls is not None:
            # string + string is concat, not arithmetic (types are only
            # known for literals here — args are unresolved until binding;
            # an actual string column through Add fails loudly at binding)
            if isinstance(node.op, ast.Add) and (
                _known_string(l) or _known_string(r)
            ):
                return st.Concat((l, r))
            return cls(l, r)
        if isinstance(node.op, ast.Mod):
            # python % has sign-of-divisor semantics == Spark's pmod, NOT
            # the % operator's java remainder
            return ar.Pmod(l, r)
        if isinstance(node.op, ast.Div):
            from .cast import Cast

            return ar.Divide(Cast(l, DOUBLE), Cast(r, DOUBLE))
        if isinstance(node.op, ast.FloorDiv):
            # python floors; Spark's div truncates toward zero — subtract 1
            # when the truncated quotient has a nonzero remainder and the
            # signs differ
            q = ar.IntegralDivide(l, r)
            signs_differ = pred.Not(
                pred.EqualTo(
                    pred.LessThan(l, to_expr(0)), pred.LessThan(r, to_expr(0))
                )
            )
            inexact = pred.Not(pred.EqualTo(ar.Remainder(l, r), to_expr(0)))
            return If(
                pred.And(inexact, signs_differ),
                ar.Subtract(q, to_expr(1)),
                q,
            )
        if isinstance(node.op, ast.Pow):
            return mx.Pow(l, r)
        raise _Untranslatable(ast.dump(node.op))
    if isinstance(node, ast.UnaryOp):
        v = _tx(node.operand, env, fn)
        if isinstance(node.op, ast.USub):
            return ar.UnaryMinus(v)
        if isinstance(node.op, ast.Not):
            return pred.Not(v)
        raise _Untranslatable(ast.dump(node.op))
    if isinstance(node, ast.Compare):
        if len(node.ops) != 1:
            # chained a < b < c → AND of pairs
            left = node.left
            parts = []
            for op, comp in zip(node.ops, node.comparators):
                parts.append(
                    _tx(ast.Compare(left, [op], [comp]), env, fn)
                )
                left = comp
            out = parts[0]
            for p in parts[1:]:
                out = pred.And(out, p)
            return out
        l = _tx(node.left, env, fn)
        if isinstance(node.ops[0], (ast.In, ast.NotIn)):
            comp = node.comparators[0]
            if not isinstance(comp, (ast.Tuple, ast.List, ast.Set)):
                raise _Untranslatable("in over non-literal collection")
            vals = tuple(_tx(e, env, fn) for e in comp.elts)
            out = pred.In(l, vals)
            return pred.Not(out) if isinstance(node.ops[0], ast.NotIn) else out
        r = _tx(node.comparators[0], env, fn)
        table = {
            ast.Lt: pred.LessThan,
            ast.LtE: pred.LessThanOrEqual,
            ast.Gt: pred.GreaterThan,
            ast.GtE: pred.GreaterThanOrEqual,
            ast.Eq: pred.EqualTo,
            ast.NotEq: lambda a, b: pred.Not(pred.EqualTo(a, b)),
        }
        cls = table.get(type(node.ops[0]))
        if cls is None:
            raise _Untranslatable(ast.dump(node.ops[0]))
        return cls(l, r)
    if isinstance(node, ast.BoolOp):
        from functools import reduce

        parts = [_tx(v, env, fn) for v in node.values]
        op = pred.And if isinstance(node.op, ast.And) else pred.Or
        return reduce(op, parts)
    if isinstance(node, ast.IfExp):
        return If(
            _tx(node.test, env, fn),
            _tx(node.body, env, fn),
            _tx(node.orelse, env, fn),
        )
    if isinstance(node, ast.Call):
        return _tx_call(node, env, fn)
    raise _Untranslatable(type(node).__name__)


def _tx_call(node: ast.Call, env: dict, fn) -> Expression:
    from . import math as mx
    from . import nullexprs as nx
    from . import strings as st

    if node.keywords:
        raise _Untranslatable("kwargs")
    args = [_tx(a, env, fn) for a in node.args]
    # str methods: x.upper() / x.lower() / x.strip()
    if isinstance(node.func, ast.Attribute):
        base = node.func.value
        name = node.func.attr
        # math.sqrt(x) etc.
        if (
            isinstance(base, ast.Name)
            and base.id not in env
            and _is_math_module(fn, base.id)
        ):
            cls = _MATH_CALLS.get(name)
            if cls is None:
                raise _Untranslatable(f"math.{name}")
            return getattr(mx, cls)(*args)
        obj = _tx(base, env, fn)
        if name in _STR_METHODS and not args:
            return getattr(st, _STR_METHODS[name])(obj)
        if name == "strip" and not args:
            return st.StringTrim(obj)
        if name == "lstrip" and not args:
            return st.StringTrimLeft(obj)
        if name == "rstrip" and not args:
            return st.StringTrimRight(obj)
        if name in ("startswith", "endswith") and len(args) == 1:
            cls = st.StartsWith if name == "startswith" else st.EndsWith
            return cls(obj, args[0])
        if name == "replace" and len(args) == 2:
            return st.StringReplace(obj, args[0], args[1])
        raise _Untranslatable(f".{name}()")
    if not isinstance(node.func, ast.Name):
        raise _Untranslatable("call target")
    name = node.func.id
    if name == "abs" and len(args) == 1:
        from .arithmetic import Abs

        return Abs(args[0])
    if name == "len" and len(args) == 1:
        return st.Length(args[0])
    if name in ("min", "max") and len(args) >= 2:
        cls = nx.Least if name == "min" else nx.Greatest
        return cls(tuple(args))
    if name in ("int", "float") and len(args) == 1:
        from .cast import Cast

        # python int() truncates toward zero — Spark's fractional→integral
        # cast does the same. str()/bool() are NOT mapped: Spark's cast
        # formats floats/booleans differently from python ('1.0E20' vs
        # '1e+20', 'true' vs 'True') and bool('false') is python-True —
        # silent wrong results, so those fall back.
        return Cast(args[0], LONG if name == "int" else DOUBLE)
    raise _Untranslatable(name)


def _is_math_module(fn, name: str) -> bool:
    try:
        return _closure_value(fn, name) is math
    except _Untranslatable:
        return False


def _known_string(e: Expression) -> bool:
    from ..types import StringType

    try:
        return isinstance(e.data_type, StringType)
    except Exception:
        return False


def _const(v):
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    raise _Untranslatable(f"constant {type(v).__name__}")
