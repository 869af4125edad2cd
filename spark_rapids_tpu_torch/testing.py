"""Checks shared by ``chip_smoke.py`` and the port's tests: the case grid
that holds the ``match_starts`` kernel against its plain version, and the
row comparison of ``tests/harness.py`` (floats within rel 1e-9 / abs 1e-11,
everything else exact), with ``tests/test_tpcds.py``'s slack on rounded
columns for TPC-DS (``tpcds_check``)."""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .ops import strings_kernels as SK

#: pattern lengths of the grid, on both sides of the kernel's 4-byte screen
#: and of its 16-byte run of outputs; ``W`` stands for the plane's width
GRID_LENGTHS = (1, 3, 4, 5, 15, 16, 17, 31, 33, "W")

#: (W, row counts) of the grid. W = 8 (the narrowest plane the device
#: layout makes) and W = 130 take the kernel's byte path, the others its
#: 16-byte path; at W = 2048 a row tile holds two rows. 4099 rows
#: leave the last row tile of every width part-filled. One row count for
#: W = 2048 keeps the plain version's [n, S, L] intermediate under 0.3 GB.
GRID = (
    (8, (4099, 65536)),
    (16, (4099, 65536)),
    (64, (4099, 65536)),
    (128, (4099, 65536)),
    (130, (4099, 65536)),
    (256, (4099, 65536)),
    (2048, (4099,)),
)

#: rows wider than the kernel's 4096-byte tile, which split over column
#: tiles: checked on the card beside :data:`GRID`
SPLIT_GRID = ((8192, (257,)), (8200, (257,)))


def grid_lengths(W: int, lengths=GRID_LENGTHS) -> list:
    """The pattern lengths of ``lengths`` that fit in a plane of width ``W``,
    each once."""
    return list(dict.fromkeys(W if L == "W" else L for L in lengths if L == "W" or L <= W))


def ragged_plane(W: int, n: int, seed: int):
    """u8[n, W] of 'a'/'b' bytes and i32[n] lengths in [0, W]. The first
    ``W + 1`` rows take every length once; where ``n <= W`` the first rows
    take lengths spread evenly over [0, W], ``W - 1`` and ``W`` among them.
    The bytes past each row's length are 'a'/'b' too, not zeros, so a
    kernel that tests the fit against W instead of the row's length gives a
    different mask."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, W + 1, n).astype(np.int32)
    if n > W:
        lens[: W + 1] = np.arange(W + 1)
    elif n >= 2:
        lens[:n] = np.linspace(0, W, n).astype(np.int32)
        lens[n - 2] = W - 1
    data = rng.choice(np.frombuffer(b"ab", np.uint8), size=(n, W))
    return data, lens


def plant_straddles(data: np.ndarray, lens: np.ndarray, pat: bytes, skip_row: int) -> int:
    """Write ``pat`` so that its last byte lies one past the row's length,
    in every third row where that fits in the plane: the bytes then hold the
    pattern, but it must not match. Returns the number of rows planted."""
    n, W = data.shape
    L = len(pat)
    start = lens.astype(np.int64) - L + 1
    rows = np.flatnonzero((start >= 0) & (start + L <= W) & (np.arange(n) != skip_row))[::3]
    p = np.frombuffer(pat, np.uint8)
    for t in range(L):
        data[rows, start[rows] + t] = p[t]
    return int(rows.size)


def match_starts_cases(W: int, n: int, seed: int, lengths=GRID_LENGTHS):
    """Yield ``(L, data, lens, pat, straddles)`` for each pattern length of
    ``lengths`` (the grid's by default). The pattern is the first ``L``
    bytes of a row that holds at least ``L``, so it occurs at least once;
    ``L == W`` gives a pattern that only full rows can hold."""
    base, lens = ragged_plane(W, n, seed)
    for L in grid_lengths(W, lengths):
        data = base.copy()
        src = int(np.argmax(lens >= L))
        pat = bytes(data[src, :L])
        straddles = plant_straddles(data, lens, pat, src)
        yield L, data, lens, pat, straddles


def at_storage_offset(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A copy of the 2-D tensor ``t`` that starts ``offset`` elements into its
    storage: ``offset = W`` is ``plane[1:]`` of a plane with one more row,
    ``offset = 1`` a base off every 16-byte boundary."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def _check_one(d: torch.Tensor, ln: torch.Tensor, pat: bytes, what: str) -> None:
    w = d.shape[1]
    before, before_total = dict(SK.LAUNCHES_BY_PATH), SK.LAUNCHES
    got = SK.match_starts(d, ln, pat)
    torch.cuda.synchronize()
    want = SK.kernel_path(w, d.data_ptr(), got.data_ptr())
    ran = {k: SK.LAUNCHES_BY_PATH[k] - before[k] for k in before}
    if ran != {k: int(k == want) for k in before} or SK.LAUNCHES != before_total + 1:
        raise AssertionError(f"match_starts launched {ran}, not one {want} launch: {what}")
    plain = SK.match_starts_plain(d, ln, pat)
    if not torch.equal(got, plain):
        bad = int((got != plain).sum())
        raise AssertionError(f"match_starts differs from plain at {bad} positions: {what}")


def check_match_starts(W: int, n: int, seed: int) -> int:
    """The CUDA kernel against ``match_starts_plain`` on the card, required
    bit-identical, over :func:`match_starts_cases`, and for one pattern
    length also on the plane at storage offsets ``W`` (``plane[1:]``) and
    ``1``. Each launch must take the path :func:`SK.kernel_path` names.
    Raises AssertionError on the first case that differs; returns the
    number of launches checked."""
    cases = 0
    for L, data, lens, pat, straddles in match_starts_cases(W, n, seed):
        d, ln = torch.from_numpy(data).cuda(), torch.from_numpy(lens).cuda()
        what = f"n={n} W={W} L={L} ({straddles} rows with the pattern across the row end)"
        _check_one(d, ln, pat, what)
        cases += 1
        if L == min(17, W):
            for offset in (W, 1):
                _check_one(at_storage_offset(d, offset), ln, pat, f"{what}, storage offset {offset}")
                cases += 1
    return cases


def _canon(v):
    if isinstance(v, float):
        if math.isnan(v):
            return "nan"
        if v == 0.0:
            return 0.0  # align -0.0 and 0.0 in the sort key only
    return v


def _sorted_rows(rows) -> list:
    """Rows in the total order of ``tests/harness.py::_normalize``."""
    return sorted(
        rows, key=lambda row: tuple((v is None, type(v).__name__, repr(_canon(v))) for v in row)
    )


def _value_equal(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return a == b or math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-11)
    return a == b


def rows_equal(ref, got, round_cols=None, round_slack: float = 0.0) -> tuple:
    """Rows equal as multisets (sorted in ``tests/harness.py``'s order),
    floats within rel 1e-9 / abs 1e-11, everything else exact; with
    ``round_slack``, floats of the columns a ``round()`` reaches
    (``round_cols``; None: every column) may also differ by that much
    absolute (``tests/test_tpcds.py`` gives 0.011 to a query text holding
    ``round(``: the device round under incompatibleOps may land one
    last-digit step from the CPU engine's). Returns ``(ok, message)``.
    Lists equal as they stand (a sorted result, an order-keeping filter)
    are equal without the sort, which costs seconds a million rows."""
    if len(ref) == len(got) and ref == got:
        return True, ""
    ref, got = _sorted_rows(ref), _sorted_rows(got)
    if len(ref) != len(got):
        return False, f"{len(ref)} vs {len(got)} rows"
    for i, (ra, rb) in enumerate(zip(ref, got)):
        if len(ra) != len(rb):
            return False, f"row {i}: {ra} vs {rb}"
        for j, (x, y) in enumerate(zip(ra, rb)):
            slack = round_slack if (round_cols is None or j in round_cols) else 0.0
            ok = _value_equal(x, y) or (
                slack > 0
                and isinstance(x, float)
                and isinstance(y, float)
                and abs(x - y) <= slack
            )
            if not ok:
                return False, f"row {i} col {j}: {x!r} vs {y!r}"
    return True, ""


def tpcds_slack(text: str, df) -> tuple:
    """The slack ``tests/test_tpcds.py`` gives a query text, as ``(columns,
    slack)``: 0.011 on the columns ``output_round_columns`` finds in
    ``df``'s plan when the text holds ``round(``, else none."""
    from .plan.logical import output_round_columns

    slack = 0.011 if "round(" in text.lower() else 0.0
    cols = None
    if slack:
        try:
            cols = output_round_columns(df._plan)
        except Exception:
            cols = None  # unknown shape: the slack stays plan-wide
    return cols, slack


def tpcds_check(text: str, df, ref_rows, got_rows) -> tuple:
    """``rows_equal`` with the slack of :func:`tpcds_slack`."""
    return rows_equal(ref_rows, got_rows, *tpcds_slack(text, df))


# ── the golden corpus (tests/golden/*.json) without pyarrow ─────────────────
#
# ``tests/test_golden.py`` and ``tests/test_golden_queries.py`` hold both JAX
# engines to literal fixtures derived from Spark's published semantics. The
# cases below are the same queries, described without pyarrow: each names
# its input columns (name, type, values), the expression it selects (built
# from a ``functions`` module, so the JAX package's module builds the same
# tree in the tests) and the expected values. ``golden_batch`` makes the
# input a ``HostBatch`` with numpy; ``run_golden_case`` runs one case on a
# session and ``golden_values_equal`` compares as ``tests/test_golden.py``
# does.

#: the conf of ``tests/test_golden.py``'s device session, in test mode: the
#: gated float <-> string casts on, so their device code is held to the
#: fixtures too
GOLDEN_CONF = {
    "spark.rapids.sql.enabled": True,
    "spark.rapids.sql.test.enabled": True,
    "spark.sql.shuffle.partitions": 8,
    "spark.rapids.sql.castFloatToString.enabled": "true",
    "spark.rapids.sql.castStringToFloat.enabled": "true",
}

#: the conf of ``tests/test_golden_queries.py``'s device session, in test mode
GOLDEN_QUERY_CONF = {
    "spark.rapids.sql.enabled": True,
    "spark.rapids.sql.test.enabled": True,
    "spark.sql.shuffle.partitions": 2,
}

_ROUND_REASON = (
    "round on floating point may round slightly differently than Spark's java "
    "BigDecimal semantics; enable spark.rapids.sql.incompatibleOps.enabled"
)

#: the fixtures the JAX package's device engine keeps off the device under
#: :data:`GOLDEN_CONF`, each with its reason: the float rounds (the
#: ``incompatibleOps`` gate), the pads whose pad string is not one byte,
#: the ``translate`` with non-ASCII arguments. ``tests/test_torch_golden.py``
#: holds this list equal to the JAX package's explain.
GOLDEN_OFF_DEVICE = {
    **{f"round_double#{i}": _ROUND_REASON for i in range(10)},
    **{f"bround_double#{i}": _ROUND_REASON for i in range(7)},
    **{f"{op}#{i}": "device pad requires a single-byte pad string"
       for op in ("lpad", "rpad") for i in (1, 4, 5, 8, 9)},
    "translate#3": "translate on device requires ASCII literal from/to arguments",
}


@dataclasses.dataclass
class GoldenCase:
    """One query of the golden corpus: ``select(build(mods, col(...)))``
    over ``columns`` (a list of ``(name, type, values)``; types are the
    fixtures' names: int, long, double, float, boolean, string, date (days),
    timestamp (micros), decimal (``Decimal`` values, precision and scale
    inferred as Arrow infers them)). ``fixtures`` counts the fixtures it
    covers; ``out`` converts a result value (``"days"``: date → days since
    the epoch)."""

    file: str
    op: str
    label: str
    columns: list
    build: object
    expected: list
    fixtures: int = 1
    out: str = ""


def decimal_type_of(values):
    """The ``DecimalType`` Arrow infers for python ``Decimal`` values: the
    largest scale, and room for the most integral digits beside it."""
    from .types import DecimalType

    shapes = [v.as_tuple() for v in values if v is not None]
    scale = max((max(0, -t.exponent) for t in shapes), default=0)
    ints = max((len(t.digits) + t.exponent for t in shapes), default=1)
    return DecimalType(max(1, max(ints, 0) + scale), scale)


def _golden_type(typ: str, values):
    from . import types as T

    if typ == "decimal":
        return decimal_type_of(values)
    return {
        "int": T.INT, "long": T.LONG, "double": T.DOUBLE, "float": T.FLOAT,
        "boolean": T.BOOLEAN, "string": T.STRING, "date": T.DATE, "timestamp": T.TIMESTAMP,
    }[typ]


def golden_batch(columns) -> "HostBatch":
    """``HostBatch`` of ``(name, type, values)`` columns, built with numpy."""
    from .columnar.host import HostBatch, HostColumn, string_column
    from .types import DecimalType, Schema, StringType, StructField

    fields, cols = [], []
    for name, typ, values in columns:
        dt = _golden_type(typ, values)
        fields.append(StructField(name, dt))
        if isinstance(dt, StringType):
            cols.append(string_column(list(values), dt))
            continue
        valid = np.array([v is not None for v in values], dtype=bool)
        if isinstance(dt, DecimalType):
            raw = [0 if v is None else int(v.scaleb(dt.scale)) for v in values]
        else:
            raw = [0 if v is None else v for v in values]
        cols.append(HostColumn(dt, np.array(raw, dtype=dt.np_dtype), valid))
    return HostBatch(Schema(fields), cols, len(columns[0][2]) if columns else 0)


def _decode(v, typ):
    """JSON sentinels by the value's type: 'NaN' is a float sentinel but a
    good string input."""
    if typ in ("double", "float"):
        if v == "NaN":
            return float("nan")
        if v == "Infinity":
            return float("inf")
        if v == "-Infinity":
            return float("-inf")
    if typ in ("date", "timestamp") and v is not None:
        return int(v)
    return v


def _load_golden(golden_dir: str, name: str):
    import json
    import os

    with open(os.path.join(golden_dir, name)) as f:
        return json.load(f)


def golden_cases(golden_dir: str) -> list:
    """Every expression fixture of the corpus, as :class:`GoldenCase`
    queries shaped as
    ``tests/test_golden.py`` runs them: one query per group where the
    fixtures share their expression, one per fixture where they do not."""
    from decimal import Decimal

    out: list = []

    def add(file, op, label, columns, build, expected, out_kind=""):
        out.append(GoldenCase(file, op, label, columns, build, expected,
                              len(expected), out_kind))

    # murmur3
    f = "golden_murmur3.json"
    data = _load_golden(golden_dir, f)
    by_type: dict = {}
    for c in data:
        if c["op"] == "hash":
            by_type.setdefault(c["type"], []).append(c)
    for typ, cs in by_type.items():
        add(f, "hash", f"hash({typ})", [("c", typ, [_decode(c["input"], typ) for c in cs])],
            lambda m, c: m.F.hash(c), [c["expected"] for c in cs])
    for i, c in enumerate(x for x in data if x["op"] == "hash2"):
        add(f, "hash2", f"hash2#{i}",
            [("a", c["types"][0], [c["inputs"][0]]), ("b", c["types"][1], [c["inputs"][1]])],
            lambda m, c: m.F.hash(m.F.col("a"), m.F.col("b")), [c["expected"]])

    # casts, one query per (from, to)
    f = "golden_cast.json"
    groups: dict = {}
    for c in _load_golden(golden_dir, f):
        groups.setdefault((c["from"], c["to"]), []).append(c)
    for (src, dst), cs in groups.items():
        add(f, "cast", f"cast {src}->{dst}", [("c", src, [_decode(c["input"], src) for c in cs])],
            lambda m, c, dst=dst: c.cast(_golden_type_of(m, dst)),
            [_decode(c["expected"], dst) for c in cs], "days" if dst == "date" else "")

    # dates and times
    f = "golden_datetime.json"
    data = _load_golden(golden_dir, f)
    unary = {
        "year": lambda m, c: m.F.year(c), "month": lambda m, c: m.F.month(c),
        "dayofmonth": lambda m, c: m.F.dayofmonth(c), "dayofyear": lambda m, c: m.F.dayofyear(c),
        "quarter": lambda m, c: m.F.quarter(c), "dayofweek": lambda m, c: m.F.dayofweek(c),
        "weekday": lambda m, c: m.F.weekday(c), "weekofyear": lambda m, c: m.F.weekofyear(c),
        "last_day": lambda m, c: m.F.last_day(c).cast(m.T.DATE),
    }
    for op, build in unary.items():
        cs = [c for c in data if c["op"] == op]
        add(f, op, op, [("c", "date", [c["input"] for c in cs])], build,
            [c["expected"] for c in cs], "days" if op == "last_day" else "")
    for op in ("hour", "minute", "second"):
        cs = [c for c in data if c["op"] == op]
        add(f, op, op, [("c", "timestamp", [c["input"] for c in cs])],
            lambda m, c, op=op: getattr(m.F, op)(c), [c["expected"] for c in cs])
    per_case = {
        "add_months": ("date", lambda m, c, x: m.F.add_months(c, x["months"]), "days"),
        "date_format": ("timestamp", lambda m, c, x: m.F.date_format(c, x["fmt"]), ""),
        "to_unix_timestamp": ("string", lambda m, c, x: m.F.unix_timestamp(c, x["fmt"]), ""),
    }
    _per_case(add, f, data, per_case)

    # decimals and rounding
    f = "golden_decimal.json"
    data = _load_golden(golden_dir, f)
    per_case = {
        "round_double": ("double", lambda m, c, x: m.F.round(c, x["scale"]), ""),
        "bround_double": ("double", lambda m, c, x: m.F.bround(c, x["scale"]), ""),
        "round_int": ("int", lambda m, c, x: m.F.round(c, x["scale"]), ""),
    }
    _per_case(add, f, data, per_case)
    for op, sym in (("decimal_add", "+"), ("decimal_mul", "*")):
        for i, c in enumerate(x for x in data if x["op"] == op):
            add(f, op, f"{op}#{i}",
                [("a", "decimal", [Decimal(c["a"])]), ("b", "decimal", [Decimal(c["b"])])],
                (lambda m, _c: m.F.col("a") + m.F.col("b")) if sym == "+"
                else (lambda m, _c: m.F.col("a") * m.F.col("b")),
                [Decimal(c["expected"])])

    # strings
    f = "golden_strings.json"
    data = _load_golden(golden_dir, f)
    for op in ("length", "reverse", "ascii", "upper", "lower", "initcap", "trim", "ltrim",
               "rtrim"):
        cs = [c for c in data if c["op"] == op]
        add(f, op, op, [("c", "string", [c["input"] for c in cs])],
            lambda m, c, op=op: getattr(m.F, op)(c), [c["expected"] for c in cs])
    per_case = {
        "substring": ("string", lambda m, c, x: m.F.substring(c, x["pos"], x["len"]), ""),
        "locate": ("string", lambda m, c, x: m.F.locate(x["sub"], c, x["pos"]), ""),
        "lpad": ("string", lambda m, c, x: m.F.lpad(c, x["n"], x["pad"]), ""),
        "rpad": ("string", lambda m, c, x: m.F.rpad(c, x["n"], x["pad"]), ""),
        "substring_index": (
            "string", lambda m, c, x: m.F.substring_index(c, x["delim"], x["count"]), ""),
        "translate": ("string", lambda m, c, x: m.F.translate(c, x["frm"], x["to"]), ""),
        "replace": ("string", lambda m, c, x: m.F.replace(c, x["search"], x["repl"]), ""),
        "repeat": ("string", lambda m, c, x: m.F.repeat(c, x["n"]), ""),
        "startswith": ("string", lambda m, c, x: c.startswith(x["pre"]), ""),
        "endswith": ("string", lambda m, c, x: c.endswith(x["pre"]), ""),
        "contains": ("string", lambda m, c, x: c.contains(x["pre"]), ""),
        "like": ("string", lambda m, c, x: c.like(x["pat"]), ""),
        "split_at": (
            "string", lambda m, c, x: m.F.element_at(m.F.split(c, x["delim"]), x["idx"]), ""),
    }
    _per_case(add, f, data, per_case)
    for i, c in enumerate(x for x in data if x["op"] == "concat_ws"):
        cols = [(f"c{j}", "string", [v]) for j, v in enumerate(c["parts"])]
        add(f, "concat_ws", f"concat_ws#{i}", cols,
            lambda m, _c, x=c: m.F.concat_ws(
                x["sep"], *[m.F.col(f"c{j}") for j in range(len(x["parts"]))]),
            [c["expected"]])

    # datetime patterns
    f = "golden_datetime_fmt.json"
    per_case = {
        "date_format": ("timestamp", lambda m, c, x: m.F.date_format(c, x["fmt"]), ""),
        "to_unix_timestamp": ("string", lambda m, c, x: m.F.unix_timestamp(c, x["fmt"]), ""),
        "from_unixtime": ("long", lambda m, c, x: m.F.from_unixtime(c, x["fmt"]), ""),
        "to_date_fmt": ("string", lambda m, c, x: m.F.to_date(c, x["fmt"]), "days"),
    }
    _per_case(add, f, _load_golden(golden_dir, f), per_case, prefix="fmt.")

    # arithmetic
    f = "golden_arith.json"
    ops = {
        "add_int": ("int", lambda m, a, b: a + b),
        "mul_int": ("int", lambda m, a, b: a * b),
        "add_long": ("long", lambda m, a, b: a + b),
        "mul_long": ("long", lambda m, a, b: a * b),
        "div_int": ("int", lambda m, a, b: m.F.expr_col(m.ar.IntegralDivide(a.expr, b.expr))),
        "remainder_int": ("int", lambda m, a, b: a % b),
        "pmod_int": ("int", lambda m, a, b: m.F.pmod(a, b)),
    }
    counts: dict = {}
    for c in _load_golden(golden_dir, f):
        typ, mk = ops[c["op"]]
        i = counts[c["op"]] = counts.get(c["op"], -1) + 1
        add(f, c["op"], f"{c['op']}#{i}", [("a", typ, [c["a"]]), ("b", typ, [c["b"]])],
            lambda m, _c, mk=mk: mk(m, m.F.col("a"), m.F.col("b")), [c["expected"]])
    return out


def _golden_type_of(m, name: str):
    return {
        "int": m.T.INT, "long": m.T.LONG, "double": m.T.DOUBLE, "float": m.T.FLOAT,
        "boolean": m.T.BOOLEAN, "string": m.T.STRING, "date": m.T.DATE,
        "timestamp": m.T.TIMESTAMP, "byte": m.T.BYTE, "short": m.T.SHORT,
    }[name]


def _per_case(add, file, data, per_case, prefix=""):
    for op, (typ, build, out_kind) in per_case.items():
        for i, c in enumerate(x for x in data if x["op"] == op):
            add(file, op, f"{prefix}{op}#{i}", [("c", typ, [c["input"]])],
                lambda m, col_, b=build, x=c: b(m, col_, x), [c["expected"]], out_kind)


def golden_modules():
    """The port's ``functions``, ``types`` and ``expr.arithmetic`` modules,
    as :class:`GoldenCase` builders take them (``m.F``, ``m.T``, ``m.ar``)."""
    import types as _types

    from . import functions as F
    from . import types as T
    from .expr import arithmetic as ar

    return _types.SimpleNamespace(F=F, T=T, ar=ar)


def golden_dataframe(session, case: GoldenCase, mods=None):
    """The case's query on a port session (not yet collected)."""
    mods = mods or golden_modules()
    df = session.create_dataframe(golden_batch(case.columns))
    return df.select(case.build(mods, mods.F.col(case.columns[0][0])).alias("r"))


def golden_result(case: GoldenCase, values: list) -> list:
    """Result values as the fixtures write them."""
    if case.out == "days":
        import datetime as _dt

        epoch = _dt.date(1970, 1, 1)
        return [None if v is None else (v - epoch).days for v in values]
    return list(values)


def golden_values_equal(got: list, expected: list) -> tuple:
    """``tests/test_golden.py``'s check: floats equal or within rel 1e-13,
    NaN equal to NaN, everything else exact. Returns ``(ok, message)``."""
    if len(got) != len(expected):
        return False, f"{len(got)} rows, the fixture has {len(expected)}"
    for i, (g, e) in enumerate(zip(got, expected)):
        if isinstance(e, float) and isinstance(g, float):
            ok = math.isnan(g) if math.isnan(e) else (g == e or math.isclose(g, e, rel_tol=1e-13))
        else:
            ok = g == e
        if not ok:
            return False, f"row {i}: got {g!r}, want {e!r}"
    return True, ""


def run_golden_case(session, case: GoldenCase) -> tuple:
    """Run ``case`` on ``session``: ``(ok, message)`` against its fixtures."""
    from .columnar.host import to_pylist

    got = golden_dataframe(session, case).to_host()
    return golden_values_equal(golden_result(case, to_pylist(got.columns[0])), case.expected)


# ── golden_queries.json: whole queries from SQL text ────────────────────────


def golden_query_tables(fx: dict) -> dict:
    """name → ``HostBatch`` of a query fixture's tables."""
    out = {}
    for tname, t in fx["tables"].items():
        cols = list(zip(*t["rows"])) if t["rows"] else [[] for _ in t["schema"]]
        out[tname] = golden_batch(
            [(cname, ctype, list(vals)) for (cname, ctype), vals in zip(t["schema"], cols)]
        )
    return out


def _query_sortkey(row):
    def k(v):
        if isinstance(v, float):
            if math.isnan(v):
                return (2, "nan")
            return (1, f"{v:.6g}")
        return (0 if v is None else 1, repr(v))

    return tuple(k(v) for v in row)


def golden_query_equal(fx: dict, rows) -> tuple:
    """``tests/test_golden_queries.py``'s check: rows sorted unless the
    fixture is ordered, floats within rel 1e-9, everything else exact."""
    got = [list(r) for r in rows]
    exp = [list(r) for r in fx["expected"]]
    if not fx.get("ordered"):
        got.sort(key=_query_sortkey)
        exp.sort(key=_query_sortkey)
    if len(got) != len(exp):
        return False, f"{len(got)} rows, want {len(exp)}: {got} vs {exp}"
    for i, (g, e) in enumerate(zip(got, exp)):
        if len(g) != len(e):
            return False, f"row {i}: width {len(g)} vs {len(e)}"
        for j, (gv, ev) in enumerate(zip(g, e)):
            if isinstance(ev, float) and isinstance(gv, float):
                ok = gv == ev or (math.isfinite(ev) and abs(gv - ev) <= 1e-9 * max(abs(ev), 1.0))
            else:
                ok = gv == ev
            if not ok:
                return False, f"row {i} col {j}: {gv!r} want {ev!r}"
    return True, ""


def run_golden_query(session, fx: dict) -> tuple:
    """Register the fixture's tables as temp views on ``session``, run its SQL
    text, and compare: ``(ok, message)``."""
    for name, batch in golden_query_tables(fx).items():
        session.create_dataframe(batch).create_or_replace_temp_view(name)
    return golden_query_equal(fx, session.sql(fx["sql"]).collect())


# ── column by column: a device result held to the CPU engine's ──────────────


def columns_equal(ref, got) -> tuple:
    """Two ``HostBatch``es equal column by column, in row order: validity
    exact, the values of valid rows exact (strings byte for byte; arrays and
    maps by their lengths and elements, structs field by field), floats
    within the harness tolerance (rel 1e-9 / abs 1e-11, NaN equal to NaN).
    Returns ``(ok, message)``."""
    if ref.num_rows != got.num_rows:
        return False, f"{ref.num_rows} vs {got.num_rows} rows"
    for f, a, b in zip(ref.schema, ref.columns, got.columns):
        msg = _column_differs(f.name, f.data_type, a, b)
        if msg:
            return False, msg
    return True, ""


def _column_differs(name: str, dt, a, b) -> str:
    """Where two host columns of ``dt`` differ ('' when equal)."""
    from .types import ArrayType, DecimalType, FractionalType, MapType, StringType, StructType

    if not np.array_equal(a.validity, b.validity):
        i = int(np.flatnonzero(a.validity != b.validity)[0])
        return f"{name}: validity differs first at row {i}"
    v = a.validity
    if isinstance(dt, StructType):
        rows = np.flatnonzero(v)
        for f, ka, kb in zip(dt.fields, a.children, b.children):
            msg = _column_differs(f"{name}.{f.name}", f.data_type, ka.take(rows), kb.take(rows))
            if msg:
                return msg
        return ""
    if a.offsets is not None:
        la, lb = np.where(v, np.diff(a.offsets), 0), np.where(v, np.diff(b.offsets), 0)
        if not np.array_equal(la, lb):
            i = int(np.flatnonzero(la != lb)[0])
            return f"{name}: lengths differ first at row {i}"
        ka, kb = np.repeat(v, np.diff(a.offsets)), np.repeat(v, np.diff(b.offsets))
        if isinstance(dt, StringType):
            return "" if np.array_equal(a.data[ka], b.data[kb]) else f"{name}: string bytes differ"
        kid_types = (dt.key_type, dt.value_type) if isinstance(dt, MapType) else (dt.element_type,)
        parts = ("key", "value") if isinstance(dt, MapType) else ("element",)
        for part, kt, ca, cb in zip(parts, kid_types, a.children, b.children):
            msg = _column_differs(f"{name}.{part}", kt, ca.take(np.flatnonzero(ka)),
                                  cb.take(np.flatnonzero(kb)))
            if msg:
                return msg
        return ""
    x, y = a.data[v], b.data[v]
    if isinstance(dt, FractionalType) and not isinstance(dt, DecimalType):
        nan = np.isnan(x)
        ok = (nan == np.isnan(y)) & (
            nan | (x == y) | (np.abs(x - y) <= np.maximum(1e-9 * np.abs(x), 1e-11))
        )
    else:
        ok = x == y
    if not ok.all():
        i = int(np.flatnonzero(v)[np.flatnonzero(~ok)[0]])
        return f"{name}: row {i}: {a.data[i]!r} vs {b.data[i]!r}"
    return ""


# ── multi-process runs: the driver service and its executor processes ───────


def run_executors(argv_for_rank, size: int = 2, env=None, timeout_s: float = 600.0,
                  before_release=None):
    """Run ``size`` executor processes of one multi-process query against a
    ``shuffle/driver_service.py`` in this process. ``argv_for_rank(rank,
    driver)`` gives each process's command (``driver`` is the service's
    ``host:port``, for ``spark.rapids.shuffle.multiproc.driver``). Each
    process prints one line ``RESULT<json>`` on its standard output, then
    waits for its standard input to close: a peer may still be fetching
    its map output. ``before_release(procs, service)``, when given, runs
    once every result is in and before the processes are released; it
    returns the ranks it killed on purpose (their exit by SIGKILL is then
    no failure).

    Returns the parsed results by rank. Raises — naming the rank and the
    tail of its standard error — when a process produces no result within
    ``timeout_s`` or exits non-zero; every process is ended either way."""
    import json
    import subprocess
    import threading
    import time

    from .shuffle.driver_service import DriverService

    svc = DriverService()
    driver = f"{svc.address[0]}:{svc.address[1]}"
    procs = []
    results = [None] * size
    errs = [[] for _ in range(size)]

    def read_out(i, p):
        for ln in p.stdout:
            if ln.startswith("RESULT"):
                results[i] = json.loads(ln[len("RESULT"):])
                return

    def read_err(i, p):
        for ln in p.stderr:
            errs[i].append(ln)
            if len(errs[i]) > 400:
                del errs[i][:200]

    def tail(i) -> str:
        return "".join(errs[i])[-4000:]

    try:
        for rank in range(size):
            procs.append(subprocess.Popen(
                argv_for_rank(rank, driver), stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, env=env,
            ))
        readers = [threading.Thread(target=read_out, args=(i, p), daemon=True)
                   for i, p in enumerate(procs)]
        for i, p in enumerate(procs):
            threading.Thread(target=read_err, args=(i, p), daemon=True).start()
        for t in readers:
            t.start()
        deadline = time.monotonic() + timeout_s
        for t in readers:
            t.join(timeout=max(1.0, deadline - time.monotonic()))
        for i, p in enumerate(procs):
            if results[i] is None:
                raise RuntimeError(
                    f"executor rank {i} produced no result (exit {p.poll()}):\n{tail(i)}"
                )
        killed = set(before_release(procs, svc) or ()) if before_release is not None else set()
        for p in procs:
            try:
                p.stdin.close()
            except OSError:
                pass
        for i, p in enumerate(procs):
            try:
                p.wait(timeout=120)
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"executor rank {i} did not exit:\n{tail(i)}") from None
            if p.returncode != 0 and not (i in killed and p.returncode == -9):
                raise RuntimeError(f"executor rank {i} exited {p.returncode}:\n{tail(i)}")
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        svc.close()
