"""Checks shared by ``chip_smoke.py`` and the port's tests: the case grid
that holds the ``match_starts`` kernel against its plain version, and the
row comparison of ``tests/harness.py`` (floats within rel 1e-9 / abs 1e-11,
everything else exact), with ``tests/test_tpcds.py``'s slack on rounded
columns for TPC-DS (``tpcds_check``)."""
from __future__ import annotations

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
    last-digit step from the CPU engine's). Returns ``(ok, message)``."""
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


def tpcds_check(text: str, df, ref_rows, got_rows) -> tuple:
    """``rows_equal`` with the slack ``tests/test_tpcds.py`` gives a
    query text: 0.011 on the columns ``output_round_columns`` finds in
    ``df``'s plan when the text holds ``round(``, else none."""
    from .plan.logical import output_round_columns

    slack = 0.011 if "round(" in text.lower() else 0.0
    cols = None
    if slack:
        try:
            cols = output_round_columns(df._plan)
        except Exception:
            cols = None  # unknown shape: the slack stays plan-wide
    return rows_equal(ref_rows, got_rows, cols, slack)
