"""Checks shared by ``chip_smoke.py`` and ``tests/test_torch_gpu.py``: the
case grid that holds the ``match_starts`` kernel against its plain version,
and the row comparison of ``tests/harness.py`` (floats within rel 1e-9 /
abs 1e-11, everything else exact)."""
from __future__ import annotations

import math

import numpy as np
import torch

from .ops import strings_kernels as SK

#: pattern lengths of the grid; ``W`` stands for the plane's width
GRID_LENGTHS = (1, 7, 17, "W")


def ragged_plane(W: int, n: int, seed: int):
    """u8[n, W] of 'a'/'b' bytes and i32[n] lengths in [0, W]; the first
    ``W + 1`` rows take every length once. The bytes past each row's length
    are 'a'/'b' too, not zeros, so a kernel that tests the fit against W
    instead of the row's length gives a different mask."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, W + 1, n).astype(np.int32)
    lens[: W + 1] = np.arange(W + 1)[:n]
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


def match_starts_cases(W: int, n: int, seed: int):
    """Yield ``(L, data, lens, pat, straddles)`` for each pattern length of
    the grid. The pattern is the first ``L`` bytes of a row that holds at
    least ``L``, so it occurs at least once; ``L == W`` gives a pattern
    that only full rows can hold."""
    base, lens = ragged_plane(W, n, seed)
    for L in GRID_LENGTHS:
        L = W if L == "W" else L
        if L > W:
            continue
        data = base.copy()
        src = int(np.argmax(lens >= L))
        pat = bytes(data[src, :L])
        straddles = plant_straddles(data, lens, pat, src)
        yield L, data, lens, pat, straddles


def check_match_starts(W: int, n: int, seed: int) -> int:
    """The CUDA kernel against ``match_starts_plain`` on the card, required
    bit-identical, over :func:`match_starts_cases`. Raises AssertionError on
    the first case that differs; returns the number of cases."""
    cases = 0
    for L, data, lens, pat, straddles in match_starts_cases(W, n, seed):
        d, ln = torch.from_numpy(data).cuda(), torch.from_numpy(lens).cuda()
        before = SK.LAUNCHES
        got = SK.match_starts(d, ln, pat)
        torch.cuda.synchronize()
        if SK.LAUNCHES != before + 1:
            raise AssertionError(f"match_starts launched no kernel: n={n} W={W} L={L}")
        plain = SK.match_starts_plain(d, ln, pat)
        if not torch.equal(got, plain):
            bad = int((got != plain).sum())
            raise AssertionError(
                f"match_starts differs from plain at {bad} positions: n={n} W={W} L={L} "
                f"({straddles} rows with the pattern across the row end)"
            )
        cases += 1
    return cases


def rows_equal(a, b) -> tuple:
    """Rows equal as multisets; floats within rel 1e-9 / abs 1e-11. Returns
    ``(ok, message)``."""

    def key(row):
        return tuple((v is None, type(v).__name__, repr(v)) for v in row)

    a, b = sorted(a, key=key), sorted(b, key=key)
    if len(a) != len(b):
        return False, f"{len(a)} vs {len(b)} rows"
    for i, (ra, rb) in enumerate(zip(a, b)):
        if len(ra) != len(rb):
            return False, f"row {i}: {ra} vs {rb}"
        for x, y in zip(ra, rb):
            if isinstance(x, float) and isinstance(y, float):
                same = x == y or (math.isnan(x) and math.isnan(y)) or math.isclose(
                    x, y, rel_tol=1e-9, abs_tol=1e-11
                )
            else:
                same = x == y
            if not same:
                return False, f"row {i}: {ra} vs {rb}"
    return True, ""
