"""Segmented-scan primitives shared by the aggregate kernels.

The port of ``spark_rapids_tpu/ops/scan.py``. Torch has no
``lax.associative_scan`` with a custom combine, so a segmented scan here is
a log-step (Hillis–Steele) scan: ⌈log2 n⌉ passes of the shifted
``(flag, value)`` combine. Its combine order is fixed by the shape alone,
so a float result is the same bits from run to run (no atomics); it differs
from XLA's tree order only in rounding. Integer sums take ``cumsum`` minus
the running total before the segment's start, which is exact in wrapping
int64 and costs one pass. ``first_k_positions`` is a cumsum and a write to
unique positions: no sort, and no host sync.
"""
from __future__ import annotations

import torch

_OPS = {"add": torch.add, "min": torch.minimum, "max": torch.maximum}


def seg_start_index(starts: torch.Tensor) -> torch.Tensor:
    """int64[n]: the index of the row that starts each row's segment (0 for
    rows before the first start): the segment's ordinal from a cumsum, then
    a gather from the start rows' positions. (``torch.cummax`` gives it in
    one call, but on an H100 it ran far slower than these cumsums.)"""
    seg = torch.cumsum(starts, dim=0, dtype=torch.int64) - 1
    at = first_k_positions(starts)[seg.clamp(min=0)]
    return torch.where(seg >= 0, at, 0)


def logstep_scan(state: tuple, combine) -> tuple:
    """Inclusive log-step scan of the tuple of equal-length tensors
    ``state`` under ``combine(left, right) -> tuple`` (associative). Pass
    ``d`` combines row ``i - d`` into row ``i``."""
    n = state[0].shape[0]
    d = 1
    while d < n:
        left = tuple(s[:-d] for s in state)
        right = tuple(s[d:] for s in state)
        out = combine(left, right)
        state = tuple(torch.cat([s[:d], o]) for s, o in zip(state, out))
        d <<= 1
    return state


def segscan(vals: torch.Tensor, starts: torch.Tensor, op: str) -> torch.Tensor:
    """Inclusive segmented scan: ``op`` ("add", "min" or "max") accumulated
    left to right, resetting at rows where ``starts`` is True."""
    if op == "add" and not vals.dtype.is_floating_point:
        c = torch.cumsum(vals.to(torch.int64), dim=0)
        s = seg_start_index(starts)
        # the running total just before each segment's start row
        before = c[s] - vals[s].to(torch.int64)
        return (c - before).to(vals.dtype)
    fn = _OPS[op]

    def comb(a, b):
        af, av = a
        bf, bv = b
        return af | bf, torch.where(bf, bv, fn(av, bv))

    return logstep_scan((starts, vals), comb)[1]


def seg_end_flags(starts: torch.Tensor) -> torch.Tensor:
    """Row i ends its segment iff row i+1 starts one (last row always ends)."""
    return torch.cat([starts[1:], torch.ones(1, dtype=torch.bool, device=starts.device)])


def first_k_positions(flags: torch.Tensor) -> torch.Tensor:
    """Positions of True flags, in order, compacted to the front, then the
    positions of the False flags in order (int64) — what the JAX package's
    stable sort of the negated mask yields. Position k of the result is the
    row index of the k-th flagged row."""
    n = flags.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=flags.device)
    on = torch.cumsum(flags, dim=0, dtype=torch.int64)
    off = (idx + 1) - on
    dest = torch.where(flags, on - 1, on[-1] + off - 1)
    out = torch.empty(n, dtype=torch.int64, device=flags.device)
    out[dest] = idx
    return out
