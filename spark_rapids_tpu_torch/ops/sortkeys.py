"""Order-preserving radix key encoding — the foundation of the device sort
and the sort-based group-by.

The port of ``spark_rapids_tpu/ops/sortkeys.py``. Every SQL value maps to
one or more radix words whose order equals Spark's sort order; a stable
LSD pass per word, least significant first, sorts the rows.

Orderings implemented to Spark's spec, as in the JAX package:

* NULLs first/last via a leading validity word
* floats: IEEE total-order bit trick with Spark's NaN semantics (all NaNs
  collapse to one greatest value) and -0.0 == 0.0 normalization
* strings: padded UTF-8 bytes packed big-endian 8-per-word, ties broken by
  length (exact lexicographic byte order, incl. interior NULs)
* descending via bitwise complement of the value words

**Word encoding.** The JAX package's words are uint64 compared unsigned.
Torch has no ``<`` or ``>>`` on uint64, so each word ``u`` is held here as
the int64 ``u ^ (1 << 63)``: signed order on those values is unsigned order
on ``u``, and complement commutes with the flip (``~(u ^ S) == (~u) ^ S``),
so descending is still ``~``. ``to_uint64`` undoes the flip.

The JAX package extracts float64 bits arithmetically on the TPU
(``ops/bits.py``); here they are ``view(torch.int64)`` after the same -0.0
and NaN canonicalisation.
"""
from __future__ import annotations

import numpy as np
import torch

from ..columnar.device import DeviceColumn
from ..types import BooleanType, DataType, DoubleType, FloatType, StringType

# the flipped encodings of the uint64 words 0 and 2**64 - 1
WORD_MIN = -(2**63)
WORD_MAX = 2**63 - 1


def to_uint64(word) -> np.ndarray:
    """A flipped int64 word (tensor or array) → the JAX package's uint64 word."""
    if isinstance(word, torch.Tensor):
        word = word.cpu().numpy()
    return (np.asarray(word, dtype=np.int64) ^ np.int64(WORD_MIN)).view(np.uint64)


def _float_bits_ordered(data: torch.Tensor, dt: DataType) -> torch.Tensor:
    """Map a float column to flipped int64 words preserving Spark order (NaN
    greatest, -0 == 0)."""
    if isinstance(dt, FloatType):
        x = data.to(torch.float32)
        x = torch.where(x == 0.0, 0.0, x)  # -0.0 -> +0.0
        x = torch.where(torch.isnan(x), float("nan"), x)  # canonical NaN
        b = x.view(torch.int32).to(torch.int64)
        # uint64 value in [0, 2**32): ~b for negatives, b | 2**31 otherwise
        return torch.where(b < 0, ~b, b | (1 << 31)) ^ WORD_MIN
    x = data.to(torch.float64)
    x = torch.where(x == 0.0, 0.0, x)
    x = torch.where(torch.isnan(x), float("nan"), x)
    b = x.view(torch.int64)
    # uint64: ~u for negatives, u | sign otherwise; flipped, the second is b
    return torch.where(b < 0, ~b ^ WORD_MIN, b)


def _string_words(data: torch.Tensor, lengths: torch.Tensor) -> list:
    """Big-endian packing of a ``uint8[cap, w]`` plane, 8 bytes a word, then
    the length word. Reversing each 8-byte group and viewing it as int64
    gives the uint64 word's bits on a little-endian device."""
    cap, w = data.shape
    nwords = (w + 7) // 8
    if nwords * 8 != w:
        data = torch.nn.functional.pad(data, (0, nwords * 8 - w))
    le = data.reshape(cap, nwords, 8).flip(-1).contiguous()
    packed = le.view(torch.int64).reshape(cap, nwords) ^ WORD_MIN
    words = [packed[:, k] for k in range(nwords)]
    words.append(lengths.to(torch.int64) ^ WORD_MIN)
    return words


def column_radix_words(
    col: DeviceColumn,
    ascending: bool = True,
    nulls_first: bool = True,
    value_only: bool = False,
) -> list:
    """Encode one column into flipped int64 words; signed lexicographic order
    over the word list == the requested Spark ordering.

    ``value_only`` omits the standalone validity word for callers that
    handle nulls themselves AND keeps the classic widened-to-64-bit
    encoding. Default (sort) callers get the packed layout for sub-64-bit
    types — validity folded into bit 63 of the single value word — so
    callers must never assume word[0] is a validity word."""
    dt = col.dtype
    valid = col.validity
    # validity word (uint64 1/0): order nulls relative to values
    one_if = valid if nulls_first else ~valid
    words: list = []
    if isinstance(dt, StringType):
        words = _string_words(col.data, col.lengths)
    elif not value_only and (
        isinstance(dt, BooleanType)
        or (getattr(dt, "np_dtype", None) is not None and dt.np_dtype.itemsize <= 4)
    ):
        # value encoding fits 32 bits: the validity bit goes into bit 63 of
        # the SAME word — one LSD pass instead of two
        if isinstance(dt, FloatType):
            enc = _float_bits_ordered(col.data, dt) ^ WORD_MIN
        elif isinstance(dt, BooleanType):
            enc = col.data.to(torch.int64)
        else:
            enc = col.data.to(torch.int64) + (1 << 31)
        enc = torch.where(valid, enc, 0)
        # uint64 bit 63 = validity word; flipped, it is set where that is 0
        packed = torch.where(one_if, enc, enc | WORD_MIN)
        if not ascending:
            # invert the VALUE bits only — null placement is nulls_first's
            packed = packed ^ WORD_MAX
        return [packed]
    elif isinstance(dt, (FloatType, DoubleType)):
        words.append(_float_bits_ordered(col.data, dt))
    else:  # integral / date / timestamp / decimal(int64)
        words.append(col.data.to(torch.int64))
    # null slots: zero value words so padding/nulls compare equal
    words = [torch.where(valid, wd, WORD_MIN) for wd in words]
    if not ascending:
        words = [~wd for wd in words]
    if value_only:
        return words
    vw = torch.where(one_if, WORD_MIN + 1, WORD_MIN)
    return [vw] + words


def batch_radix_words(columns: list, ascendings=None, nulls_firsts=None) -> list:
    out: list = []
    for i, c in enumerate(columns):
        asc = True if ascendings is None else ascendings[i]
        nf = True if nulls_firsts is None else nulls_firsts[i]
        out.extend(column_radix_words(c, asc, nf))
    return out


def sort_permutation(words: list, row_mask: torch.Tensor, live_first: bool = True) -> torch.Tensor:
    """Stable sort permutation (int64) over radix words; padding rows sort
    last. An LSD radix sort: one stable single-key ``torch.sort`` per word,
    from the least- to the most-significant, as the JAX package's
    ``lax.scan`` of stable passes — so ties give the same permutation."""
    cap = words[0].shape[0]
    keys = []
    if live_first:
        keys.append((~row_mask).to(torch.int64))
    keys.extend(words)
    perm = None
    for w in reversed(keys):
        _, order = torch.sort(w if perm is None else w[perm], stable=True)
        perm = order if perm is None else perm[order]
    return perm


def _lex_less(words_a: list, words_b: list, or_equal: bool) -> torch.Tensor:
    """Elementwise lexicographic a < b (or a <= b) over aligned word lists."""
    lt = torch.zeros(words_a[0].shape, dtype=torch.bool, device=words_a[0].device)
    eq = torch.ones_like(lt)
    for wa, wb in zip(words_a, words_b):
        lt = lt | (eq & (wa < wb))
        eq = eq & (wa == wb)
    return (lt | eq) if or_equal else lt


def merge_permutation(words: list, na, nb) -> torch.Tensor:
    """Permutation that merges two sorted live segments of one batch: rows
    ``[0, na)`` and ``[na, na+nb)`` are each sorted by ``words``; the
    returned perm gathers the stable merge (A wins ties). Each row
    binary-searches the OTHER segment for its merged position (reference:
    GpuSortExec.scala:212-510). ``na``/``nb`` are device scalars."""
    cap = words[0].shape[0]
    device = words[0].device
    idx = torch.arange(cap, dtype=torch.int64, device=device)
    na = torch.as_tensor(na, device=device).to(torch.int64)
    nb = torch.as_tensor(nb, device=device).to(torch.int64)
    is_a = idx < na
    # A rows search the B segment (side=left: A precedes equal B rows);
    # B rows search the A segment (side=right)
    pos_in_b = _binary_search(words, na, nb, words, right=False)
    pos_in_a = _binary_search(words, torch.zeros_like(na), na, words, right=True)
    pos = torch.where(is_a, idx + pos_in_b, (idx - na) + pos_in_a)
    pos = torch.where(idx < na + nb, pos, cap)  # padding rows go to the dropped slot
    # live positions are unique; the JAX package's .at[pos].set(mode="drop")
    perm = torch.zeros(cap + 1, dtype=torch.int64, device=device)
    perm[pos] = idx
    return perm[:cap]


def _binary_search(words: list, base, m, queries: list, right: bool) -> torch.Tensor:
    cap = words[0].shape[0]
    n = queries[0].shape[0]
    device = words[0].device
    lo = torch.zeros(n, dtype=torch.int64, device=device)
    hi = torch.broadcast_to(torch.as_tensor(m, device=device).to(torch.int64), (n,))
    for _ in range(max(1, cap.bit_length())):
        active = lo < hi
        mid = (lo + hi) >> 1
        at = torch.clamp(base + mid, 0, cap - 1)
        seg = [w[at] for w in words]
        # side=left: descend right while seg[mid] <  q  (first idx with seg >= q)
        # side=right: descend right while seg[mid] <= q (first idx with seg >  q)
        go_right = _lex_less(seg, queries, or_equal=right) & active
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def np_column_radix_words(
    dt: DataType,
    data,
    valid,
    lengths=None,
    ascending: bool = True,
    nulls_first: bool = True,
):
    """Numpy twin of :func:`column_radix_words` for the CPU engine's range
    partitioner, in the same flipped int64 words (``to_uint64`` gives the
    JAX package's ``np_column_radix_words`` words). NOT the same word layout
    as the device version: that one packs validity into the value word for
    sub-64-bit types; this twin keeps the classic [validity, value64] pair.
    The engines never mix word spaces — do not compare words across the
    two functions."""
    valid = np.asarray(valid).astype(bool)
    one, zero, sign = np.uint64(1), np.uint64(0), np.uint64(1 << 63)
    vw = np.where(valid, one, zero) if nulls_first else np.where(valid, zero, one)
    words: list = []
    if isinstance(dt, StringType):
        if getattr(data, "ndim", 1) != 2 or lengths is None:
            from .hash import np_strings_to_padded

            data, lengths = np_strings_to_padded(data, valid)
        n, w = data.shape
        nwords = (w + 7) // 8
        padded = np.zeros((n, nwords * 8), dtype=np.uint8)
        padded[:, :w] = data
        d64 = padded.astype(np.uint64).reshape(n, nwords, 8)
        shifts = np.arange(7, -1, -1, dtype=np.uint64) * np.uint64(8)
        packed = (d64 << shifts[None, None, :]).sum(axis=-1, dtype=np.uint64)
        words = [packed[:, k] for k in range(nwords)]
        words.append(np.asarray(lengths).astype(np.uint64))
    elif isinstance(dt, BooleanType):
        words.append(np.asarray(data).astype(np.uint64))
    elif isinstance(dt, (FloatType, DoubleType)):
        from ..exec.cpu_kernels import normalized_float_bits

        b = normalized_float_bits(np.asarray(data))
        words.append(np.where(b < 0, ~b.view(np.uint64), b.view(np.uint64) | sign))
    else:  # integral / date / timestamp / decimal(int64)
        words.append((np.asarray(data).astype(np.int64).view(np.uint64)) ^ sign)
    words = [np.where(valid, wd, zero) for wd in words]
    if not ascending:
        words = [~wd for wd in words]
    return [(wd ^ sign).view(np.int64) for wd in [vw] + words]


def _signed64(u: int) -> int:
    """The int64 with the bits of the uint64 ``u``."""
    return u - (1 << 64) if u >= 1 << 63 else u


def radix_select_kth(words: torch.Tensor, k: int) -> torch.Tensor:
    """Exact k-th smallest (1-based) of flipped int64 words, as a 0-d
    flipped word — the JAX package's ``_radix_select_kth``
    (``spark_rapids_tpu/exec/tpu.py``), which works on uint64. MSB→LSB: fix
    one bit per step by counting the words that share the prefix built so
    far with the current bit 0.

    Torch has no ``<`` or ``>>`` on uint64, so the prefix is built on the
    unflipped bit pattern (``words ^ WORD_MIN``) with ``&``, ``|`` and
    ``==`` alone, which ignore the sign; bit 63 is ``WORD_MIN``. The
    prefix and the rank stay 0-d device tensors: 64 steps, no host sync."""
    bits = words ^ WORD_MIN
    prefix = torch.zeros((), dtype=torch.int64, device=words.device)
    kk = torch.full((), k, dtype=torch.int64, device=words.device)
    for i in range(64):
        shift = 63 - i
        bit = _signed64(1 << shift)
        # the bits at and above the current position
        hi_mask = _signed64(((1 << 64) - 1) ^ ((1 << shift) - 1))
        cnt0 = ((bits & hi_mask) == prefix).sum()
        take1 = kk > cnt0
        prefix = torch.where(take1, prefix | bit, prefix)
        kk = torch.where(take1, kk - cnt0, kk)
    return prefix ^ WORD_MIN


def segment_starts(words: list, row_mask: torch.Tensor) -> torch.Tensor:
    """bool[cap]: row i starts a new group (equal radix words ⇔ equal keys).
    Assumes rows already sorted by ``words`` with live rows first."""
    cap = words[0].shape[0]
    diff = torch.zeros(cap, dtype=torch.bool, device=row_mask.device)
    diff[0] = True
    for w in words:
        diff[1:] |= w[1:] != w[:-1]
    return diff & row_mask
