"""Vectorized MD5 over padded byte rows — device path for the ``md5``
expression (reference: HashFunctions.scala GpuMd5, which dispatches to cudf's
device MD5).

Operates on the engine's padded-string layout ``uint8[n, width]`` +
``lengths[n]``: every row is hashed independently, entirely in uint32 lanes.
The block/round loops are over *static* bounds (derived from ``width``), so
under ``jax.jit`` they unroll into one fused kernel — the analogue of cudf's
precompiled md5 kernel.

Copied from ``spark_rapids_tpu/ops/md5.py``.
"""
from __future__ import annotations

import math

import numpy as np

# Round constants K[i] = floor(abs(sin(i+1)) * 2^32) and the standard shift
# schedule (RFC 1321).
_K = np.array(
    [int(abs(math.sin(i + 1)) * (1 << 32)) & 0xFFFFFFFF for i in range(64)],
    dtype=np.uint32,
)
_S = np.array(
    [7, 12, 17, 22] * 4 + [5, 9, 14, 20] * 4 + [4, 11, 16, 23] * 4 + [6, 10, 15, 21] * 4,
    dtype=np.uint32,
)
_INIT = np.array([0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476], dtype=np.uint32)

_HEX = np.frombuffer(b"0123456789abcdef", dtype=np.uint8)


def _rotl(xp, x, s):
    x = x.astype(xp.uint32)
    s = np.uint32(s)
    return ((x << s) | (x >> np.uint32(32 - s))).astype(xp.uint32)


def md5_padded(xp, data_u8, lengths):
    """MD5 of each row of ``data_u8[n, width]`` (first ``lengths[i]`` bytes).

    Returns hex digests as ``(uint8[n, 32], int32[n] lengths)``.
    """
    n, width = data_u8.shape
    lengths = xp.asarray(lengths).astype(xp.int32)
    max_blocks = (width + 9 + 63) // 64
    total_bytes = max_blocks * 64

    # Build the padded message: data | 0x80 | zeros | 8-byte LE bit length,
    # where the length field sits at the end of each row's *own* final block.
    pos = xp.arange(total_bytes, dtype=xp.int32)[None, :]  # [1, T]
    ln = lengths[:, None]  # [n, 1]
    nblocks = ((ln + 9) + 63) // 64  # [n, 1]
    row_total = nblocks * 64
    if total_bytes > width:
        padded = xp.pad(data_u8, ((0, 0), (0, total_bytes - width)))
    else:
        padded = data_u8[:, :total_bytes]
    base = padded.astype(xp.uint32)
    msg = xp.where(pos < ln, base, np.uint32(0))
    msg = xp.where(pos == ln, np.uint32(0x80), msg)
    # length field: little-endian 64-bit bit count at row_total-8 .. row_total-1
    bitlen = (ln.astype(xp.int64) * 8).astype(xp.int64)
    byte_index = pos - (row_total - 8)  # which of the 8 length bytes
    in_len_field = (byte_index >= 0) & (byte_index < 8)
    shift = (byte_index.astype(xp.int64) * 8) & xp.asarray(63, dtype=xp.int64)
    len_byte = ((bitlen >> shift) & xp.asarray(0xFF, dtype=xp.int64)).astype(xp.uint32)
    msg = xp.where(in_len_field, len_byte, msg)

    a = xp.broadcast_to(xp.asarray(_INIT[0]), (n,)).astype(xp.uint32)
    b = xp.broadcast_to(xp.asarray(_INIT[1]), (n,)).astype(xp.uint32)
    c = xp.broadcast_to(xp.asarray(_INIT[2]), (n,)).astype(xp.uint32)
    d = xp.broadcast_to(xp.asarray(_INIT[3]), (n,)).astype(xp.uint32)

    nb = nblocks[:, 0]
    for blk in range(max_blocks):
        # 16 little-endian words of this block
        words = []
        for w in range(16):
            o = blk * 64 + w * 4
            word = (
                msg[:, o]
                | (msg[:, o + 1] << np.uint32(8))
                | (msg[:, o + 2] << np.uint32(16))
                | (msg[:, o + 3] << np.uint32(24))
            ).astype(xp.uint32)
            words.append(word)
        A, B, C, D = a, b, c, d
        for i in range(64):
            if i < 16:
                f = (B & C) | (~B & D)
                g = i
            elif i < 32:
                f = (D & B) | (~D & C)
                g = (5 * i + 1) % 16
            elif i < 48:
                f = B ^ C ^ D
                g = (3 * i + 5) % 16
            else:
                f = C ^ (B | ~D)
                g = (7 * i) % 16
            f = (f.astype(xp.uint32) + A + xp.asarray(_K[i]) + words[g]).astype(xp.uint32)
            A = D
            D = C
            C = B
            B = (B + _rotl(xp, f, int(_S[i]))).astype(xp.uint32)
        active = blk < nb
        a = xp.where(active, (a + A).astype(xp.uint32), a)
        b = xp.where(active, (b + B).astype(xp.uint32), b)
        c = xp.where(active, (c + C).astype(xp.uint32), c)
        d = xp.where(active, (d + D).astype(xp.uint32), d)

    # Digest bytes (LE within each state word) → 32 hex chars.
    state = [a, b, c, d]
    cols = []
    for wi in range(4):
        s = state[wi]
        for byte in range(4):
            v = ((s >> np.uint32(8 * byte)) & np.uint32(0xFF)).astype(xp.int32)
            cols.append(xp.asarray(_HEX)[v >> 4])
            cols.append(xp.asarray(_HEX)[v & 15])
    out = xp.stack(cols, axis=1).astype(xp.uint8)
    out_len = xp.full((n,), 32, dtype=xp.int32)
    return out, out_len
