"""Vectorized MD5 over padded byte rows — device path for the ``md5``
expression (reference: HashFunctions.scala GpuMd5, which dispatches to cudf's
device MD5).

Operates on the engine's padded-string layout ``uint8[n, width]`` +
``lengths[n]``: every row is hashed independently. The block/round loops
are over *static* bounds (derived from ``width``): eager torch ops over the
whole column, 64 rounds a block.

Copied from ``spark_rapids_tpu/ops/md5.py``, in int64 lanes (see
``md5_padded``).
"""
from __future__ import annotations

import math

import numpy as np

# Round constants K[i] = floor(abs(sin(i+1)) * 2^32) and the standard shift
# schedule (RFC 1321).
_K = [int(abs(math.sin(i + 1)) * (1 << 32)) & 0xFFFFFFFF for i in range(64)]
_S = [7, 12, 17, 22] * 4 + [5, 9, 14, 20] * 4 + [4, 11, 16, 23] * 4 + [6, 10, 15, 21] * 4
_INIT = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476]

_HEX = np.frombuffer(b"0123456789abcdef", dtype=np.uint8)
_M32 = 0xFFFFFFFF


def _rotl(x, s: int):
    """32-bit rotate left of the word ``x`` held in an int64 lane."""
    return ((x << s) | (x >> (32 - s))) & _M32


def md5_padded(xp, data_u8, lengths):
    """MD5 of each row of ``data_u8[n, width]`` (first ``lengths[i]`` bytes).

    Returns hex digests as ``(uint8[n, 32], int32[n] lengths)``. The JAX
    package works in uint32 lanes; here each 32-bit word lives in an int64
    lane, masked with ``& 0xFFFFFFFF`` after every add and shift (torch has
    no ``+``/``<<`` on uint32), as the port's murmur3 does.
    """
    n, width = data_u8.shape
    lengths = xp.astype(xp.asarray(lengths), xp.int64)
    max_blocks = (width + 9 + 63) // 64
    total_bytes = max_blocks * 64

    # Build the padded message: data | 0x80 | zeros | 8-byte LE bit length,
    # where the length field sits at the end of each row's *own* final block.
    pos = xp.arange(total_bytes, dtype=xp.int64)[None, :]  # [1, T]
    ln = lengths[:, None]  # [n, 1]
    nblocks = ((ln + 9) + 63) // 64  # [n, 1]
    row_total = nblocks * 64
    if total_bytes > width:
        padded = xp.pad(data_u8, ((0, 0), (0, total_bytes - width)))
    else:
        padded = data_u8[:, :total_bytes]
    base = xp.astype(padded, xp.int64)
    msg = xp.where(pos < ln, base, 0)
    msg = xp.where(pos == ln, 0x80, msg)
    # length field: little-endian 64-bit bit count at row_total-8 .. row_total-1
    bitlen = ln * 8
    byte_index = pos - (row_total - 8)  # which of the 8 length bytes
    in_len_field = (byte_index >= 0) & (byte_index < 8)
    shift = (byte_index * 8) & 63
    msg = xp.where(in_len_field, (bitlen >> shift) & 0xFF, msg)

    a, b, c, d = (xp.full((n,), v, dtype=xp.int64) for v in _INIT)
    nb = nblocks[:, 0]
    for blk in range(max_blocks):
        # 16 little-endian words of this block
        words = []
        for w in range(16):
            o = blk * 64 + w * 4
            words.append(
                msg[:, o] | (msg[:, o + 1] << 8) | (msg[:, o + 2] << 16) | (msg[:, o + 3] << 24)
            )
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
                f = C ^ (B | (~D & _M32))
                g = (7 * i) % 16
            f = ((f & _M32) + A + _K[i] + words[g]) & _M32
            A = D
            D = C
            C = B
            B = (B + _rotl(f, _S[i])) & _M32
        active = blk < nb
        a = xp.where(active, (a + A) & _M32, a)
        b = xp.where(active, (b + B) & _M32, b)
        c = xp.where(active, (c + C) & _M32, c)
        d = xp.where(active, (d + D) & _M32, d)

    # Digest bytes (LE within each state word) → 32 hex chars.
    hexd = xp.asarray(_HEX)
    cols = []
    for s in (a, b, c, d):
        for byte in range(4):
            v = (s >> (8 * byte)) & 0xFF
            cols.append(hexd[v >> 4])
            cols.append(hexd[v & 15])
    out = xp.astype(xp.stack(cols, axis=1), xp.uint8)
    out_len = xp.full((n,), 32, dtype=xp.int32)
    return out, out_len
