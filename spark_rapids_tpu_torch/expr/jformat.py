"""Java-compatible floating-point → string formatting.

Spark's ``cast(float/double as string)`` produces ``java.lang.Double.toString``
/ ``Float.toString`` output (reference: GpuCast.scala castFloatingTypeToString,
which documents cuDF's divergence and gates the pair behind
``spark.rapids.sql.castFloatToString.enabled``). Java's rules:

* NaN → ``NaN``; infinities → ``Infinity`` / ``-Infinity``; zeros keep their
  sign bit (``0.0`` / ``-0.0``).
* ``1e-3 <= |x| < 1e7``: plain decimal with the shortest digit string that
  round-trips, always keeping at least one digit after the point (``1.0``).
* otherwise: "computerized scientific" ``d.dddE±e`` with at least one digit
  after the point (``1.0E10``).

The shortest round-trip digits here come from numpy's ``unique=True``
formatter (Grisu/Ryu-exact); OpenJDK's pre-19 FloatingDecimal emits a
non-shortest string for a handful of exotic values — a documented divergence
class the reference shares.

Copied from ``spark_rapids_tpu/expr/jformat.py``.
"""
from __future__ import annotations

import numpy as np


def _digits_exp(x, is32: bool) -> tuple[str, int, bool]:
    """Shortest round-trip digits of finite nonzero ``x`` as
    (digit string, adjusted exponent a, negative) with x = d.igits × 10^a."""
    v = np.float32(x) if is32 else np.float64(x)
    s = np.format_float_scientific(abs(v), unique=True, trim="-")
    mant, _, exp = s.partition("e")
    digits = mant.replace(".", "")
    return digits, int(exp), bool(np.signbit(v))


def java_float_str(x, is32: bool) -> str:
    """Java ``Double.toString``/``Float.toString`` of ``x``."""
    if np.isnan(x):
        return "NaN"
    if np.isinf(x):
        return "-Infinity" if x < 0 else "Infinity"
    if x == 0:
        return "-0.0" if np.signbit(x) else "0.0"
    digits, a, neg = _digits_exp(x, is32)
    sign = "-" if neg else ""
    if -3 <= a < 7:
        if a >= len(digits) - 1:  # integral value: pad with zeros, add .0
            return f"{sign}{digits}{'0' * (a - len(digits) + 1)}.0"
        if a >= 0:
            return f"{sign}{digits[: a + 1]}.{digits[a + 1 :]}"
        return f"{sign}0.{'0' * (-a - 1)}{digits}"
    frac = digits[1:] or "0"
    return f"{sign}{digits[0]}.{frac}E{a}"
