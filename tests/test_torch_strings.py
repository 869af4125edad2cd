"""The port's string predicates and substring on the device path
(``device="cpu"``), against the golden corpus and the JAX package.

* The ``like``, ``substring``, ``startswith`` and ``endswith`` cases of
  ``tests/golden/golden_strings.json`` (18, 312, 7 and 7) through the
  port's device engine in strict mode, as ``tests/test_golden.py`` runs
  them through the JAX engines: one query per case, the pattern (or
  position and length) a literal, every node on the device.
* ``Like.eval``'s byte-NFA (``like_nfa``) against the JAX ``Like.eval`` on
  JAX-CPU (its ``lax.scan``) over the same seeded UTF-8 plane — one-, two-,
  three- and four-byte characters, empty rows, null rows and bytes past
  each row's length — for patterns with ``_``, ``%``, escapes and a custom
  escape character; both against the CPU engine's regular expression.
* The device rules: a non-literal pattern keeps ``Like`` on the CPU
  engine with the reference's reason."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on a machine with only the port

import jax.numpy as jnp  # noqa: E402

from spark_rapids_tpu.expr.base import BoundReference as JRef  # noqa: E402
from spark_rapids_tpu.expr.base import Ctx as JCtx  # noqa: E402
from spark_rapids_tpu.expr.base import Literal as JLit  # noqa: E402
from spark_rapids_tpu.expr.base import Val as JVal  # noqa: E402
from spark_rapids_tpu.expr.strings import Like as JLike  # noqa: E402
from spark_rapids_tpu.types import STRING as JSTRING  # noqa: E402
from spark_rapids_tpu_torch import TorchSession  # noqa: E402
from spark_rapids_tpu_torch import functions as PF  # noqa: E402
from spark_rapids_tpu_torch.expr.base import BoundReference as PRef  # noqa: E402
from spark_rapids_tpu_torch.expr.base import Ctx as PCtx  # noqa: E402
from spark_rapids_tpu_torch.expr.base import Literal as PLit  # noqa: E402
from spark_rapids_tpu_torch.expr.base import Val as PVal  # noqa: E402
from spark_rapids_tpu_torch.expr.strings import Like as PLike  # noqa: E402
from spark_rapids_tpu_torch.types import STRING as PSTRING  # noqa: E402
from spark_rapids_tpu_torch.xp import namespace  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden_strings.json")

_BUILD = {
    "like": lambda c, cc: c.like(cc["pat"]),
    "substring": lambda c, cc: PF.substring(c, cc["pos"], cc["len"]),
    "startswith": lambda c, cc: c.startswith(cc["pre"]),
    "endswith": lambda c, cc: c.endswith(cc["pre"]),
}
_COUNTS = {"like": 18, "substring": 312, "startswith": 7, "endswith": 7}


@pytest.mark.parametrize("op", list(_BUILD))
def test_golden_cases_on_the_device_path(op):
    with open(GOLDEN) as f:
        cases = [c for c in json.load(f) if c["op"] == op]
    assert len(cases) == _COUNTS[op]
    s = TorchSession(
        {"spark.rapids.sql.enabled": True, "spark.rapids.sql.test.enabled": True}, device="cpu"
    )
    for c in cases:
        df = s.create_dataframe({"c": [c["input"]]})
        got = df.select(_BUILD[op](PF.col("c"), c).alias("r")).collect()
        assert got == [(c["expected"],)], (op, c, got)
        project = [e for e in s._last_overrides.explain if e.node.startswith("CpuProject")]
        assert project and all(e.on_device for e in project), (op, c)


# ── the byte-NFA against the JAX lax.scan ──────────────────────────────────

_ALPHABET = ["a", "b", "c", "%", "_", "\\", "!", "é", "日", "😀", " "]


def _plane(seed: int, n: int = 400, width: int = 64):
    """(strings, uint8[n, width] plane, int32 lengths, validity): UTF-8 rows
    of 0-12 characters, a few null; bytes past each length are noise, as
    the device layout allows."""
    rng = np.random.default_rng(seed)
    strs = [
        "".join(_ALPHABET[i] for i in rng.integers(0, len(_ALPHABET), rng.integers(0, 13)))
        for _ in range(n)
    ]
    strs[:6] = ["", "a", "ab", "é", "日本", "😀b"]
    valid = rng.random(n) >= 0.1
    plane = rng.integers(0, 256, (n, width)).astype(np.uint8)
    lengths = np.zeros(n, dtype=np.int32)
    for i, s in enumerate(strs):
        b = s.encode("utf-8")
        plane[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        lengths[i] = len(b)
    return strs, plane, lengths, valid


_PATTERNS = [
    ("", "\\"), ("%", "\\"), ("_", "\\"), ("__", "\\"), ("a%", "\\"), ("%b", "\\"),
    ("a_b%", "\\"), ("%é%", "\\"), ("_日%", "\\"), ("%😀_", "\\"), ("%\\%%", "\\"),
    ("\\_%", "\\"), ("%\\\\%", "\\"), ("%_%_%", "\\"), ("%a%b%c", "\\"), ("!%%!_", "!"),
    ("___", "\\"), ("%ab", "\\"),
]


@pytest.mark.parametrize("pat,esc", _PATTERNS)
def test_like_nfa_matches_jax(pat, esc):
    strs, plane, lengths, valid = _plane(seed=80 + len(pat))
    n = len(strs)
    pctx = PCtx(namespace("cpu"), n, True, [PVal(torch.from_numpy(plane), torch.from_numpy(valid),
                                                 torch.from_numpy(lengths))])
    got = PLike(PRef(0, PSTRING, True), PLit(pat, PSTRING), esc).eval(pctx)
    jctx = JCtx(jnp, n, True, [JVal(jnp.asarray(plane), jnp.asarray(valid), jnp.asarray(lengths))])
    want = JLike(JRef(0, JSTRING, True), JLit(pat, JSTRING), esc).eval(jctx)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data), err_msg=pat)
    cctx = PCtx(np, n, False, [PVal(np.asarray(strs, dtype=object), valid)])
    oracle = PLike(PRef(0, PSTRING, True), PLit(pat, PSTRING), esc).eval(cctx)
    np.testing.assert_array_equal(got.data.numpy(), oracle.data, err_msg=pat)
    assert got.data.any() and not got.data.all() or pat == "%", pat


def test_non_literal_like_stays_on_the_cpu_engine():
    s = TorchSession({"spark.rapids.sql.enabled": True}, device="cpu")
    df = s.create_dataframe({"c": ["ab", "xy", None], "p": ["a%", "x_", "%"]})
    from spark_rapids_tpu_torch.expr.strings import Like

    rows = df.select(PF.Column(Like(PF.col("c").expr, PF.col("p").expr)).alias("r")).collect()
    assert rows == [(True,), (True,), (None,)]
    reasons = [r for e in s._last_overrides.explain for r in e.reasons]
    assert "LIKE pattern must be a string literal for the device path" in reasons
