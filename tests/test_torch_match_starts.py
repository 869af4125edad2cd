"""The port's match_starts (spark_rapids_tpu_torch/ops/strings_kernels.py)
against the JAX package's Pallas kernel in interpret mode and its python
oracle, over the cases of tests/test_pallas.py. Masks must be bit-identical.

On the CPU the wrapper runs its plain torch version; the CUDA kernel itself
is held against that plain version by tests/test_torch_gpu.py (and
chip_smoke.py) on a card."""
from __future__ import annotations

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference; absent on a machine with only the port

import jax.numpy as jnp  # noqa: E402

from spark_rapids_tpu.ops import pallas_strings as PS  # noqa: E402
from spark_rapids_tpu_torch.ops import strings_kernels as SK
from spark_rapids_tpu_torch.testing import match_starts_cases


def _pack(strs, W):
    n = len(strs)
    data = np.zeros((n, W), np.uint8)
    lens = np.zeros(n, np.int32)
    for i, s in enumerate(strs):
        b = s.encode()[:W]
        lens[i] = len(b)
        data[i, : len(b)] = np.frombuffer(b, np.uint8)
    return data, lens


def _ragged(W, seed=11, n=300):
    rng = np.random.default_rng(seed)
    strs = [
        "".join(rng.choice(list("abxyz"), size=rng.integers(0, W)))
        for _ in range(n)
    ] + ["", "a", "ab", "abc", "abcabcabc", "aab" * 10]
    return _pack(strs, W)


def _port(data, lens, pat, device="cpu"):
    out = SK.match_starts(
        torch.from_numpy(data).to(device), torch.from_numpy(lens).to(device), pat
    )
    assert out.dtype == torch.bool and tuple(out.shape) == data.shape
    return out.cpu().numpy()


@pytest.mark.parametrize("pat", [b"a", b"ab", b"abc", b"xyzw"])
@pytest.mark.parametrize("W", [16, 64, 130])
def test_match_starts_matches_pallas_and_oracle(pat, W):
    data, lens = _ragged(W)
    got = _port(data, lens, pat)
    pallas = np.asarray(
        PS.match_starts(jnp.asarray(data), jnp.asarray(lens), pat, interpret=True)
    )
    ref = PS.match_starts_np_reference(data, lens, pat)
    assert (got == ref).all()
    assert (got == pallas).all()


@pytest.mark.parametrize("W", [16, 64, 130])
def test_match_starts_noise_past_length_and_straddles(W):
    """The card's case grid at a small n: the bytes past each row's length
    are noise, and some rows hold the pattern across their end, so only a
    fit test against the row's length gives the reference's mask."""
    for L, data, lens, pat, straddles in match_starts_cases(W, 300, seed=W):
        assert straddles > 0, L
        got = _port(data, lens, pat)
        ref = PS.match_starts_np_reference(data, lens, pat)
        pallas = np.asarray(
            PS.match_starts(jnp.asarray(data), jnp.asarray(lens), pat, interpret=True)
        )
        assert (got == ref).all(), L
        assert (got == pallas).all(), L
        assert got.any(), L


def test_match_starts_row_padding():
    """n not a multiple of the TPU kernel's 256-row block."""
    data, lens = _pack(["abc"] * 7, 16)
    got = _port(data, lens, b"bc")
    assert got.shape == (7, 16)
    assert got[:, 1].all() and got.sum() == 7


@pytest.mark.parametrize("pat,W", [(b"", 16), (b"a" * 17, 16), (b"ab" * 40, 64)])
def test_match_starts_empty_or_too_long_pattern(pat, W):
    """L == 0 or L > W: all False, and no launch."""
    data, lens = _ragged(W, seed=3, n=40)
    before = SK.LAUNCHES
    got = _port(data, lens, pat)
    assert not got.any()
    pallas = np.asarray(
        PS.match_starts(jnp.asarray(data), jnp.asarray(lens), pat, interpret=True)
    )
    assert (got == pallas).all()
    assert SK.LAUNCHES == before


def test_match_starts_plain_counts_no_launch():
    data, lens = _ragged(32, seed=5, n=20)
    before = SK.LAUNCHES
    _port(data, lens, b"ab")
    assert SK.LAUNCHES == before


def test_match_starts_rejects_bad_shape():
    with pytest.raises(ValueError):
        SK.match_starts(torch.zeros(8, dtype=torch.uint8), torch.zeros(8, dtype=torch.int32), b"a")
