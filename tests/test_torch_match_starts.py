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
from spark_rapids_tpu_torch.testing import (
    GRID,
    at_storage_offset,
    grid_lengths,
    match_starts_cases,
    ragged_plane,
)


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
    """The noisy planes of the card's case grid at a small n, with pattern
    lengths 1, 7, 17 and W: the bytes past each row's length are noise, and
    some rows hold the pattern across their end, so only a fit test against
    the row's length gives the reference's mask. (The grid's own lengths
    are in test_match_starts_grid_small_n.)"""
    cases = match_starts_cases(W, 300, seed=W, lengths=(1, 7, 17, "W"))
    for L, data, lens, pat, straddles in cases:
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


@pytest.mark.parametrize("W", [W for W, _ in GRID])
def test_match_starts_grid_small_n(W):
    """The card's full case grid (every width, every pattern length up to W)
    at a small n: the port's plain version, the numpy oracle and, for
    L <= 17, the Pallas kernel in interpret mode agree bit for bit. (The
    interpret mode compiles one roll per pattern byte for each pattern:
    L = 2048 alone takes minutes on the CPU, and the lengths up to 17
    already fall on both sides of the 4-byte screen and the 16-byte run.)"""
    n = 300 if W <= 256 else 40
    seen = []
    for L, data, lens, pat, straddles in match_starts_cases(W, n, seed=W):
        assert straddles > 0, L
        got = _port(data, lens, pat)
        ref = PS.match_starts_np_reference(data, lens, pat)
        assert (got == ref).all(), L
        assert got.any(), L
        if L <= 17:
            pallas = np.asarray(
                PS.match_starts(jnp.asarray(data), jnp.asarray(lens), pat, interpret=True)
            )
            assert (got == pallas).all(), L
        seen.append(L)
    assert seen == grid_lengths(W)


def test_grid_reaches_every_kernel_path():
    """Widths on both kernel paths, pattern lengths on both sides of the
    4-byte screen and the 16-byte run, and 4099 rows that leave the last
    row tile of the kernel (256 threads, 16 outputs each) part-filled."""
    widths = [W for W, _ in GRID]
    assert any(W % 16 for W in widths) and any(W % 16 == 0 for W in widths)
    assert 8 in widths and max(widths) >= 2048
    assert {1, 3, 4, 5, 15, 16, 17, 31, 33} <= set(grid_lengths(64))
    assert grid_lengths(8) == [1, 3, 4, 5, 8]
    assert grid_lengths(16) == [1, 3, 4, 5, 15, 16]
    for W, ns in GRID:
        rows_per_tile = 256 // min(-(-W // 16), 256)
        assert any(n % rows_per_tile for n in ns), W


@pytest.mark.parametrize("W,n", [(8, 5), (64, 9), (2048, 40)])
def test_ragged_plane_small_n_holds_full_rows(W, n):
    """Where n <= W the lengths still reach W - 1 and W, so L = W has a
    match and a straddling row."""
    _, lens = ragged_plane(W, n, seed=1)
    assert lens.min() == 0 and lens.max() == W and (lens == W - 1).any()


@pytest.mark.parametrize(
    "W,offset,path",
    [(128, 0, "vec16"), (128, 128, "vec16"), (128, 1, "bytes"), (130, 0, "bytes"),
     (8, 0, "bytes"), (2048, 0, "vec16"), (2048, 4, "bytes")],
)
def test_kernel_path_by_shape_and_alignment(W, offset, path):
    """vec16 needs W % 16 == 0 and a 16-byte-aligned base; views at other
    storage offsets take the byte path, and give the same mask."""
    data, lens = ragged_plane(W, 40, seed=2)
    t = torch.from_numpy(data)
    view = at_storage_offset(t, offset) if offset else t.clone()
    assert view.storage_offset() == offset and torch.equal(view, t)
    out = torch.empty((40, W), dtype=torch.bool)
    assert out.data_ptr() % 16 == 0
    assert SK.kernel_path(W, view.data_ptr(), out.data_ptr()) == path
    pat = bytes(data[int(np.argmax(lens >= 3)), :3])
    got = SK.match_starts(view, torch.from_numpy(lens), pat)
    assert (got.numpy() == PS.match_starts_np_reference(data, lens, pat)).all()


def test_device_pattern_is_copied_once():
    """The launch path reuses one device copy of each pattern."""
    a = SK._device_pattern(b"special", torch.device("cpu"))
    assert SK._device_pattern(b"special", torch.device("cpu")) is a
    assert bytes(a.tolist()) == b"special" and a.dtype == torch.uint8
    assert SK._device_pattern(b"spec", torch.device("cpu")) is not a
