"""Tests of the port that need an NVIDIA GPU: the hand-written match_starts
kernel against its plain torch version, bit for bit, and the slice's
queries on the card against the port's CPU engine. Each test decides in its
body whether a card is present and skips where none is.

This file imports neither jax nor the JAX package, so it runs on a machine
that has only the port: ``python -m pytest --noconftest -m gpu
tests/test_torch_*.py`` (tests/conftest.py sets up JAX for the reference's
suites)."""
from __future__ import annotations

import pytest
import torch

from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.ops import strings_kernels as SK
from spark_rapids_tpu_torch.testing import check_match_starts, rows_equal
from spark_rapids_tpu_torch.tpch.datagen import gen_orders_lineitem
from spark_rapids_tpu_torch.tpch.queries import SLICE_QUERIES


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel and the device path run only on a GPU")


@pytest.mark.gpu
@pytest.mark.parametrize("W", [8, 16, 64, 128, 130, 256])
def test_match_starts_kernel_matches_plain(W):
    """Bytes past each row's length are noise, and some rows hold the
    pattern across their end: the fit test must use the row's length."""
    _need_gpu()
    assert check_match_starts(W, 4099, seed=W) == len({1, 7, 17, W} & set(range(1, W + 1)))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SLICE_QUERIES))
def test_slice_query_on_gpu_matches_cpu_engine(name):
    _need_gpu()
    o, l = gen_orders_lineitem(0.01)
    tables = {"orders": o, "lineitem": l}
    fn, _ = SLICE_QUERIES[name]
    gpu = TorchSession({"spark.rapids.sql.test.enabled": True}, device="cuda")
    before = SK.LAUNCHES
    got = fn(lambda t: gpu.create_dataframe(tables[t])).collect()
    torch.cuda.synchronize()
    cpu = TorchSession({"spark.rapids.sql.enabled": False}, device="cpu")
    want = fn(lambda t: cpu.create_dataframe(tables[t])).collect()
    ok, msg = rows_equal(got, want)
    assert want and ok, msg
    if name.startswith("contains"):
        assert SK.LAUNCHES > before
