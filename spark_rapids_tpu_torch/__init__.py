"""spark_rapids_tpu_torch — the PyTorch/CUDA port of ``spark_rapids_tpu``.

A columnar SQL engine with the architecture of NVIDIA's RAPIDS Accelerator
for Apache Spark: a planning layer that rewrites physical plans so SQL
operators run as columnar kernels on device-resident batches, with a per-
operator CPU fallback that explains itself. The JAX package beside it is the
reference; this package runs the same plans with torch on one NVIDIA GPU
(Hopper, ``sm_90a``), and its TPU kernels become CUDA kernels written by hand.

It imports torch and numpy, never jax and nothing of ``spark_rapids_tpu``.
Spark's 64-bit semantics need no switch here: torch has int64 and float64.
"""
from . import config
from .config import TpuConf
from .types import (
    BOOLEAN,
    BYTE,
    DATE,
    DOUBLE,
    FLOAT,
    INT,
    LONG,
    NULL,
    SHORT,
    STRING,
    TIMESTAMP,
    DecimalType,
    Schema,
    StructField,
)

from .session import DataFrame, TorchSession
from . import functions

__version__ = "0.1.0"
