"""TPC-H rig: the data generator and the queries of the port's slices
(see ``spark_rapids_tpu/tpch/`` for the full rig of the JAX package)."""
from .datagen import TABLES, gen_table  # noqa: F401
from .queries import SLICE_QUERIES  # noqa: F401
