"""Multi-device execution over a single-controller mesh (``mesh.py``,
``ici.py``, ``distributed.py``) — the port of ``spark_rapids_tpu/parallel/``.
``parallel/compat.py`` (resolving ``shard_map`` across JAX versions) has no
counterpart: the port's mesh exchange is torch ops."""
