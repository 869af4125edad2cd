"""The port's file I/O: its own Parquet (``parquet.py`` over ``thrift.py``
and the host codec library ``csrc/host/io_codec.cc``) and CSV (``csv.py``)
readers and writers, the file scan (``files.py``), the plan-node writer
(``writer.py``) and the bucketed layout (``bucketing.py``). The port of
``spark_rapids_tpu/io/`` without pyarrow; ORC waits for ROADMAP item 10b."""
