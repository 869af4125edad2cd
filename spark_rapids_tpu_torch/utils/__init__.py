"""Small shared helpers of the port (copied from ``spark_rapids_tpu/utils/``)."""
