from .device import (
    DeviceBatch,
    DeviceColumn,
    batch_from_arrays,
    bucket_capacity,
    bucket_width,
    device_to_host,
    empty_batch,
    host_to_device,
)
from .host import HostBatch, HostColumn, batch_from_columns, concat_batches
