"""Accelerated columnar shuffle (SURVEY §2.7).

Three data planes, mirroring the reference's transport split:

* **Mesh** — partitions exchanged member-to-member by the single-controller
  mesh exchange (parallel/mesh.py, parallel/ici.py, parallel/
  distributed.py): peer copies between GPUs, slices within one device's
  memory when the members share it. Replaces UCX NVLink/RDMA; never
  serializes.
* **In-process** — same-host executors share the HBM-resident shuffle
  catalog; the transport SPI runs over direct calls (local.py).
* **TCP/DCN (inter-host)** — length-prefixed framed streams (tcp.py), the
  UCX-over-network replacement, with framed batches (columnar/ipc.py) +
  LZ4 payloads staged through bounce buffers.

The SPI (transport.py), metadata schema (meta.py), catalogs (catalog.py),
client/server protocol (client.py / server.py), heartbeat discovery
(heartbeat.py) and manager (manager.py) are transport-agnostic, exactly like
the reference's RapidsShuffleTransport seam.

The port of ``spark_rapids_tpu/shuffle/``: torch, numpy and the standard
library only; every module names its source.
"""
from .catalog import ShuffleBufferCatalog, ShuffleReceivedBufferCatalog
from .client import ShuffleClient, ShuffleFetchError
from .compression import get_codec
from .heartbeat import HeartbeatEndpoint, ShuffleHeartbeatManager
from .manager import (
    CachingReader,
    CachingWriter,
    MapOutputRegistry,
    MapStatus,
    ShuffleEnv,
    TpuShuffleManager,
)
from .server import ShuffleServer
from .transport import (
    REQ_METADATA,
    REQ_TRANSFER,
    ClientConnection,
    InflightThrottle,
    ServerConnection,
    Transaction,
    TransactionStatus,
    Transport,
)

__all__ = [
    "ShuffleBufferCatalog",
    "ShuffleReceivedBufferCatalog",
    "ShuffleClient",
    "ShuffleFetchError",
    "get_codec",
    "HeartbeatEndpoint",
    "ShuffleHeartbeatManager",
    "CachingReader",
    "CachingWriter",
    "MapOutputRegistry",
    "MapStatus",
    "ShuffleEnv",
    "TpuShuffleManager",
    "ShuffleServer",
    "REQ_METADATA",
    "REQ_TRANSFER",
    "ClientConnection",
    "InflightThrottle",
    "ServerConnection",
    "Transaction",
    "TransactionStatus",
    "Transport",
]
