"""Server layer (torch counterpart of presto_tpu/server/).

Ported so far: the HTTP cluster data plane and the static catalog store.

Cluster execution:  WorkerServer(catalog).start() per node (catalog on the
                    card, or device="cpu"), then NodeManager([...uris]) and
                    HttpClusterSession(catalog, nodes).query(sql).
Wire format:        serialize_page / deserialize_page (PTP1 and PTP2 frames,
                    byte-compatible with the JAX package's).

The coordinator, client and the rest of the control plane are ROADMAP
queue 1 items."""

from .cluster import HttpClusterSession, HttpScheduler, NodeManager, TaskFailure
from .exchange import ExchangeClient, ExchangeError, ExchangeStats
from .serde import (
    DictionaryCache,
    WireStats,
    deserialize_page,
    local_capabilities,
    negotiate,
    serialize_page,
)
from .worker import WorkerServer

__all__ = [
    "WorkerServer",
    "NodeManager",
    "HttpScheduler",
    "HttpClusterSession",
    "TaskFailure",
    "ExchangeClient",
    "ExchangeError",
    "ExchangeStats",
    "serialize_page",
    "deserialize_page",
    "local_capabilities",
    "negotiate",
    "WireStats",
    "DictionaryCache",
]
