"""Server layer (torch counterpart of presto_tpu/server/): coordinator,
workers and the REST protocol.

Single-node embedding:  CoordinatorServer(Session(...)).start()
                        (the Session on the card, or device="cpu").
Cluster execution:      WorkerServer(catalog).start() per node, then
                        NodeManager([...uris]) and
                        HttpClusterSession(catalog, nodes); a
                        CoordinatorServer serves it as it is.
Client:                 Client(coordinator_uri).execute(sql).
Wire format:            serialize_page / deserialize_page (PTP1 and PTP2
                        frames, byte-compatible with the JAX package's).
"""

from .client import Client, QueryError
from .cluster import HttpClusterSession, HttpScheduler, NodeManager, TaskFailure
from .coordinator import CoordinatorServer
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
    "Client",
    "QueryError",
    "CoordinatorServer",
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
