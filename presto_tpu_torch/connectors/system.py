"""system.runtime tables: cluster introspection through SQL (torch
counterpart of presto_tpu/connectors/system.py, the same tables and
columns).

Re-designed equivalent of the reference's system connector
(presto-main/.../connector/system/ — SystemTablesMetadata,
QuerySystemTable, NodeSystemTable; `select * from system.runtime.queries`).
A wrapper catalog routes `system.runtime.*` names to live snapshots built
from the coordinator's QueryManager / cluster NodeManager, and everything
else to the wrapped user catalog. The pages are built on the wrapped
catalog's device. system.jmx.process reports torch's device type for the
wrapped catalog and the number of CUDA devices torch sees.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import types as T
from ..page import Block, Page
from .spi import Connector, read_columns

QUERIES = "system.runtime.queries"
NODES = "system.runtime.nodes"
MATERIALIZED_VIEWS = "system.runtime.materialized_views"
# the observability plane (obs/): every metric
# sample the /v1/metrics scrape would return, and every span of the
# recently kept query traces, queryable as SQL
METRICS = "system.runtime.metrics"
TASKS = "system.runtime.tasks"
# jmx-analog runtime metrics (reference presto-jmx connector exposing
# the JVM's Runtime/Memory/OperatingSystem MBeans as tables): the
# process table is this interpreter's runtime MBean, the memory table
# the device/host pool gauges a JVM would publish per memory pool
JMX_PROCESS = "system.jmx.process"
JMX_MEMORY = "system.jmx.memory"
# history-based adaptive execution (plan/history.py): every live
# feedback-store entry — semantic plan-frame fingerprint, observed vs
# estimated cardinality, hybrid-join partition memory — as a table
PLAN_HISTORY = "system.runtime.plan_history"


def _varchar(values: List[Optional[str]], device) -> Block:
    return Block.from_strings(values if values else [None], device=device)


def _queries_page(manager, device) -> Page:
    infos = sorted(manager.list_queries(), key=lambda i: i.query_id)
    n = len(infos)
    if n == 0:
        from ..ops.union import empty_page

        return empty_page(_QUERIES_SCHEMA, device=device)
    now = __import__("time").time()
    return Page.from_dict(
        {
            "query_id": _varchar([i.query_id for i in infos], device),
            "state": _varchar([i.state for i in infos], device),
            "user": _varchar([i.user for i in infos], device),
            "source": _varchar([i.source for i in infos], device),
            "query": _varchar([i.sql for i in infos], device),
            "elapsed_s": (
                np.array(
                    [(i.finished_at or now) - i.created_at for i in infos],
                    np.float64,
                ),
                T.DOUBLE,
            ),
            "output_rows": (
                np.array(
                    [
                        len(i.rows) if i.rows is not None else -1
                        for i in infos
                    ],
                    np.int64,
                ),
                T.BIGINT,
            ),
            "error": _varchar(
                [
                    i.error.strip().split("\n")[-1][:200] if i.error else None
                    for i in infos
                ], device),
        }, device=device)


def _nodes_page(node_manager, self_uri: Optional[str], device) -> Page:
    rows: List[Tuple[str, str, str]] = []
    if self_uri is not None:
        rows.append((self_uri, "ACTIVE", "true"))
    if node_manager is not None:
        for uri, state in node_manager.workers.items():
            rows.append((uri, state["state"], "false"))
    if not rows:
        rows.append(("unknown", "ACTIVE", "true"))
    return Page.from_dict(
        {
            "node_id": _varchar([r[0] for r in rows], device),
            "state": _varchar([r[1] for r in rows], device),
            "coordinator": _varchar([r[2] for r in rows], device),
        }, device=device)


def _process_page(device) -> Page:
    import os
    import resource
    import threading
    import time as _t

    import torch

    ru = resource.getrusage(resource.RUSAGE_SELF)
    backend = torch.device(device).type
    n_devices = torch.cuda.device_count() if backend == "cuda" else 1
    return Page.from_dict(
        {
            "pid": (np.array([os.getpid()], np.int64), T.BIGINT),
            "rss_bytes": (
                np.array([ru.ru_maxrss * 1024], np.int64), T.BIGINT,
            ),
            "user_time_s": (
                np.array([ru.ru_utime], np.float64), T.DOUBLE,
            ),
            "system_time_s": (
                np.array([ru.ru_stime], np.float64), T.DOUBLE,
            ),
            "threads": (
                np.array([threading.active_count()], np.int64), T.BIGINT,
            ),
            "backend": _varchar([backend], device),
            "devices": (
                np.array([n_devices], np.int64), T.BIGINT,
            ),
            "uptime_hint_s": (
                np.array([_t.process_time()], np.float64), T.DOUBLE,
            ),
        }, device=device)


def _memory_page(memory_manager, node_manager, device) -> Page:
    """One row per known memory pool: the coordinator's cluster view
    (worker /v1/memory polls) or, standalone, this process's pool."""
    rows = []
    snap = None
    if memory_manager is not None:
        snap = getattr(memory_manager, "last_snapshot", None)
    if snap:
        for uri, info in snap.items():
            rows.append(
                (
                    uri,
                    int(info.get("reserved", 0)),
                    int(info.get("limit", 0) or 0),
                    int(info.get("blocked", 0)),
                )
            )
    if not rows:
        rows.append(("local", 0, 0, 0))
    return Page.from_dict(
        {
            "pool": _varchar([r[0] for r in rows], device),
            "reserved_bytes": (
                np.array([r[1] for r in rows], np.int64), T.BIGINT,
            ),
            "max_bytes": (
                np.array([r[2] for r in rows], np.int64), T.BIGINT,
            ),
            "blocked": (
                np.array([r[3] for r in rows], np.int64), T.BIGINT,
            ),
        }, device=device)


_JMX_PROCESS_SCHEMA: Dict[str, T.Type] = {
    "pid": T.BIGINT, "rss_bytes": T.BIGINT, "user_time_s": T.DOUBLE,
    "system_time_s": T.DOUBLE, "threads": T.BIGINT, "backend": T.VARCHAR,
    "devices": T.BIGINT, "uptime_hint_s": T.DOUBLE,
}
_JMX_MEMORY_SCHEMA: Dict[str, T.Type] = {
    "pool": T.VARCHAR, "reserved_bytes": T.BIGINT, "max_bytes": T.BIGINT,
    "blocked": T.BIGINT,
}


_QUERIES_SCHEMA: Dict[str, T.Type] = {
    "query_id": T.VARCHAR, "state": T.VARCHAR, "user": T.VARCHAR,
    "source": T.VARCHAR, "query": T.VARCHAR, "elapsed_s": T.DOUBLE,
    "output_rows": T.BIGINT, "error": T.VARCHAR,
}
_NODES_SCHEMA: Dict[str, T.Type] = {
    "node_id": T.VARCHAR, "state": T.VARCHAR, "coordinator": T.VARCHAR,
}
_METRICS_SCHEMA: Dict[str, T.Type] = {
    "name": T.VARCHAR, "type": T.VARCHAR, "labels": T.VARCHAR,
    "value": T.DOUBLE,
}
_TASKS_SCHEMA: Dict[str, T.Type] = {
    "trace_id": T.VARCHAR, "span_id": T.VARCHAR, "parent_id": T.VARCHAR,
    "name": T.VARCHAR, "status": T.VARCHAR, "start_s": T.DOUBLE,
    "wall_ms": T.DOUBLE, "rows_out": T.BIGINT, "bytes_out": T.BIGINT,
    "attrs": T.VARCHAR,
}
_PLAN_HISTORY_SCHEMA: Dict[str, T.Type] = {
    "fingerprint": T.VARCHAR, "kind": T.VARCHAR, "rows": T.DOUBLE,
    "est_rows": T.DOUBLE, "observations": T.BIGINT,
    "mispredicts": T.BIGINT, "hybrid_parts": T.BIGINT,
    "hybrid_depth": T.BIGINT, "tables": T.VARCHAR,
}
_MATVIEWS_SCHEMA: Dict[str, T.Type] = {
    "name": T.VARCHAR, "base_tables": T.VARCHAR, "incremental": T.VARCHAR,
    "reason": T.VARCHAR, "staleness_versions": T.BIGINT,
    "last_refresh_at": T.DOUBLE, "last_mode": T.VARCHAR,
    "rows_patched": T.BIGINT, "refreshes": T.BIGINT,
}


def _mat_views_page(mgr, device) -> Page:
    rows = mgr.rows() if mgr is not None else []
    if not rows:
        from ..ops.union import empty_page

        return empty_page(_MATVIEWS_SCHEMA, device=device)
    return Page.from_dict(
        {
            "name": _varchar([r["name"] for r in rows], device),
            "base_tables": _varchar([r["base_tables"] for r in rows], device),
            "incremental": _varchar(
                ["true" if r["incremental"] else "false" for r in rows], device),
            "reason": _varchar([r["reason"] or None for r in rows], device),
            "staleness_versions": (
                np.array(
                    [r["staleness_versions"] for r in rows], np.int64
                ),
                T.BIGINT,
            ),
            "last_refresh_at": (
                np.array([r["last_refresh_at"] for r in rows], np.float64),
                T.DOUBLE,
            ),
            "last_mode": _varchar([r["last_mode"] for r in rows], device),
            "rows_patched": (
                np.array([r["rows_patched"] for r in rows], np.int64),
                T.BIGINT,
            ),
            "refreshes": (
                np.array([r["refreshes"] for r in rows], np.int64),
                T.BIGINT,
            ),
        }, device=device)


def _metrics_page(device) -> Page:
    from ..obs.metrics import METRICS as REGISTRY

    samples = REGISTRY.collect()
    if not samples:
        from ..ops.union import empty_page

        return empty_page(_METRICS_SCHEMA, device=device)
    return Page.from_dict(
        {
            "name": _varchar([s[0] for s in samples], device),
            "type": _varchar([s[1] for s in samples], device),
            "labels": _varchar(
                [
                    ",".join(f"{k}={v}" for k, v in s[2]) or None
                    for s in samples
                ], device),
            "value": (
                np.array([float(s[3]) for s in samples], np.float64),
                T.DOUBLE,
            ),
        }, device=device)


def _plan_history_page(device) -> Page:
    """One row per live feedback-store entry (plan/history.py). The
    fingerprint is the semantic frame key the planner looks up, so a
    `rows` column here IS what the next plan of the same frame will use."""
    from ..plan.history import HISTORY

    entries = HISTORY.rows_snapshot()
    if not entries:
        from ..ops.union import empty_page

        return empty_page(_PLAN_HISTORY_SCHEMA, device=device)
    return Page.from_dict(
        {
            "fingerprint": _varchar([fp for fp, _ in entries], device),
            "kind": _varchar([e.kind or None for _, e in entries], device),
            "rows": (
                np.array(
                    [-1.0 if e.rows is None else float(e.rows)
                     for _, e in entries],
                    np.float64,
                ),
                T.DOUBLE,
            ),
            "est_rows": (
                np.array(
                    [-1.0 if e.est_rows is None else float(e.est_rows)
                     for _, e in entries],
                    np.float64,
                ),
                T.DOUBLE,
            ),
            "observations": (
                np.array([e.n for _, e in entries], np.int64), T.BIGINT,
            ),
            "mispredicts": (
                np.array([e.mispredicts for _, e in entries], np.int64),
                T.BIGINT,
            ),
            "hybrid_parts": (
                np.array([e.hybrid_parts for _, e in entries], np.int64),
                T.BIGINT,
            ),
            "hybrid_depth": (
                np.array([e.hybrid_depth for _, e in entries], np.int64),
                T.BIGINT,
            ),
            "tables": _varchar(
                [",".join(e.tables) or None for _, e in entries], device),
        }, device=device)


def _tasks_page(device) -> Page:
    """One row per span over the trace store's kept traces — the merged
    fleet trees, so a cluster query's worker task spans appear here."""
    from ..obs.span import TRACES

    spans = [s for tr in TRACES.recent() for s in tr.spans()]
    if not spans:
        from ..ops.union import empty_page

        return empty_page(_TASKS_SCHEMA, device=device)

    def _intattr(span, key) -> int:
        try:
            return int(span.attrs.get(key, -1))
        except (TypeError, ValueError):
            return -1

    return Page.from_dict(
        {
            "trace_id": _varchar([s.trace_id for s in spans], device),
            "span_id": _varchar([s.span_id for s in spans], device),
            "parent_id": _varchar([s.parent_id for s in spans], device),
            "name": _varchar([s.name for s in spans], device),
            "status": _varchar([s.status for s in spans], device),
            "start_s": (
                np.array([s.start for s in spans], np.float64), T.DOUBLE,
            ),
            "wall_ms": (
                np.array([s.wall_s * 1e3 for s in spans], np.float64),
                T.DOUBLE,
            ),
            "rows_out": (
                np.array([_intattr(s, "rows") for s in spans], np.int64),
                T.BIGINT,
            ),
            "bytes_out": (
                np.array([_intattr(s, "bytes") for s in spans], np.int64),
                T.BIGINT,
            ),
            "attrs": _varchar(
                [
                    ",".join(
                        f"{k}={v}" for k, v in sorted(s.attrs.items())
                        if k not in ("rows", "bytes")
                    ) or None
                    for s in spans
                ], device),
        }, device=device)


class SystemCatalog(Connector):
    """Routes system.runtime.* to live snapshots, everything else to the
    wrapped catalog. `manager`/`node_manager` are late-bound attributes —
    the coordinator sets them after construction (QueryManager needs a
    session, whose catalog is this object)."""

    def __init__(self, wrapped, manager=None, node_manager=None,
                 self_uri: Optional[str] = None, memory_manager=None):
        self.wrapped = wrapped
        self.manager = manager
        self.node_manager = node_manager
        self.self_uri = self_uri
        self.memory_manager = memory_manager
        # set explicitly (not via late getattr) so __getattr__ never
        # delegates the name to the wrapped catalog
        self.matview_manager = None
        self.device = torch.device(getattr(wrapped, "device", "cuda"))

    @property
    def name(self):
        return getattr(self.wrapped, "name", "catalog")

    # -- metadata --

    _SYSTEM_TABLES = (
        QUERIES, NODES, JMX_PROCESS, JMX_MEMORY, MATERIALIZED_VIEWS,
        METRICS, TASKS, PLAN_HISTORY,
    )

    def table_names(self) -> List[str]:
        return list(self.wrapped.table_names()) + list(self._SYSTEM_TABLES)

    def schema(self, table: str):
        if table == QUERIES:
            return dict(_QUERIES_SCHEMA)
        if table == NODES:
            return dict(_NODES_SCHEMA)
        if table == JMX_PROCESS:
            return dict(_JMX_PROCESS_SCHEMA)
        if table == JMX_MEMORY:
            return dict(_JMX_MEMORY_SCHEMA)
        if table == MATERIALIZED_VIEWS:
            return dict(_MATVIEWS_SCHEMA)
        if table == METRICS:
            return dict(_METRICS_SCHEMA)
        if table == TASKS:
            return dict(_TASKS_SCHEMA)
        if table == PLAN_HISTORY:
            return dict(_PLAN_HISTORY_SCHEMA)
        return self.wrapped.schema(table)

    def row_count(self, table: str) -> int:
        if table == QUERIES:
            return len(self.manager.list_queries()) if self.manager else 0
        if table in (
            NODES, JMX_PROCESS, JMX_MEMORY, METRICS, TASKS, PLAN_HISTORY,
        ):
            return 1  # planner estimate; exact counts come from the page
        if table == MATERIALIZED_VIEWS:
            mgr = self.matview_manager
            return len(mgr.views) if mgr is not None else 0
        return self.wrapped.row_count(table)

    def unique_columns(self, table: str):
        if table in self._SYSTEM_TABLES:
            return []
        return self.wrapped.unique_columns(table)

    def table_version(self, table: str):
        # system.runtime.* are live views of server state: NEVER cacheable
        if table in self._SYSTEM_TABLES:
            return None
        fn = getattr(self.wrapped, "table_version", None)
        return None if fn is None else fn(table)

    # -- data --

    def page(self, table: str) -> Page:
        dev = self.device
        if table == QUERIES:
            return _queries_page(self.manager, dev)
        if table == NODES:
            return _nodes_page(self.node_manager, self.self_uri, dev)
        if table == JMX_PROCESS:
            return _process_page(dev)
        if table == JMX_MEMORY:
            return _memory_page(self.memory_manager, self.node_manager, dev)
        if table == MATERIALIZED_VIEWS:
            return _mat_views_page(self.matview_manager, dev)
        if table == METRICS:
            return _metrics_page(dev)
        if table == TASKS:
            return _tasks_page(dev)
        if table == PLAN_HISTORY:
            return _plan_history_page(dev)
        return self.wrapped.page(table)

    def page_columns(self, table: str, columns) -> Page:
        if table in self._SYSTEM_TABLES:
            return self.page(table)
        return read_columns(self.wrapped, table, columns)

    def exact_row_count(self, table: str) -> int:
        if table in self._SYSTEM_TABLES:
            return int(self.page(table).count)
        return self.wrapped.exact_row_count(table)

    def scan(self, table: str, start: int, stop: int, pad_to=None,
             columns=None, predicate=None) -> Page:
        if table in self._SYSTEM_TABLES:
            return Connector.scan(
                self, table, start, stop, pad_to=pad_to, columns=columns
            )
        return self.wrapped.scan(
            table, start, stop, pad_to=pad_to, columns=columns,
            predicate=predicate,
        )

    # -- write passthrough (DDL/DML on the user catalog) --

    def __getattr__(self, item):
        # create_table/append/... delegate when the wrapped catalog is
        # writable; AttributeError otherwise, as for any read-only catalog
        return getattr(self.wrapped, item)
