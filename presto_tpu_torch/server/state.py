"""Query manager and state machine (torch counterpart of
presto_tpu/server/state.py).

Re-designed equivalent of the reference's coordinator query tracking:
SqlQueryManager (execution/SqlQueryManager.java:88), QueryStateMachine and
the generic listener-based StateMachine (execution/StateMachine.java:44),
and the /v1/statement paging buffer (server/protocol/Query.java:90,357).

Admission control is delegated to hierarchical resource groups
(server/resource_groups.py — reference InternalResourceGroup.run,
resourceGroups/InternalResourceGroup.java:584): submissions enter a group
chosen by user/source selectors, wait for a slot, and are executed by a
bounded worker pool. Query lifecycle events fan out to EventListeners
(server/events.py).

A query runs on a manager thread with the session's card as the thread's
current device, on that device's current stream (the default stream: the
manager never creates one). The result is copied to the host once, by
QueryResult.rows(), and the statement protocol pages from that copy; then
the kernel profile reads the event pairs that have completed."""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import queue
import threading
import time
import traceback
from typing import Dict, List, Optional

QUEUED = "QUEUED"
RUNNING = "RUNNING"
FINISHED = "FINISHED"
FAILED = "FAILED"
CANCELED = "CANCELED"

_TERMINAL = (FINISHED, FAILED, CANCELED)


@dataclasses.dataclass
class QueryInfo:
    query_id: str
    sql: str
    state: str = QUEUED
    error: Optional[str] = None
    created_at: float = dataclasses.field(default_factory=time.time)
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    columns: Optional[List[dict]] = None
    rows: Optional[List[tuple]] = None  # materialized result (root buffer)
    plan: Optional[str] = None
    user: str = "user"
    source: Optional[str] = None
    properties: dict = dataclasses.field(default_factory=dict)
    # observability (obs/): set from the QueryResult when the executing
    # session traced the query; ride the query_completed event
    trace_id: Optional[str] = None
    phase_ms: Optional[dict] = None

    @property
    def priority(self) -> int:  # query_priority scheduling policy input
        return int(self.properties.get("query_priority", 1))

    @property
    def done(self) -> bool:
        return self.state in _TERMINAL


class QueryManager:
    """Tracks every query's lifecycle; executes via the supplied session
    factory on worker threads (max_concurrent = admission control)."""

    def __init__(self, session, max_concurrent: int = 1,
                 max_history: int = 100, resource_groups: Optional[dict] = None,
                 selectors: Optional[list] = None, listeners=None,
                 access_control=None, cluster_pressure=None):
        from .events import EventBus
        from .resource_groups import ResourceGroupManager

        self.session = session
        # explicit access control covers duck-typed sessions
        # (HttpClusterSession) that cannot carry one themselves — without
        # this the manager would silently fail open for them
        self.access_control = access_control or getattr(
            session, "access_control", None
        )
        self.queries: Dict[str, QueryInfo] = {}
        self.max_history = max_history
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._queue: "queue.Queue[str]" = queue.Queue()
        self._events: Dict[str, threading.Event] = {}
        self.events = EventBus(listeners)
        spec = resource_groups or {
            "name": "global",
            "hard_concurrency_limit": max_concurrent,
            "max_queued": 10_000,
        }
        # cluster_pressure (typically ClusterMemoryManager.above_watermark
        # when serving an HttpClusterSession): admission refuses to start
        # queries while the cluster is above the revocation watermark
        self.groups = ResourceGroupManager(
            spec, selectors,
            dispatch=lambda info: self._queue.put(info.query_id),
            cluster_pressure=cluster_pressure,
        )
        # enough executor threads to honor the root group's concurrency;
        # beyond the thread cap, clamp the group limit so admission never
        # exceeds what can actually run (stats stay truthful)
        pool = min(max(max_concurrent, self.groups.root.hard_concurrency_limit), 32)
        if self.groups.root.hard_concurrency_limit > pool:
            import logging

            logging.getLogger("presto_tpu_torch.server").warning(
                "clamping root hard_concurrency_limit %d to worker pool %d",
                self.groups.root.hard_concurrency_limit, pool,
            )
            self.groups.root.hard_concurrency_limit = pool
        self._workers = [
            threading.Thread(target=self._run_loop, daemon=True)
            for _ in range(pool)
        ]
        for w in self._workers:
            w.start()

    # -- submission / lifecycle --

    def submit(self, sql: str, user: str = "user",
               source: Optional[str] = None,
               properties: Optional[dict] = None) -> QueryInfo:
        from .resource_groups import QueryRejected

        with self._lock:
            qid = f"q_{next(self._ids)}"
            info = QueryInfo(
                qid, sql, user=user, source=source,
                properties=dict(properties or {}),
            )
            self.queries[qid] = info
            self._events[qid] = threading.Event()
            self._expire_locked()
        self.events.fire_created(info)
        try:
            # multi-statement transactions are SESSION-scoped (an overlay
            # catalog swapped into one Session, exec/transaction.py); the
            # REST Session is shared across clients and worker threads, so
            # a BEGIN here would entangle every client's reads and writes.
            # The reference scopes wire transactions with
            # X-Presto-Transaction handles — unsupported here, so reject
            # by PARSING (a first-token sniff is bypassed by ';'/comments)
            try:
                from ..sql import parser as _p
                from ..sql import tree as _t

                ast = _p.parse(sql)
            except Exception:  # noqa: BLE001 - surfaces at execution
                ast = None
            if isinstance(
                ast, (_t.StartTransaction, _t.Commit, _t.Rollback)
            ):
                raise QueryRejected(
                    "multi-statement transactions are not supported over "
                    "the shared REST session; use an in-process Session"
                )
            self.groups.submit(info)
        except QueryRejected as e:
            info.state = FAILED
            info.error = str(e)
            info.finished_at = time.time()
            ev = self._events.get(qid)  # may already be expired from history
            if ev is not None:
                ev.set()
            self.events.fire_completed(info)
        return info

    def _expire_locked(self):
        """Bound coordinator memory: drop the oldest completed queries
        beyond max_history (reference PurgeQueriesRunnable +
        query expiration in SqlQueryManager)."""
        done = [q for q in self.queries.values() if q.done]
        excess = len(done) - self.max_history
        if excess > 0:
            done.sort(key=lambda q: q.finished_at or 0)
            for q in done[:excess]:
                self.queries.pop(q.query_id, None)
                self._events.pop(q.query_id, None)

    def get(self, query_id: str) -> Optional[QueryInfo]:
        return self.queries.get(query_id)

    def cancel(self, query_id: str) -> bool:
        info = self.queries.get(query_id)
        if info is None:
            return False
        if info.done:
            # DELETE on a finished query purges it (result acknowledged)
            with self._lock:
                self.queries.pop(query_id, None)
                self._events.pop(query_id, None)
            return True
        # cooperative: QUEUED queries are dropped; RUNNING queries finish
        # their current kernel then observe the canceled state. The state
        # write is under the manager lock so it cannot interleave with a
        # worker's QUEUED->RUNNING transition and get lost.
        with self._lock:
            if info.done:
                return True
            was_queued = info.state == QUEUED
            info.state = CANCELED
            info.finished_at = time.time()
        if was_queued and self.groups.remove_queued(info):
            # never admitted: no slot to release
            self.events.fire_completed(info)
        ev = self._events.get(query_id)
        if ev is not None:
            ev.set()
        return True

    def wait(self, query_id: str, timeout: float) -> Optional[QueryInfo]:
        """Long-poll support (reference max-wait on statement GETs).
        None when the query was purged while waiting."""
        ev = self._events.get(query_id)
        if ev is not None:
            ev.wait(timeout)
        return self.queries.get(query_id)

    def list_queries(self) -> List[QueryInfo]:
        return list(self.queries.values())

    # -- execution --

    def _run_loop(self):
        while True:
            qid = self._queue.get()
            with self._lock:
                info = self.queries.get(qid)
                runnable = info is not None and info.state == QUEUED
                if runnable:
                    info.state = RUNNING
                    info.started_at = time.time()
            if not runnable:
                # canceled/purged after its group admitted it: the slot
                # was taken at dispatch, release it (by id — the info may
                # be gone from history)
                self.groups.finished_by_id(qid, 0.0)
                if info is not None:
                    self.events.fire_completed(info)
                continue
            try:
                with _device_scope(self.session):
                    result, rows = self._execute(info)
                info.columns = [
                    {"name": t, "type": str(b.type)}
                    for t, b in zip(result.titles, result.page.blocks)
                ]
                info.rows = rows
                info.trace_id = getattr(result, "trace_id", None)
                info.phase_ms = getattr(result, "phase_ms", None)
                with self._lock:
                    if info.state != CANCELED:
                        info.state = FINISHED
            except Exception:  # noqa: BLE001 - query failure is data
                info.error = traceback.format_exc(limit=20)
                with self._lock:
                    if info.state != CANCELED:
                        info.state = FAILED
            info.finished_at = time.time()
            self.groups.finished(info, info.finished_at - info.started_at)
            ev = self._events.get(qid)
            if ev is not None:
                ev.set()
            self.events.fire_completed(info)

    def _execute(self, info: QueryInfo):
        """Run one query: (its QueryResult, its rows copied to the host)."""
        from ..obs.kernelprof import KERNEL_PROFILE

        session = self.session
        if info.properties and hasattr(session, "with_properties"):
            session = session.with_properties(info.properties)
        if getattr(session, "access_control", None) is not None:
            # the session enforces itself, as the REQUEST user
            result = session.query(info.sql, user=info.user)
        elif self.access_control is not None:
            # duck-typed session that cannot carry an access control: the
            # manager enforces before executing
            from ..security import enforce
            from ..sql.parser import parse

            enforce(self.access_control, info.user, parse(info.sql))
            result = session.query(info.sql)
        else:
            result = session.query(info.sql)
        rows = result.rows()
        # the result is on the host: the query's kernels have finished
        KERNEL_PROFILE.drain()
        return result, rows


def _device_scope(session):
    """The session's card as the calling thread's current device (a no-op
    on the CPU): a manager thread launches on the session's device and its
    current stream, never another."""
    dev = getattr(session, "device", None)
    if dev is None:
        dev = getattr(getattr(session, "scheduler", None), "device", None)
    if getattr(dev, "type", None) == "cuda":
        import torch

        return torch.cuda.device(dev)
    return contextlib.nullcontext()
