"""Query event listener SPI (torch counterpart of
presto_tpu/server/events.py).

Re-designed equivalent of the reference's EventListener SPI
(presto-spi/.../spi/eventlistener/EventListener.java: queryCreated /
queryCompleted / splitCompleted) fed by QueryMonitor
(presto-main/.../event/QueryMonitor.java:73,112,171). Listeners are plain
objects registered on the QueryManager; failures in a listener never fail
the query (matching the reference's isolation of listener plugins).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import List, Optional

log = logging.getLogger("presto_tpu_torch.events")


@dataclasses.dataclass(frozen=True)
class QueryCreatedEvent:
    query_id: str
    sql: str
    user: str
    source: Optional[str]
    create_time: float


@dataclasses.dataclass(frozen=True)
class QueryCompletedEvent:
    query_id: str
    sql: str
    user: str
    source: Optional[str]
    state: str  # FINISHED | FAILED | CANCELED
    error: Optional[str]
    create_time: float
    start_time: Optional[float]
    end_time: float
    wall_s: float
    rows: Optional[int]
    # observability plane (obs/span.py): the query's trace id — join key
    # into system.runtime.tasks / the trace store — and per-phase wall
    # timings ({"plan": ms, "execute": ms, ...}) from the span tree.
    # None when tracing is disabled (PRESTO_TPU_TRACE=0)
    trace_id: Optional[str] = None
    phase_ms: Optional[dict] = None


@dataclasses.dataclass(frozen=True)
class WorkerStateEvent:
    """A worker transitioned liveness state (reference analog: the
    HeartbeatFailureDetector's state changes surfaced via node-state
    JMX + the coordinator log). States: ACTIVE (re-admitted / up),
    FAILED (heartbeat probes exhausted), BLACKLISTED (drained after
    consecutive task failures), MEMORY_UNPOLLABLE / MEMORY_POLLABLE
    (the cluster memory manager lost / regained sight of the worker's
    /v1/memory — manager blindness is observable, not an invisible
    skipped poll)."""

    uri: str
    state: str  # ACTIVE | FAILED | BLACKLISTED
    reason: str
    time: float


class EventListener:
    """Subclass and override the hooks you care about."""

    def query_created(self, event: QueryCreatedEvent) -> None:  # noqa: B027
        pass

    def query_completed(self, event: QueryCompletedEvent) -> None:  # noqa: B027
        pass

    def worker_state_changed(self, event: WorkerStateEvent) -> None:  # noqa: B027
        pass


class LoggingEventListener(EventListener):
    """Reference analog: the event-listener plugins that write query logs."""

    def query_created(self, event: QueryCreatedEvent) -> None:
        log.info("query created %s user=%s", event.query_id, event.user)

    def query_completed(self, event: QueryCompletedEvent) -> None:
        log.info(
            "query completed %s state=%s wall=%.3fs rows=%s",
            event.query_id, event.state, event.wall_s, event.rows,
        )

    def worker_state_changed(self, event: WorkerStateEvent) -> None:
        log.warning(
            "worker %s -> %s (%s)", event.uri, event.state, event.reason
        )


class EventBus:
    def __init__(self, listeners: Optional[List[EventListener]] = None):
        self.listeners = list(listeners or [])

    def add(self, listener: EventListener) -> None:
        self.listeners.append(listener)

    def fire_created(self, info) -> None:
        ev = QueryCreatedEvent(
            info.query_id, info.sql, getattr(info, "user", "user"),
            getattr(info, "source", None), info.created_at,
        )
        self._fire("query_created", ev)

    def fire_completed(self, info) -> None:
        end = info.finished_at or time.time()
        ev = QueryCompletedEvent(
            info.query_id, info.sql, getattr(info, "user", "user"),
            getattr(info, "source", None), info.state, info.error,
            info.created_at, info.started_at, end,
            end - (info.started_at or end),
            len(info.rows) if info.rows is not None else None,
            trace_id=getattr(info, "trace_id", None),
            phase_ms=getattr(info, "phase_ms", None),
        )
        self._fire("query_completed", ev)

    def fire_worker_state(self, uri: str, state: str, reason: str) -> None:
        self._fire(
            "worker_state_changed",
            WorkerStateEvent(uri, state, reason, time.time()),
        )

    def _fire(self, hook: str, event) -> None:
        for listener in self.listeners:
            try:
                getattr(listener, hook)(event)
            except Exception:  # noqa: BLE001 - listener isolation
                log.exception("event listener %r failed", listener)
