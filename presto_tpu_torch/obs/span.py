"""Span trees: one query end to end across the fleet (torch counterpart
of presto_tpu/obs/span.py, the same classes and rendering).

A query gets a `trace_id`; the coordinator opens phase spans (plan,
execute), per-stage and per-dispatch spans; the trace context (trace id
and parent span id) rides the HTTP task spec; workers record their own
task spans against that parent and return them in the task-status
payload; the coordinator merges the fleet's spans into one tree.

Retry: every dispatch attempt gets its own span under the same parent,
so a retried task shows as sibling spans (the failed attempt with
status "error", the retry "ok"), never an overwrite. Merging is
idempotent by span id, last write wins, so a status polled mid-flight
(end None) is upgraded by the final poll.

The timebase is time.time(), so coordinator and worker spans align on
the wall clock; remote spans' durations are computed remotely, so clock
skew shifts placement, not length.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple


def _new_id(n: int = 16) -> str:
    return uuid.uuid4().hex[:n]


class Span:
    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "start", "end",
        "status", "attrs",
    )

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str], start: float):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.end: Optional[float] = None
        self.status = "ok"
        self.attrs: Dict[str, object] = {}

    @property
    def wall_s(self) -> float:
        if self.end is None:
            return 0.0
        return max(0.0, self.end - self.start)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "end": self.end,
            "status": self.status,
            "attrs": dict(self.attrs),
        }


class Trace:
    """One query's span tree. All span mutation happens through the
    trace's lock (begin/finish/add_remote), so status-poll merges from
    puller threads and the coordinator's own phase spans never race."""

    def __init__(self, trace_id: Optional[str] = None):
        self.trace_id = trace_id or _new_id()
        self._lock = threading.Lock()
        self._spans: "OrderedDict[str, Span]" = OrderedDict()

    # -- recording --

    def begin(self, name: str, parent: Optional[Span] = None,
              parent_id: Optional[str] = None, **attrs) -> Span:
        span = Span(
            name, self.trace_id, _new_id(12),
            parent.span_id if parent is not None else parent_id,
            time.time(),
        )
        if attrs:
            span.attrs.update(attrs)
        with self._lock:
            self._spans[span.span_id] = span
        return span

    def finish(self, span: Span, status: str = "ok", **attrs) -> Span:
        with self._lock:
            if span.end is None:
                span.end = time.time()
            span.status = status
            if attrs:
                span.attrs.update(attrs)
        return span

    def add_synthetic(self, name: str, parent: Optional[Span],
                      wall_s: float, status: str = "ok", **attrs) -> Span:
        """A span with a known duration but no live start and stop: grafts
        per-node EXPLAIN ANALYZE stats into the tree shape the cluster
        path ships."""
        now = time.time()
        span = Span(
            name, self.trace_id, _new_id(12),
            parent.span_id if parent is not None else None,
            now - max(0.0, wall_s),
        )
        span.end = now
        span.status = status
        span.attrs.update(attrs)
        with self._lock:
            self._spans[span.span_id] = span
        return span

    def add_remote(self, span_dicts: Iterable[dict]) -> int:
        """Merge spans shipped from a worker (task-status payload).
        Idempotent by span_id: re-polling a task upgrades the entry in
        place instead of duplicating it. Returns the spans merged."""
        n = 0
        with self._lock:
            for d in span_dicts or ():
                try:
                    sid = d["span_id"]
                    span = Span(
                        str(d.get("name", "?")), self.trace_id, sid,
                        d.get("parent_id"), float(d.get("start", 0.0)),
                    )
                    end = d.get("end")
                    span.end = float(end) if end is not None else None
                    span.status = str(d.get("status", "ok"))
                    span.attrs = dict(d.get("attrs") or {})
                except (KeyError, TypeError, ValueError):
                    continue
                self._spans[sid] = span
                n += 1
        return n

    # -- reading --

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans.values())

    def to_dicts(self) -> List[dict]:
        return [s.to_dict() for s in self.spans()]

    def root(self) -> Optional[Span]:
        for s in self.spans():
            if s.parent_id is None:
                return s
        return None

    def children(self, span_id: Optional[str]) -> List[Span]:
        return [s for s in self.spans() if s.parent_id == span_id]

    def orphans(self) -> List[Span]:
        """Spans whose parent never arrived: a merge fault or a lost
        status payload."""
        with self._lock:
            ids = set(self._spans)
            return [
                s for s in self._spans.values()
                if s.parent_id is not None and s.parent_id not in ids
            ]

    def exclusive_walls(self) -> List[Tuple[Span, float]]:
        """(span, wall minus its children's wall): the time a span spent
        not delegated further down the tree, the critical-path unit."""
        spans = self.spans()
        child_sum: Dict[str, float] = {}
        for s in spans:
            if s.parent_id is not None:
                child_sum[s.parent_id] = (
                    child_sum.get(s.parent_id, 0.0) + s.wall_s
                )
        return [
            (s, max(0.0, s.wall_s - child_sum.get(s.span_id, 0.0)))
            for s in spans
        ]

    def critical_path(self, topk: int = 5) -> List[Tuple[Span, float]]:
        ranked = sorted(
            self.exclusive_walls(), key=lambda p: p[1], reverse=True
        )
        return ranked[:max(1, topk)]


def render_critical_path(trace: Trace, topk: int = 5) -> str:
    """The `-- trace:` EXPLAIN ANALYZE footer: one renderer for the
    single-process and the cluster paths."""
    root = trace.root()
    total = root.wall_s if root is not None else 0.0
    parts = []
    for span, excl in trace.critical_path(topk):
        pct = f" ({excl / total * 100:.0f}%)" if total > 0 else ""
        flag = "!" if span.status != "ok" else ""
        parts.append(f"{flag}{span.name} {excl * 1e3:.1f}ms{pct}")
    head = f"trace {trace.trace_id} wall {total * 1e3:.1f}ms"
    if not parts:
        return head
    return head + "; top exclusive: " + ", ".join(parts)


class TraceStore:
    """The last `trace_keep()` traces, for system.runtime.tasks and the
    coordinator's merging. Workers do not register their task traces
    here: theirs travel in the status payload, so the merge path is the
    same in-process and across processes."""

    def __init__(self):
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, Trace]" = OrderedDict()

    def _keep(self) -> int:
        from ..server import knobs

        return knobs.trace_keep()

    def new_trace(self) -> Trace:
        trace = Trace()
        keep = self._keep()
        with self._lock:
            self._traces[trace.trace_id] = trace
            while len(self._traces) > max(1, keep):
                self._traces.popitem(last=False)
        return trace

    def get(self, trace_id: str) -> Optional[Trace]:
        with self._lock:
            return self._traces.get(trace_id)

    def recent(self) -> List[Trace]:
        with self._lock:
            return list(self._traces.values())

    def reset(self) -> None:
        with self._lock:
            self._traces.clear()


def enabled() -> bool:
    from ..server import knobs

    return knobs.trace_enabled()


# process-wide: the coordinator's (or a single-process session's) view
TRACES = TraceStore()
