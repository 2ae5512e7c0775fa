"""Multilevel feedback task scheduler: the worker's gate between batches
(torch counterpart of presto_tpu/exec/taskqueue.py).

Re-designed equivalent of the reference's MultilevelSplitQueue +
TaskExecutor (presto-main/.../executor/MultilevelSplitQueue.java:34,
TaskExecutor.java): queries are binned into levels by accumulated
execution time, and scheduling targets a fixed utilization ratio between
adjacent levels (each level gets about twice the time share of the next
slower one), so a fresh interactive query is never starved behind a long
scan.

A worker drives one device, so the quantum is one streaming batch (the
driver loop's natural yield point) and the scheduler is a cooperative
slot gate that task threads pass through between batches:

    with scheduler.quantum(query_id):
        page = next(stream)

Selection (MultilevelSplitQueue.pollSplit): among levels with waiters,
the one with the smallest scheduled_time / weight; FIFO within a level.
Weights halve per level.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

LEVEL_THRESHOLD_SECONDS = (0.0, 1.0, 10.0, 60.0, 300.0)
LEVEL_WEIGHTS = (16, 8, 4, 2, 1)


class MultilevelScheduler:
    def __init__(self, concurrency: int = 2):
        self._cv = threading.Condition()
        self._slots = max(1, int(concurrency))
        self._query_time: Dict[str, float] = {}
        self._level_time: List[float] = [0.0] * len(LEVEL_WEIGHTS)
        # FIFO arrival order: list of (query_id, ticket)
        self._waiting: List[Tuple[str, object]] = []
        self._running: Dict[object, Tuple[str, int, float]] = {}

    # -- level accounting --
    def level_of(self, query_id: str) -> int:
        t = self._query_time.get(query_id, 0.0)
        lev = 0
        for i, thr in enumerate(LEVEL_THRESHOLD_SECONDS):
            if t >= thr:
                lev = i
        return lev

    def _pick(self) -> Optional[object]:
        """Ticket to run next: level with min scheduled/weight, FIFO
        within the level. None when nothing waits."""
        if not self._waiting:
            return None
        best_lev, best_ratio = None, None
        by_level: Dict[int, object] = {}
        for qid, ticket in self._waiting:
            lev = self.level_of(qid)
            if lev not in by_level:
                by_level[lev] = ticket  # first-in at this level
        for lev, ticket in by_level.items():
            ratio = self._level_time[lev] / LEVEL_WEIGHTS[lev]
            if best_ratio is None or ratio < best_ratio:
                best_lev, best_ratio = lev, ratio
        return by_level[best_lev]

    # -- the gate --
    @contextmanager
    def quantum(self, query_id: str, max_wait: float = 2.0):
        """Slot gate around one batch of work.

        A quantum can BLOCK inside (a consumer task's next() waits on
        upstream pages) — the reference's blocked-split futures return
        their thread for that; the cooperative analog is a bounded
        wait: after `max_wait` the task proceeds WITHOUT a slot
        (bypass), so same-worker producer/consumer chains can never
        deadlock on the gate. Bypassed quanta still charge their time."""
        ticket = object()
        bypass = False
        deadline = time.perf_counter() + max_wait
        with self._cv:
            self._waiting.append((query_id, ticket))
            while not (self._slots > 0 and self._pick() is ticket):
                left = deadline - time.perf_counter()
                if left <= 0:
                    bypass = True
                    break
                self._cv.wait(timeout=left)
            self._waiting = [w for w in self._waiting if w[1] is not ticket]
            if not bypass:
                self._slots -= 1
            lev = self.level_of(query_id)
            self._running[ticket] = (
                query_id, lev, time.perf_counter(), bypass
            )
            # wake remaining waiters: with >1 slot the next-best ticket
            # can enter immediately (entry itself frees no slot to signal)
            self._cv.notify_all()
        try:
            yield
        finally:
            with self._cv:
                qid, lev, t0, byp = self._running.pop(ticket)
                dt = time.perf_counter() - t0
                self._query_time[qid] = self._query_time.get(qid, 0.0) + dt
                self._level_time[lev] += dt
                if not byp:
                    self._slots += 1
                self._cv.notify_all()

    # -- observability (system.runtime / tests) --
    def snapshot(self) -> dict:
        with self._cv:
            return {
                "levels": {
                    i: round(t, 6) for i, t in enumerate(self._level_time)
                },
                "queries": {
                    q: round(t, 6) for q, t in self._query_time.items()
                },
                "waiting": len(self._waiting),
                "running": len(self._running),
            }

    def charge(self, query_id: str, seconds: float) -> None:
        """Test/bookkeeping hook: attribute execution time directly.
        Books into the query's POST-update level — a bulk charge models
        time the query spent getting TO that level."""
        with self._cv:
            self._query_time[query_id] = (
                self._query_time.get(query_id, 0.0) + seconds
            )
            self._level_time[self.level_of(query_id)] += seconds
