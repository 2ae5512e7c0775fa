"""Hierarchical resource groups: admission control for the coordinator
(torch counterpart of presto_tpu/server/resource_groups.py).

Re-designed equivalent of the reference's resource-group subsystem
(execution/resourceGroups/InternalResourceGroup.java:78,584,748 with
FifoQueue/WeightedFairQueue, config via presto-resource-group-managers'
file-based manager, and the selector SPI spi/resourceGroups/). Quotas
gate how many queries may be RUNNING at once and how much accumulated
wall clock a group may burn per quota period: concurrency here is about
coordinator scheduling, not sharing the card.

Config shape (mirrors the reference's resource-groups JSON):

    {"name": "global", "hard_concurrency_limit": 10, "max_queued": 100,
     "scheduling_policy": "fair" | "weighted" | "query_priority",
     "cpu_quota_period_s": 60.0, "hard_cpu_limit_s": 30.0,
     "sub_groups": [
        {"name": "etl", "hard_concurrency_limit": 2, "max_queued": 10,
         "scheduling_weight": 3},
        {"name": "adhoc", ...}],
    }
    selectors = [{"user": "regex", "source": "regex", "group": "global.etl"},
                 ...]  # first match wins; default last group
"""

from __future__ import annotations

import dataclasses
import re
import threading
import time
from typing import Callable, Dict, List, Optional


class QueryRejected(RuntimeError):
    """Group queue full (reference: QUERY_QUEUE_FULL error)."""


@dataclasses.dataclass
class GroupStats:
    name: str
    running: int
    queued: int
    cpu_used_s: float


class ResourceGroup:
    """One node of the group tree. Leaf groups hold query queues; interior
    groups aggregate limits over their children (reference
    InternalResourceGroup: canRunMore/internalStartNext)."""

    def __init__(self, spec: dict, parent: Optional["ResourceGroup"] = None):
        self.name = spec["name"]
        self.parent = parent
        self.full_name = (
            f"{parent.full_name}.{self.name}" if parent else self.name
        )
        self.hard_concurrency_limit = int(
            spec.get("hard_concurrency_limit", 10)
        )
        self.max_queued = int(spec.get("max_queued", 100))
        self.scheduling_policy = spec.get("scheduling_policy", "fair")
        self.scheduling_weight = int(spec.get("scheduling_weight", 1))
        self.cpu_quota_period_s = float(spec.get("cpu_quota_period_s", 0.0))
        self.hard_cpu_limit_s = float(spec.get("hard_cpu_limit_s", 0.0))
        self.children = [
            ResourceGroup(s, self) for s in spec.get("sub_groups", [])
        ]
        # runtime state
        self.running = 0
        self.queue: List[object] = []  # queued query infos (leaf only)
        self.cpu_used_s = 0.0
        self._last_refill = time.monotonic()
        self._last_started = 0.0  # fair-policy recency
        self._rr = 0

    # -- tree helpers --

    def find(self, full_name: str) -> Optional["ResourceGroup"]:
        if self.full_name == full_name:
            return self
        for c in self.children:
            hit = c.find(full_name)
            if hit is not None:
                return hit
        return None

    def _refill_cpu(self):
        if self.cpu_quota_period_s <= 0:
            return
        now = time.monotonic()
        elapsed = now - self._last_refill
        if elapsed > 0 and self.hard_cpu_limit_s > 0:
            refill = elapsed * (self.hard_cpu_limit_s / self.cpu_quota_period_s)
            self.cpu_used_s = max(0.0, self.cpu_used_s - refill)
            self._last_refill = now

    def can_run_more(self) -> bool:
        self._refill_cpu()
        if self.running >= self.hard_concurrency_limit:
            return False
        if self.hard_cpu_limit_s > 0 and self.cpu_used_s >= self.hard_cpu_limit_s:
            return False
        return True

    def queued_count(self) -> int:
        return len(self.queue) + sum(c.queued_count() for c in self.children)

    # -- scheduling --

    def _eligible_children(self) -> List["ResourceGroup"]:
        return [
            c
            for c in self.children
            if c.can_run_more() and c.queued_count() > 0
        ]

    def pop_next(self) -> Optional[object]:
        """Next query this subtree may start, honoring every ancestor's
        limits (caller checked self.can_run_more)."""
        if self.queue:
            if self.scheduling_policy == "query_priority":
                self.queue.sort(
                    key=lambda q: -getattr(q, "priority", 1)
                )
            return self.queue.pop(0)
        elig = self._eligible_children()
        if not elig:
            return None
        if self.scheduling_policy == "weighted":
            # deterministic weighted round-robin: highest credit first
            elig.sort(
                key=lambda c: (-c.scheduling_weight, c._last_started)
            )
        else:  # fair: least-recently-started subgroup first
            elig.sort(key=lambda c: c._last_started)
        for child in elig:
            q = child.pop_next()
            if q is not None:
                child._last_started = time.monotonic()
                return q
        return None

    def on_start(self):
        self.running += 1
        if self.parent:
            self.parent.on_start()

    def on_finish(self, cpu_s: float):
        self.running = max(0, self.running - 1)
        self.cpu_used_s += cpu_s
        if self.parent:
            self.parent.on_finish(cpu_s)

    def stats(self) -> List[GroupStats]:
        out = [
            GroupStats(
                self.full_name, self.running, len(self.queue), self.cpu_used_s
            )
        ]
        for c in self.children:
            out.extend(c.stats())
        return out


@dataclasses.dataclass
class Selector:
    """First-match-wins routing of (user, source) to a group (reference
    StaticSelector in presto-resource-group-managers)."""

    group: str
    user: Optional[str] = None
    source: Optional[str] = None

    def matches(self, user: str, source: Optional[str]) -> bool:
        if self.user is not None and not re.fullmatch(self.user, user or ""):
            return False
        if self.source is not None and not re.fullmatch(
            self.source, source or ""
        ):
            return False
        return True


class ResourceGroupManager:
    """Routes submissions into the group tree and releases them as slots
    free up (reference ResourceGroupManager + InternalResourceGroup.run).

    `dispatch` is called (on the submitting or finishing thread) with each
    query info the moment its group admits it."""

    def __init__(
        self,
        root_spec: dict,
        selectors: Optional[List[dict]] = None,
        dispatch: Optional[Callable[[object], None]] = None,
        poll_interval_s: float = 0.2,
        cluster_pressure: Optional[Callable[[], bool]] = None,
    ):
        self.root = ResourceGroup(root_spec)
        self.selectors = [Selector(**s) for s in (selectors or [])]
        self.dispatch = dispatch or (lambda info: None)
        # memory-pressure gate (the admission rung of the degradation
        # ladder): while the cluster memory manager reports usage above
        # the revocation watermark, new queries QUEUE instead of starting
        # (reference: ClusterMemoryManager's lastKilledQuery admission
        # backoff). Typically ClusterMemoryManager.above_watermark.
        self.cluster_pressure = cluster_pressure
        self.pressure_deferrals = 0  # submissions queued due to pressure
        self._lock = threading.Lock()
        self._groups_of: Dict[str, ResourceGroup] = {}
        # periodic drain: CPU quotas refill with TIME (and memory
        # pressure clears with time), not with query completions, so
        # queued queries need a ticker to wake them (reference:
        # ResourceGroupManager's scheduled processQueuedQueries)
        if self._has_cpu_quota(self.root) or cluster_pressure is not None:
            t = threading.Thread(
                target=self._poll_loop, args=(poll_interval_s,), daemon=True
            )
            t.start()

    def _under_pressure(self) -> bool:
        if self.cluster_pressure is None:
            return False
        try:
            return bool(self.cluster_pressure())
        except Exception:  # noqa: BLE001 - a broken gauge must not wedge
            return False  # admission (fail open, the killer still guards)

    @staticmethod
    def _has_cpu_quota(group: ResourceGroup) -> bool:
        if group.hard_cpu_limit_s > 0:
            return True
        return any(
            ResourceGroupManager._has_cpu_quota(c) for c in group.children
        )

    def _poll_loop(self, interval: float):
        while True:
            time.sleep(interval)
            with self._lock:
                released = self._drain_eligible_locked()
            for q in released:
                self.dispatch(q)

    def _select(self, user: str, source: Optional[str]) -> ResourceGroup:
        for sel in self.selectors:
            if sel.matches(user, source):
                g = self.root.find(sel.group)
                if g is not None:
                    return g
        return self.root

    def submit(self, info) -> None:
        """Queue or immediately dispatch. Raises QueryRejected when the
        selected group's queue is full."""
        released = []
        with self._lock:
            group = self._select(
                getattr(info, "user", "user"), getattr(info, "source", None)
            )
            self._groups_of[info.query_id] = group
            chain_ok = True
            g = group
            while g is not None:
                if not g.can_run_more():
                    chain_ok = False
                    break
                g = g.parent
            if chain_ok and self._under_pressure():
                # cluster above the revocation watermark: queue instead
                # of piling more reservations onto a straining fleet
                chain_ok = False
                self.pressure_deferrals += 1
            if chain_ok and not group.queue:
                group.on_start()
                released.append(info)
            else:
                if len(group.queue) >= group.max_queued:
                    self._groups_of.pop(info.query_id, None)
                    raise QueryRejected(
                        f"queue full for resource group {group.full_name!r} "
                        f"(max_queued={group.max_queued})"
                    )
                # FIFO within the group: earlier queued queries (e.g. held
                # back by an exhausted CPU quota that has since refilled)
                # start before this one
                group.queue.append(info)
                released.extend(self._drain_eligible_locked())
        for q in released:
            self.dispatch(q)

    def _drain_eligible_locked(self) -> List[object]:
        out = []
        while self.root.can_run_more() and not self._under_pressure():
            nxt = self.root.pop_next()
            if nxt is None:
                break
            g = self._groups_of.get(nxt.query_id)
            if g is None:  # canceled while queued
                continue
            g.on_start()
            out.append(nxt)
        return out

    def finished(self, info, cpu_s: float) -> None:
        """Release the slot and start whatever became eligible."""
        self.finished_by_id(info.query_id, cpu_s)

    def finished_by_id(self, query_id: str, cpu_s: float) -> None:
        """Release by id — usable when the QueryInfo itself was already
        purged from coordinator history."""
        with self._lock:
            group = self._groups_of.pop(query_id, None)
            if group is None:
                return
            group.on_finish(cpu_s)
            released = self._drain_eligible_locked()
        for q in released:
            self.dispatch(q)

    def remove_queued(self, info) -> bool:
        with self._lock:
            group = self._groups_of.get(info.query_id)
            if group is not None and info in group.queue:
                group.queue.remove(info)
                self._groups_of.pop(info.query_id, None)
                return True
        return False

    def stats(self) -> List[GroupStats]:
        with self._lock:
            return self.root.stats()
