"""Device-memory accounting for query execution (torch counterpart of
presto_tpu/exec/memory.py).

Re-designed equivalent of the reference's node memory management
(presto-main/.../memory/MemoryPool.java:43 reserve/reserveRevocable): one
pool per query tracking the card-resident page bytes the streaming executor
holds (build sides, accumulator state, sort and window inputs). Those
bytes are "revocable": the streaming executor (exec/stream.py) offloads them to pinned
host memory and from there to the disk spill tier (exec/spill.py,
exec/spillspace.py).

Enforcement is cooperative: the executor asks BEFORE it materializes
(`reserve` raises MemoryExceededError, `can_accumulate` answers False) and
then takes a bounded strategy (offload, chunked or partitioned build)
instead of blocking on a future as the reference does. Bytes are counted
by exec/stats.py page_device_bytes: every tensor of a page's blocks, at
capacity.

Cooperative revocation (the MemoryRevokingScheduler analog,
execution/MemoryRevokingScheduler.java:46): `request_revoke()` makes
`can_accumulate` answer False, so the executor's accumulators take their
offload path at the next batch boundary and then call `note_revoked`.

Over-frees (freeing more than is reserved) are COUNTED, not silently
clamped away: a nonzero `over_frees` is a double-free accounting bug.

On a cluster worker a pool mirrors its reservations into the worker's
WorkerMemoryPool (`parent`, server/worker.py), whose execution ledger
`/v1/memory` and the cluster memory manager read, and whose revoking
scheduler asks the largest `revocable_bytes()` first.
"""

from __future__ import annotations

import time
from typing import Optional


class MemoryExceededError(RuntimeError):
    """Query exceeded its device-memory budget (reference
    ExceededMemoryLimitException)."""


# process-wide over-free aggregate: a double-free anywhere is a bug even
# if the owning pool was short-lived
GLOBAL_ACCOUNTING = {"over_frees": 0, "over_freed_bytes": 0}


class MemoryPool:
    def __init__(self, max_bytes: Optional[int] = None, name: str = "query",
                 parent=None, query_id: str = ""):
        self.max_bytes = max_bytes
        self.name = name
        self.parent = parent  # server.worker.WorkerMemoryPool, or None
        self.query_id = query_id or name
        self.reserved = 0
        self.peak = 0
        self.over_frees = 0
        self.over_freed_bytes = 0
        self.revocations = 0  # completed revoke cycles
        self.accumulated = 0  # executor-held device bytes not yet reserved
        self._revoke_requested_at: Optional[float] = None
        self.revoke_grace_s = 5.0

    # -- reservation --

    def can_reserve(self, nbytes: int) -> bool:
        return self.max_bytes is None or self.reserved + nbytes <= self.max_bytes

    def can_accumulate(self, nbytes: int) -> bool:
        """May the executor keep accumulating device state? False while a
        revoke is pending: the accumulator then takes its offload path
        (host, then disk) exactly as if the budget ran out."""
        if self.revoke_pending:
            return False
        return self.can_reserve(nbytes)

    def reserve(self, nbytes: int, what: str = "") -> int:
        if not self.can_reserve(nbytes):
            raise MemoryExceededError(
                f"{self.name}: reserving {nbytes:,}B for {what or 'pages'} "
                f"exceeds budget ({self.reserved:,}B reserved of "
                f"{self.max_bytes:,}B)"
            )
        self.reserved += nbytes
        self.peak = max(self.peak, self.reserved)
        if self.parent is not None:
            self.parent.reserve_execution(self.query_id, nbytes)
        return nbytes

    def free(self, nbytes: int) -> None:
        if nbytes > self.reserved:
            self.over_frees += 1
            over = nbytes - self.reserved
            self.over_freed_bytes += over
            GLOBAL_ACCOUNTING["over_frees"] += 1
            GLOBAL_ACCOUNTING["over_freed_bytes"] += over
            nbytes = self.reserved
        self.reserved -= nbytes
        if self.parent is not None and nbytes:
            self.parent.free_execution(self.query_id, nbytes)

    # -- revocation (cooperative; see exec/stream.py accumulators) --

    @property
    def revoke_pending(self) -> bool:
        t = self._revoke_requested_at
        if t is None:
            return False
        if time.monotonic() - t > self.revoke_grace_s:
            # the executor never reached a revocation point: expire the
            # request so a healthy query is not forced to spill forever
            self._revoke_requested_at = None
            return False
        return True

    def request_revoke(self) -> bool:
        """Ask the executor to offload revocable state at its next batch
        boundary. Returns True when a new request was armed."""
        if self._revoke_requested_at is not None:
            return False
        self._revoke_requested_at = time.monotonic()
        return True

    def note_revoked(self, nbytes: int) -> None:
        """The executor offloaded `nbytes` of device state; completes a
        pending revoke request (a no-op when none is pending)."""
        if self._revoke_requested_at is not None:
            self._revoke_requested_at = None
            self.revocations += 1

    def revocable_bytes(self) -> int:
        """Bytes a revoke could free: accumulator-held pages plus reserved
        operator state (the worker revokes the largest first)."""
        return self.accumulated + self.reserved

    def snapshot(self) -> dict:
        return {
            "name": self.name,
            "max_bytes": self.max_bytes,
            "reserved": self.reserved,
            "peak": self.peak,
            "accumulated": self.accumulated,
            "over_frees": self.over_frees,
            "over_freed_bytes": self.over_freed_bytes,
            "revocations": self.revocations,
            "revoke_pending": self.revoke_pending,
        }
