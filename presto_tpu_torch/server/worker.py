"""Worker server: task execution and pull-based output buffers over HTTP
(torch counterpart of presto_tpu/server/worker.py).

Re-designed equivalent of the reference's worker surface: TaskResource
(`POST /v1/task/{id}`, server/TaskResource.java:120), SqlTaskExecution
running a PlanFragment, partitioned output buffers
(execution/buffer/PartitionedOutputBuffer) and the pull protocol
`GET /v1/task/{id}/results/{bufferId}/{token}` (TaskResource.java:239).

Pages move between processes as PTP2 bytes (server/serde.py). A task's
fragment is a pickled subtree of port plan nodes whose exchange inputs are
RemoteSource placeholders, resolved by pulling the upstream buffers; any
tensor in it lands on the worker's device, which is its catalog's. Every
fragment runs through the streaming executor (exec/stream.py), so the
partial aggregates and the joins of a worker reach the card's kernels.

Observability (obs/): `GET /v1/metrics` serves the process's metrics in
Prometheus text. A task whose spec carries a trace context records a task
span under the coordinator's dispatch span, with its wait split into
synthetic child spans (the executor's wall and, inside it, the wait on
empty staging with the pullers' HTTP and decode walls; the emission's
wall and, inside it, the encode); the spans travel home in the task
status and merge into the coordinator's trace. Serving the task's
results is timed too (blocked for a page, and sending), and every status
carries those times on the task span.
"""

from __future__ import annotations

import base64
import dataclasses
import io
import json
import pickle
import random
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..exec.dynfilter import HostFilterAccumulator, filter_from_summary
from ..exec.executor import Executor
from ..exec.memory import GLOBAL_ACCOUNTING
from ..exec.spillspace import SPILL_MANAGER, SpillSpaceManager
from ..exec.stream import StreamingExecutor, coalesce_pages
from ..exec.taskqueue import MultilevelScheduler
from ..ops.filter import compact
from ..ops.union import concat_pages
from ..page import Page, _pad_block, round_capacity
from ..parallel.exchange import route
from ..plan import nodes as N
from ..session import resolve_device
from . import knobs
from .exchange import ExchangeClient, ExchangeStats, ack_pages, fetch_pages
from .hier import HierExchangeStats, hier_negotiated, hier_partition
from .serde import DictionaryCache, WireStats, baseline_capabilities, serialize_page


@dataclasses.dataclass(frozen=True)
class RemoteSource(N.PlanNode):
    """Placeholder for an exchange input materialized by pulling upstream
    task buffers (reference RemoteSourceNode)."""

    source_id: str
    schema: Tuple[Tuple[str, object], ...]  # (channel, Type)

    @property
    def fields(self):
        return self.schema


# ---------------------------------------------------------------------------
# fragments on the wire: pickled plan nodes, tensors carried as numpy
# ---------------------------------------------------------------------------

_LOAD = threading.local()


def _tensor_from_wire(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(arr)).to(getattr(_LOAD, "device", "cpu"))


class _FragmentPickler(pickle.Pickler):
    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            return _tensor_from_wire, (obj.detach().cpu().numpy(),)
        return NotImplemented


def dumps_fragment(node) -> str:
    """A plan subtree as base64 text for a task spec."""
    buf = io.BytesIO()
    _FragmentPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(node)
    return base64.b64encode(buf.getvalue()).decode()


def loads_fragment(text: str, device):
    """The plan subtree of `dumps_fragment`, its tensors on `device`."""
    _LOAD.device = torch.device(device)
    try:
        return pickle.loads(base64.b64decode(text))
    finally:
        del _LOAD.device


class QueryKilledError(RuntimeError):
    """Raised into blocked tasks when the cluster memory manager kills
    their query (reference ExceededMemoryLimitException from
    LowMemoryKiller)."""


class WorkerMemoryPool:
    """Worker-wide memory accounting (reference: the worker MemoryPool
    polled by ClusterMemoryManager.process, memory/ClusterMemoryManager
    .java:89).

    Two ledgers share one limit:
    * OUTPUT buffers (`reserve`/`free`): reservations past the limit BLOCK
      until space frees, a revocation frees executor state, or the cluster
      memory manager kills a query;
    * EXECUTION state (`reserve_execution`/`free_execution`): build tables,
      accumulator state and pending bytes mirrored from each task's
      executor pool (exec/memory.py parent mirroring), counted against the
      limit and the watermark so `/v1/memory` and the killer see real use.

    Crossing the revocation watermark asks running executors to revoke
    (offload, then disk spill) largest revocable first (the
    MemoryRevokingScheduler analog, MemoryRevokingScheduler.java:46),
    before anything blocks long enough for the killer to fire."""

    def __init__(self, limit: Optional[int] = None, revoke_watermark: Optional[float] = None):
        self.limit = limit
        self.revoke_watermark = (knobs.revoke_watermark() if revoke_watermark is None
                                 else revoke_watermark)
        self.reserved = 0  # output-buffer bytes
        self.by_query: Dict[str, int] = {}
        self.exec_reserved = 0  # executor-held bytes (mirrored)
        self.exec_by_query: Dict[str, int] = {}
        self.blocked: set = set()  # query ids waiting now
        self.over_frees = 0  # double frees, counted, never clamped silently
        self.over_freed_bytes = 0
        # exec reservations force-released at task end: nonzero is a leak
        self.leaked_exec_bytes = 0
        self.revocations_requested = 0
        self.watermark_breaches = 0
        self._revocations_base = 0  # completed, from unregistered pools
        self._exec_pools: Dict[int, object] = {}
        self._cond = threading.Condition()

    # -- execution ledger --

    def register_exec_pool(self, pool) -> None:
        with self._cond:
            self._exec_pools[id(pool)] = pool

    def unregister_exec_pool(self, pool) -> None:
        """Detach a finished task's pool; bytes it still holds are a leak:
        release them so the worker stays healthy, and count them."""
        with self._cond:
            self._exec_pools.pop(id(pool), None)
            self._revocations_base += pool.revocations
        leaked = pool.reserved
        if leaked:
            with self._cond:
                self.leaked_exec_bytes += leaked
            self.free_execution(pool.query_id, leaked)

    def reserve_execution(self, query_id: str, nbytes: int) -> None:
        with self._cond:
            self.exec_reserved += nbytes
            self.exec_by_query[query_id] = self.exec_by_query.get(query_id, 0) + nbytes
            if (self.limit is not None
                    and self.reserved + self.exec_reserved > self.revoke_watermark * self.limit):
                self._request_revocations_locked(0)

    def _over_free(self, nbytes: int, held: int) -> int:
        if nbytes > held:
            self.over_frees += 1
            self.over_freed_bytes += nbytes - held
            GLOBAL_ACCOUNTING["over_frees"] += 1
            GLOBAL_ACCOUNTING["over_freed_bytes"] += nbytes - held
            return held
        return nbytes

    def free_execution(self, query_id: str, nbytes: int) -> None:
        with self._cond:
            nbytes = self._over_free(nbytes, self.exec_reserved)
            self.exec_reserved -= nbytes
            left = self.exec_by_query.get(query_id, 0) - nbytes
            if left > 0:
                self.exec_by_query[query_id] = left
            else:
                self.exec_by_query.pop(query_id, None)
            self._cond.notify_all()

    def total_reserved(self) -> int:
        with self._cond:
            return self.reserved + self.exec_reserved

    # -- revocation: the rung between "blocked" and "killed" --

    def _request_revocations_locked(self, need: int) -> None:
        """Ask executors to revoke until the projected freeing covers the
        excess over the watermark, largest revocable first (reference
        MemoryRevokingScheduler.requestMemoryRevoking)."""
        if self.limit is None:
            return
        excess = (self.reserved + self.exec_reserved + need
                  - int(self.revoke_watermark * self.limit))
        if excess <= 0:
            return
        self.watermark_breaches += 1
        for pool in sorted(self._exec_pools.values(), key=lambda p: -p.revocable_bytes()):
            if excess <= 0:
                break
            if pool.request_revoke():
                self.revocations_requested += 1
            # a pool with nothing revocable right now is asked all the
            # same: its next accumulation window offloads instead of growing
            excess -= max(pool.revocable_bytes(), 1)

    def revocations_completed(self) -> int:
        with self._cond:
            return self._revocations_base + sum(p.revocations for p in self._exec_pools.values())

    # -- output-buffer ledger --

    def reserve(self, query_id: str, nbytes: int, abort: threading.Event,
                timeout: float = 600.0) -> None:
        if self.limit is None:
            with self._cond:
                self.reserved += nbytes
                self.by_query[query_id] = self.by_query.get(query_id, 0) + nbytes
            return
        deadline = time.time() + timeout
        with self._cond:
            while self.reserved + self.exec_reserved + nbytes > self.limit:
                if abort.is_set():
                    self.blocked.discard(query_id)
                    raise QueryKilledError("Query killed: the cluster ran out of memory "
                                           "(TotalReservation low-memory killer)")
                if time.time() > deadline:
                    self.blocked.discard(query_id)
                    raise MemoryError(
                        f"worker memory exhausted: {nbytes:,}B requested, "
                        f"{self.reserved:,}B of {self.limit:,}B reserved")
                # revoke before kill: ask executors to free revocable state
                self._request_revocations_locked(nbytes)
                self.blocked.add(query_id)
                self._cond.wait(timeout=0.05)
            self.blocked.discard(query_id)
            self.reserved += nbytes
            self.by_query[query_id] = self.by_query.get(query_id, 0) + nbytes
            # buffer growth alone can cross the watermark
            self._request_revocations_locked(0)

    def free(self, query_id: str, nbytes: int) -> None:
        with self._cond:
            nbytes = self._over_free(nbytes, self.reserved)
            self.reserved -= nbytes
            left = self.by_query.get(query_id, 0) - nbytes
            if left > 0:
                self.by_query[query_id] = left
            else:
                self.by_query.pop(query_id, None)
            self._cond.notify_all()

    def wake(self) -> None:
        with self._cond:
            self._cond.notify_all()

    def snapshot(self) -> dict:
        with self._cond:
            queries: Dict[str, int] = dict(self.by_query)
            for qid, nbytes in self.exec_by_query.items():
                queries[qid] = queries.get(qid, 0) + nbytes
            return {
                "limit": self.limit,
                # buffers plus executor-held bytes: the killer acts on real use
                "reserved": self.reserved + self.exec_reserved,
                "buffer_reserved": self.reserved,
                "exec_reserved": self.exec_reserved,
                "queries": queries,
                "buffers": dict(self.by_query),
                "execution": dict(self.exec_by_query),
                "blocked": sorted(self.blocked),
                "over_frees": self.over_frees,
                "over_freed_bytes": self.over_freed_bytes,
                "leaked_exec_bytes": self.leaked_exec_bytes,
                "revocations": {
                    "watermark_breaches": self.watermark_breaches,
                    "requested": self.revocations_requested,
                    "completed": self._revocations_base + sum(
                        p.revocations for p in self._exec_pools.values()),
                    "pending": any(p.revoke_pending for p in self._exec_pools.values()),
                },
                "watermark": self.revoke_watermark,
            }


class OutputBuffers:
    """Bounded, ack-consumed task output buffers (reference
    PartitionedOutputBuffer + OutputBufferMemoryManager): producers append
    page at a time and BLOCK while unacknowledged bytes exceed the bound
    (backpressure); consumers pull by token and acknowledge, which frees
    producer budget. Bytes are also accounted in the worker pool, so the
    cluster memory manager sees them."""

    def __init__(self, pool: WorkerMemoryPool, query_id: str, abort: threading.Event,
                 bound: Optional[int] = None):
        self.pool = pool
        self.query_id = query_id
        self.abort = abort
        self.bound = bound
        self._pages: Dict[int, List[Optional[bytes]]] = {}
        self._unacked = 0
        self._finished = False
        self._drained = False
        self._cond = threading.Condition()

    def put(self, buffer_id: int, data: bytes, timeout: float = 600.0) -> None:
        deadline = time.time() + timeout
        with self._cond:
            while self.bound is not None and self._unacked + len(data) > max(self.bound,
                                                                              len(data)):
                if self.abort.is_set():
                    raise QueryKilledError("Query killed: the cluster ran out of memory "
                                           "(TotalReservation low-memory killer)")
                if time.time() > deadline:
                    raise MemoryError("output buffer consumer stalled past the bound")
                self._cond.wait(timeout=0.05)
            if self._drained:
                raise QueryKilledError("task deleted while producing")
            # claim the bound under the same lock as the check, so
            # concurrent producers cannot all pass it and overshoot
            self._unacked += len(data)
        try:
            self.pool.reserve(self.query_id, len(data), self.abort)
        except BaseException:
            with self._cond:
                if not self._drained:  # drain() already zeroed _unacked
                    self._unacked -= len(data)
                self._cond.notify_all()
            raise
        with self._cond:
            if self._drained:
                # deleted mid-stream: hand the bytes straight back
                self.pool.free(self.query_id, len(data))
                raise QueryKilledError("task deleted while producing")
            self._pages.setdefault(buffer_id, []).append(data)
            self._cond.notify_all()

    def finish(self) -> None:
        with self._cond:
            self._finished = True
            self._cond.notify_all()

    def get(self, buffer_id: int, token: int, timeout: float = 60.0):
        """(serialized page | None, complete, ready): ready False means
        poll again (the page is not produced yet)."""
        with self._cond:
            deadline = time.time() + timeout
            while True:
                pages = self._pages.get(buffer_id, [])
                if token < len(pages):
                    if pages[token] is None:
                        raise RuntimeError(f"buffer {buffer_id} token {token} was already "
                                           "acknowledged (exchange protocol violation)")
                    return pages[token], False, True
                if self._finished:
                    return None, True, True
                if time.time() > deadline:
                    return None, False, False
                self._cond.wait(timeout=0.1)

    def get_many(self, buffer_id: int, token: int, max_bytes: int, timeout: float = 60.0):
        """([serialized pages], complete, ready): as many consecutive pages
        from `token` as fit `max_bytes` (the reference's
        exchange.max-response-size batching), at least one when one
        exists; `complete` when the batch drains a finished buffer."""
        first, complete, ready = self.get(buffer_id, token, timeout=timeout)
        if not ready or first is None:
            return [], complete, ready
        out = [first]
        total = len(first)
        with self._cond:
            pages = self._pages.get(buffer_id, [])
            t = token + 1
            while t < len(pages) and total < max_bytes:
                p = pages[t]
                if p is None:
                    raise RuntimeError(f"buffer {buffer_id} token {t} was already "
                                       "acknowledged (exchange protocol violation)")
                out.append(p)
                total += len(p)
                t += 1
            complete = self._finished and t >= len(pages)
        return out, complete, True

    def ack(self, buffer_id: int, upto_token: int) -> None:
        """Acknowledge pages [0, upto_token): their bytes free the bound
        and the worker pool."""
        with self._cond:
            pages = self._pages.get(buffer_id, [])
            freed = 0
            for i in range(min(upto_token, len(pages))):
                if pages[i] is not None:
                    freed += len(pages[i])
                    pages[i] = None
            if freed:
                self._unacked -= freed
                self._cond.notify_all()
        if freed:
            self.pool.free(self.query_id, freed)

    def drain(self) -> None:
        """Free everything still held (task deleted); later puts are
        refused, so a producer mid-stream cannot leak reservations."""
        with self._cond:
            self._drained = True
            freed = sum(len(p) for pages in self._pages.values() for p in pages
                        if p is not None)
            self._pages.clear()
            self._unacked = 0
            self._cond.notify_all()
        if freed:
            self.pool.free(self.query_id, freed)


class TaskState:
    def __init__(self, query_id: str = ""):
        self.state = "RUNNING"
        self.error: Optional[str] = None
        # structured cause the coordinator classifies (_classify_failure)
        self.error_info: Optional[dict] = None
        self.buffers: Optional[OutputBuffers] = None
        self.done = threading.Event()
        self.query_id = query_id
        self.abort = threading.Event()  # set by the low-memory killer
        # dynamic-filter summaries over this task's output, read by the
        # coordinator through the status endpoint
        self.dyn_filters: dict = {}
        # encode stats of this task's output, pull stats of its sources
        self.wire_stats = WireStats()
        self.pull_stats = None
        self.hier_stats = None
        # filled at task end: the executor pool snapshot and spill stats
        self.executor = None
        self.spill_space = None
        self.memory_stats: Optional[dict] = None
        self.spill_stats: Optional[dict] = None
        # host wall of the task thread: inside the executor (pulls
        # included) and emitting (partitioning, serializing, buffering)
        self.exec_s = 0.0
        self.emit_s = 0.0
        # host wall of the results handler threads: blocked until a page
        # of this task was ready, and encoding and sending responses
        self.serve_lock = threading.Lock()
        self.serve_wait_s = 0.0
        self.serve_send_s = 0.0
        # this task's spans (obs/span.py dicts), filled at task end
        self.spans: List[dict] = []

    def served(self, wait_s: float, send_s: float) -> None:
        with self.serve_lock:
            self.serve_wait_s += wait_s
            self.serve_send_s += send_s

    def span_dicts(self) -> List[dict]:
        """The task's spans with the serving walls so far on its task
        span (the last status of a task, polled after its consumers
        finished, carries the final ones)."""
        if not self.spans:
            return []
        out = [dict(d) for d in self.spans]
        with self.serve_lock:
            out[0]["attrs"] = dict(out[0]["attrs"],
                                   serve_wait_ms=round(self.serve_wait_s * 1e3, 3),
                                   serve_send_ms=round(self.serve_send_s * 1e3, 3))
        return out


# message fragments of failures that would recur identically on any
# worker: retrying them only spends the retry budget
_FATAL_MARKERS = (
    "Query killed",  # the low-memory killer chose this query
    "memory exhausted",  # the worker pool limit: a retry would exceed it too
    "protocol violation",
    "not yet supported",
    "not ported yet",  # the port's NotPortedError and unported plan nodes
    # the disk spill tier (exec/spillspace.py): another worker would hit
    # the same quota, and a corrupt spill file must fail the query
    "spill quota exceeded",
    "spill file corrupt",
)

# fragments naming a fault of a kernel on the card (a CUDA error, a launch
# refused, a kernel library that did not build): retryable on another
# worker, where the fault may not recur
_KERNEL_FAULT_MARKERS = (
    "CUDA error", "cudaError", "KernelBuildError", "CUBLAS_STATUS", "device-side assert",
    "kernel launch",
)


def _classify_failure(exc: BaseException) -> dict:
    """Serialize an exception into the structured error the coordinator's
    retry policy reads (reference ExecutionFailureInfo + ErrorCode
    retryability, spi/StandardErrorCode.java)."""
    text = f"{type(exc).__name__}: {exc}"
    retryable = not any(m in text for m in _FATAL_MARKERS)
    # NotImplementedError (an unsorted dictionary under ORDER BY, say) recurs
    # on any worker: the JAX package retries it and blacklists the fleet
    if isinstance(exc, (QueryKilledError, MemoryError, NotImplementedError)):
        retryable = False
    return {
        "type": type(exc).__name__,
        "message": str(exc)[:500],
        "retryable": retryable,
        "kernelFault": any(m in text for m in _KERNEL_FAULT_MARKERS),
    }


class FragmentExecutor(Executor):
    """Executes a fragment subtree materialized: scans are split-limited,
    RemoteSources read pulled pages (reference SqlTaskExecution +
    LocalExecutionPlanner). The coordinator runs the root fragment so."""

    def __init__(self, catalog, splits, sources, device="cuda"):
        super().__init__(catalog, device=device)
        self.splits = splits or {}
        self.sources = sources or {}
        self.sample_salt = _split_salt(self.splits)

    def _exec_tablescan(self, node: N.TableScan) -> Page:
        rng = self.splits.get(node.table)
        if rng is None:
            return super()._exec_tablescan(node)
        start, stop = rng
        cols = [c for _, c, _ in node.columns]
        src = self.catalog.scan(node.table, start, stop, columns=cols).to(self.device)
        return Page(tuple(src.block(c) for _ch, c, _t in node.columns),
                    tuple(ch for ch, _c, _t in node.columns), src.count)

    def _exec_remotesource(self, node: RemoteSource) -> Page:
        pages = self.sources[node.source_id]
        if not pages:
            raise RuntimeError(f"no pages for source {node.source_id}")
        return pages[0] if len(pages) == 1 else concat_pages(pages)


class StreamingFragmentExecutor(StreamingExecutor):
    """Streaming task execution (reference Driver pipeline fed by an
    ExchangeOperator): scans honor split ranges batch by batch, and
    RemoteSource inputs arrive page at a time from the pull clients. The
    budget-aware sinks compose unchanged, so an upstream stage larger than
    the worker's memory flows through in bounded pieces."""

    def __init__(self, catalog, splits, source_streams, device="cuda",
                 batch_rows: int = 1 << 18, memory_budget: Optional[int] = None,
                 query_id: str = "", worker_pool=None, spill_space=None,
                 coalesce_remote: bool = False):
        super().__init__(catalog, device=device, batch_rows=batch_rows,
                         memory_budget=memory_budget, query_id=query_id,
                         worker_pool=worker_pool, spill_space=spill_space)
        self.splits = splits or {}
        self.source_streams = source_streams or {}
        self.coalesce_remote = coalesce_remote
        # TABLESAMPLE: a per-worker salt from the split assignment, so
        # workers sampling disjoint row ranges never reuse one mask
        self.local.sample_salt = _split_salt(self.splits)

    def stream(self, node: N.PlanNode):
        if isinstance(node, RemoteSource):
            pages = self.source_streams[node.source_id]()
            if self.coalesce_remote:
                # the hierarchical exchange ships ragged slivers: coalesce
                # them into full batches of `batch_rows`, so the operators
                # launch once per batch, not once per sliver (the JAX
                # package coalesces to 4 wire pages, 8,192 rows)
                pages = coalesce_pages(pages, self.batch_rows)
            yield from pages
            return
        yield from super().stream(node)

    def _stream_scan(self, node: N.TableScan, predicate=None):
        rng = self.splits.get(node.table)
        if rng is None:
            yield from super()._stream_scan(node, predicate)
            return
        start, stop = rng
        cols = [c for _, c, _ in node.columns]
        B = self.batch_rows
        pos = start
        first = True
        while pos < stop or first:
            # split bounds are exact, so pruning hints stay safe (a pruned
            # short batch is never taken for the end of the table)
            hi = min(pos + B, stop)
            src = self.catalog.scan(node.table, pos, hi, pad_to=round_capacity(max(hi - pos, 1)),
                                    columns=cols, predicate=predicate)
            yield self._scan_out(node, self._rename_scan(node, src))
            first = False
            pos += B


class WorkerServer:
    """One worker: executes tasks against its own catalog (catalogs must be
    deterministic across nodes, as the TPC-H generator and files are) on
    the catalog's device. A worker on the card raises without one."""

    def __init__(self, catalog, host: str = "127.0.0.1", port: int = 0,
                 memory_limit: Optional[int] = None,
                 buffer_bound: Optional[int] = 32 << 20,
                 task_concurrency: int = 2,
                 fault_rate: float = 0.0,
                 task_timeout: Optional[float] = None,
                 wire_caps: Optional[dict] = None,
                 exec_budget: Optional[int] = None,
                 revoke_watermark: Optional[float] = None,
                 spill_dir: Optional[str] = None,
                 spill_node_quota: Optional[int] = None,
                 spill_query_quota: Optional[int] = None):
        self.catalog = catalog
        self.device = resolve_device(getattr(catalog, "device", "cuda"))
        # per-task device budget of the streaming executor: past it,
        # operator state offloads to host memory, then to the disk tier
        self.exec_budget = exec_budget
        if spill_dir or spill_node_quota or spill_query_quota:
            self.spill = SpillSpaceManager(directory=spill_dir, node_quota=spill_node_quota,
                                           query_quota=spill_query_quota)
        else:
            self.spill = SPILL_MANAGER
        # capability advert override (tests: an old node, or one without
        # a codec, in an in-process fleet)
        self.wire_caps = wire_caps
        # fault injection: the probability that a task fails at start
        self.fault_rate = float(fault_rate)
        # wall ceiling per task, checked between batches
        self.task_timeout = task_timeout
        self.tasks: Dict[str, TaskState] = {}
        self.pool = WorkerMemoryPool(memory_limit, revoke_watermark=revoke_watermark)
        self.buffer_bound = buffer_bound
        # multilevel feedback gate over per-batch quanta (reference
        # TaskExecutor + MultilevelSplitQueue)
        self.scheduler = MultilevelScheduler(task_concurrency)
        self._task_threads: List[threading.Thread] = []
        self._httpd = ThreadingHTTPServer((host, port), _handler_for(self))
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self.node_id = f"{self.host}:{self.port}"
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True,
                                        name=f"ptpu-worker-{self.port}")

    # -- task execution --

    def _start_task(self, task_id: str, spec: dict):
        state = TaskState(query_id=spec.get("query_id") or task_id)
        self.tasks[task_id] = state
        t = threading.Thread(target=self._run_task, args=(task_id, spec, state), daemon=True,
                             name=f"ptpu-task-{task_id}")
        self._task_threads = [x for x in self._task_threads if x.is_alive()] + [t]
        t.start()

    def _source_streams(self, spec: dict, state: TaskState):
        if spec.get("sources"):
            state.pull_stats = ExchangeStats()

        def make_stream(locations, exclusive):
            def gen():
                # one puller per producer task, decoding onto this worker's
                # device while the next responses are in flight; acks free
                # producer pages, safe only for the buffer's sole consumer
                client = ExchangeClient([(u, t, b) for u, t, b in locations], ack=exclusive,
                                        stats=state.pull_stats, device=self.device)
                for page in client.pages():
                    yield _min_capacity(page)
            return gen

        return {sid: make_stream(src["locations"], bool(src.get("exclusive", True)))
                for sid, src in (spec.get("sources") or {}).items()}

    def _run_task(self, task_id: str, spec: dict, state: TaskState):
        stream_iter = None  # closed in the finally: reservations return first
        # broadcast consumers never ack (pages are shared, freed at the
        # task's DELETE), so a bounded buffer would stall its producer
        bound = None if spec.get("buffer_unbounded") else self.buffer_bound
        buffers = OutputBuffers(self.pool, state.query_id, state.abort, bound=bound)
        state.buffers = buffers
        # the task span opens before fault injection: a failed attempt
        # still ships an error span in its FAILED status, so the merged
        # tree shows the attempt. The trace is standalone (never in the
        # process's TRACES): its only way home is the status payload, in
        # process as across processes
        from ..obs.span import Trace, enabled as trace_enabled

        tctx = spec.get("trace") or {}
        task_trace = task_span = None
        if tctx.get("trace_id") and trace_enabled():
            task_trace = Trace(str(tctx["trace_id"]))
            task_span = task_trace.begin(f"task {task_id}", parent_id=tctx.get("parent"),
                                         worker=self.node_id)
        try:
            if self.fault_rate > 0 and random.random() < self.fault_rate:
                # fault injection, so cluster tests can drive the failure
                # path deterministically
                raise RuntimeError(f"injected fault on worker {self.node_id} "
                                   f"(fault_rate={self.fault_rate})")
            fragment = loads_fragment(spec["fragment"], self.device)
            splits = {t: tuple(rng) for t, rng in (spec.get("splits") or {}).items()}
            # the fleet-negotiated wire: this task's output uses only what
            # every consumer decodes; a spec without it came from a
            # coordinator that does not negotiate, so assume the baseline
            wire_caps = spec.get("wire") or baseline_capabilities()
            streams = self._source_streams(spec, state)
            # per-task spill space under the query id, released below
            spill_space = self.spill.open(state.query_id)
            state.spill_space = spill_space
            ex = StreamingFragmentExecutor(
                self.catalog, splits, streams, device=self.device, memory_budget=self.exec_budget,
                query_id=state.query_id, worker_pool=self.pool, spill_space=spill_space,
                coalesce_remote=(bool(spec.get("sources")) and knobs.hier_exchange_enabled()
                                 and hier_negotiated(wire_caps)))
            state.executor = ex
            self.pool.register_exec_pool(ex.pool)
            # cross-task dynamic filters shipped by the coordinator: a
            # filter that is absent or late stays unpublished and the scan
            # runs unfiltered; a malformed summary raises
            for fid, summary in (spec.get("dyn_filters") or {}).items():
                df = filter_from_summary(summary, None, device=self.device)
                if df is not None:
                    ex.dyn_ctx.publish(fid, df)
            # summaries over THIS task's output (the build side of a join
            # in a downstream stage)
            dyn_accs = {fid: HostFilterAccumulator(channel)
                        for fid, channel in (spec.get("dyn_filter_produce") or [])}
            nparts = int(spec.get("num_partitions", 1))
            keys = (pickle.loads(base64.b64decode(spec["partition_keys"]))
                    if spec.get("partition_keys") and nparts > 1 else None)
            use_hier = (keys is not None and knobs.hier_exchange_enabled()
                        and hier_negotiated(wire_caps))
            # one dictionary cache per output buffer, when every consumer
            # reads its buffers through one (serde's `dict_cache`)
            caches = ({p: DictionaryCache() for p in range(nparts)}
                      if wire_caps.get("dict_cache") else None)
            if use_hier:
                state.hier_stats = HierExchangeStats()
            stream_iter = iter(ex.stream(fragment))
            deadline = time.time() + self.task_timeout if self.task_timeout else None
            while True:
                # checkpoints between batches: an aborted task stops, and one
                # past its deadline fails instead of holding its slot
                if state.abort.is_set():
                    raise QueryKilledError("task aborted")
                if deadline is not None and time.time() > deadline:
                    raise TimeoutError(f"task {task_id} exceeded task_timeout="
                                       f"{self.task_timeout}s on worker {self.node_id}")
                # the batch runs in a scheduler quantum; emitting into the
                # buffers stays outside it (blocking on a slow consumer must
                # not hold an execution slot)
                t0 = time.perf_counter()
                with self.scheduler.quantum(state.query_id):
                    page = next(stream_iter, None)
                state.exec_s += time.perf_counter() - t0
                if page is None:
                    break
                t0 = time.perf_counter()
                for acc in dyn_accs.values():
                    acc.add_page(page)
                self._emit(page, bound, keys, nparts, use_hier, wire_caps, caches, state,
                           buffers)
                state.emit_s += time.perf_counter() - t0
            if dyn_accs:
                state.dyn_filters = {fid: s for fid, acc in dyn_accs.items()
                                     if (s := acc.summary()) is not None}
            state.state = "FINISHED"
        except BaseException as exc:  # noqa: BLE001 - every failure, kernel
            # faults included, becomes a FAILED task with a structured cause
            # the coordinator classifies
            state.error = traceback.format_exc(limit=20)
            state.error_info = _classify_failure(exc)
            state.state = "FAILED"
        finally:
            self._teardown(state, stream_iter, buffers, task_trace, task_span)

    def _emit(self, page, bound, keys, nparts, use_hier, wire_caps, caches, state, buffers):
        """One output batch into the bounded buffers, partitioned or not;
        pages bigger than the bound split into row slices first
        (reference PageSplitterUtil)."""
        for piece in _split_to_bound(page, bound):
            if keys is None:
                buffers.put(0, serialize_page(piece, cache=caches and caches[0], caps=wire_caps,
                                              stats=state.wire_stats))
                continue
            if use_hier:
                parts = hier_partition(piece, keys, nparts, caps=wire_caps,
                                       stats=state.wire_stats, hier=state.hier_stats,
                                       caches=caches)
            else:
                parts = _hash_partition(piece, keys, nparts, caps=wire_caps,
                                        stats=state.wire_stats, caches=caches)
            for p, datas in parts.items():
                for d in datas:
                    buffers.put(p, d)

    def _teardown(self, state: TaskState, stream_iter, buffers: OutputBuffers,
                  task_trace=None, task_span=None) -> None:
        # deterministic teardown: closing the stream runs every suspended
        # generator's finally, returning reservations before unregister
        release_error = None
        if stream_iter is not None:
            try:
                stream_iter.close()
            except Exception as exc:  # noqa: BLE001 - recorded below
                release_error = repr(exc)
        ex = state.executor
        if ex is not None:
            try:
                ex.release_spill()
            except Exception as exc:  # noqa: BLE001 - recorded below
                release_error = repr(exc)
            state.memory_stats = ex.pool.snapshot()
            state.spill_stats = dict(ex.spill_stats)
            state.spill_stats["events"] = sorted(set(ex.spill_events))
            if release_error is not None:
                state.spill_stats["release_error"] = release_error
            self.pool.unregister_exec_pool(ex.pool)
        if state.spill_space is not None:
            state.spill_space.release()  # spill files go on finish, failure and kill
        buffers.finish()
        try:
            self._finish_observability(state, task_trace, task_span)
        finally:
            state.done.set()  # a fault here still ends the task's polls

    @staticmethod
    def _finish_observability(state: TaskState, task_trace, task_span) -> None:
        """Close the task span (pages and bytes from the wire stats, error
        status for FAILED) with its wait split into synthetic child spans,
        into state.spans; fold the task's serde and pull accounting and its
        outcome into the metrics plane."""
        from ..obs.export import (METRICS, export_exchange_stats, export_hier_stats,
                                  export_wire_stats)

        wire = state.wire_stats.snapshot()
        pull = state.pull_stats.snapshot() if state.pull_stats is not None else None
        if task_trace is not None:
            attrs = {"pages": wire["pages"], "bytes": wire["wire_bytes"]}
            if state.error_info:
                attrs["error"] = str(state.error_info.get("message", ""))[:200]
            if state.hier_stats is not None:
                hs = state.hier_stats.snapshot()
                if hs["exchanges"]:
                    attrs["hier_collective_ms"] = hs["collective_ms"]
                    attrs["hier_wire_pages"] = hs["wire_pages"]
            if pull is not None and pull["pull_ms"]:
                attrs["wire_ms"] = pull["pull_ms"]
                attrs["wire_hidden_ms"] = pull["hidden_ms"]
            # the task's wall split: inside the executor, the wait on empty
            # staging and the pullers' HTTP and decode walls (on their own
            # threads, so they may exceed the wait); emitting, the encode
            ex_span = task_trace.add_synthetic("exec", task_span, state.exec_s)
            if pull is not None:
                wait = task_trace.add_synthetic("wait", ex_span, pull["consumer_wait_ms"] / 1e3,
                                                pages=pull["pages"], bytes=pull["wire_bytes"],
                                                responses=pull["responses"])
                task_trace.add_synthetic("pull", wait, pull["pull_ms"] / 1e3)
                task_trace.add_synthetic("decode", wait, pull["decode_ms"] / 1e3)
            emit = task_trace.add_synthetic("emit", task_span, state.emit_s)
            task_trace.add_synthetic("encode", emit, wire["encode_ms"] / 1e3,
                                     pages=wire["pages"], raw_bytes=wire["raw_bytes"])
            task_trace.finish(task_span, status="error" if state.state == "FAILED" else "ok",
                              **attrs)
            # the task span first: span_dicts() adds the serving walls to it
            spans = task_trace.to_dicts()
            spans.sort(key=lambda d: d["span_id"] != task_span.span_id)
            state.spans = spans
        METRICS.counter("presto_worker_tasks_total", 1, {"state": state.state},
                        help="Worker tasks run")
        export_wire_stats("task_encode", state.wire_stats)
        if state.pull_stats is not None:
            export_exchange_stats(state.pull_stats)
        if state.hier_stats is not None:
            export_hier_stats(state.hier_stats)

    def start(self) -> "WorkerServer":
        self._thread.start()
        return self

    def kill_query(self, query_id: str) -> None:
        for t in list(self.tasks.values()):
            if t.query_id == query_id:
                t.abort.set()
        self.pool.wake()

    def stop(self, timeout: float = 30.0):
        """Stop serving, abort the tasks left and wait for their threads."""
        self._httpd.shutdown()
        self._httpd.server_close()
        for t in list(self.tasks.values()):
            t.abort.set()
            if t.buffers is not None:
                t.buffers.drain()
        self.pool.wake()
        for th in self._task_threads:
            th.join(timeout=timeout)
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)

    @property
    def uri(self) -> str:
        return f"http://{self.host}:{self.port}"


def _handler_for(outer: WorkerServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            pass

        def _send(self, code, payload):
            body = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            parts = [p for p in self.path.split("/") if p]
            if parts[:2] == ["v1", "task"] and len(parts) == 3:
                # a malformed spec answers 500 with a structured error and
                # never tears down the connection
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    outer._start_task(parts[2], json.loads(self.rfile.read(n)))
                except Exception as exc:  # noqa: BLE001 - answered as a 500
                    self._send(500, {"error": traceback.format_exc(limit=10),
                                     "errorInfo": _classify_failure(exc)})
                    return
                self._send(200, {"taskId": parts[2], "state": "RUNNING"})
                return
            self._send(404, {"error": "not found"})

        def do_GET(self):
            try:
                self._do_get()
            except (BrokenPipeError, ConnectionResetError):
                raise
            except Exception:  # noqa: BLE001 - a handler bug answers 500
                self._send(500, {"error": traceback.format_exc(limit=10)})

        def _do_get(self):
            path, _, query = self.path.partition("?")
            parts = [p for p in path.split("/") if p]
            if parts == ["v1", "status"]:
                # the capability handshake: the coordinator intersects every
                # member's advert and ships the result in task specs
                from ..exec import qcache
                from .serde import local_capabilities

                self._send(200, {"state": "ACTIVE", "wire": outer.wire_caps or local_capabilities(),
                                 "device": str(outer.device), "caches": qcache.snapshot_all()})
                return
            if parts == ["v1", "metrics"]:
                # Prometheus text of this process's registry: an in-process
                # fleet shares one plane, a worker process exposes its own
                from ..obs.metrics import METRICS

                body = METRICS.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if parts == ["v1", "memory"]:
                # reference MemoryResource: both ledgers, the revocation
                # counters and the disk spill tier
                snap = outer.pool.snapshot()
                snap["spill"] = outer.spill.snapshot()
                self._send(200, snap)
                return
            if parts[:2] == ["v1", "task"] and len(parts) == 3:
                t = outer.tasks.get(parts[2])
                if t is None:
                    self._send(404, {"error": "unknown task"})
                    return
                t.done.wait(timeout=0.5)  # short poll: consumers pipeline
                # against running producers
                ex_stats = t.wire_stats.snapshot()
                if t.pull_stats is not None:
                    ex_stats["pull"] = t.pull_stats.snapshot()
                if t.hier_stats is not None:
                    ex_stats["hier"] = t.hier_stats.snapshot()
                self._send(200, {"state": t.state, "error": t.error, "errorInfo": t.error_info,
                                 "dynFilters": t.dyn_filters or None, "exchangeStats": ex_stats,
                                 "memoryStats": t.memory_stats, "spillStats": t.spill_stats,
                                 "timing": {"exec_ms": round(t.exec_s * 1e3, 2),
                                            "emit_ms": round(t.emit_s * 1e3, 2),
                                            "serve_wait_ms": round(t.serve_wait_s * 1e3, 2),
                                            "serve_send_ms": round(t.serve_send_s * 1e3, 2)},
                                 "spans": t.span_dicts()})
                return
            if parts[:2] == ["v1", "task"] and len(parts) == 6 and parts[3] == "results":
                self._results(parts[2], int(parts[4]), int(parts[5]), query)
                return
            self._send(404, {"error": "not found"})

        def _results(self, tid: str, buffer_id: int, token: int, query: str):
            t = outer.tasks.get(tid)
            if t is None:
                self._send(404, {"error": "unknown task"})
                return
            if t.state == "FAILED":
                self._send(500, {"error": t.error, "errorInfo": t.error_info})
                return
            if t.buffers is None:
                self._send(503, {"retry": True, "state": t.state})
                return
            max_bytes = 0
            for kv in query.split("&"):
                if kv.startswith("max_bytes="):
                    max_bytes = int(kv.split("=", 1)[1])
            t0 = time.perf_counter()
            if max_bytes > 0:
                datas, complete, ready = t.buffers.get_many(buffer_id, token, max_bytes,
                                                            timeout=50)
            else:
                data, complete, ready = t.buffers.get(buffer_id, token, timeout=50)
                datas = [] if data is None else [data]
            if t.state == "FAILED":
                # finish() fires in the task's finally: a failed producer
                # must never look like a complete stream
                self._send(500, {"error": t.error, "errorInfo": t.error_info})
                return
            if not ready:
                self._send(503, {"retry": True, "state": t.state})
                t.served(time.perf_counter() - t0, 0.0)
                return
            t1 = time.perf_counter()
            encoded = [base64.b64encode(d).decode() for d in datas]
            self._send(200, {"page": encoded[0] if encoded else None, "pages": encoded,
                             "complete": complete})
            t.served(t1 - t0, time.perf_counter() - t1)

        def do_DELETE(self):
            parts = [p for p in self.path.split("/") if p]
            if parts[:2] == ["v1", "task"] and len(parts) == 6 and parts[3] == "results":
                # acknowledge pages [0, token): frees producer budget
                t = outer.tasks.get(parts[2])
                if t is not None and t.buffers is not None:
                    t.buffers.ack(int(parts[4]), int(parts[5]))
                self._send(200, {"acknowledged": True})
                return
            if parts[:2] == ["v1", "task"] and len(parts) == 3:
                t = outer.tasks.pop(parts[2], None)
                if t is not None:
                    t.abort.set()
                    if t.buffers is not None:
                        t.buffers.drain()
                self._send(200, {"deleted": True})
                return
            if parts[:2] == ["v1", "query"] and len(parts) == 3:
                # low-memory kill: abort every task of the query
                outer.kill_query(parts[2])
                self._send(200, {"killed": parts[2]})
                return
            self._send(404, {"error": "not found"})

    return Handler


def _split_salt(splits: Dict[str, Tuple[int, int]]) -> int:
    """Per-task sample salt from the split assignment: the summed range
    starts differ across the workers of a stage."""
    return sum(int(start) for start, _stop in splits.values())


def _split_to_bound(page: Page, bound: Optional[int]):
    """Row slices of `page` whose raw bytes fit the output-buffer bound
    (reference PageSplitterUtil.splitPage)."""
    n = int(page.count)
    if bound is None or n == 0:
        yield page
        return
    row_bytes = max(sum(b.data.element_size() * (b.data.numel() // max(b.data.shape[0], 1))
                        + (1 if b.valid is not None else 0) for b in page.blocks), 1)
    max_rows = max(bound // (2 * row_bytes), 256)
    if n <= max_rows:
        yield page
        return
    for start in range(0, n, max_rows):
        stop = min(start + max_rows, n)
        yield Page(tuple(b.take_rows(slice(start, stop)) for b in page.blocks), page.names,
                   torch.tensor(stop - start, dtype=torch.int32, device=page.device))


def _min_capacity(page: Page, minimum: int = 16) -> Page:
    """Empty wire pages arrive with no capacity; the sinks want at least
    one slot."""
    if not page.blocks or page.blocks[0].data.shape[0] >= minimum:
        return page
    return Page(tuple(_pad_block(b, minimum) for b in page.blocks), page.names, page.count)


def _hash_partition(page: Page, key_exprs, nparts: int, caps: Optional[dict] = None,
                    stats=None, caches=None) -> Dict[int, List[bytes]]:
    """The flat producer: live rows by key hash, one compaction and one
    serialized page per partition (reference PartitionedOutputOperator
    .partitionPage + PagesSerde). `caches` holds a buffer's
    DictionaryCache by partition, or is None."""
    part = route(page, key_exprs, nparts)
    return {p: [serialize_page(compact(page, part == p), cache=caches and caches[p], caps=caps,
                               stats=stats)]
            for p in range(nparts)}


def _pull_buffer(uri: str, task_id: str, buffer_id: int, ack: bool = True,
                 deadline: Optional[float] = None, max_bytes: Optional[int] = None):
    """Serialized pages of ONE upstream buffer, by batched long polls and
    acks (reference HttpPageBufferClient). `deadline` caps the wall time
    between pages: a wedged producer fails the pull, retryably. The
    concurrent client is server/exchange.py's ExchangeClient; this one is
    the oracle it is tested against."""
    if deadline is None:
        deadline = knobs.task_deadline_s()
    give_up = time.time() + deadline
    token = 0
    while True:
        pages, complete, ready = fetch_pages(uri, task_id, buffer_id, token,
                                             max_bytes=max_bytes)
        if pages:
            token += len(pages)
            yield from pages
            give_up = time.time() + deadline
            if ack:
                ack_pages(uri, task_id, buffer_id, token)
            if complete:
                return
            continue
        if complete:
            return
        if not ready and time.time() >= give_up:
            raise RuntimeError(f"upstream task {task_id} on {uri} produced no page within "
                               f"the {deadline:.0f}s task deadline (wedged worker?)")
