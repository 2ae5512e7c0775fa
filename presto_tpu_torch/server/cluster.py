"""HTTP cluster execution: node discovery, failure detection, and the stage
scheduler that runs fragmented plans across worker processes (torch
counterpart of presto_tpu/server/cluster.py).

Re-designed equivalents:
* NodeManager: DiscoveryNodeManager + HeartbeatFailureDetector
  (failureDetector/HeartbeatFailureDetector.java:77). Periodic /v1/status
  probes; consecutive probe failures mark a worker FAILED. Consecutive TASK
  failures BLACKLIST a worker that still answers its probes; after
  `blacklist_recovery` seconds a healthy probe re-admits it.
* HttpScheduler: SqlQueryScheduler + SqlStageExecution + HttpRemoteTask
  (execution/scheduler/SqlQueryScheduler.java:112). It cuts the
  fragmented plan (plan/fragment.py) at its exchanges into stages, runs
  leaf stages as one task per worker over row-range splits, links
  consumer tasks to producer output buffers (worker w pulls hash
  partition w from every producer: the pull-based FIXED_HASH shuffle),
  and runs the root fragment on the coordinator.

Fault tolerance: a task that fails to START (POST refused, or FAILED at
the eager status check with a retryable cause) is retried with
exponential backoff and jitter on an alternate healthy worker, up to
`max_task_retries` times. A later failure (a fault surfacing on the
results pull) re-executes the query, a bounded number of times, on a
fresh worker snapshot. Fatal causes (a low-memory kill, exhausted worker
memory, protocol violations) are never retried, and the query's sibling
tasks are cancelled.

Tracing (obs/): the session opens the query's root and its plan and
execute spans; the scheduler hangs per-attempt, per-stage, per-dispatch
and per-gather spans under execute, the task spec carries the trace id
and the dispatch span's id, and the workers' task spans (returned in
their statuses) merge into the same tree. Scheduler, exchange, wire and
hierarchical-exchange stats export into the metrics plane."""

from __future__ import annotations

import base64
import dataclasses
import itertools
import json
import os
import pickle
import random
import threading
import time
import urllib.error
import urllib.request
import uuid
from typing import Dict, List, Optional, Tuple

from ..exec.dynfilter import merge_summaries
from ..expr import ir
from ..plan import nodes as N
from ..plan.fragment import Exchange
from ..session import resolve_device
from . import knobs
from .exchange import ExchangeClient, ExchangeError, ExchangeStats
from .hier import HierExchangeStats
from .serde import WireStats, negotiate
from .worker import _FATAL_MARKERS, FragmentExecutor, RemoteSource, dumps_fragment


def _retryable_message(msg: str) -> bool:
    """Classify an unstructured failure message: fatal causes recur on any
    worker and attempt (worker._classify_failure)."""
    return not any(m in msg for m in _FATAL_MARKERS)


def _http_error_details(e: urllib.error.HTTPError) -> Tuple[str, bool]:
    """(detail, retryable) of a worker's structured error response."""
    try:
        payload = json.loads(e.read())
    except (ValueError, OSError):
        payload = {}  # no JSON body: classify the HTTPError's own message
    if not isinstance(payload, dict):
        payload = {}
    detail = payload.get("error") or str(e)
    info = payload.get("errorInfo") or {}
    return detail, bool(info.get("retryable", _retryable_message(detail)))


def _get_json(url: str, timeout: float):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


class NodeManager:
    """Tracks worker liveness by heartbeats; failed nodes are left out of
    scheduling until they answer again. Consecutive task failures
    blacklist (drain) a worker, re-admitted after a recovery time."""

    def __init__(self, worker_uris: List[str], interval: float = 5.0,
                 failure_threshold: int = 3, task_failure_threshold: int = 3,
                 blacklist_recovery: float = 30.0, event_bus=None):
        self.workers = {
            u: {"state": "ACTIVE", "failures": 0, "task_failures": 0,
                "blacklisted_at": None, "wire": None}
            for u in worker_uris
        }
        self.interval = interval
        self.failure_threshold = failure_threshold
        self.task_failure_threshold = task_failure_threshold
        self.blacklist_recovery = blacklist_recovery
        self.event_bus = event_bus  # the control plane's events, or None
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="ptpu-nodes")

    def start(self) -> "NodeManager":
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=10)

    def active_workers(self) -> List[str]:
        with self._lock:
            return [u for u, s in self.workers.items() if s["state"] == "ACTIVE"]

    def all_workers(self) -> List[str]:
        with self._lock:
            return list(self.workers)

    # -- state transitions (events fire outside the lock) --

    def _set_state(self, uri: str, state: str, reason: str) -> None:
        with self._lock:
            st = self.workers[uri]
            if st["state"] == state:
                return
            st["state"] = state
            if state == "BLACKLISTED":
                st["blacklisted_at"] = time.time()
            elif state == "ACTIVE":
                st["failures"] = 0
                st["task_failures"] = 0
                st["blacklisted_at"] = None
        if self.event_bus is not None:
            self.event_bus.fire_worker_state(uri, state, reason)

    def record_task_failure(self, uri: str, reason: str = "") -> None:
        """A task on this worker failed; N in a row drain the worker."""
        with self._lock:
            st = self.workers.get(uri)
            if st is None:
                return
            st["task_failures"] += 1
            drain = st["state"] == "ACTIVE" and st["task_failures"] >= self.task_failure_threshold
        if drain:
            self._set_state(uri, "BLACKLISTED",
                            f"{self.task_failure_threshold} consecutive task failures"
                            + (f": {reason[:120]}" if reason else ""))

    def record_task_success(self, uri: str) -> None:
        with self._lock:
            st = self.workers.get(uri)
            if st is not None:
                st["task_failures"] = 0

    def wire_caps(self, uri: str) -> Optional[dict]:
        """The wire capabilities a worker advertised, fetched once when no
        probe has cached them yet. None is unknown (negotiation degrades
        the fleet to the baseline); a failed probe is cached for one
        interval, so an unreachable worker costs one query one stall."""
        with self._lock:
            st = self.workers.get(uri)
            if st is None:
                return None
            cached = st.get("wire")
            failed_at = st.get("wire_probe_failed_at")
        if cached is not None:
            return cached
        if failed_at is not None and time.time() - failed_at < self.interval:
            return None
        try:
            caps = _get_json(f"{uri}/v1/status", 2).get("wire")
        except (OSError, ValueError):
            caps = None  # an unknown peer stays at the baseline
        with self._lock:
            st = self.workers.get(uri)
            if st is not None:
                if isinstance(caps, dict):
                    st["wire"] = caps
                    st.pop("wire_probe_failed_at", None)
                else:
                    st["wire_probe_failed_at"] = time.time()
        return caps if isinstance(caps, dict) else None

    def wire_caps_all(self, uris: List[str]) -> List[Optional[dict]]:
        """wire_caps of a worker snapshot, the uncached ones probed at once."""
        results: Dict[str, Optional[dict]] = {}
        with self._lock:
            for u in uris:
                st = self.workers.get(u)
                if st is not None and st.get("wire") is not None:
                    results[u] = st["wire"]
        missing = [u for u in uris if u not in results]
        if len(missing) == 1:
            results[missing[0]] = self.wire_caps(missing[0])
        elif missing:
            def probe(u):
                results[u] = self.wire_caps(u)

            threads = [threading.Thread(target=probe, args=(u,), daemon=True) for u in missing]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=3)
        return [results.get(u) for u in uris]

    def probe_all(self):
        for uri in self.all_workers():
            try:
                payload = _get_json(f"{uri}/v1/status", 2)
                ok = payload.get("state") == "ACTIVE"
                # cache what the worker advertises now, clearing a stale
                # entry when a build at the same address stops advertising
                caps = payload.get("wire")
                with self._lock:
                    st = self.workers.get(uri)
                    if st is not None:
                        st["wire"] = caps if isinstance(caps, dict) else None
            except (OSError, ValueError):  # a failed probe IS the signal
                ok = False
            with self._lock:
                st = self.workers[uri]
                state = st["state"]
                st["failures"] = 0 if ok else st["failures"] + 1
                # only an ACTIVE worker degrades to FAILED: a BLACKLISTED
                # one keeps serving its drain penalty
                probe_failed = (not ok and state == "ACTIVE"
                                and st["failures"] >= self.failure_threshold)
                blacklist_done = (ok and state == "BLACKLISTED"
                                  and st["blacklisted_at"] is not None
                                  and time.time() - st["blacklisted_at"]
                                  >= self.blacklist_recovery)
            if probe_failed:
                self._set_state(uri, "FAILED", "heartbeat probes exhausted")
            elif ok and state == "FAILED":
                self._set_state(uri, "ACTIVE", "heartbeat recovered")
            elif blacklist_done:
                self._set_state(uri, "ACTIVE", "blacklist recovery elapsed")

    def _loop(self):
        while not self._stop.wait(self.interval):
            self.probe_all()


def _has_remote_source(node) -> bool:
    """Does a producer subtree pull from a deeper exchange? Its estimate
    then bottoms out at the RemoteSource default and is not comparable."""
    if isinstance(node, RemoteSource):
        return True
    return any(_has_remote_source(c) for c in node.children)


class TaskFailure(RuntimeError):
    """A task (or its stage) failed: the worker, task id, attempt, and
    whether the cause is retryable on another worker or attempt."""

    def __init__(self, message: str, uri: str = "", task_id: str = "", attempt: int = 1,
                 retryable: bool = True):
        super().__init__(message)
        self.uri = uri
        self.task_id = task_id
        self.attempt = attempt
        self.retryable = retryable


@dataclasses.dataclass
class SchedulerStats:
    """Retries, dynamic filters, replans and the exchange, observable."""

    task_retries: int = 0
    query_retries: int = 0
    tasks_failed: int = 0
    worker_failures: Dict[str, int] = dataclasses.field(default_factory=dict)
    last_error: str = ""
    # cross-task dynamic filters: shipped into probe-stage specs, seconds
    # in the bounded wait, waits that expired (proceed without)
    dynfilters_shipped: int = 0
    dynfilter_wait_s: float = 0.0
    dynfilter_timeouts: int = 0
    # attempts abandoned at an exchange for a mid-query replan
    adaptive_replans: int = 0
    # per-source pull stats of the last attempt's coordinator gathers,
    # with the producers' encode stats, and the negotiated wire
    exchange: Dict[str, dict] = dataclasses.field(default_factory=dict)
    wire_caps: Optional[dict] = None
    # the workers' memory ladder over every task: disk bytes, revocations,
    # spill events
    memory: Dict[str, object] = dataclasses.field(default_factory=dict)
    # the hierarchical exchange, folded over every partitioned producer
    hier: Dict[str, object] = dataclasses.field(default_factory=dict)
    # every task's output encoding (WireStats), the pull wall and the
    # consumers' wait on empty staging (pull_ms, wait_ms) of every consumer,
    # workers and coordinator, and the task threads' executor and emission
    # walls (exec_ms, emit_ms): the query's whole wire
    wire: Dict[str, object] = dataclasses.field(default_factory=dict)
    caches: Optional[dict] = None

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


class HttpScheduler:
    """Executes a fragmented plan over HTTP workers; the coordinator runs
    the root fragment itself, on its catalog's device."""

    def __init__(self, catalog, nodes: NodeManager, max_task_retries: Optional[int] = None,
                 max_query_retries: Optional[int] = None, task_deadline: Optional[float] = None,
                 status_deadline: float = 10.0, status_timeout: float = 15.0,
                 backoff_base: float = 0.2, backoff_cap: float = 5.0, device=None):
        self.catalog = catalog
        self.device = resolve_device(device if device is not None
                                     else getattr(catalog, "device", "cuda"))
        self.nodes = nodes
        # task ids unique across schedulers sharing workers
        self._task_prefix = uuid.uuid4().hex[:8]
        self._task_ids = itertools.count(1)
        env = os.environ.get
        self.max_task_retries = (int(env("PRESTO_TPU_TASK_RETRIES", "3"))
                                 if max_task_retries is None else max_task_retries)
        self.max_query_retries = (int(env("PRESTO_TPU_QUERY_RETRIES", "2"))
                                  if max_query_retries is None else max_query_retries)
        # wall ceiling between pages of one task's results stream
        self.task_deadline = knobs.task_deadline_s() if task_deadline is None else task_deadline
        self.status_deadline = status_deadline
        self.status_timeout = status_timeout
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        # bounded wait for a build stage's dynamic-filter summaries before
        # the probe stage launches; expiry proceeds without the filter.
        # 0 disables cross-task shipping.
        self.dynfilter_wait = float(env("PRESTO_TPU_DYNFILTER_WAIT_S", "10"))
        self.stats = SchedulerStats()
        self._lock = threading.Lock()

    # -- public --

    def record_caches(self, snapshot: dict) -> None:
        """Publish the serving caches' counters, and the cumulative
        scheduler counters as gauges, once per query."""
        from ..obs.export import export_scheduler_stats

        with self._lock:
            self.stats.caches = snapshot
            export_scheduler_stats(self.stats)

    def stats_snapshot(self) -> dict:
        with self._lock:
            return self.stats.snapshot()

    def run(self, root: N.PlanNode, query_id: Optional[str] = None, adapt: bool = True,
            trace_ctx: Optional[tuple] = None):
        """Execute, re-running the whole plan on a fresh worker snapshot
        after a retryable failure that escaped the per-task retries.
        `trace_ctx` is (Trace, parent span id): each attempt gets its own
        span under the parent, so a retried query shows sibling attempts."""
        if query_id is None:
            query_id = f"q_{uuid.uuid4().hex[:12]}"
        trace = trace_ctx[0] if trace_ctx else None
        for attempt in range(self.max_query_retries + 1):
            # a distinct id per attempt: a prior attempt's dying tasks never
            # share memory accounting with the re-run
            qid = query_id if attempt == 0 else f"{query_id}.r{attempt}"
            aspan = None
            if trace is not None:
                aspan = trace.begin(f"attempt {attempt}", parent_id=trace_ctx[1], query_id=qid)
            try:
                result = self._run_attempt(root, qid, adapt=adapt,
                                           tctx=(trace, aspan.span_id) if trace else None)
                if trace is not None:
                    trace.finish(aspan)
                return result
            except RuntimeError as exc:
                if trace is not None:
                    trace.finish(aspan, "error", error=str(exc)[:200])
                retryable = getattr(exc, "retryable", None)
                if retryable is None:
                    retryable = _retryable_message(str(exc))
                if not retryable or attempt >= self.max_query_retries:
                    raise
                # a failure attributed to a worker counts toward its
                # blacklist streak
                uri = getattr(exc, "uri", "")
                if uri:
                    self._note_task_failure(uri, str(exc))
                with self._lock:
                    self.stats.query_retries += 1
                    self.stats.last_error = str(exc)[:300]
                time.sleep(self._backoff(attempt))
                if not self.nodes.active_workers():
                    raise

    def _run_attempt(self, root: N.PlanNode, query_id: str, adapt: bool = True,
                     tctx: Optional[tuple] = None):
        # one membership snapshot per attempt: producer partition counts
        # must match consumer task counts even if a node fails mid-query
        workers = self.nodes.active_workers()
        if not workers:
            raise TaskFailure("no active workers", retryable=False)
        # the wire handshake: intersect the snapshot's adverts once and
        # ship the result in every task spec
        wire_caps = negotiate(self.nodes.wire_caps_all(workers))
        with self._lock:
            self.stats.wire_caps = wire_caps
            self.stats.exchange = {}
            self.stats.memory = {}
            self.stats.hier = {}
            self.stats.wire = {}
        all_tasks: List[Tuple[str, str, bool]] = []
        try:
            fragment, specs = self._cut(root)
            sources = self._resolve_sources(
                specs, False, workers, all_tasks, query_id,
                dyn_links=self._dyn_links(fragment, specs), dyn_values={},
                wire_caps=wire_caps, adapt=adapt, tctx=tctx)
            rspan = tctx[0].begin("root-fragment", parent_id=tctx[1]) if tctx else None
            try:
                result = FragmentExecutor(self.catalog, {}, sources,
                                          device=self.device).run(fragment)
            except Exception:
                if rspan is not None:
                    tctx[0].finish(rspan, "error")
                raise
            if rspan is not None:
                tctx[0].finish(rspan)
            return result
        finally:
            self._collect_task_stats(all_tasks, tctx)
            # free the workers' output buffers; on failure this also
            # cancels the sibling tasks
            self._cancel_tasks(all_tasks)

    def _collect_task_stats(self, tasks: List[Tuple[str, str, bool]],
                            tctx: Optional[tuple] = None) -> None:
        """Fold every task's spans into the query's trace, and its wire,
        hierarchical-exchange and memory-ladder stats into the query's
        rollup (the tasks feeding other workers are never polled
        otherwise). Tasks of failed POSTs answer 404 and are left out."""
        from ..obs.export import export_hier_stats

        hier = HierExchangeStats()
        wire = WireStats()
        sums = {"pull_ms": 0.0, "wait_ms": 0.0, "exec_ms": 0.0, "emit_ms": 0.0,
                "serve_wait_ms": 0.0, "serve_send_ms": 0.0}
        events: set = set()
        spilled = revocations = 0
        for uri, task_id, _partitioned in tasks:
            try:
                st = self._task_status(uri, task_id)
            except TaskFailure:
                continue
            if tctx is not None:
                tctx[0].add_remote(st.get("spans") or ())
            ex = st.get("exchangeStats") or {}
            wire.merge_snapshot(ex)
            hier.merge_snapshot(ex.get("hier"))
            pull = ex.get("pull") or {}
            sums["pull_ms"] += float(pull.get("pull_ms") or 0.0)
            sums["wait_ms"] += float(pull.get("consumer_wait_ms") or 0.0)
            for k in ("exec_ms", "emit_ms", "serve_wait_ms", "serve_send_ms"):
                sums[k] += float((st.get("timing") or {}).get(k) or 0.0)
            sp = st.get("spillStats") or {}
            spilled += int(sp.get("disk_bytes") or 0)
            events.update(sp.get("events") or ())
            revocations += int((st.get("memoryStats") or {}).get("revocations") or 0)
        snap = hier.snapshot()
        with self._lock:
            if snap.get("exchanges"):
                self.stats.hier = snap
            for e in self.stats.exchange.values():  # the coordinator's gathers
                sums["pull_ms"] += e.get("pull_ms", 0.0)
                sums["wait_ms"] += e.get("consumer_wait_ms", 0.0)
            self.stats.wire = dict(wire.snapshot(), **{k: round(v, 2) for k, v in sums.items()})
            if spilled or revocations or events:
                self.stats.memory = {"spilled_bytes": spilled, "revocations": revocations,
                                     "events": sorted(events)}
        if snap.get("exchanges"):
            export_hier_stats(hier, role="gather")

    def _cancel_tasks(self, tasks: List[Tuple[str, str, bool]]) -> None:
        for uri, task_id, _partitioned in tasks:
            try:
                req = urllib.request.Request(f"{uri}/v1/task/{task_id}", method="DELETE")
                urllib.request.urlopen(req, timeout=5).read()
            except OSError:  # a worker already gone holds nothing to free
                pass

    def _backoff(self, attempt: int) -> float:
        """Exponential backoff with full jitter (attempt counts from 0)."""
        return random.uniform(0, min(self.backoff_base * (2 ** attempt), self.backoff_cap))

    # -- plan cutting --

    def _cut(self, node: N.PlanNode):
        """Replace each Exchange child with a RemoteSource; returns
        (fragment, {source_id: Exchange})."""
        specs: Dict[str, Exchange] = {}

        def walk(n):
            if isinstance(n, Exchange):
                sid = f"s{len(specs)}"
                specs[sid] = n
                return RemoteSource(sid, tuple(n.fields))
            replace = {}
            for f in dataclasses.fields(n):
                v = getattr(n, f.name)
                if isinstance(v, N.PlanNode):
                    nv = walk(v)
                    if nv is not v:
                        replace[f.name] = nv
                elif isinstance(v, tuple) and v and isinstance(v[0], N.PlanNode):
                    nv = tuple(walk(c) for c in v)
                    if nv != v:
                        replace[f.name] = nv
            return dataclasses.replace(n, **replace) if replace else n

        return walk(node), specs

    @staticmethod
    def _has_scan(node: N.PlanNode) -> bool:
        if isinstance(node, N.TableScan):
            return True
        return any(HttpScheduler._has_scan(c) for c in node.children)

    # -- cross-task dynamic filters (exec/dynfilter.py) --

    @staticmethod
    def _dyn_links(fragment: N.PlanNode, specs: Dict[str, Exchange]):
        """(produce, consume) links of dynamic filters that cross task
        boundaries. produce: source_id -> [(filter_id, channel)] for joins
        in `fragment` whose build side is directly a RemoteSource (that
        stage's output IS the build rows). consume: source_id -> {filter_id}
        for producer subtrees holding annotated probe scans."""
        produce: Dict[str, list] = {}

        def walk(n):
            if isinstance(n, (N.Join, N.SemiJoin)) and getattr(n, "dynamic_filters", ()):
                build = n.children[1]
                keys = n.right_keys if isinstance(n, N.Join) else n.source_keys
                if isinstance(build, RemoteSource):
                    fields = {f for f, _ in build.fields}
                    for fid, i, _c in n.dynamic_filters:
                        k = keys[i]
                        if isinstance(k, ir.ColumnRef) and k.name in fields:
                            produce.setdefault(build.source_id, []).append((fid, k.name))
            for c in n.children:
                walk(c)

        walk(fragment)

        def scan_fids(n, acc: set):
            if isinstance(n, N.TableScan):
                for fid, *_rest in n.dynamic_filters:
                    acc.add(fid)
            for c in n.children:
                scan_fids(c, acc)

        consume: Dict[str, set] = {}
        for sid, ex in specs.items():
            acc: set = set()
            scan_fids(ex.child, acc)
            if acc:
                consume[sid] = acc
        return produce, consume

    def _await_dyn_filters(self, handles, entries, dyn_values: dict) -> None:
        """Bounded wait for a build stage's tasks to FINISH, then merge
        their summaries into `dyn_values`. Expiry or a failed task leaves
        the filter out (proceed without): dynamic filters are an
        optimization, never a correctness dependency."""
        deadline = time.time() + self.dynfilter_wait
        t0 = time.perf_counter()
        per_task: List[Optional[dict]] = []
        timed_out = False
        for uri, task in handles:
            status = None
            while time.time() < deadline:
                try:
                    status = self._task_status(uri, task)
                except TaskFailure:
                    status = None
                    break
                if status.get("state") in ("FINISHED", "FAILED"):
                    break
                time.sleep(0.05)
            else:
                timed_out = True
            if status is None or status.get("state") != "FINISHED":
                per_task.append(None)
            else:
                per_task.append(status.get("dynFilters") or {})
        with self._lock:
            self.stats.dynfilter_wait_s += time.perf_counter() - t0
            if timed_out:
                self.stats.dynfilter_timeouts += 1
        if any(p is None for p in per_task):
            return  # a task failed or timed out: the filter is untrusted
        for fid, _channel in entries:
            merged = merge_summaries([p.get(fid) for p in per_task])
            if merged is not None:
                dyn_values[fid] = merged
                with self._lock:
                    self.stats.dynfilters_shipped += 1

    # -- stage execution --

    def _resolve_sources(self, specs, sharded_consumer: bool, workers: List[str], all_tasks,
                         query_id: Optional[str] = None, dyn_links=None,
                         dyn_values: Optional[dict] = None, wire_caps: Optional[dict] = None,
                         adapt: bool = False, tctx: Optional[tuple] = None):
        """Run the producer stage of each exchange; returns
        {sid: (kind, handles)} for a sharded consumer, else {sid: [pages]}
        (the coordinator consumes). A stage producing a filter that a
        sibling stage's scans consume launches first, and the coordinator
        waits (bounded) for its summaries before launching the others."""
        produce, consume = dyn_links if dyn_links else ({}, {})
        if dyn_values is None:
            dyn_values = {}
        wanted: set = set()
        for fids in consume.values():
            wanted |= fids
        if self.dynfilter_wait <= 0:
            produce, consume, wanted = {}, {}, set()

        def is_producer(sid):
            return any(f in wanted for f, _ in produce.get(sid, ()))

        resolved = {}
        for sid in sorted(specs, key=lambda s: (not is_producer(s),)):
            ex = specs[sid]
            entries = [(f, ch) for f, ch in produce.get(sid, ()) if f in wanted]
            if ex.kind == "repartition" and sharded_consumer:
                handles = self._run_sharded_stage(
                    ex.child, ("hash", ex.keys), workers, all_tasks, query_id,
                    dyn_produce=entries, dyn_values=dyn_values, wire_caps=wire_caps, tctx=tctx)
                resolved[sid] = ("repartition", handles)
            else:
                # gather, replicate, and a repartition the coordinator
                # consumes (it reads everything anyway). Replicated outputs
                # are pulled by every consumer without acks, so their
                # buffers are unbounded.
                handles = self._run_sharded_stage(
                    ex.child, ("single",), workers, all_tasks, query_id,
                    unbounded_output=sharded_consumer and ex.kind == "replicate",
                    dyn_produce=entries, dyn_values=dyn_values, wire_caps=wire_caps, tctx=tctx)
                resolved[sid] = ("gather", handles)
            if entries and any(other != sid and (consume.get(other, set())
                                                 & {f for f, _ in entries})
                               for other in specs):
                self._await_dyn_filters(handles, entries, dyn_values)
        if sharded_consumer:
            return resolved
        # the coordinator side: every source into pages through the
        # pipelined exchange client, decoded onto the coordinator's device
        out = {}
        for sid, (_kind, handles) in resolved.items():
            ex_stats = ExchangeStats()
            client = ExchangeClient([(uri, task, 0) for uri, task in handles], ack=True,
                                    deadline=self.task_deadline, stats=ex_stats,
                                    device=self.device)
            gspan = tctx[0].begin(f"exchange {sid}", parent_id=tctx[1]) if tctx else None
            try:
                pages = list(client.pages())
            except ExchangeError as e:
                # attribute the failure to its worker, so the query retry
                # feeds the blacklist
                self._record_exchange(sid, ex_stats, ())
                if gspan is not None:
                    tctx[0].finish(gspan, "error", error=str(e)[:200])
                raise TaskFailure(str(e), uri=e.uri, task_id=e.task_id,
                                  retryable=_retryable_message(str(e))) from None
            self._record_exchange(sid, ex_stats, handles)
            if gspan is not None:
                snap = ex_stats.snapshot()
                tctx[0].finish(gspan, pages=snap["pages"], bytes=snap["wire_bytes"],
                               wire_ms=snap["pull_ms"], hidden_ms=snap["hidden_ms"],
                               overlap=snap["overlap_frac"], wait_ms=snap["consumer_wait_ms"],
                               decode_ms=snap["decode_ms"],
                               producers=[task for _uri, task in handles])
            if adapt:
                self._maybe_adaptive_replan(specs[sid], pages)
            out[sid] = pages
        return out

    def _maybe_adaptive_replan(self, ex, pages) -> None:
        """Mid-query adaptation (plan/history.py): a producer stage just
        materialized on the coordinator, so its true cardinality is known
        while the fragments downstream have not run. When it contradicts
        the estimate by more than PRESTO_TPU_FEEDBACK_REPLAN_FACTOR, the
        observation is recorded and AdaptiveReplan raised; the session
        re-plans on the updated history and re-runs once, without
        adaptation."""
        from ..exec.qcache import plan_tables
        from ..plan import history as H
        from ..plan.stats import derive

        if not H.feedback_on():
            return
        child = ex.child
        if _has_remote_source(child) or not self._has_scan(child):
            return  # estimates over a nested exchange are not comparable
        observed = float(sum(int(p.count) for p in pages))
        if observed < knobs.feedback_replan_min_rows():
            return
        est = float(derive(child, self.catalog).rows)
        if observed < knobs.feedback_replan_factor() * max(est, 1.0):
            return
        recorded = H.HISTORY.record(H.fingerprint(child), catalog=self.catalog,
                                    tables=plan_tables(child), rows=observed, est_rows=est,
                                    kind=type(child).__name__)
        if not recorded:
            return  # unversioned tables: a re-plan would not differ
        with H.HISTORY.stats._lock:
            H.HISTORY.stats.replans += 1
        with self._lock:
            self.stats.adaptive_replans += 1
        raise H.AdaptiveReplan(f"stage output {observed:,.0f} rows vs estimate {est:,.0f}: "
                               "re-planning downstream fragments on observed cardinality")

    def _record_exchange(self, sid: str, ex_stats: ExchangeStats, handles) -> None:
        """Fold one gather's pull stats and its producers' encode stats
        (their statuses, still queryable until the query's cleanup) into
        the exchange's entry and the metrics plane."""
        from ..obs.export import export_exchange_stats, export_wire_stats

        entry = ex_stats.snapshot()
        encode = WireStats()
        hier = HierExchangeStats()
        for uri, task in handles:
            try:
                st = self._task_status(uri, task)
            except TaskFailure:
                continue  # a producer gone after its pages were pulled
            ex = st.get("exchangeStats") or {}
            encode.merge_snapshot(ex)
            hier.merge_snapshot(ex.get("hier"))
        entry["producer"] = encode.snapshot()
        export_exchange_stats(ex_stats)
        export_wire_stats("producer_encode", encode)
        hier_snap = hier.snapshot()
        if hier_snap.get("exchanges"):
            entry["hier"] = hier_snap
        with self._lock:
            self.stats.exchange[sid] = entry

    def _run_sharded_stage(self, node: N.PlanNode, output, all_workers: List[str], all_tasks,
                           query_id: Optional[str] = None, unbounded_output: bool = False,
                           dyn_produce=None, dyn_values: Optional[dict] = None,
                           wire_caps: Optional[dict] = None,
                           tctx: Optional[tuple] = None) -> List[Tuple[str, str]]:
        """One task per worker for a sharded stage (splits or repartitioned
        inputs); a scan-less single-distribution stage runs as ONE task so
        rows are never duplicated. Returns [(worker_uri, task_id)]."""
        nw = len(all_workers)
        fragment, specs = self._cut(node)
        sharded = self._has_scan(fragment) or any(ex.kind == "repartition"
                                                  for ex in specs.values())
        workers = all_workers if sharded else all_workers[:1]
        sspan = None
        if tctx is not None:
            # the stage span covers the launch; its dispatch spans and the
            # workers' task spans under them carry the execution wall
            sspan = tctx[0].begin(f"stage {output[0]}:{type(fragment).__name__}",
                                  parent_id=tctx[1], tasks=len(workers))
            tctx = (tctx[0], sspan.span_id)
        child_resolved = self._resolve_sources(
            specs, True, all_workers, all_tasks, query_id,
            dyn_links=self._dyn_links(fragment, specs), dyn_values=dyn_values,
            wire_caps=wire_caps, tctx=tctx)
        # row-range splits per scanned table
        tables = self._scan_tables(fragment)
        ranges = {}
        for t in tables:
            exact = getattr(self.catalog, "exact_row_count", None)
            total = exact(t) if exact is not None else self.catalog.row_count(t)
            per = -(-total // nw)
            ranges[t] = [(w * per, min((w + 1) * per, total)) for w in range(nw)]
        frag_text = dumps_fragment(fragment)
        part_keys_b64 = None
        nparts = 1
        if output[0] == "hash":
            part_keys_b64 = base64.b64encode(pickle.dumps(output[1])).decode()
            nparts = nw
        launched = []
        for w, uri in enumerate(workers):
            sources = {}
            for sid, (kind, child_handles) in child_resolved.items():
                if kind == "repartition":
                    # partition w has exactly one consumer: acks may free
                    # producer pages as it consumes them
                    sources[sid] = {"locations": [(u, t, w) for (u, t) in child_handles],
                                    "exclusive": True}
                else:  # gather/replicate: every consumer pulls buffer 0
                    sources[sid] = {"locations": [(u, t, 0) for (u, t) in child_handles],
                                    "exclusive": len(workers) == 1}
            spec = {
                "fragment": frag_text,
                "splits": {t: list(ranges[t][w]) for t in tables},
                "sources": sources,
                "partition_keys": part_keys_b64,
                "num_partitions": nparts,
                "query_id": query_id,
                "buffer_unbounded": unbounded_output,
                # summaries this stage PRODUCES over its output, and the
                # resolved filters its scans may CONSUME (a snapshot: stages
                # launched before a build finished run unfiltered)
                "dyn_filter_produce": list(dyn_produce or ()) or None,
                "dyn_filters": dict(dyn_values) if dyn_values else None,
                "wire": wire_caps,
            }
            launched.append(self._post_with_retry(uri, spec, all_workers, all_tasks, tctx=tctx))
        # surface start failures eagerly, retrying each failed task on an
        # alternate worker (catalogs are deterministic across nodes, so the
        # same spec is valid anywhere in the snapshot)
        handles = [self._ensure_started(uri, task_id, spec, all_workers, all_tasks, tctx=tctx)
                   for uri, task_id, spec, _attempts in launched]
        if sspan is not None:
            tctx[0].finish(sspan)
        return handles

    # -- task start and retry --

    def _post_with_retry(self, uri: str, spec: dict, snapshot: List[str], all_tasks,
                         tctx: Optional[tuple] = None):
        """POST a task, retrying a refused connection on alternates.
        Returns (uri, task_id, spec, attempts_used)."""
        attempt = 1
        while True:
            task_id = self._new_task_id()
            failed = self._try_post(uri, task_id, spec, all_tasks, tctx=tctx)
            if failed is None:
                return uri, task_id, spec, attempt
            error = failed["error"]
            retryable = bool(failed["errorInfo"]["retryable"])
            self._note_task_failure(uri, error)
            if not retryable or attempt > self.max_task_retries:
                raise TaskFailure(f"task {task_id} could not be started (last worker {uri}, "
                                  f"attempt {attempt}, retryable={retryable}): {error}",
                                  uri=uri, task_id=task_id, attempt=attempt, retryable=retryable)
            time.sleep(self._backoff(attempt - 1))
            uri = self._pick_alternate(uri, snapshot)
            attempt += 1
            with self._lock:
                self.stats.task_retries += 1

    def _try_post(self, uri: str, task_id: str, spec: dict, all_tasks,
                  tctx: Optional[tuple] = None) -> Optional[dict]:
        """POST a task; None on success, else a FAILED status dict (never
        raises for transport errors). The task is registered for cleanup
        BEFORE the POST: if the response is lost after the worker took the
        task, the query's cleanup still deletes it. Every post passes here,
        so each (re)post gets its own dispatch span under the stage, and
        the spec carries (trace id, that span's id) for the worker's task
        span: a retry is a sibling subtree, never an overwrite."""
        all_tasks.append((uri, task_id, bool(spec.get("partition_keys"))))
        dspan = None
        if tctx is not None:
            dspan = tctx[0].begin(f"dispatch {task_id}", parent_id=tctx[1], worker=uri)
            spec["trace"] = {"trace_id": tctx[0].trace_id, "parent": dspan.span_id}
        try:
            self._post_task(uri, task_id, spec)
            if dspan is not None:
                tctx[0].finish(dspan)
            return None
        except urllib.error.HTTPError as e:
            # the worker answered: honor its structured verdict
            detail, retryable = _http_error_details(e)
            if dspan is not None:
                tctx[0].finish(dspan, "error", error=detail[:200])
            return {"state": "FAILED", "error": detail, "errorInfo": {"retryable": retryable}}
        except OSError as e:
            if dspan is not None:
                tctx[0].finish(dspan, "error", error=str(e)[:200])
            return {"state": "FAILED", "error": f"POST to {uri} refused: {e}",
                    "errorInfo": {"retryable": True}}

    def _ensure_started(self, uri: str, task_id: str, spec: dict, snapshot: List[str],
                        all_tasks, attempt: int = 1,
                        tctx: Optional[tuple] = None) -> Tuple[str, str]:
        """Eager failure surfacing with bounded retry: a task FAILED at the
        status check is re-posted (same spec) to an alternate worker after
        backoff and jitter; an unrecoverable failure cancels the query's
        sibling tasks and raises."""
        status: Optional[dict] = None
        posted = True
        while True:
            if posted:
                try:
                    status = self._task_status(uri, task_id, attempt=attempt)
                except TaskFailure as tf:
                    status = {"state": "FAILED", "error": str(tf),
                              "errorInfo": {"retryable": tf.retryable}}
            if tctx is not None:
                # a FAILED attempt's task span (status "error") lands in
                # the tree here, before its replacement is posted
                tctx[0].add_remote(status.get("spans") or ())
            if status.get("state") != "FAILED":
                # started: reset the failure streak feeding the blacklist
                self.nodes.record_task_success(uri)
                return uri, task_id
            error = status.get("error") or "unknown"
            info = status.get("errorInfo") or {}
            retryable = bool(info.get("retryable", _retryable_message(error)))
            self._note_task_failure(uri, error)
            if not retryable or attempt > self.max_task_retries:
                self._cancel_tasks(list(all_tasks))
                raise TaskFailure(f"task {task_id} on worker {uri} failed (attempt {attempt}/"
                                  f"{self.max_task_retries + 1}, retryable={retryable}):\n{error}",
                                  uri=uri, task_id=task_id, attempt=attempt, retryable=retryable)
            time.sleep(self._backoff(attempt - 1))
            uri = self._pick_alternate(uri, snapshot)
            task_id = self._new_task_id()
            failed = self._try_post(uri, task_id, spec, all_tasks, tctx=tctx)
            posted = failed is None
            if not posted:
                status = failed  # classify directly, no status poll
            attempt += 1
            with self._lock:
                self.stats.task_retries += 1

    def _new_task_id(self) -> str:
        return f"t_{self._task_prefix}_{next(self._task_ids)}"

    def _pick_alternate(self, failed_uri: str, snapshot: List[str]) -> str:
        """An active snapshot member other than the failed worker, else any
        other member, else the same worker (a one-worker cluster)."""
        active = set(self.nodes.active_workers())
        candidates = ([u for u in snapshot if u != failed_uri and u in active]
                      or [u for u in snapshot if u != failed_uri] or [failed_uri])
        return random.choice(candidates)

    def _note_task_failure(self, uri: str, error: str) -> None:
        with self._lock:
            self.stats.tasks_failed += 1
            self.stats.worker_failures[uri] = self.stats.worker_failures.get(uri, 0) + 1
            self.stats.last_error = error[:300]
        self.nodes.record_task_failure(uri, error)

    @staticmethod
    def _scan_tables(node: N.PlanNode) -> List[str]:
        out = []

        def walk(n):
            if isinstance(n, N.TableScan):
                out.append(n.table)
            for c in n.children:
                walk(c)

        walk(node)
        return sorted(set(out))

    # -- HTTP --

    @staticmethod
    def _post_task(uri: str, task_id: str, spec: dict):
        req = urllib.request.Request(f"{uri}/v1/task/{task_id}",
                                     data=json.dumps(spec).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            return json.loads(resp.read())

    def _task_status(self, uri: str, task_id: str, attempt: int = 1) -> dict:
        """Short-poll the task status within `status_deadline`: the worker
        answers within ~0.5 s, so the loop only spans transient network
        errors; past the deadline a TaskFailure names the worker, task
        and attempt."""
        deadline = time.time() + self.status_deadline
        last = None
        while True:
            try:
                return _get_json(f"{uri}/v1/task/{task_id}", self.status_timeout)
            except urllib.error.HTTPError as e:
                # the worker answered with an error (404 after a restart,
                # 500): definitive, not worth polling out the deadline
                detail, _retryable = _http_error_details(e)
                raise TaskFailure(f"status of task {task_id} on worker {uri} (attempt "
                                  f"{attempt}): HTTP {e.code}: {detail}",
                                  uri=uri, task_id=task_id, attempt=attempt) from None
            except (OSError, ValueError) as e:  # poll again until the deadline
                last = e
            if time.time() >= deadline:
                raise TaskFailure(f"status poll for task {task_id} on worker {uri} (attempt "
                                  f"{attempt}) exceeded {self.status_deadline:.0f}s deadline: "
                                  f"{last}", uri=uri, task_id=task_id, attempt=attempt) from None
            time.sleep(0.1)


class ClusterMemoryManager:
    """Coordinator-side cluster memory management (reference
    memory/ClusterMemoryManager.java:89,210 + LowMemoryKiller.java:26):
    polls every worker's /v1/memory, sums each query's reservation across
    the cluster, and when a worker stays memory-blocked kills the query
    with the LARGEST total reservation (TotalReservation) on every
    worker."""

    def __init__(self, nodes: NodeManager, interval: float = 0.25, on_kill=None,
                 grace_polls: int = 4, revoke_watermark: Optional[float] = None):
        self.nodes = nodes
        self.interval = interval
        self.on_kill = on_kill
        self.grace_polls = grace_polls  # sustained blockage before a kill
        # fraction of a worker's limit past which admission holds new
        # queries back (above_watermark)
        self.revoke_watermark = (knobs.revoke_watermark() if revoke_watermark is None
                                 else revoke_watermark)
        self._pressure = False
        self._blocked_streak = 0
        self.killed: List[str] = []
        # blindness is counted and surfaced, never skipped silently
        self.poll_failures: Dict[str, int] = {}
        self.loop_errors = 0
        self.last_loop_error = ""
        self.last_snapshot: Dict[str, dict] = {}
        # per-worker last-seen revocation counters (a flapping worker in a
        # summed total would fake or hide progress)
        self._last_rev_by_worker: Dict[str, int] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="ptpu-memmgr")

    def start(self) -> "ClusterMemoryManager":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.poll_once()
            except Exception as exc:  # noqa: BLE001 - counted, and polling goes on
                self.loop_errors += 1
                self.last_loop_error = repr(exc)[:300]

    def above_watermark(self) -> bool:
        """Was any worker above the revocation watermark, or blocked, at
        the last poll? Resource-group admission starts no new query while
        it is (server/resource_groups.py cluster_pressure)."""
        return self._pressure

    def poll_once(self) -> Optional[str]:
        """One manager cycle; returns the killed query id, if any."""
        states = []
        snapshot: Dict[str, dict] = {}
        for uri in self.nodes.active_workers():
            try:
                states.append((uri, _get_json(f"{uri}/v1/memory", 5)))
            except (OSError, ValueError):
                # counted; demoting the worker is the failure detector's job
                self.poll_failures[uri] = self.poll_failures.get(uri, 0) + 1
                snapshot[uri] = {"unreachable": True, "poll_failures": self.poll_failures[uri]}
        progress = False
        pressure = False
        for uri, st in states:
            reserved = int(st.get("reserved") or 0)
            limit = st.get("limit") or 0
            rev = st.get("revocations") or {}
            completed = int(rev.get("completed") or 0)
            if completed > self._last_rev_by_worker.get(uri, completed):
                progress = True
            self._last_rev_by_worker[uri] = completed
            if st.get("blocked") or (limit and reserved >= self.revoke_watermark * limit):
                pressure = True
            snapshot[uri] = {
                "reserved": reserved,
                "limit": limit,
                "blocked": len(st.get("blocked") or ()),
                "exec_reserved": int(st.get("exec_reserved") or 0),
                "revocations": rev,
                "over_frees": int(st.get("over_frees") or 0),
                "spilled_bytes": int((st.get("spill") or {}).get("total_written") or 0),
                "poll_failures": self.poll_failures.get(uri, 0),
            }
        self.last_snapshot = snapshot
        self._pressure = pressure
        if not any(st.get("blocked") for _, st in states):
            self._blocked_streak = 0
            return None
        # revoke before kill: while executors keep completing revocations
        # the blockage is being worked on
        if progress:
            self._blocked_streak = 0
            return None
        # transient blocking is flow control; only sustained exhaustion
        # triggers the killer
        self._blocked_streak += 1
        if self._blocked_streak < self.grace_polls:
            return None
        self._blocked_streak = 0
        victim = self.choose_victim(states)
        if victim is None:
            return None
        self.kill(victim)
        return victim

    @staticmethod
    def choose_victim(states) -> Optional[str]:
        """TotalReservation: the query holding the most bytes cluster-wide
        (blocked queries without reservations are victims of last resort)."""
        totals: Dict[str, int] = {}
        for _uri, st in states:
            for qid, nbytes in (st.get("queries") or {}).items():
                totals[qid] = totals.get(qid, 0) + int(nbytes)
            for qid in st.get("blocked") or ():
                totals.setdefault(qid, 0)
        if not totals:
            return None
        return max(totals, key=lambda q: (totals[q], q))

    def kill(self, query_id: str) -> None:
        # every known worker: a blacklisted one can still hold tasks of it
        for uri in self.nodes.all_workers():
            try:
                req = urllib.request.Request(f"{uri}/v1/query/{query_id}", method="DELETE")
                urllib.request.urlopen(req, timeout=5).read()
            except OSError:  # a worker gone holds no task of the query
                pass
        self.killed.append(query_id)
        if self.on_kill is not None:
            self.on_kill(query_id)


class HttpClusterSession:
    """Session facade executing SQL over an HTTP worker cluster (the
    DistributedQueryRunner analog). The coordinator plans, fragments and
    runs the root fragment on its catalog's device."""

    def __init__(self, catalog, nodes: NodeManager, broadcast_threshold=None,
                 memory_manager: bool = False, scheduler_opts: Optional[dict] = None,
                 result_cache: bool = True):
        from ..session import Session

        device = getattr(catalog, "device", "cuda")
        self._planner = Session(catalog, device=device)  # parse, plan, optimize
        self.catalog = catalog
        self.broadcast_threshold = broadcast_threshold
        self.result_cache = result_cache
        self.scheduler = HttpScheduler(catalog, nodes, device=device, **(scheduler_opts or {}))
        self._id_prefix = uuid.uuid4().hex[:8]
        self._query_ids = itertools.count(1)
        self.memory_manager = ClusterMemoryManager(nodes).start() if memory_manager else None

    def _run_fragmented(self, sql: str, use_result_cache: bool = True):
        """The one plan -> fragment -> schedule pipeline of query() and
        explain_analyze(); returns (fragmented node, result page, trace or
        None, phase ms). Both serving caches (exec/qcache.py) sit in front
        of the scheduler: the fragmented plan is cached per (sql, worker
        count, broadcast setting, feedback generation) and validated
        against the tables' snapshot versions, and a snapshot-identical
        repeat serves its page without touching the fleet. With tracing
        on, the query's root and its plan and execute spans open here and
        the scheduler hangs the fleet's spans under execute."""
        from ..obs import span as obs_span
        from ..obs.export import export_query

        trace = obs_span.TRACES.new_trace() if obs_span.enabled() else None
        root = trace.begin("query", sql=sql[:200]) if trace is not None else None
        status = "ok"
        phase_ms: dict = {}
        try:
            node, page = self._plan_and_run(sql, use_result_cache, trace, root, phase_ms)
            return node, page, trace, phase_ms
        except Exception:
            status = "error"
            raise
        finally:
            if trace is not None:
                trace.finish(root, status)
                export_query(status, root.wall_s, phase_ms)

    def _plan_and_run(self, sql: str, use_result_cache: bool, trace, root, phase_ms: dict):
        from ..exec import qcache
        from ..plan import history as H
        from ..plan.fragment import fragment_plan

        pspan = trace.begin("plan", parent=root) if trace is not None else None
        n_workers = max(len(self.scheduler.nodes.active_workers()), 2)

        def plan_fresh():
            key = ("c", sql, self.broadcast_threshold, n_workers, id(self.catalog),
                   H.plan_env_token())
            ent = qcache.PLAN_CACHE.lookup(key, self.catalog)
            if ent is not None:
                return ent.plan
            planned = fragment_plan(self._planner.plan(sql), self.catalog,
                                    self.broadcast_threshold, num_workers=n_workers)
            qcache.PLAN_CACHE.store(key, planned, self.catalog)
            return planned

        node = plan_fresh()
        if pspan is not None:
            trace.finish(pspan)
            phase_ms["plan"] = round(pspan.wall_s * 1e3, 3)
        rkey = ("cr", sql, self.broadcast_threshold, n_workers, id(self.catalog))
        pre = None
        if use_result_cache:
            hit = qcache.RESULT_CACHE.lookup(rkey, self.catalog)
            if hit is not None:
                self.scheduler.record_caches(qcache.snapshot_all())
                return node, hit.page
            pre = qcache.RESULT_CACHE.preversions(node, self.catalog)
        espan = trace.begin("execute", parent=root) if trace is not None else None
        tctx = (trace, espan.span_id) if trace is not None else None
        try:
            try:
                page = self.scheduler.run(node, query_id=self._new_query_id(), trace_ctx=tctx)
            except H.AdaptiveReplan:
                # the scheduler recorded the contradicting observation: a
                # fresh plan (new generation, new key) re-plans the fragments
                # downstream on it. One replan per query.
                node = plan_fresh()
                page = self.scheduler.run(node, query_id=self._new_query_id(), adapt=False,
                                          trace_ctx=tctx)
        except Exception:
            if espan is not None:
                trace.finish(espan, "error")
            raise
        if espan is not None:
            # no row count on the span: on the card it is a host read
            trace.finish(espan)
            phase_ms["execute"] = round(espan.wall_s * 1e3, 3)
        if pre is not None and qcache.plan_is_deterministic(node):
            qcache.RESULT_CACHE.store(rkey, page, getattr(node, "titles", ()), self.catalog, pre)
        self.scheduler.record_caches(qcache.snapshot_all())
        return node, page

    def _new_query_id(self) -> str:
        # unique across sessions sharing workers: per-query memory
        # accounting and the killer never merge two sessions' queries
        return f"q_{self._id_prefix}_{next(self._query_ids)}"

    def query(self, sql: str):
        from ..session import QueryResult

        node, page, trace, phase_ms = self._run_fragmented(sql,
                                                           use_result_cache=self.result_cache)
        res = QueryResult(page, node.titles)
        if trace is not None:
            res.trace_id = trace.trace_id
            res.phase_ms = phase_ms
        return res

    def explain_analyze(self, sql: str) -> str:
        """Run the query over the cluster (never from the result cache) and
        render the fragmented plan with each exchange's wire: pages, wire
        and raw bytes, the ratio, encode and decode wall, pull concurrency
        and the copies between the card and the host."""
        from ..exec import qcache

        node, _page, trace, _phase_ms = self._run_fragmented(sql, use_result_cache=False)
        lines = [N.plan_tree_str(node)]
        st = self.scheduler.stats_snapshot()
        if st["wire_caps"]:
            lines.append("-- wire: v%s, codecs %s" % (
                st["wire_caps"].get("version"), "/".join(st["wire_caps"].get("codecs") or ())))
        for sid, ex in sorted(st["exchange"].items()):
            prod = ex.get("producer") or {}
            ratio = prod.get("compression_ratio")
            lines.append(
                f"-- exchange {sid}: {ex['pages']} pages from {ex['sources']} producers, wire "
                f"{ex['wire_bytes']:,}B"
                + (f" (raw {prod['raw_bytes']:,}B, {ratio}x)"
                   if prod.get("raw_bytes") and ratio else "")
                + f", encode {prod.get('encode_ms', 0)}ms, decode {ex['decode_ms']}ms, "
                f"pull peak {ex['peak_concurrent']} concurrent, device-to-host copies "
                f"{prod.get('d2h_copies', 0)}")
            lines.append(
                f"-- exchange {sid} overlap: wire {ex['pull_ms']}ms, consumer wait "
                f"{ex.get('consumer_wait_ms', 0)}ms, hidden {ex.get('hidden_ms', 0)}ms "
                f"({round(100 * ex.get('overlap_frac', 0.0))}%)")
        if st.get("hier"):
            h = st["hier"]
            lines.append(
                f"-- hier: {h['collective_exchanges']}/{h['exchanges']} batches collective, "
                f"regroup {h['collective_ms']}ms, {h['wire_pages']} ragged pages, "
                f"{h['wire_bytes']:,}B")
        if st["memory"]:
            m = st["memory"]
            lines.append("-- memory: spill " + ",".join(m.get("events") or ("none",))
                         + f", disk {m.get('spilled_bytes', 0):,}B, "
                         f"revocations {m.get('revocations', 0)}")
        if st["caches"]:
            lines.append("-- caches: " + qcache.format_summary(st["caches"]))
        if trace is not None:
            # the renderer Session.explain_analyze_plan uses
            from ..obs.span import render_critical_path

            lines.append("-- trace: " + render_critical_path(trace, knobs.trace_topk()))
        return "\n".join(lines)

    def close(self):
        if self.memory_manager is not None:
            self.memory_manager.stop()
