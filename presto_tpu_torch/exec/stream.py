"""Streaming (paged) plan execution under a device-memory budget (torch
counterpart of presto_tpu/exec/stream.py).

Re-designed equivalent of the reference's worker streaming pipeline: the
Driver loop pulling pages operator to operator
(presto-main/.../operator/Driver.java:347-430), split scans
(SourcePartitionedScheduler + ConnectorPageSource), and the revocable
memory and spill machinery (memory/MemoryPool.java:43,
operator/HashBuilderOperator.java:155-180 SPILLING_INPUT, spiller/):

* A batch is a device Page of at most `batch_rows` rows; the host loop
  streams leaf batches through stateless operators into accumulating
  sinks, so a base table is never resident on the card.
* Aggregations accumulate PARTIAL states on the card and merge them
  periodically (ops/aggregate.decompose_partial). Partial and merge
  passes try the group-by kernel first (csrc/groupby_partials.cu: the
  dense strategy, then the hash-slot strategy), then the sorted path.
* Join build sides materialize on the card under a MemoryPool budget.
  Past it they offload to pinned host memory, then to disk (exec/spill.py,
  exec/spillspace.py), and INNER joins run as a partitioned hybrid hash
  join: the partitions that fit stay resident and join in one pass over
  the probe, the rest of the probe spills alongside the build, and each
  deferred pair joins later, recursively repartitioned on fresh hash bits
  when it is still too large. Builds and probes go through the join
  kernels (csrc/join_insert.cu, csrc/join_probe.cu) via ops/join.py.
* Semi joins (IN, EXISTS, NOT IN) whose source exceeds the budget run
  partitioned the same way (the JAX package raises there); outer joins
  whose build exceeds it raise MemoryExceededError, as there.
* Sorts and windows beyond the budget run external (exec/spill.py);
  LIMIT stops the scan.

The JAX package routes around faults in four places (a breaker around the
hybrid join, the host dynamic filter, the hash-slot group-by, and history
sizing): here a fault propagates and fails the query. Two routes are
choices of algorithm and stay: keys whose dictionaries are too large to
value-hash take the chunked build loop (`_hybrid_unsafe_keys`), and an
all-ties or depth-exhausted partition takes build chunks (counted in
spill_stats["chunk_fallbacks"]). With feedback on (plan/history.py), a
join frame that recursed before starts with its recorded partitions
scaled by 2^depth (`_hybrid_history_parts`), and each hybrid join records
how it partitioned (`_record_hybrid_outcome`).

Results of external sorts and spilled aggregations are host-backed pages;
Output takes them as they are, and any other operator above gets them
uploaded again, so a session on the card never computes on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from .. import types as T
from ..expr import ir
from ..expr.compiler import evaluate
from ..ops.aggregate import (apply_avg_post, decompose_partial, global_aggregate,
                             grouped_aggregate_sorted)
from ..ops.filter import compact, filter_page
from ..ops.join import build, join_n1, null_aware_anti, semi_match_mask, source_null_state
from ..ops.sort import distinct_page, limit_page, sort_page, top_n
from ..ops.union import concat_pages
from ..page import Page, round_capacity
from ..plan import nodes as N
from .executor import Executor
from .memory import MemoryExceededError, MemoryPool
from .qcache import plan_tables
from .spill import HostTable, SpilledRows, hash_partition_indices, partition_of
from .stats import page_device_bytes

__all__ = ["coalesce_pages", "HostTable", "StreamingExecutor"]

# the sorted group-by holds about five times its input at its peak (the
# input, the hash keys and their sort permutation, the columns gathered into
# sorted order, the wide decimal sums, the output; 325 MB for a 64 MB batch
# of 4,194,304 rows, profiled on the CPU): the aggregate sink keeps merged
# state on the card only while that working set fits the budget, and sizes
# its final partitions by it (the JAX package counts the state alone)
_AGG_WORK = 5


def coalesce_pages(pages: Iterator[Page], target_rows: int) -> Iterator[Page]:
    """Merge consecutive small pages into ~target_rows batches, so sinks
    see full batches instead of a kernel dispatch per sliver. A stream of
    only empty pages coalesces to ONE empty page, so the schema survives;
    an empty iterator stays empty."""
    held: List[Page] = []
    held_rows = 0
    for page in pages:
        n = int(page.count)
        if n >= target_rows and not held:
            yield page
            continue
        held.append(page)
        held_rows += n
        if held_rows >= target_rows:
            yield held[0] if len(held) == 1 else concat_pages(held)
            held, held_rows = [], 0
    if held:
        yield held[0] if len(held) == 1 else concat_pages(held)


def _owned(page: Page) -> Page:
    """`page` with every tensor owning its storage. A shrunk or sliced page
    views the storage of the capacity it came from (a 4,194,304-row batch,
    a sort's full-length scratch): a page the executor holds on to (a build
    side, aggregate state) must not keep that alive, nor count less than it
    holds (page_device_bytes counts the views)."""
    def own(t):
        if t is None or t.untyped_storage().nbytes() <= t.numel() * t.element_size():
            return t
        return t.clone()

    blocks = tuple(dataclasses.replace(b, data=own(b.data), valid=own(b.valid),
                                       lengths=own(b.lengths), elem_valid=own(b.elem_valid))
                   for b in page.blocks)
    return Page(blocks, page.names, page.count)


def _pushdown_hints(predicate, scan_node: N.TableScan):
    """(source_column, op, python_value) pruning hints from simple
    conjuncts over scanned columns (the TupleDomain-lite of the SPI)."""
    import datetime as pydt
    import decimal as pydec

    to_source = {ch: col for ch, col, _ in scan_node.columns}
    types = {ch: typ for ch, _, typ in scan_node.columns}
    conjuncts: List = []

    def split(e):
        if isinstance(e, ir.Call) and e.name == "and":
            for a in e.args:
                split(a)
        else:
            conjuncts.append(e)

    split(predicate)
    flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}
    hints = []

    def value_for(ch, lit):
        typ = types.get(ch)
        v = lit.value
        if v is None:
            return None
        if isinstance(typ, T.DateType):
            if isinstance(v, str):
                return pydt.date.fromisoformat(v)
            return pydt.date(1970, 1, 1) + pydt.timedelta(days=int(v))
        if isinstance(typ, T.DecimalType):
            # the literal carries the LOGICAL value
            return float(v) if not isinstance(v, pydec.Decimal) else v
        if isinstance(typ, T.VarcharType):
            return v if isinstance(v, str) else None
        return v

    def in_values(e):
        """(channel, values) for `col IN (lit...)` and an OR of equalities
        over ONE column: both become the SPI 'in' hint."""
        if e.name == "in" and isinstance(e.args[0], ir.ColumnRef):
            col, opts = e.args[0], e.args[1:]
            if all(isinstance(o, ir.Literal) for o in opts):
                return col.name, opts
            return None
        if e.name == "or":
            col = None
            opts = []
            for part in e.args:
                if not (isinstance(part, ir.Call) and part.name == "eq" and len(part.args) == 2):
                    return None
                a, b = part.args
                if isinstance(b, ir.ColumnRef) and isinstance(a, ir.Literal):
                    a, b = b, a
                if not (isinstance(a, ir.ColumnRef) and isinstance(b, ir.Literal)):
                    return None
                if col is None:
                    col = a.name
                elif col != a.name:
                    return None
                opts.append(b)
            return (col, tuple(opts)) if col is not None else None
        return None

    for e in conjuncts:
        if not isinstance(e, ir.Call):
            continue
        iv = in_values(e)
        if iv is not None:
            col_name, opts = iv
            if col_name in to_source:
                vals = tuple(value_for(col_name, o) for o in opts)
                if all(v is not None for v in vals):
                    hints.append((to_source[col_name], "in", vals))
            continue
        if e.name == "between" and isinstance(e.args[0], ir.ColumnRef):
            col, lo, hi = e.args
            if col.name in to_source and isinstance(lo, ir.Literal) and isinstance(hi, ir.Literal):
                vlo, vhi = value_for(col.name, lo), value_for(col.name, hi)
                if vlo is not None:
                    hints.append((to_source[col.name], "ge", vlo))
                if vhi is not None:
                    hints.append((to_source[col.name], "le", vhi))
            continue
        if e.name not in flip or len(e.args) != 2:
            continue
        a, b = e.args
        if isinstance(a, ir.ColumnRef) and isinstance(b, ir.Literal):
            col, lit, op = a, b, e.name
        elif isinstance(b, ir.ColumnRef) and isinstance(a, ir.Literal):
            col, lit, op = b, a, flip[e.name]
        else:
            continue
        if col.name not in to_source:
            continue
        v = value_for(col.name, lit)
        if v is not None:
            hints.append((to_source[col.name], op, v))
    return hints or None


class StreamingExecutor:
    """Host loop over device page batches (reference Driver +
    TaskExecutor collapsed: one Python loop, the operators on the card)."""

    def __init__(self, catalog, device="cuda", batch_rows: int = 1 << 20,
                 memory_budget: Optional[int] = None, collector=None,
                 pallas_groupby: bool = True, query_id: str = "", worker_pool=None,
                 spill_space=None):
        self._catalog = catalog
        self.device = torch.device(device)
        self.batch_rows = batch_rows
        self.query_id = query_id or f"local-{id(self):x}"
        # on a cluster worker the pool mirrors into the worker's ledger
        # (server/worker.py WorkerMemoryPool)
        self.pool = MemoryPool(memory_budget, name=self.query_id, parent=worker_pool,
                               query_id=self.query_id)
        self.local = Executor(catalog, device=self.device, collector=collector,
                              pallas_groupby=pallas_groupby)
        self.collector = collector
        # dynamic filters are shared with the delegate executor: joins
        # publish there, and scans and filters running through exec_node
        # read the same registry (exec/dynfilter.py)
        self.dyn_ctx = self.local.dyn_ctx
        # which operators offloaded this query (reference OperatorStats
        # spill counters)
        self.spill_events: List[str] = []
        # the ladder's counters (EXPLAIN ANALYZE's memory line): disk bytes
        # written, hybrid-join partitions and recursion depth, chunk-loop
        # routes (all-ties / depth exhausted), the ragged layout of the
        # last hybrid join's deferred partitions, and the aggregate sink's
        # batches through the group-by kernel strategies
        self.spill_stats: Dict[str, int] = {
            "disk_bytes": 0,
            "hybrid_parts": 0,
            "hybrid_depth": 0,
            "chunk_fallbacks": 0,
            "ragged_pages": 0,
            "ragged_occupancy_pct": 0,
            "agg_hash_batches": 0,
            "agg_dense_batches": 0,
        }
        # opened at the first spill of a query, or given by a worker task
        # (which releases it)
        self._spill_space = spill_space

    @property
    def catalog(self):
        return self._catalog

    @catalog.setter
    def catalog(self, catalog) -> None:
        # a transaction overlay or DELETE's numbered table swaps it
        self._catalog = catalog
        self.local.catalog = catalog

    @property
    def dynamic_filtering(self) -> bool:
        return self.local.dynamic_filtering

    @dynamic_filtering.setter
    def dynamic_filtering(self, on: bool) -> None:
        self.local.dynamic_filtering = on

    def _spill(self):
        """The lazily opened spill space (exec/spillspace.py): disk quota
        accounting and guaranteed file cleanup at run() end."""
        if self._spill_space is None:
            from .spillspace import SPILL_MANAGER

            self._spill_space = SPILL_MANAGER.open(self.query_id)
        return self._spill_space

    def _new_spill(self, tag: str) -> SpilledRows:
        return SpilledRows(space=self._spill(), tag=tag, device=self.device)

    def _spill_share(self) -> int:
        """Device bytes one offloaded operator may hold at a time: half the
        budget left after resident reservations."""
        budget = self.pool.max_bytes or (1 << 62)
        return max((budget - self.pool.reserved) // 2, 1)

    def _on_device(self, page: Page) -> Page:
        """A host-backed sink result uploaded whole, for a materializing
        operator above it."""
        return page.to(self.device)

    def _device_batches(self, page: Page) -> Iterator[Page]:
        """A sink's result as the stream above it takes it: `batch_rows`
        rows at a time (slices of a page on the device; uploads of a
        host-backed one, an external sort's or a spilled aggregation's), so
        the operators above hold no more than a batch of it."""
        n = int(page.count)
        B = self.batch_rows
        if page.device == self.device and page.capacity <= B:
            yield page
            return
        for start in range(0, max(n, 1), B):
            stop = min(start + B, n)
            blocks = [b.take_rows(slice(start, stop)).to(self.device) for b in page.blocks]
            yield Page.from_blocks(blocks, page.names, count=stop - start, device=self.device)

    def _apply(self, node: N.PlanNode, *pages: Page) -> Page:
        """One operator over one batch, recorded per batch under EXPLAIN
        ANALYZE (host wall, rows in and out)."""
        if self.collector is None:
            return self.local.exec_node(node, *pages)
        t0 = time.perf_counter()
        out = self.local.exec_node(node, *pages)
        self.collector.record(node, time.perf_counter() - t0, [p.count for p in pages],
                              out.count, page_device_bytes(out))
        return out

    def _record_sink(self, node: N.PlanNode, t0: float, out: Page) -> Page:
        if self.collector is not None:
            self.collector.record(node, time.perf_counter() - t0, [], out.count,
                                  page_device_bytes(out))
        return out

    def _collect_or_spill(self, child: N.PlanNode, tag: str, whole_budget: bool = True):
        """Accumulate a child stream on the card while the budget allows;
        past it, or when a revoke is pending, move everything to a
        SpilledRows store (host, then disk). With `whole_budget` False (a
        join build or semi-join source, which has an offloaded path and a
        probe side still to run) the state may take only half the budget
        left (`_spill_share`), so the joins nested in its probe side keep
        room for their own builds; the JAX package lets each take all of it,
        and a nested join then finds the budget spent. Returns
        (first_batch, device_batches, held_bytes, spilled_or_None)."""
        limit = None if whole_budget else self._spill_share()
        batches: List[Page] = []
        held = 0
        spilled = None
        first: Optional[Page] = None
        for b in self.stream(child):
            if first is None:
                first = b  # schema carrier for the all-empty case
            if int(b.count) == 0:
                continue
            nb = page_device_bytes(b)
            if spilled is None and self.pool.can_accumulate(held + nb) and (
                    limit is None or held + nb <= limit):
                batches.append(_owned(b))
                held += nb
                self.pool.accumulated = held
                continue
            if spilled is None:
                self.spill_events.append(tag)
                spilled = self._new_spill(tag)
                for p in batches:
                    spilled.append(p)
                batches = []
                self.pool.note_revoked(held)
                held = 0
                self.pool.accumulated = 0
            spilled.append(b)
        self.pool.accumulated = 0
        return first, batches, held, spilled

    # -- public --

    def run(self, node: N.PlanNode) -> Page:
        # dynamic filters and sample offsets are per-query state
        self.dyn_ctx.reset()
        self.local._sample_pos.clear()
        try:
            return self._run(node)
        finally:
            self.release_spill()

    def release_spill(self) -> None:
        """Guaranteed spill cleanup: fold the disk-tier counter into the
        stats and unlink this query's spill files."""
        if self._spill_space is not None:
            self.spill_stats["disk_bytes"] += self._spill_space.written
            self._spill_space.release()
            self._spill_space = None

    # -- top-level dispatch: sinks consume streams --

    def _run(self, node: N.PlanNode) -> Page:
        if isinstance(node, N.Output):
            return self._apply(node, self._run(node.child))
        t0 = time.perf_counter()
        if isinstance(node, N.Aggregate):
            return self._record_sink(node, t0, self._sink_aggregate(node))
        if isinstance(node, N.Distinct):
            return self._record_sink(node, t0, self._sink_distinct(node))
        if isinstance(node, N.TopN):
            return self._record_sink(node, t0, self._sink_topn(node))
        if isinstance(node, N.Limit):
            return self._record_sink(node, t0, self._sink_limit(node))
        if isinstance(node, N.Sort):
            return self._record_sink(node, t0, self._sink_sort(node))
        return self._materialize(node)

    def _materialize(self, node: N.PlanNode) -> Page:
        pages: List[Page] = []
        first: Optional[Page] = None
        for p in self.stream(node):
            if first is None:
                first = p  # schema carrier for the all-empty case
            if int(p.count) > 0:
                pages.append(p)
        if not pages:
            return first
        if len(pages) == 1:
            return pages[0]
        return concat_pages(pages)

    # -- streaming core: a generator of batches per node --

    def stream(self, node: N.PlanNode) -> Iterator[Page]:
        if isinstance(node, N.TableScan):
            yield from self._stream_scan(node)
        elif isinstance(node, N.Filter) and isinstance(node.child, N.TableScan):
            # predicate pushdown hint: simple conjuncts may prune at the
            # connector; the filter still runs on every delivered batch
            hints = _pushdown_hints(node.predicate, node.child)
            for batch in self._stream_scan(node.child, predicate=hints):
                yield self._apply(node, batch)
        elif isinstance(node, (N.Filter, N.Project, N.Unnest, N.Sample)):
            # row-local and stateless: apply per batch (Unnest expands
            # within the batch, which keeps the budget honest)
            for batch in self.stream(node.child):
                yield self._apply(node, batch)
        elif isinstance(node, N.Join) and node.kind in ("inner", "left") and not (
                node.kind == "left" and node.residual is not None):
            yield from self._stream_join(node)
        elif isinstance(node, N.SemiJoin) and node.residual is None:
            yield from self._stream_semijoin(node)
        elif isinstance(node, N.ScalarApply):
            sub = self._on_device(self._run(node.subquery))
            for batch in self.stream(node.child):
                yield self._apply(node, batch, sub)
        elif isinstance(node, N.Union) and not node.distinct:
            first_names = None
            for child in node.children:
                for batch in self.stream(child):
                    if first_names is None:
                        first_names = batch.names
                    yield Page(batch.blocks, first_names, batch.count)
        elif isinstance(node, N.Window) and node.partition_exprs:
            yield from self._stream_window(node)
        elif isinstance(node, (N.Aggregate, N.Distinct, N.TopN, N.Limit, N.Sort)):
            # sinks reached mid-tree still go through their budget-aware
            # sinks; a host-backed result goes back to the card in batches
            yield from self._device_batches(self._run(node))
        else:
            # windows without PARTITION BY, outer and residual joins,
            # distinct unions: materialize the inputs (which still stream
            # where they can) and run the materializing operator
            yield self._exec_fallback(node)

    def _exec_fallback(self, node: N.PlanNode) -> Page:
        pages = [self._on_device(self._run(c)) for c in node.children]
        return self._apply(node, *pages)

    def _scan_out(self, node: N.TableScan, page: Page) -> Page:
        """Post-scan dynamic masks for the filter entries no Filter above
        fuses (the annotation's apply_mask entries)."""
        entries = [(fid, ch) for fid, ch, _src, apply in node.dynamic_filters if apply]
        if entries:
            return self.local._dyn_mask_page(node, page, entries, "scan")
        return page

    def _stream_scan(self, node: N.TableScan, predicate=None) -> Iterator[Page]:
        # row_count is a planner ESTIMATE; drive the scan off the actual
        # batches (or the exact count) until the table ends
        est = self.catalog.row_count(node.table)
        B = self.batch_rows
        scan = getattr(self.catalog, "scan", None)
        if scan is None:
            yield self._scan_out(node, self._rename_scan(node, self.catalog.page(node.table)))
            return
        if est <= B // 2 and not predicate:
            try:
                src = self.catalog.page(node.table)
            except MemoryError:
                pass  # chunked catalogs refuse to materialize; stream below
            else:
                yield self._scan_out(node, self._rename_scan(node, src))
                return
        cols = [col for _, col, _ in node.columns]
        exact = getattr(self.catalog, "exact_row_count", None)
        total = exact(node.table) if exact is not None else None
        if total is None:
            # without an exact count a short batch is the only end signal,
            # and pruning may shorten any batch: drop the optional hints
            predicate = None
        start = 0
        read_total = skipped_total = 0
        while True:
            src = scan(node.table, start, start + B, pad_to=B, columns=cols,
                       predicate=predicate)
            # the connector's pruning counters are per scan CALL: keep the
            # highest over the batches — exact for partition pruning (every
            # call sees the whole file set), a per-batch high-water mark for
            # stripe and shard pruning (each call sees only its range)
            skipped_total = max(skipped_total,
                                getattr(self.catalog, "last_scan_files_skipped", 0) or 0)
            read_total = max(read_total, getattr(self.catalog, "last_scan_files_read", 0) or 0)
            n = int(src.count) if total is None else max(min(total - start, B), 0)
            if n > 0 or start == 0:
                yield self._scan_out(node, self._rename_scan(node, src))
            start += B
            if (start >= total) if total is not None else (n < B):
                # connector pruning in EXPLAIN ANALYZE (reference: the hive
                # split source reports the partitions it skipped)
                if skipped_total and self.collector is not None:
                    self.collector.stats_for(node).detail = (
                        f"files: {read_total} read, {skipped_total} pruned")
                return

    def _rename_scan(self, node: N.TableScan, src: Page) -> Page:
        src = src.to(self.device)
        blocks = tuple(src.block(col) for _ch, col, _typ in node.columns)
        return Page(blocks, tuple(ch for ch, _col, _typ in node.columns), src.count)

    # -- joins --

    def _collect_side(self, node: N.PlanNode, inner: bool = True):
        """Materialize a build side on the card within budget; offload it
        to a SpilledRows store (host, then disk) when its share runs out or
        a revoke is pending (HashBuilderOperator's revoke-to-spill). An
        outer join, which has no offloaded path, may use the whole budget
        left before it raises."""
        first, batches, held, spilled = self._collect_or_spill(node, "join_build",
                                                               whole_budget=not inner)
        if spilled is not None:
            return "spilled", spilled
        if not batches and first is not None:
            batches.append(first)  # keep the schema carrier
        self.pool.reserve(held, "join build side")
        page = batches[0] if len(batches) == 1 else concat_pages(batches)
        return "device", (page, held)

    def _bucket_side_info(self, side: N.PlanNode):
        """(scan_node, wrappers, (bucket_cols, count)) when `side` is a
        Filter/Project chain over a TableScan of a BUCKETED table."""
        wrappers = []
        n = side
        while isinstance(n, (N.Filter, N.Project)):
            wrappers.append(n)
            n = n.child
        if not isinstance(n, N.TableScan):
            return None
        bucketing = getattr(self.catalog, "bucketing", None)
        if bucketing is None:
            return None
        spec = bucketing(n.table)
        if spec is None:
            return None
        return n, tuple(reversed(wrappers)), spec

    def _grouped_join_spec(self, node: N.Join):
        """A co-located bucket join: both sides bucketed with the same
        bucket count, and the bucket columns PAIRED at one equi-key index
        (single-column buckets)."""
        li = self._bucket_side_info(node.left)
        ri = self._bucket_side_info(node.right)
        if li is None or ri is None:
            return None
        (lscan, lwrap, (lcols, lcount)) = li
        (rscan, rwrap, (rcols, rcount)) = ri
        if lcount != rcount or len(lcols) != 1 or len(rcols) != 1:
            return None
        lsrc = {ch: col for ch, col, _ in lscan.columns}
        rsrc = {ch: col for ch, col, _ in rscan.columns}
        paired = any(
            isinstance(lk, ir.ColumnRef) and isinstance(rk, ir.ColumnRef)
            and lsrc.get(lk.name) == lcols[0] and rsrc.get(rk.name) == rcols[0]
            for lk, rk in zip(node.left_keys, node.right_keys)
        )
        if not paired:
            return None
        return (lscan, lwrap), (rscan, rwrap), lcount

    def _stream_side_bucket(self, scan_node: N.TableScan, wrappers, bucket: int):
        """Batches of ONE bucket of a side, its Filter/Project chain
        applied per batch."""
        cols = [col for _, col, _ in scan_node.columns]
        for lo, hi in self.catalog.bucket_row_ranges(scan_node.table, bucket):
            for s in range(lo, hi, self.batch_rows):
                src = self.catalog.scan(scan_node.table, s, min(s + self.batch_rows, hi),
                                        columns=cols)
                page = self._rename_scan(scan_node, src)
                for w in wrappers:
                    page = self._apply(w, page)
                yield page

    def _grouped_bucket_join(self, node: N.Join, spec) -> Iterator[Page]:
        """Bucket-at-a-time execution (reference Lifespan +
        GROUPED_EXECUTION): bucket i's build and probe run end to end
        before bucket i+1, so one bucket's build is resident at a time."""
        (lscan, lwrap), (rscan, rwrap), count = spec
        right_names = tuple(n for n, _ in node.right.fields)
        for b in range(count):
            build_batches = [p for p in self._stream_side_bucket(rscan, rwrap, b)
                             if int(p.count) > 0]
            if not build_batches:
                continue  # inner join: an empty build bucket matches nothing
            # a skewed bucket can still exceed the budget: probe it in
            # build sub-chunks (inner joins distribute over build chunks)
            chunks: List[List[Page]] = [[]]
            held = 0
            for p in build_batches:
                nb = page_device_bytes(p)
                if chunks[-1] and not self.pool.can_reserve(held + nb):
                    chunks.append([])
                    held = 0
                chunks[-1].append(p)
                held += nb
            for chunk in chunks:
                build_page = chunk[0] if len(chunk) == 1 else concat_pages(chunk)
                nb = page_device_bytes(build_page)
                self.pool.reserve(nb, f"bucket {b} build side")
                try:
                    yield from self._probe_stream(node, build_page, right_names,
                                                  probe=self._stream_side_bucket(lscan, lwrap, b))
                finally:
                    self.pool.free(nb)

    def _index_join_spec(self, node: N.Join):
        """Index join (reference operator/index/ IndexLoader): the build side
        is a bare TableScan of a connector that serves point lookups on the
        single integral equi-key, and is large against a probe batch."""
        if not isinstance(node.right, N.TableScan):
            return None
        if len(node.right_keys) != 1 or len(node.left_keys) != 1:
            return None
        rkey, lkey = node.right_keys[0], node.left_keys[0]
        if not isinstance(rkey, ir.ColumnRef) or not isinstance(lkey, ir.ColumnRef):
            return None
        # block values are ENCODED (varchar codes, date offsets): only
        # integral keys survive the trip to a remote lookup
        if not (T.is_integral(rkey.type) and T.is_integral(lkey.type)):
            return None
        scan = node.right
        col = {ch: c for ch, c, _ in scan.columns}.get(rkey.name)
        supports = getattr(self.catalog, "supports_index", None)
        if col is None or supports is None or not supports(scan.table, col):
            return None
        if self.catalog.row_count(scan.table) < 4 * self.batch_rows:
            return None
        return scan, col, lkey.name

    def _stream_index_join(self, node: N.Join, spec) -> Iterator[Page]:
        scan, index_col, probe_ch = spec
        right_names = tuple(n for n, _ in node.right.fields)
        cols = [col for _, col, _ in scan.columns]
        for batch in self.stream(node.left):
            blk = batch.block(probe_ch)
            m = int(batch.count)
            keys = blk.data[:m]
            if blk.valid is not None:
                keys = keys[blk.valid[:m]]
            keys = torch.unique(keys).cpu().numpy()
            rows = self.catalog.index_lookup(scan.table, index_col, keys.tolist(), cols)
            build_page = self._rename_scan(scan, rows)
            yield from self._probe_stream(node, build_page, right_names, probe=iter([batch]))

    def _stream_join(self, node: N.Join) -> Iterator[Page]:
        if node.kind == "inner":
            idx = self._index_join_spec(node)
            if idx is not None:
                self.spill_events.append("index_join")
                yield from self._stream_index_join(node, idx)
                return
        # grouped execution covers INNER joins (a LEFT join with an empty
        # build bucket would need schema-only null extension)
        grouped = self._grouped_join_spec(node) if node.kind == "inner" else None
        if grouped is not None:
            self.spill_events.append("grouped_bucket_join")
            yield from self._grouped_bucket_join(node, grouped)
            return
        kind, side = self._collect_side(node.right, inner=node.kind == "inner")
        right_names = tuple(n for n, _ in node.right.fields)
        if kind == "device":
            right_page, held = side
            if node.dynamic_filters:
                # the build side is complete: publish BEFORE the probe
                # stream's scans start pulling batches
                self.local._publish_dynamic_filters(node, right_page)
            try:
                yield from self._probe_stream(node, right_page, right_names)
            finally:
                self.pool.free(held)
            return
        # offloaded build: partitioned hybrid hash join, INNER only
        if node.kind != "inner":
            raise MemoryExceededError(
                "outer join build side exceeds the device budget "
                "(chunked execution covers inner joins)")
        spilled = side
        if node.dynamic_filters:
            self._publish_host_filters(node, spilled)
        if self._hybrid_unsafe_keys(node, spilled):
            self.spill_stats["chunk_fallbacks"] += 1
            yield from self._chunked_host_join(node, spilled, right_names)
            return
        setup = self._hybrid_setup(node, spilled)
        yield from self._hybrid_hash_join(node, spilled, right_names, setup)

    def _hybrid_unsafe_keys(self, node: N.Join, spilled) -> bool:
        """Hash partitioning needs build and probe key hashes to agree for
        equal VALUES: varchar keys hash by dictionary value
        (ops/hashing.hash_rows_values). Only a build-side dictionary beyond
        the value-hash cap routes to the chunked build loop."""
        from ..ops.hashing import value_hashable

        if not any(isinstance(getattr(k, "type", None), T.VarcharType)
                   for k in tuple(node.left_keys) + tuple(node.right_keys)):
            return False
        sample = spilled.take_page(np.arange(min(spilled.num_rows, 1)))
        return not value_hashable([evaluate(e, sample) for e in node.right_keys])

    def _chunked_host_join(self, node: N.Join, spilled, right_names):
        """Offloaded-build execution by chunks: upload budget-sized build
        chunks and re-stream the whole probe against each (inner joins
        distribute over build chunks)."""
        share = self._spill_share()
        rows_per_chunk = max(int(share // max(spilled.row_bytes, 1)), 1)
        for chunk in spilled.iter_pages(rows_per_chunk):
            nb = page_device_bytes(chunk)
            self.pool.reserve(nb, "join build chunk")
            try:
                yield from self._probe_stream(node, chunk, right_names)
            finally:
                self.pool.free(nb)

    def _hybrid_partition_count(self, total_bytes: int, share: int, cap: int = 64,
                                node=None) -> int:
        env = int(os.environ.get("PRESTO_TPU_HYBRID_JOIN_PARTS", "0"))
        if env > 0:
            return env  # manual override beats both heuristics
        # 2x headroom per partition (arXiv:2112.02480: over-partitioning
        # is cheap, under-partitioning forces recursion)
        P = min(max(-(-total_bytes * 2 // max(share, 1)), 2), cap)
        if node is not None:
            P = self._hybrid_history_parts(node, P, cap)
        return P

    def _hybrid_history_parts(self, node: N.Join, P: int, cap: int) -> int:
        """History-based sizing (plan/history.py): a join frame that
        recursed before with P0 partitions wants P0 * 2^depth up front —
        recursion repartitions the SAME rows on fresh hash bits, so
        pre-scaling buys the one-pass layout the byte estimate undersized.
        Never below the byte-derived count, never above `cap`."""
        from ..plan.history import HISTORY, feedback_on, fingerprint

        if not feedback_on():
            return P
        ent = HISTORY.lookup(fingerprint(node), self.catalog)
        if ent is None or not ent.hybrid_parts:
            return P
        want = ent.hybrid_parts << max(int(ent.hybrid_depth), 0)
        return min(max(P, want), cap)

    def _record_hybrid_outcome(self, node: N.Join, P: int, depth_before: int) -> None:
        """Remember how this join frame partitioned (the feedback half of
        _hybrid_history_parts). spill_stats holds the query-wide max depth,
        so only the depth gained since THIS join started is its own."""
        from ..plan.history import HISTORY, feedback_on, fingerprint

        if not feedback_on():
            return
        d = self.spill_stats["hybrid_depth"]
        HISTORY.record(fingerprint(node), catalog=self.catalog, tables=plan_tables(node),
                       hybrid=(P, max(d - depth_before, 0)), kind="Join")

    def _hybrid_setup(self, node: N.Join, spilled) -> dict:
        """Hash-partition the build side, choose the resident set (smallest
        partitions first, up to half the share), and upload and build it."""
        from ..ops import ragged as _ragged

        share = self._spill_share()
        row_b = max(spilled.row_bytes, 1)
        total_bytes = spilled.num_rows * row_b
        P = self._hybrid_partition_count(total_bytes, share, node=node)
        chunk_rows = max(share // (2 * row_b), 1 << 10)
        parts = hash_partition_indices(spilled, node.right_keys, P, chunk_rows, salt=0,
                                       value_safe=True)
        resident: List[int] = []
        acc = 0
        for p in sorted(range(P), key=lambda q: len(parts[q])):
            nb = len(parts[p]) * row_b
            if len(parts[p]) and acc + nb <= share // 2:
                resident.append(p)
                acc += nb
        resident_set = frozenset(resident)
        deferred = [p for p in range(P) if p not in resident_set and len(parts[p])]
        # the ragged paged layout (ops/ragged.py) takes over the DEFERRED
        # partitions' row ids: skewed partitions allocate unequal page
        # counts, and the occupancy lands in EXPLAIN ANALYZE's memory line
        deferred_set = frozenset(deferred)
        rp = _ragged.from_partitions([parts[p] if p in deferred_set else np.empty(0, np.int64)
                                      for p in range(P)])
        for p in deferred:
            parts[p] = None  # owned by the ragged layout now
        self.spill_stats["ragged_pages"] += rp.num_pages
        if rp.num_pages:
            self.spill_stats["ragged_occupancy_pct"] = int(rp.occupancy() * 100)
        bs_mem = None
        mem_held = 0
        if resident:
            idx = np.concatenate([parts[p] for p in sorted(resident)])
            mem_page = spilled.take_page(idx)
            mem_held = page_device_bytes(mem_page)
            self.pool.reserve(mem_held, "hybrid join resident build")
            try:
                bs_mem = build(mem_page, node.right_keys)
            except BaseException:
                self.pool.free(mem_held)
                raise
        res_np = np.zeros(P, np.bool_)
        res_np[resident] = True
        return {
            "P": P, "chunk_rows": chunk_rows, "parts": parts, "ragged": rp,
            "deferred": deferred, "bs_mem": bs_mem, "mem_held": mem_held,
            "res_np": res_np,
            "max_depth": int(os.environ.get("PRESTO_TPU_HYBRID_JOIN_MAX_DEPTH", "3")),
        }

    def _hybrid_hash_join(self, node: N.Join, spilled, right_names, setup):
        """Partitioned hybrid hash join over an offloaded build side
        (reference HashBuilderOperator SPILLING_INPUT +
        GenericPartitioningSpiller; trade-offs per arXiv:2112.02480): ONE
        pass over the probe joins the resident partitions and spills the
        deferred partitions' probe rows; then each deferred (build, probe)
        pair joins, recursively repartitioned on fresh hash bits up to
        PRESTO_TPU_HYBRID_JOIN_MAX_DEPTH, after which an all-ties partition
        takes the chunked build loop."""
        from ..ops.hashing import hash_rows_values

        P = setup["P"]
        chunk_rows = setup["chunk_rows"]
        deferred = setup["deferred"]
        bs_mem = setup["bs_mem"]
        mem_held = setup["mem_held"]
        max_depth = setup["max_depth"]
        depth_before = self.spill_stats["hybrid_depth"]
        self.spill_events.append("hybrid_hash_join")
        self.spill_stats["hybrid_parts"] = max(self.spill_stats["hybrid_parts"], P)
        res_lut = torch.from_numpy(setup["res_np"]).to(self.device)
        probe_spill = self._new_spill("hybrid_probe") if deferred else None
        preprobe = any(not consumed for _f, _i, consumed in node.dynamic_filters)
        first_probe: Optional[Page] = None
        yielded = False
        try:
            for batch in self.stream(node.left):
                if preprobe:
                    batch = self.local._apply_preprobe(node, batch)
                if first_probe is None:
                    first_probe = batch
                # value-safe: must agree with the build side's partitioning
                # for equal VALUES (varchar dictionaries differ per side)
                part = partition_of(hash_rows_values([evaluate(e, batch)
                                                      for e in node.left_keys]), P)
                resident = res_lut[part]
                live = batch.live_mask()
                if bs_mem is not None:
                    mem_batch = compact(batch, resident & live)
                    if int(mem_batch.count) == 0:
                        mem_batch = None
                    for out in () if mem_batch is None else self._probe_with(node, bs_mem, right_names, iter([mem_batch])):
                        yielded = True
                        yield out
                if probe_spill is not None:
                    d_batch = compact(batch, ~resident & live)
                    if int(d_batch.count) > 0:
                        probe_spill.append(d_batch)
        finally:
            if mem_held:
                self.pool.free(mem_held)
        bs_mem = None
        if probe_spill is not None and probe_spill.num_rows:
            pparts = hash_partition_indices(probe_spill, node.left_keys, P, chunk_rows, salt=0,
                                            value_safe=True)
            ragged = setup["ragged"]
            todo = [p for p in deferred if len(pparts[p])]
            builds = spilled.split([ragged.part_rows(p) for p in todo])
            probes = probe_spill.split([pparts[p] for p in todo])
            for build_sub, probe_sub in zip(builds, probes):
                for out in self._join_partition(node, build_sub, probe_sub, right_names, 0,
                                                chunk_rows, max_depth):
                    yielded = True
                    yield out
        if not yielded and first_probe is not None:
            # schema carrier: one probe batch against an empty build, so
            # the sinks always see the output schema
            empty = spilled.take_page(np.empty(0, np.int64))
            yield from self._probe_with(node, build(empty, node.right_keys), right_names,
                                        iter([first_probe]))
        self._record_hybrid_outcome(node, P, depth_before)

    def _join_partition(self, node: N.Join, build_sub, probe_sub, right_names, depth: int,
                        chunk_rows: int, max_depth: int):
        """Join one deferred (build, probe) partition pair: upload the build
        whole when it fits, repartition on fresh hash bits when it does
        not, and take the chunked build loop when partitioning stops making
        progress (all-ties keys) or the depth bound is hit."""
        share = self._spill_share()
        row_b = max(build_sub.row_bytes, 1)
        bbytes = build_sub.num_rows * row_b
        if bbytes * 2 <= share or build_sub.num_rows <= 1:
            page = build_sub.take_page(np.arange(build_sub.num_rows))
            nb = page_device_bytes(page)
            self.pool.reserve(nb, "hybrid join partition build")
            try:
                bs = build(page, node.right_keys)
                yield from self._probe_with(node, bs, right_names,
                                            probe_sub.iter_pages(chunk_rows))
            finally:
                self.pool.free(nb)
            return
        if depth < max_depth:
            P2 = self._hybrid_partition_count(bbytes, share, cap=16)
            salt = 7 * (depth + 1)  # fresh hash bits each level
            bparts = hash_partition_indices(build_sub, node.right_keys, P2, chunk_rows,
                                            salt=salt, value_safe=True)
            if max(len(i) for i in bparts) < build_sub.num_rows:
                self.spill_stats["hybrid_depth"] = max(self.spill_stats["hybrid_depth"],
                                                       depth + 1)
                pparts = hash_partition_indices(probe_sub, node.left_keys, P2, chunk_rows,
                                                salt=salt, value_safe=True)
                todo = [p for p in range(P2) if len(bparts[p]) and len(pparts[p])]
                for b_sub, p_sub in zip(build_sub.split([bparts[p] for p in todo]),
                                        probe_sub.split([pparts[p] for p in todo])):
                    yield from self._join_partition(node, b_sub, p_sub, right_names, depth + 1,
                                                    chunk_rows, max_depth)
                return
        # all-ties partition (one key value defeats every hash) or depth
        # exhausted: inner joins distribute over build chunks
        self.spill_stats["chunk_fallbacks"] += 1
        rows_per = max(int((share // 2) // row_b), 1)
        for page in build_sub.iter_pages(rows_per):
            nb = page_device_bytes(page)
            self.pool.reserve(nb, "hybrid join build chunk")
            try:
                bs = build(page, node.right_keys)
                yield from self._probe_with(node, bs, right_names,
                                            probe_sub.iter_pages(chunk_rows))
            finally:
                self.pool.free(nb)

    def _publish_host_filters(self, node: N.Join, spilled) -> None:
        """Derive filters from an offloaded build side (host columns, host
        or disk tier; the spilled-build analog of _publish_dynamic_filters).
        A fault here fails the query."""
        from .dynfilter import HostFilterAccumulator, filter_from_summary

        if not self.local.dynamic_filtering or not self.local._dyn_worthwhile(node):
            return
        for fid, i, _c in node.dynamic_filters:
            key = node.right_keys[i]
            if not isinstance(key, ir.ColumnRef):
                continue
            acc = HostFilterAccumulator(key.name)
            key_type = None
            for chunk in spilled.iter_host_chunks():
                if key.name not in chunk.names:
                    acc = None
                    break
                idx = chunk.names.index(key.name)
                key_type = chunk.types[idx]
                v = chunk.valids[idx]
                acc.add_numpy(chunk.columns[idx].numpy(), None if v is None else v.numpy(),
                              key_type)
            if acc is None:
                continue
            df = filter_from_summary(acc.summary(), key_type, device=self.device)
            if df is not None:
                self.dyn_ctx.publish(fid, df)

    def _probe_stream(self, node: N.Join, right_page: Page, right_names,
                      probe=None) -> Iterator[Page]:
        bs = build(right_page, node.right_keys)
        preprobe = any(not consumed for _f, _i, consumed in node.dynamic_filters)

        def batches():
            for batch in (probe if probe is not None else self.stream(node.left)):
                yield self.local._apply_preprobe(node, batch) if preprobe else batch

        yield from self._probe_with(node, bs, right_names, batches())

    def _probe_with(self, node: N.Join, bs, right_names, batches) -> Iterator[Page]:
        """Probe batches against a prepared build (the shared probe loop of
        the device, chunked and hybrid join paths)."""
        for batch in batches:
            t0 = time.perf_counter()
            if node.unique_build:
                out = join_n1(batch, bs, node.left_keys, right_names, right_names,
                              kind=node.kind)
            else:
                out = self.local._expand_retrying(
                    batch, bs, node.left_keys, batch.names, [(nm, nm) for nm in right_names],
                    round_capacity(max(int(batch.count), 1)), node.kind)
            if node.residual is not None:
                out = filter_page(out, node.residual)
            out = self.local._shrink(out)
            if self.collector is not None:
                self.collector.record(node, time.perf_counter() - t0, batch.count, out.count,
                                      page_device_bytes(out))
            yield out

    def _stream_window(self, node: N.Window) -> Iterator[Page]:
        """Partitioned window under the budget: one window operator when the
        input fits; otherwise rows hash-bucketed on the PARTITION BY keys (a
        window function never reads across partitions), one window per
        bucket (reference grouped execution + the spilling
        WindowOperator). Bucket order is a hash order, which SQL allows."""
        first, batches, held, spilled = self._collect_or_spill(node.child, "window")
        if spilled is None:
            if not batches:
                yield self._apply(node, first)
                return
            self.pool.reserve(held, "window input")
            try:
                acc = batches[0] if len(batches) == 1 else concat_pages(batches)
                yield self._apply(node, acc)
            finally:
                self.pool.free(held)
            return
        chunk_rows = max(self._spill_share() // spilled.row_bytes, 1 << 10)
        num_parts = max(-(-spilled.num_rows // chunk_rows), 2)
        parts = [ix for ix in hash_partition_indices(spilled, node.partition_exprs, num_parts,
                                                     chunk_rows) if len(ix)]
        for part in spilled.split(parts):
            page = part.take_page(np.arange(part.num_rows))
            nb = page_device_bytes(page)
            self.pool.reserve(nb, "window partition bucket")
            try:
                yield self._apply(node, page)
            finally:
                self.pool.free(nb)

    def _stream_semijoin(self, node: N.SemiJoin) -> Iterator[Page]:
        """The source collects on the card within the budget and the probe
        batches stream against it. Past the budget the source offloads and
        the semi join runs partitioned (`_partitioned_semijoin`). NOT IN
        keeps SQL's three-valued rule (ops/join.null_aware_anti), the
        source's emptiness and NULL keys reduced once."""
        first, batches, held, spilled = self._collect_or_spill(node.source, "semijoin_source",
                                                               whole_budget=False)
        if spilled is not None:
            yield from self._partitioned_semijoin(node, spilled)
            return
        source = first if not batches else (batches[0] if len(batches) == 1
                                            else concat_pages(batches))
        self.pool.reserve(held, "semijoin source")
        try:
            if node.dynamic_filters:
                self.local._publish_dynamic_filters(node, source)
            preprobe = any(not consumed for _f, _i, consumed in node.dynamic_filters)
            bs = build(source, node.source_keys)
            na = source_null_state(source, node.source_keys) if node.null_aware else None
            for batch in self.stream(node.child):
                if preprobe:
                    batch = self.local._apply_preprobe(node, batch)
                yield self._semi_probe(node, bs, batch, na)
        finally:
            self.pool.free(held)

    def _semi_probe(self, node: N.SemiJoin, bs, batch: Page, na) -> Page:
        """One probe batch of a semi, anti (NOT IN: null-aware, `na` the
        source's (empty, has_null)) or mark join."""
        if node.mark is not None:
            return self.local._attach_mark(batch, semi_match_mask(batch, bs, node.probe_keys),
                                           node.mark)
        out = join_n1(batch, bs, node.probe_keys, [], [], kind="anti" if node.anti else "semi")
        if na is not None:
            out = null_aware_anti(out, node.probe_keys, *na)
        return self.local._shrink(out)

    def _partitioned_semijoin(self, node: N.SemiJoin, spilled) -> Iterator[Page]:
        """A semi join over an offloaded source: a semi, anti or mark join
        distributes over hash partitions of the key (equal keys share one),
        so the probe spills by partition beside the source and each pair
        joins on the card, repartitioned on fresh hash bits while a
        partition's source is still too large. (The JAX package raises
        MemoryExceededError when the source exceeds the budget.)"""
        share = self._spill_share()
        row_b = max(spilled.row_bytes, 1)
        P = self._hybrid_partition_count(spilled.num_rows * row_b, share)
        chunk_rows = max(share // (2 * row_b), 1 << 10)
        self.spill_events.append("partitioned_semijoin")
        self.spill_stats["hybrid_parts"] = max(self.spill_stats["hybrid_parts"], P)
        na = None
        if node.null_aware:
            has_null = torch.zeros((), dtype=torch.bool, device=self.device)
            for page in spilled.iter_pages(chunk_rows):
                has_null = has_null | source_null_state(page, node.source_keys)[1]
            na = (torch.tensor(spilled.num_rows == 0, device=self.device), has_null)
        sparts = hash_partition_indices(spilled, node.source_keys, P, chunk_rows,
                                        value_safe=True)
        probe_spill = self._new_spill("semijoin_probe")
        first_probe: Optional[Page] = None
        for batch in self.stream(node.child):
            if first_probe is None:
                first_probe = batch
            if int(batch.count) > 0:
                probe_spill.append(batch)
        yielded = False
        if probe_spill.num_rows:
            pparts = hash_partition_indices(probe_spill, node.probe_keys, P, chunk_rows,
                                            value_safe=True)
            todo = [p for p in range(P) if len(pparts[p])]
            for build_sub, probe_sub in zip(spilled.split([sparts[p] for p in todo]),
                                            probe_spill.split([pparts[p] for p in todo])):
                for out in self._semijoin_partition(node, build_sub, probe_sub, 0, chunk_rows,
                                                    na):
                    yielded = True
                    yield out
        if not yielded and first_probe is not None:
            # schema carrier: no probe row at all
            none = torch.zeros(first_probe.capacity, dtype=torch.bool, device=self.device)
            empty = compact(first_probe, none)
            yield (empty if node.mark is None
                   else self.local._attach_mark(empty, none, node.mark))

    def _semijoin_partition(self, node: N.SemiJoin, build_sub, probe_sub, depth: int,
                            chunk_rows: int, na) -> Iterator[Page]:
        """One (source, probe) partition pair of `_partitioned_semijoin`."""
        max_depth = int(os.environ.get("PRESTO_TPU_HYBRID_JOIN_MAX_DEPTH", "3"))
        share = self._spill_share()
        n = build_sub.num_rows
        bbytes = n * max(build_sub.row_bytes, 1)
        if n == 0:
            # nothing to match in this partition: semi keeps no row, anti
            # and mark keep every row (less NOT IN's NULL rule)
            if node.anti or node.mark is not None:
                for batch in probe_sub.iter_pages(chunk_rows):
                    if node.mark is not None:
                        none = torch.zeros(batch.capacity, dtype=torch.bool, device=self.device)
                        yield self.local._attach_mark(batch, none, node.mark)
                    elif na is not None:
                        yield self.local._shrink(null_aware_anti(batch, node.probe_keys, *na))
                    else:
                        yield batch
            return
        if bbytes * 2 > share and depth < max_depth and n > 1:
            P2 = self._hybrid_partition_count(bbytes, share, cap=16)
            salt = 7 * (depth + 1)  # fresh hash bits each level
            bparts = hash_partition_indices(build_sub, node.source_keys, P2, chunk_rows,
                                            salt=salt, value_safe=True)
            if max(len(i) for i in bparts) < n:
                self.spill_stats["hybrid_depth"] = max(self.spill_stats["hybrid_depth"],
                                                       depth + 1)
                pparts = hash_partition_indices(probe_sub, node.probe_keys, P2, chunk_rows,
                                                salt=salt, value_safe=True)
                todo = [p for p in range(P2) if len(pparts[p])]
                for b_sub, p_sub in zip(build_sub.split([bparts[p] for p in todo]),
                                        probe_sub.split([pparts[p] for p in todo])):
                    yield from self._semijoin_partition(node, b_sub, p_sub, depth + 1,
                                                        chunk_rows, na)
                return
        # fits, or one key value defeats every hash: upload it whole and
        # let the pool refuse it honestly
        page = build_sub.take_page(np.arange(n))
        nb = page_device_bytes(page)
        self.pool.reserve(nb, "semijoin source partition")
        try:
            bs = build(page, node.source_keys)
            for batch in probe_sub.iter_pages(chunk_rows):
                yield self._semi_probe(node, bs, batch, na)
        finally:
            self.pool.free(nb)

    # -- sinks --

    def _hash_agg_attempt(self, page: Page, group_exprs, group_names, aggs,
                          mask) -> Optional[Page]:
        """The group-by kernel strategies for the aggregate sink's partial
        and merge passes, in the materializing executor's order: the dense
        kernel (unless the `pallas_groupby` property is off), then the
        hash-slot kernel (ops/groupby_kernel.py). None sends the batch to
        the sorted path; both share its output schema, so partial pages of
        either strategy merge freely. No try: a kernel fault fails the
        query."""
        from ..ops.groupby_kernel import maybe_grouped_aggregate, maybe_grouped_aggregate_hash

        if self.local.pallas_groupby:
            out = maybe_grouped_aggregate(page, group_exprs, group_names, aggs, mask)
            if out is not None:
                self.spill_stats["agg_dense_batches"] += 1
                return out
        out = maybe_grouped_aggregate_hash(page, group_exprs, group_names, aggs, mask)
        if out is not None:
            self.spill_stats["agg_hash_batches"] += 1
        return out

    def _agg_input_stream(self, node: N.Aggregate) -> Iterator[Page]:
        """Child batches of a (possibly filter-fused) aggregation; a fused
        mask over a table scan still pushes pruning hints down."""
        if node.mask is not None and isinstance(node.child, N.TableScan):
            return self._stream_scan(node.child,
                                     predicate=_pushdown_hints(node.mask, node.child))
        return self.stream(node.child)

    def _sorted_groups(self, page: Page, group_exprs, group_names, aggs, max_groups: int,
                       mask=None) -> Page:
        """grouped_aggregate_sorted with the adaptive-capacity retry."""
        mg = max_groups
        while True:
            out = grouped_aggregate_sorted(page, group_exprs, group_names, aggs, mg, mask)
            n = int(out.count)
            if n <= mg:
                return out
            mg = round_capacity(n)

    def _sink_aggregate(self, node: N.Aggregate) -> Page:
        try:
            partial, final, post = decompose_partial(node.aggs)
        except KeyError:
            # not decomposable: aggregate the materialized input in one pass
            return self._exec_fallback(node)
        if not node.group_exprs:
            partials = [global_aggregate(batch, partial, node.mask)
                        for batch in self._agg_input_stream(node)]
            out = global_aggregate(concat_pages(partials), final)
            return apply_avg_post(out, node.aggs, post)

        group_refs = tuple(ir.ColumnRef(nm, e.type)
                           for nm, e in zip(node.group_names, node.group_exprs))
        state: Optional[Page] = None
        state_held = 0
        merge_rows = max(self.batch_rows // 2, 1 << 14)
        pending: List[Page] = []
        pending_rows = 0
        spilled = None  # SpilledRows of partial-state pages

        def merge(parts: List[Page], bound: int) -> Page:
            acc = parts[0] if len(parts) == 1 else concat_pages(parts)
            out = self._hash_agg_attempt(acc, group_refs, node.group_names, final, None)
            if out is None:
                out = self._sorted_groups(acc, group_refs, node.group_names, final,
                                          round_capacity(min(max(bound, 1), 1 << 22)))
            return _owned(self.local._shrink(out))

        def spill_all(pages: List[Page]) -> None:
            """Move partial-state pages to the spill store (`final` over
            partial columns is idempotent, so spilled merged state and raw
            partials share one schema)."""
            nonlocal spilled
            if spilled is None:
                self.spill_events.append("aggregate")
                spilled = self._new_spill("aggregate")
            for p in pages:
                if int(p.count) > 0 or spilled.num_rows == 0:
                    spilled.append(p)

        # state_held rotates through the loop; the finally releases whatever
        # is still reserved when a kernel faults or a MemoryExceededError
        # fires mid-stream
        try:
            for batch in self._agg_input_stream(node):
                part = self._hash_agg_attempt(batch, node.group_exprs, node.group_names,
                                              partial, node.mask)
                if part is None:
                    part = self._sorted_groups(
                        batch, node.group_exprs, node.group_names, partial,
                        round_capacity(min(max(int(batch.count), 1), 1 << 16)), node.mask)
                part = _owned(self.local._shrink(part))
                if spilled is not None:
                    spill_all([part])
                    continue
                pending.append(part)
                pending_rows += int(part.count)
                pending_bytes = sum(page_device_bytes(p) for p in pending)
                self.pool.accumulated = pending_bytes
                merge_bytes = state_held + pending_bytes
                if (pending_rows >= merge_rows or not self.pool.can_accumulate(pending_bytes)
                        or not self.pool.can_accumulate(_AGG_WORK * merge_bytes - state_held)):
                    parts = ([state] if state is not None else []) + pending
                    self.pool.free(state_held)
                    state_held = 0
                    if self.pool.can_accumulate(_AGG_WORK * merge_bytes):
                        new_state = merge(parts, pending_rows + (
                            int(state.count) if state is not None else 0))
                        nb = page_device_bytes(new_state)
                        state = None
                        if self.pool.can_accumulate(nb):
                            state_held = self.pool.reserve(nb, "aggregation state")
                            state = new_state
                        else:
                            spill_all([new_state])
                    else:
                        # the merge's working set would not fit (or a revoke
                        # asked for the state back): switch to spilling
                        # (SpillableHashAggregationBuilder.spillToDisk)
                        spill_all(parts)
                        state = None
                    if state is None:
                        self.pool.note_revoked(merge_bytes)
                    pending = []
                    pending_rows = 0
                    self.pool.accumulated = 0
            self.pool.accumulated = 0
            if spilled is not None:
                spill_all(pending)
                return self._finalize_spilled_agg(node, spilled, group_refs, final, post)
            parts = ([state] if state is not None else []) + pending
            est = sum(page_device_bytes(p) for p in parts)
            if not self.pool.can_reserve(_AGG_WORK * est - state_held):
                # the final merged state itself would not fit: finish on the
                # spill path, which emits a host-backed result
                spill_all(parts)
                self.pool.free(state_held)
                state_held = 0
                return self._finalize_spilled_agg(node, spilled, group_refs, final, post)
            out = merge(parts, pending_rows + (int(state.count) if state is not None else 0))
            self.pool.free(state_held)
            state_held = 0
            return apply_avg_post(out, node.aggs, post)
        finally:
            if state_held:
                self.pool.free(state_held)
            self.pool.accumulated = 0

    def _finalize_spilled_agg(self, node: N.Aggregate, spilled, group_refs, final,
                              post) -> Page:
        """Final aggregation over spilled partial states: hash-partition the
        rows by group key (equal keys share a partition), run the final
        aggregation per partition on the card, concatenate on the host.
        Skewed partitions repartition on fresh hash bits."""
        from .spill import host_concat_pages, to_host_page

        outs: List[Page] = []
        # a partition's page is padded to its power-of-two capacity, up to
        # twice its rows: its working set must fit the share
        chunk_rows = max(self._spill_share() // (2 * _AGG_WORK * spilled.row_bytes), 1 << 10)

        def finalize(sub, depth: int) -> None:
            n = sub.num_rows
            if n > chunk_rows and depth < 4:
                parts = max(-(-n // chunk_rows), 2)
                idx = [ix for ix in hash_partition_indices(sub, group_refs, parts, chunk_rows,
                                                           salt=13 * (depth + 1)) if len(ix)]
                for part in sub.split(idx):
                    finalize(part, depth + 1)
                return
            # one partition's groups fit (or hashing cannot split further:
            # upload regardless and let the pool fail honestly)
            page = sub.take_page(np.arange(n))
            nb = page_device_bytes(page)
            self.pool.reserve(nb, "final aggregation partition")
            try:
                out = self._hash_agg_attempt(page, group_refs, node.group_names, final, None)
                if out is None:
                    out = self._sorted_groups(page, group_refs, node.group_names, final,
                                              round_capacity(max(n, 1)))
                outs.append(to_host_page(apply_avg_post(out, node.aggs, post)))
            finally:
                self.pool.free(nb)

        finalize(spilled, 0)
        return host_concat_pages(outs)

    def _sink_distinct(self, node: N.Distinct) -> Page:
        state: Optional[Page] = None
        for batch in self.stream(node.child):
            d = distinct_page(batch, batch.capacity)
            if state is None:
                state = d
            else:
                merged = concat_pages([state, d])
                state = distinct_page(merged, merged.capacity)
            state = self.local._shrink(state)
        return state if state is not None else next(self.stream(node.child))

    def _sink_topn(self, node: N.TopN) -> Page:
        state: Optional[Page] = None
        for batch in self.stream(node.child):
            t = top_n(batch, node.keys, node.count)
            state = t if state is None else top_n(concat_pages([state, t]), node.keys,
                                                  node.count)
        return state if state is not None else next(self.stream(node.child))

    def _sink_limit(self, node: N.Limit) -> Page:
        got: List[Page] = []
        rows = 0
        for batch in self.stream(node.child):
            got.append(batch)
            rows += int(batch.count)
            if rows >= node.count:
                break  # short-circuit: stop pulling the scan
        if not got:
            got = [next(self.stream(node.child))]
        acc = got[0] if len(got) == 1 else concat_pages(got)
        return self.local._shrink(limit_page(acc, node.count))

    def _sink_sort(self, node: N.Sort) -> Page:
        """Full sort; beyond the budget it goes external: offload, range-
        partition on the first key, sort each range on the card
        (spill.external_sort_chunks, the OrderByOperator-spill analog)."""
        from .spill import external_sort_chunks, host_concat_pages

        first, batches, held, spilled = self._collect_or_spill(node.child, "sort")
        if spilled is None:
            if not batches:
                return sort_page(first, node.keys)
            self.pool.reserve(held, "sort input")
            try:
                acc = batches[0] if len(batches) == 1 else concat_pages(batches)
                return sort_page(acc, node.keys)
            finally:
                self.pool.free(held)
        chunk_rows = max(self._spill_share() // spilled.row_bytes, 1 << 10)
        return host_concat_pages(external_sort_chunks(spilled, node.keys, chunk_rows, self.pool))
