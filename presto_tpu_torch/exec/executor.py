"""Single-node plan executor (torch counterpart of presto_tpu/exec/executor.py).

The analog of the reference's LocalExecutionPlanner + Driver (SURVEY.md
§3.3): walks the PlanNode tree bottom-up, executing each node as a few
eager tensor operations (and the CUDA kernels of ops/groupby_kernel.py and
ops/join_kernel.py) over capacity-padded Pages on one device.

Kept from the JAX package: capacities bucketed to powers of two and pages
shrunk after selective operators (`_shrink`, gated by the CBO estimate so
most nodes pay no host sync), the adaptive-capacity retry loops of the
sorted group-by and the 1:N join, build sides run first so their dynamic
filters prune the probe side's scans, and the star-join fusion, so results
and strategy choices match. PyTorch runs eagerly, so the JAX package's jit
kernel cache is a plain call here, and no breaker stands around a kernel:
a kernel fault fails the query.

EXPLAIN ANALYZE (exec/stats.py): with a `collector`, every node records
its host wall time, rows in and out (0-d count tensors, read once at the
end), output bytes and retries, and the strategy notes keep the JAX
package's names (`pallas` is the dense group-by strategy, whose kernel is
csrc/groupby_partials.cu; `hash-slot`, `hash-sort`, `multiway-fused`,
`keypack=...`, `hash-table(...)`, `df[...]`, `dyn_pruned=...`).

Nodes ported: TableScan, Sample, Filter, Project, Aggregate, Distinct,
Window, Sort, TopN, Limit, Union, Unnest, Output, SingleRow, Join,
SemiJoin, ScalarApply and the Exchange/AggFinalize pass-throughs. Any other
node raises ExecutionError("not ported yet: <node>").
"""

from __future__ import annotations

import os
import re
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import types as T
from ..connectors.spi import read_columns
from ..expr.compiler import evaluate, project_page
from ..expr.ir import Call, ColumnRef
from ..ops.aggregate import global_aggregate, grouped_aggregate_sorted
from ..ops.filter import compact, filter_page
from ..ops.join import (build, join_expand, join_n1, null_aware_anti, semi_match_mask,
                        source_null_state)
from ..ops.join_kernel import JoinTable, build_table, table_multiway_n1
from ..ops.sort import distinct_page, limit_page, sort_page, top_n
from ..page import Block, Page, round_capacity
from ..plan import nodes as N
from .dynfilter import DynamicFilterContext, derive_filter
from .qcache import LRUCache
from .stats import page_device_bytes

# dynamic filters are derived only when the CBO expects the join to keep
# under this fraction of its probe rows
DYN_MAX_SELECTIVITY = 0.7


class ExecutionError(RuntimeError):
    pass


class Executor:
    def __init__(self, catalog, device="cuda", collector=None, pallas_groupby=True):
        self.catalog = catalog
        self.device = torch.device(device)
        # EXPLAIN ANALYZE support (exec/stats.py); None = no accounting
        self.collector = collector
        # the dense group-by kernel strategy (the `pallas_groupby` session
        # property): on by default on every device, its wrapper running
        # the plain version for CPU tensors; the hash-slot strategy is not
        # gated by it
        self.pallas_groupby = pallas_groupby
        # the `dynamic_filtering` session property: off derives no filters
        self.dynamic_filtering = True
        self._retries = 0  # adaptive-capacity re-runs
        # (width tried, width retried with) of each collection-width retry
        self.width_retries = []
        # CBO row estimates and full plan stats per (plan node, estimate
        # environment), LRU-bounded: a long-lived session executes
        # unboundedly many plans
        self._est_cache = LRUCache(max_entries=4096, name="row_est")
        self._ps_cache = LRUCache(max_entries=1024, name="plan_stats")
        # runtime dynamic filters: per-query build-side summaries consumed
        # by probe-side scans and filters
        self.dyn_ctx = DynamicFilterContext()
        # TABLESAMPLE: a running row offset per Sample node plus a salt,
        # mixed into the sample hash so a positional mask never repeats
        # across batches (ops/filter.py sample_page)
        self._sample_pos: Dict[int, int] = {}
        self.sample_salt = 0
        # the width of the mesh this executor serves (exec/dist.py sets it):
        # part of the estimate-cache keys
        self.mesh_n = 1

    # -- public --
    def run(self, node: N.PlanNode) -> Page:
        # dynamic filters and sample offsets are per-query state (the JAX
        # package keeps the offsets for the executor's life, keyed by id():
        # a later query's node can reuse a freed node's id and its offset)
        self.dyn_ctx.reset()
        self._sample_pos.clear()
        return self._run(node)

    # -- dispatch --
    def _run_children(self, node: N.PlanNode):
        """Execute a node's children, BUILD SIDE FIRST for dynamic-filter
        joins, so the derived filter is published before the probe side's
        scans run (the reference's LocalDynamicFiltersCollector order)."""
        if isinstance(node, (N.Join, N.SemiJoin)) and node.dynamic_filters:
            build_page = self._run(node.children[1])
            self._publish_dynamic_filters(node, build_page)
            return [self._run(node.children[0]), build_page]
        return [self._run(c) for c in node.children]

    def _run(self, node: N.PlanNode) -> Page:
        inner = self._star_spec(node)
        if inner is not None:
            if self.collector is None:
                return self._run_star_join(node, inner)
            t0 = time.perf_counter()
            out = self._run_star_join(node, inner)
            # fused execution: the outer node carries the pair's stats
            # (child scans and builds record their own through _run)
            self.collector.record(node, time.perf_counter() - t0, [], out.count,
                                  page_device_bytes(out))
            return out
        pages = self._run_children(node)
        if self.collector is None:
            return self.exec_node(node, *pages)
        # row counts stay 0-d device tensors: the collector reads them all
        # at once at the end, so wall is host time (dispatch and the
        # node's own host reads)
        retries_before = self._retries
        t0 = time.perf_counter()
        out = self.exec_node(node, *pages)
        self.collector.record(node, time.perf_counter() - t0, [p.count for p in pages],
                              out.count, page_device_bytes(out),
                              self._retries - retries_before)
        return out

    def exec_node(self, node: N.PlanNode, *pages: Page) -> Page:
        """Apply one plan node to already-materialized input pages."""
        name = type(node).__name__
        method = getattr(self, f"_exec_{name.lower()}", None)
        if method is None:
            raise ExecutionError(f"not ported yet: {name}")
        return method(node, *pages)

    def _shrink(self, page: Page, node: N.PlanNode = None) -> Page:
        """Slice page capacity down to the live row count's bucket. Reading
        the count is a host sync, so it is only paid when the page is big
        AND the CBO expects it to be well under capacity."""
        if page.capacity <= (1 << 14):
            return page
        if node is not None:
            est = self._est_rows(node)
            if est is not None and est >= 0.5 * page.capacity:
                return page
        n = int(page.count)
        cap = round_capacity(max(n, 1))
        if cap >= page.capacity:
            return page
        blocks = [b.take_rows(slice(0, cap)) for b in page.blocks]
        return Page(tuple(blocks), page.names, page.count)

    def _est_rows(self, node):
        """CBO row estimate for a node's output (cached per plan node and
        estimate environment)."""
        key = (node,) + self._est_env()
        hit = self._est_cache.get(key, count=False)
        if hit is not None:
            return hit[0]
        try:
            from ..plan.stats import derive

            est = float(derive(node, self.catalog).rows)
        except Exception:  # noqa: BLE001 — estimation is best-effort
            est = None
        self._est_cache.put(key, (est,))
        return est

    def _est_env(self) -> tuple:
        """Environment half of the estimate-cache keys: the feedback
        store's generation (a recorded observation or an invalidation must
        never leave a live executor serving estimates derived from the
        superseded history) and the mesh width (`mesh_n`), 1 on one device."""
        from ..plan.history import plan_env_token

        return plan_env_token(), self.mesh_n

    # -- EXPLAIN ANALYZE notes --
    def _strategy_note(self, node, name: str) -> None:
        """Record which strategy ran (EXPLAIN ANALYZE surfaces it)."""
        if self.collector is not None:
            self.collector.stats_for(node).detail = f"strategy={name}"

    def _append_detail(self, node, txt: str) -> None:
        if self.collector is None:
            return
        s = self.collector.stats_for(node)
        if txt not in s.detail:
            s.detail = f"{s.detail}; {txt}" if s.detail else txt

    def _note_dyn_pruned(self, node, lead_fid: str, pruned: int, where: str,
                         descs: str) -> None:
        """Book pruned rows (a combined mask attributed once, to the lead
        filter id) and refresh the node's EXPLAIN ANALYZE tag with the
        accumulated total."""
        self.dyn_ctx.note_pruned(lead_fid, pruned, where)
        if self.collector is None:
            return
        book = self.dyn_ctx.scan_pruned if where == "scan" else self.dyn_ctx.preprobe_pruned
        total = book.get(lead_fid, pruned)
        s = self.collector.stats_for(node)
        tag = f"dyn_pruned={total:,} ({descs})"
        if "dyn_pruned=" in s.detail:
            s.detail = re.sub(r"dyn_pruned=[^;]*", tag, s.detail)
        else:
            self._append_detail(node, tag)

    # -- physical nodes (fragmented plans executed single-node) --
    def _exec_exchange(self, node, page: Page) -> Page:
        return page  # all exchange kinds are identities on a single worker

    def _exec_aggfinalize(self, node, page: Page) -> Page:
        from ..ops.aggregate import apply_avg_post

        return apply_avg_post(page, node.aggs, node.post)

    # -- leaf --
    def _exec_singlerow(self, node: N.SingleRow) -> Page:
        blk = Block.from_numpy(np.zeros(1, dtype=np.int64), T.BIGINT, device=self.device)
        return Page.from_blocks((blk,), (node.channel,), 1)

    def _exec_tablescan(self, node: N.TableScan) -> Page:
        # file connectors decode only the scanned columns (page_columns);
        # the others serve their whole cached page
        cols = list(dict.fromkeys(col for _ch, col, _typ in node.columns))
        src = (read_columns(self.catalog, node.table, cols) if cols
               else self.catalog.page(node.table)).to(self.device)
        blocks = tuple(src.block(col) for _ch, col, _typ in node.columns)
        names = tuple(ch for ch, _col, _typ in node.columns)
        page = Page(blocks, names, src.count)
        # scan-level pruning for the entries no Filter above fuses
        entries = [(fid, ch) for fid, ch, _src, apply in node.dynamic_filters if apply]
        if entries:
            page = self._dyn_mask_page(node, page, entries, "scan")
        return page

    def _exec_sample(self, node: N.Sample, page: Page) -> Page:
        from ..ops.filter import sample_page

        # this page's global row position: the node's running offset,
        # advanced by capacity (no host read), plus the salt
        pos = self._sample_pos.get(id(node), 0)
        self._sample_pos[id(node)] = pos + page.capacity
        offset = (self.sample_salt + pos) & 0xFFFFFFFFFFFFFFFF
        return self._shrink(sample_page(page, node.fraction, node.seed, offset), node)

    # -- stateless row ops --
    def _exec_filter(self, node: N.Filter, page: Page) -> Page:
        if any(self.dyn_ctx.get(fid) is not None for fid, _ch in node.dynamic_filters):
            return self._exec_filter_dyn(node, page)
        return self._shrink(filter_page(page, node.predicate), node)

    def _exec_filter_dyn(self, node: N.Filter, page: Page) -> Page:
        """Filter with the published dynamic-filter masks fused in: ONE
        compaction for the predicate and every runtime filter."""
        v = evaluate(node.predicate, page)
        keep = v.data if v.valid is None else (v.data & v.valid)
        dmask = None
        picked = []
        for fid, ch in node.dynamic_filters:
            df = self.dyn_ctx.get(fid)
            if df is None:
                continue
            m = df.mask(page.block(ch))
            dmask = m if dmask is None else (dmask & m)
            picked.append((fid, df))
        live_keep = keep & page.live_mask()
        would_keep = live_keep.sum()
        out, n = self._dyn_compact(page, live_keep & dmask)
        self._note_dyn_pruned(node, picked[0][0], int(would_keep) - n, "scan",
                              ",".join(f"{fid}:{df.strategy}" for fid, df in picked))
        return out

    # -- dynamic filters (exec/dynfilter.py) --
    def _dyn_worthwhile(self, node) -> bool:
        """CBO benefit gate: deriving costs a build-side pass plus a probe
        mask, so skip joins expected to keep most probe rows.
        PRESTO_TPU_DYNFILTER_FORCE=1 (read per call) derives always."""
        if os.environ.get("PRESTO_TPU_DYNFILTER_FORCE") == "1":
            return True
        out_est = self._est_rows(node)
        probe_est = self._est_rows(node.children[0])
        if out_est is None or probe_est is None or probe_est <= 0:
            return True
        return out_est < DYN_MAX_SELECTIVITY * probe_est

    def _publish_dynamic_filters(self, node, build_page: Page) -> None:
        """Derive per-key summaries from a materialized build side and
        publish them under the planner-assigned ids (none when the
        `dynamic_filtering` property is off)."""
        if not self.dynamic_filtering or not self._dyn_worthwhile(node):
            return
        keys = node.right_keys if isinstance(node, N.Join) else node.source_keys
        notes = []
        t0 = time.perf_counter()
        live = build_page.live_mask()
        for fid, i, _consumed in node.dynamic_filters:
            df = derive_filter(evaluate(keys[i], build_page), live)
            if df is not None:
                self.dyn_ctx.publish(fid, df)
                notes.append(f"{fid}={df.describe()}")
        if notes and self.collector is not None:
            ms = (time.perf_counter() - t0) * 1e3
            self._append_detail(node, f"df[{', '.join(notes)}, derive {ms:.1f}ms]")

    def _dyn_compact(self, page: Page, keep) -> Tuple[Page, int]:
        """Compact for dynamic-filter masks, which are typically very
        selective: the survivor count is read (the pruned-row accounting
        needs it) and the output always sliced to its bucket. Returns
        (page, survivor count)."""
        out = compact(page, keep & page.live_mask())
        n = int(out.count)
        cap = round_capacity(max(n, 1))
        if cap < out.capacity:
            out = Page(tuple(b.take_rows(slice(0, cap)) for b in out.blocks), out.names,
                       out.count)
        return out, n

    def _dyn_mask_page(self, node, page: Page, entries, where: str) -> Page:
        """AND every published dynamic-filter mask over `page` and compact.
        `entries` is [(fid, channel name or key RowExpression)]."""
        picked = [(fid, src, self.dyn_ctx.get(fid)) for fid, src in entries]
        picked = [p for p in picked if p[2] is not None]
        if not picked:
            return page
        keep = None
        for _fid, src, df in picked:
            val = page.block(src) if isinstance(src, str) else evaluate(src, page)
            m = df.mask(val)
            keep = m if keep is None else (keep & m)
        before = int(page.count)
        out, n = self._dyn_compact(page, keep)
        self._note_dyn_pruned(node, picked[0][0], before - n, where,
                              ",".join(f"{fid}:{df.strategy}" for fid, _s, df in picked))
        return out

    def _apply_preprobe(self, node, probe: Page) -> Page:
        """Pre-probe filter for produced ids with NO scan consumer: the
        probe then sees only surviving rows."""
        keys = node.left_keys if isinstance(node, N.Join) else node.probe_keys
        entries = [(fid, keys[i]) for fid, i, consumed in node.dynamic_filters if not consumed]
        if not entries:
            return probe
        return self._dyn_mask_page(node, probe, entries, "preprobe")

    def _exec_project(self, node: N.Project, page: Page) -> Page:
        return project_page(page, node.exprs, node.names)

    def _exec_output(self, node: N.Output, page: Page) -> Page:
        blocks = tuple(page.block(c) for c in node.channels)
        return Page(blocks, tuple(node.titles), page.count)

    # -- aggregation --
    def _exec_unnest(self, node: N.Unnest, page: Page) -> Page:
        from ..ops.unnest import unnest_page

        out = unnest_page(page, node.array_exprs, node.elem_channels,
                          node.ordinality_channel, node.replicate)
        return self._shrink(out, node)

    def _collect_width(self, out: Page, max_elems: int):
        """The collection-width protocol: (None, page without the
        `$collect_need` column) when every collection fit in `max_elems`,
        else (the wider width to retry with, None). One host read."""
        if "$collect_need" not in out.names:
            return None, out
        need = int(out.block("$collect_need").data[0])
        if need > max_elems:
            self._retries += 1
            self.width_retries.append((max_elems, round_capacity(need)))
            return round_capacity(need), None
        keep = [(n, b) for n, b in zip(out.names, out.blocks) if n != "$collect_need"]
        return None, Page(tuple(b for _, b in keep), tuple(n for n, _ in keep), out.count)

    def _exec_aggregate(self, node: N.Aggregate, page: Page) -> Page:
        # collection aggregates start 128 elements wide and widen to the
        # widest group on overflow
        max_elems = 128
        if not node.group_exprs:
            while True:
                out = global_aggregate(page, node.aggs, node.mask, max_elems=max_elems)
                wider, out = self._collect_width(out, max_elems)
                if wider is None:
                    return out
                max_elems = wider
        # the dense kernel strategy first (unless the `pallas_groupby`
        # property is off), on every device: its wrapper launches the CUDA
        # kernel for CUDA tensors and runs the plain version for CPU tensors
        from ..ops.groupby_kernel import maybe_grouped_aggregate, maybe_grouped_aggregate_hash

        if self.pallas_groupby:
            out = maybe_grouped_aggregate(
                page, node.group_exprs, node.group_names, node.aggs, node.mask
            )
            if out is not None:
                self._strategy_note(node, "pallas")
                return self._shrink(out, node)
        # the hash-slot strategy next: the kernel's second caller on CUDA,
        # the plain totals on the CPU
        out = maybe_grouped_aggregate_hash(
            page, node.group_exprs, node.group_names, node.aggs, node.mask
        )
        if out is not None:
            self._strategy_note(node, "hash-slot")
            return self._shrink(out, node)
        self._strategy_note(node, "hash-sort")
        # groups <= live rows; guess from the CBO estimate and retry with
        # the true group count on overflow
        est = self._est_rows(node)
        guess = int(est) if est is not None else page.capacity
        max_groups = round_capacity(min(max(guess, 1), page.capacity, 1 << 16))
        while True:
            out = grouped_aggregate_sorted(
                page, node.group_exprs, node.group_names, node.aggs, max_groups,
                node.mask, max_elems=max_elems,
            )
            true_groups = int(out.count)
            if true_groups > max_groups:
                max_groups = round_capacity(true_groups)
                self._retries += 1
                continue
            wider, out = self._collect_width(out, max_elems)
            if wider is not None:
                max_elems = wider
                continue
            break
        return self._shrink(out, node)

    def _exec_distinct(self, node: N.Distinct, page: Page) -> Page:
        if any(b.lengths is not None or b.key_block is not None for b in page.blocks):
            # collection columns carry equality in companion tensors
            # (lengths, elem_valid, key_block) a packed key cannot see
            return self._shrink(distinct_page(page, page.capacity), node)
        keys = tuple(ColumnRef(n, b.type) for n, b in zip(page.names, page.blocks))
        plan = self._keypack_plan(node, keys, page, equality_only=True, allow_hashed=True)
        if plan is not None:
            from ..ops.sort import distinct_packed

            out = self._run_packed(node, plan, lambda p: distinct_packed(p, plan), page)
            if out is not None:
                return self._shrink(out, node)
        self._strategy_note(node, "hash-sort")
        return self._shrink(distinct_page(page, page.capacity), node)

    # -- composite-key packing (ops/keypack.py) --
    def _node_plan_stats(self, node):
        """Memoized full CBO PlanStats for a node (the keypack planner's
        column min/max/NDV), keyed as _est_rows."""
        key = (node,) + self._est_env()
        hit = self._ps_cache.get(key, count=False)
        if hit is not None:
            return hit[0]
        from ..plan.stats import derive

        try:
            ps = derive(node, self.catalog)
        except Exception:  # noqa: BLE001 — estimation is best-effort
            ps = None
        self._ps_cache.put(key, (ps,))
        return ps

    def _keypack_plan(self, node, keys, page: Page, equality_only=False,
                      allow_hashed=False, single_lane=False, n_order_keys=0):
        """A packing strategy for one order-sensitive node from the input
        page's blocks plus the child's CBO column stats, or None when the
        keys don't pack (the node runs its legacy sort)."""
        from ..ops.keypack import KeyInfo, key_info_from_block, keypack_enabled, plan_keypack
        from ..plan.stats import storage_bounds

        if not keypack_enabled():
            return None
        ps = self._node_plan_stats(node.children[0])
        infos = []
        for k in keys:
            e = getattr(k, "expr", k)
            typ = getattr(e, "type", None)
            if typ is None:
                return None
            if isinstance(e, ColumnRef) and e.name in page.names:
                b = page.block(e.name)
                lo = hi = None
                if ps is not None:
                    bounds = storage_bounds(ps.column(e.name), b.type)
                    if bounds is not None:
                        lo, hi = bounds
                infos.append(key_info_from_block(b, lo=lo, hi=hi))
            else:
                infos.append(KeyInfo(type=typ, nullable=True))
        return plan_keypack(keys, infos, equality_only=equality_only,
                            allow_hashed=allow_hashed, single_lane=single_lane,
                            n_order_keys=n_order_keys)

    def _run_packed(self, node, plan, fn, page: Page):
        """Run one packed operator; None when its runtime range check
        tripped (sampled CBO bounds missed, or a hash collided) and the
        caller must run the legacy operator."""
        out, ok = fn(page)
        if ok is not None and not bool(ok):
            self._strategy_note(node, f"keypack={plan.strategy}->legacy(range)")
            return None
        self._strategy_note(node, f"keypack={plan.strategy}")
        return out

    # -- windows --
    def _exec_window(self, node: N.Window, page: Page) -> Page:
        from ..ops.sort import SortKey
        from ..ops.window import window_op, window_op_packed

        specs = tuple(SortKey(e) for e in node.partition_exprs) + tuple(node.order_keys)
        plan = self._keypack_plan(node, specs, page, single_lane=True,
                                  n_order_keys=len(node.order_keys)) if specs else None
        if plan is not None:
            out = self._run_packed(
                node, plan, lambda p: window_op_packed(p, node.partition_exprs, node.order_keys,
                                                       node.funcs, plan), page)
            if out is not None:
                return out
        return window_op(page, node.partition_exprs, node.order_keys, node.funcs)

    # -- ordering / limits --
    def _exec_sort(self, node: N.Sort, page: Page) -> Page:
        plan = self._keypack_plan(node, node.keys, page)
        if plan is not None:
            from ..ops.sort import sort_page_packed

            out = self._run_packed(node, plan, lambda p: sort_page_packed(p, node.keys, plan),
                                   page)
            if out is not None:
                return out
        return sort_page(page, node.keys)

    def _exec_topn(self, node: N.TopN, page: Page) -> Page:
        plan = self._keypack_plan(node, node.keys, page)
        if plan is not None:
            from ..ops.sort import top_n_packed

            out = self._run_packed(
                node, plan, lambda p: top_n_packed(p, node.keys, node.count, plan), page
            )
            if out is not None:
                return out
        return top_n(page, node.keys, node.count)

    def _exec_limit(self, node: N.Limit, page: Page) -> Page:
        return self._shrink(limit_page(page, node.count), node)

    def _exec_union(self, node: N.Union, *pages: Page) -> Page:
        from ..ops.union import concat_pages

        # positional union: the output's names follow the first branch
        return self._shrink(concat_pages(pages, distinct=node.distinct), node)

    # -- joins --
    def _star_spec(self, node: N.PlanNode) -> Optional[N.Join]:
        """The inner Join of a fusable star shape: two stacked inner n1
        joins whose probe keys BOTH live on the shared fact side, no
        residuals (the multiway probe of ops/join_kernel.table_multiway_n1)."""
        if not isinstance(node, N.Join) or node.kind != "inner":
            return None
        if not node.unique_build or node.residual is not None:
            return None
        inner = node.left
        if not isinstance(inner, N.Join) or inner.kind != "inner":
            return None
        if not inner.unique_build or inner.residual is not None:
            return None
        fact_names = {n for n, _ in inner.left.fields}
        for k in node.left_keys:
            if not isinstance(k, ColumnRef) or k.name not in fact_names:
                return None
        return inner

    def _run_star_join(self, node: N.Join, inner: N.Join) -> Page:
        """Fused multiway execution of a star pair; a side whose build is
        not eligible for a hash table runs the two joins nested instead."""
        dim1 = self._run(inner.right)
        if inner.dynamic_filters:
            self._publish_dynamic_filters(inner, dim1)
        dim2 = self._run(node.right)
        if node.dynamic_filters:
            self._publish_dynamic_filters(node, dim2)
        fact = self._run(inner.left)
        if inner.dynamic_filters:
            fact = self._apply_preprobe(inner, fact)
        if node.dynamic_filters:
            fact = self._apply_preprobe(node, fact)
        bs1 = build_table(dim1, inner.right_keys)
        bs2 = build_table(dim2, node.right_keys)
        if bs1 is None or bs2 is None:
            mid = self._exec_join(inner, fact, dim1)
            return self._exec_join(node, mid, dim2)
        names1 = tuple(n for n, _ in inner.right.fields)
        names2 = tuple(n for n, _ in node.right.fields)
        out = table_multiway_n1(fact, (
            (bs1, tuple(inner.left_keys), names1, names1),
            (bs2, tuple(node.left_keys), names2, names2),
        ))
        self._strategy_note(inner, "multiway-fused")
        self._strategy_note(node, f"multiway occ={int(bs1.occupancy() * 100)}%"
                                  f"/{int(bs2.occupancy() * 100)}%")
        return self._shrink(out, node)

    def _table_note(self, node, bs) -> None:
        """The hash-table join strategy's note: `pallas` names the CUDA
        kernels (csrc/join_insert.cu, join_probe.cu), `host` their plain
        versions on the CPU, as the JAX package names its modes."""
        if self.collector is None or not isinstance(bs, JoinTable):
            return
        mode = "pallas" if bs.slots.device.type == "cuda" else "host"
        of = len(bs.of_tag)
        self._strategy_note(node, f"hash-table({mode}) occ={int(bs.occupancy() * 100)}%"
                                  + (f" of={of}" if of else ""))

    def _expand_retrying(self, probe: Page, bs, keys, probe_out, build_out, cap: int,
                         kind: str) -> Page:
        """join_expand with the adaptive-capacity retry: on overflow, rerun
        with the capacity the overflow asks for."""
        while True:
            out, overflow = join_expand(probe, bs, keys, probe_out, build_out,
                                        out_capacity=cap, kind=kind)
            overflow = int(overflow)
            if overflow == 0:
                return out
            cap = round_capacity(cap + overflow)
            self._retries += 1

    def _join_capacity(self, node, probe: Page) -> int:
        """Initial 1:N output capacity: probe capacity vs the CBO estimate
        (no count sync)."""
        est = self._est_rows(node)
        return round_capacity(max(probe.capacity, int(est) if est is not None else 1, 1))

    def _exec_join(self, node: N.Join, left: Page, right: Page) -> Page:
        if node.kind == "full" or (node.kind != "inner" and node.residual is not None):
            return self._exec_outer_join(node, left, right)
        if node.dynamic_filters:
            left = self._apply_preprobe(node, left)
        # the hash table when the build is eligible for one, else the
        # sorted-hash layout (ops/join.py)
        bs = build(right, node.right_keys)
        self._table_note(node, bs)
        if node.unique_build:
            out = join_n1(left, bs, node.left_keys, right.names, right.names, kind=node.kind)
        else:
            out = self._expand_retrying(left, bs, node.left_keys, left.names,
                                        [(n, n) for n in right.names],
                                        self._join_capacity(node, left), node.kind)
        if node.residual is not None:
            out = filter_page(out, node.residual)
        return self._shrink(out, node)

    def _exec_outer_join(self, node: N.Join, left: Page, right: Page) -> Page:
        """LEFT join with a residual ON filter, and FULL OUTER join:
        inner-expand on the equi keys, apply the residual, then null-extend
        the probe rows (and for FULL the build rows) whose row id has no
        surviving match."""
        from ..ops.union import concat_pages, extend_with_nulls

        full = node.kind == "full"
        taken = set(left.names) | set(right.names)
        i = 0
        while f"$ridL{i}" in taken or f"$ridR{i}" in taken:
            i += 1
        rid_l, rid_r = f"$ridL{i}", f"$ridR{i}"
        left2 = self._with_row_id(left, rid_l)
        right2 = self._with_row_id(right, rid_r)
        bs = build(right2, node.right_keys)
        expanded = self._expand_retrying(
            left2, bs, node.left_keys, list(left.names) + [rid_l],
            [(n, n) for n in right.names] + [(rid_r, rid_r)],
            self._join_capacity(node, left), "inner",
        )
        matched = expanded if node.residual is None else filter_page(expanded, node.residual)
        matched = self._shrink(matched, node)
        parts = [self._drop(matched, {rid_l, rid_r})]
        # probe rows with no surviving match -> NULL build columns
        lkey = (ColumnRef(rid_l, T.BIGINT),)
        left_un = join_n1(left2, build(matched, lkey), lkey, [], [], kind="anti")
        parts.append(extend_with_nulls(
            self._drop(left_un, {rid_l}), right.names, [b.type for b in right.blocks],
            [b.dict_id for b in right.blocks],
        ))
        if full:
            rkey = (ColumnRef(rid_r, T.BIGINT),)
            right_un = join_n1(right2, build(matched, rkey), rkey, [], [], kind="anti")
            parts.append(extend_with_nulls(
                self._drop(right_un, {rid_r}), left.names, [b.type for b in left.blocks],
                [b.dict_id for b in left.blocks], prepend=True,
            ))
        return self._shrink(concat_pages(parts), node)

    @staticmethod
    def _drop(page: Page, names) -> Page:
        keep = [(b, n) for b, n in zip(page.blocks, page.names) if n not in names]
        return Page(tuple(b for b, _ in keep), tuple(n for _, n in keep), page.count)

    @staticmethod
    def _attach_mark(probe: Page, mask, name: str) -> Page:
        return Page(probe.blocks + (Block(mask, T.BOOLEAN, None),), probe.names + (name,),
                    probe.count)

    def _exec_semijoin(self, node: N.SemiJoin, probe: Page, source: Page) -> Page:
        if node.dynamic_filters:
            probe = self._apply_preprobe(node, probe)
        kind = "anti" if node.anti else "semi"
        if node.residual is None:
            bs = build(source, node.source_keys)
            if node.mark is not None:
                mask = semi_match_mask(probe, bs, node.probe_keys)
                return self._attach_mark(probe, mask, node.mark)
            out = join_n1(probe, bs, node.probe_keys, [], [], kind=kind)
            if node.null_aware:
                empty, has_null = source_null_state(source, node.source_keys)
                out = null_aware_anti(out, node.probe_keys, empty, has_null)
            return self._shrink(out, node)
        # residual EXISTS: expand probe x source on the equi keys, filter the
        # residual, then keep probe rows whose row id survived
        rid = self._row_id_channel(probe)
        probe2 = self._with_row_id(probe, rid)
        needed = self._residual_channels(node.residual)
        expanded = self._expand_retrying(
            probe2, build(source, node.source_keys), node.probe_keys,
            [rid] + [n for n in probe.names if n in needed],
            [(n, n) for n in source.names if n in needed],
            round_capacity(max(probe.capacity, 1)), "inner",
        )
        matched = self._shrink(filter_page(expanded, node.residual), node)
        rkey = (ColumnRef(rid, T.BIGINT),)
        bs2 = build(matched, rkey)
        if node.mark is not None:
            return self._attach_mark(probe, semi_match_mask(probe2, bs2, rkey), node.mark)
        out = join_n1(probe2, bs2, rkey, [], [], kind=kind)
        return self._shrink(self._drop(out, {rid}), node)

    @staticmethod
    def _row_id_channel(page: Page) -> str:
        i = 0
        while f"$rid{i}" in page.names:
            i += 1
        return f"$rid{i}"

    @staticmethod
    def _with_row_id(page: Page, name: str) -> Page:
        rid = Block(torch.arange(page.capacity, dtype=torch.int64, device=page.device),
                    T.BIGINT, None, None)
        return Page(page.blocks + (rid,), page.names + (name,), page.count)

    @staticmethod
    def _residual_channels(e) -> set:
        out: set = set()

        def walk(x):
            if isinstance(x, ColumnRef):
                out.add(x.name)
            elif isinstance(x, Call):
                for a in x.args:
                    walk(a)

        walk(e)
        return out

    def _exec_scalarapply(self, node: N.ScalarApply, page: Page, sub: Page) -> Page:
        n = int(sub.count)
        if n > 1:
            raise ExecutionError("scalar subquery returned more than one row")
        cap = page.capacity
        blocks = list(page.blocks)
        names = list(page.names)
        for b, (fname, _ftype) in zip(sub.blocks, node.subquery.fields):
            if n == 0:
                data = torch.zeros((cap,) + tuple(b.data.shape[1:]), dtype=b.data.dtype,
                                   device=page.device)
                valid = torch.zeros(cap, dtype=torch.bool, device=page.device)
            elif b.lengths is not None or b.key_block is not None:
                # a collection value: every row gathers row 0, companions too
                blocks.append(b.take_rows(torch.zeros(cap, dtype=torch.int64,
                                                      device=page.device)))
                names.append(fname)
                continue
            else:
                data = b.data[0].expand((cap,) + tuple(b.data.shape[1:]))
                valid = None if b.valid is None else b.valid[0].expand(cap)
            blocks.append(Block(data, b.type, valid, b.dict_id))
            names.append(fname)
        return Page(tuple(blocks), tuple(names), page.count)
