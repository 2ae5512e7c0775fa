"""Maintenance planner: is a view's plan delta-patchable, and how? (torch
counterpart of presto_tpu/matview/maintenance.py)

The reference engine splits every aggregation into PARTIAL and FINAL
stages whose intermediate states merge associatively
(AggregationNode.Step); incremental view maintenance is the same algebra
applied across TIME instead of across parallel tasks — new rows form a delta
page, the view's core plan runs over just the delta, and the delta result
merges into the stored result with the merge functions
`ops.aggregate.decompose_partial` uses. A plan is delta-patchable when
that merge is exact:

  'aggregate' — Filter/Project/TableScan/Union-all feeding one Aggregate
      whose functions all have closed-form merges (count/sum → sum,
      min/max → min/max, checksum → sum). Old result + delta result
      re-aggregate by the same group keys (the group-by kernel on the
      card).
  'append' — a pure Filter/Project/TableScan/Union-all pipeline (rows
      in = rows out, per row). Delta rows simply append; Sort/TopN/Limit/
      Distinct terminals stay exact because for pure appends
      top-N(old ∪ delta) ⊆ top-N(old) ∪ delta and
      distinct(old ∪ delta) = distinct(distinct(old) ∪ delta).

Everything else (joins, windows, avg-style aggregates whose stored final
values do not merge, nondeterministic plans) is recompute-only: the
manager re-executes in full and records why.

Every executor here runs on the device its caller names (the session's,
or the cached page's for a result-cache patch), the merge's in-memory
catalog included.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

from .. import types as T
from ..connectors.memory import MemoryCatalog
from ..exec import qcache
from ..exec.executor import Executor
from ..expr.ir import ColumnRef
from ..ops.aggregate import AggSpec
from ..ops.union import concat_pages
from ..page import Page
from ..plan import nodes as N


def _env_float(name: str, default: float) -> float:
    return float(os.environ.get(name, default))


# Largest delta, as a fraction of the base tables' row count, that a delta
# refresh or patch processes before falling back to a full recompute —
# past it re-execution is cheaper than the scan_delta + merge pipeline.
DELTA_MAX_FRAC = _env_float("PRESTO_TPU_MATVIEW_DELTA_MAX_FRAC", 0.2)

# Master switch of the result cache's "patch" verdict (patch.py). 0: any
# base-table write invalidates the cached result.
PATCH_ENABLED = _env_float("PRESTO_TPU_MATVIEW_PATCH", 1) != 0

# Background refresh cadence of MatViewManager.start_auto_refresh(); 0
# leaves the thread off unless an interval is passed.
REFRESH_INTERVAL_S = _env_float("PRESTO_TPU_MATVIEW_REFRESH_INTERVAL_S", 0.0)


# Aggregates whose stored final values merge exactly. avg/stddev merge
# through moment pairs and approx_distinct through sketch union in the
# partial/final path, but a STORED view keeps final values only.
MERGEABLE_AGGS = ("count", "count_star", "checksum", "sum", "min", "max")

_TERMINALS = (N.Sort, N.TopN, N.Limit, N.Distinct)
_APPEND_OK = (N.TableScan, N.Filter, N.Project, N.Union)


@dataclasses.dataclass(frozen=True)
class MaintenancePlan:
    """How to maintain one view incrementally.

    kind      — 'aggregate' | 'append'
    core      — the plan subtree re-run over delta pages (the Aggregate
                for 'aggregate', the whole pipeline for 'append');
                channel-named, no Output wrapper.
    channels  — engine channel names of the stored columns (the
                Output.channels of the view plan).
    titles    — user-visible names (Output.titles).
    terminals — Sort/TopN/Limit/Distinct nodes peeled off above the core,
                outermost first; re-applied after every merge.
    types     — channel -> Type of the stored columns.
    group_names / merge_aggs — 'aggregate' only: the group-by channels and
                the AggSpecs that re-aggregate old and delta rows.
    tables    — base tables the core scans.
    """

    kind: str
    core: N.PlanNode
    channels: Tuple[str, ...]
    titles: Tuple[str, ...]
    terminals: Tuple[N.PlanNode, ...]
    types: Dict[str, T.Type]
    group_names: Tuple[str, ...] = ()
    merge_aggs: Tuple[AggSpec, ...] = ()
    tables: Tuple[str, ...] = ()


def _expr_columns(expr) -> Tuple[str, ...]:
    names = []
    qcache._walk(expr, lambda o: names.append(o.name) if isinstance(o, ColumnRef) else None)
    return tuple(names)


def _check_append_subtree(node) -> Optional[str]:
    """None when `node` is a pure per-row pipeline (each input row maps to
    at most one output row, independently of every other row), else the
    rejection reason."""
    if isinstance(node, N.Union):
        if node.distinct:
            return "UNION DISTINCT"
    elif not isinstance(node, _APPEND_OK):
        return type(node).__name__
    for child in node.children:
        reason = _check_append_subtree(child)
        if reason is not None:
            return reason
    return None


def classify(plan) -> Tuple[Optional[MaintenancePlan], str]:
    """(MaintenancePlan, "") when `plan` (an optimized N.Output tree) is
    delta-patchable, else (None, reason) — the reason shows in EXPLAIN
    ANALYZE's `-- matview:` footer."""
    if not isinstance(plan, N.Output):
        return None, "not an Output plan"
    if len(set(plan.titles)) != len(plan.titles):
        return None, "duplicate output column names"
    if not qcache.plan_is_deterministic(plan):
        return None, "non-deterministic plan"
    chans = set(plan.channels)

    # Peel order-shaping terminals; the merge re-applies them to
    # old ∪ delta. Their sort keys must survive the Output projection: the
    # stored table keeps plan.channels only.
    terminals = []
    core = plan.child
    while isinstance(core, _TERMINALS):
        if isinstance(core, (N.Sort, N.TopN)):
            for k in core.keys:
                missing = [c for c in _expr_columns(k.expr) if c not in chans]
                if missing:
                    return None, f"sort key over dropped column {missing[0]}"
        if isinstance(core, N.Distinct):
            dropped = [n for n, _t in core.fields if n not in chans]
            if dropped:
                return None, f"DISTINCT over dropped column {dropped[0]}"
        terminals.append(core)
        core = core.child

    types = {n: t for n, t in core.fields if n in chans}
    missing = [c for c in plan.channels if c not in types]
    if missing:
        return None, f"output channel {missing[0]} not produced by core"
    tables = qcache.plan_tables(plan)
    if not tables:
        return None, "no base tables"

    if isinstance(core, N.Aggregate):
        # TopN/Limit above an aggregation would need retraction when a
        # delta moves group totals across the cutoff: not append-only
        for tn in terminals:
            if isinstance(tn, (N.TopN, N.Limit, N.Distinct)):
                return None, "LIMIT/TopN/DISTINCT above an aggregation"
        bad = [a.func for a in core.aggs if a.func not in MERGEABLE_AGGS]
        if bad:
            return None, f"non-decomposable aggregate {bad[0]}"
        # a fused mask references core.child's columns only: the delta run
        # applies it again, nothing to check
        needed = set(core.group_names) | {a.name for a in core.aggs}
        dropped = needed - chans
        if dropped:
            return None, f"aggregation column {sorted(dropped)[0]} dropped"
        reason = _check_append_subtree(core.child)
        if reason is not None:
            return None, f"non-append input to aggregation: {reason}"
        merge_aggs = tuple(
            AggSpec("sum" if a.func in ("count", "count_star", "checksum") else a.func,
                    ColumnRef(a.name, a.output_type), a.name, a.output_type)
            for a in core.aggs
        )
        return MaintenancePlan(
            kind="aggregate", core=core, channels=plan.channels, titles=plan.titles,
            terminals=tuple(terminals), types=types, group_names=core.group_names,
            merge_aggs=merge_aggs, tables=tables,
        ), ""

    reason = _check_append_subtree(core)
    if reason is not None:
        return None, reason
    return MaintenancePlan(
        kind="append", core=core, channels=plan.channels, titles=plan.titles,
        terminals=tuple(terminals), types=types, tables=tables,
    ), ""


class _DeltaOverlay:
    """Catalog view in which the named tables hold ONLY their delta rows.
    The executor's scan reads catalog.page() or page_columns(), so both
    are swapped; metadata calls fall through to the base."""

    def __init__(self, base, deltas: Dict[str, Page]):
        self._base = base
        self._deltas = deltas

    def page(self, table: str) -> Page:
        return self._deltas[table]

    def page_columns(self, table: str, columns) -> Page:
        return self._deltas[table]

    def exact_row_count(self, table: str) -> int:
        return int(self._deltas[table].count)

    def __getattr__(self, name):
        return getattr(self._base, name)


def run_core(catalog, mplan: MaintenancePlan, deltas: Dict[str, Page], device) -> Page:
    """Run the view's core plan over the delta rows only, on `device`.
    Returns a channel-named page (the shape the merge expects)."""
    plan = N.Output(mplan.core, mplan.channels, mplan.channels)
    return Executor(_DeltaOverlay(catalog, deltas), device=device).run(plan)


def merge_pages(mplan: MaintenancePlan, old: Page, delta: Page, device) -> Page:
    """Fold a delta result into the stored result on `device`. Both pages
    are channel-named; so is the output."""
    if int(delta.count) == 0 and not mplan.terminals:
        return old
    pages = [p.to(device) for p in (old, delta) if int(p.count) > 0]
    if not pages:
        return old
    both = pages[0] if len(pages) == 1 else concat_pages(pages)
    if mplan.kind == "append" and not mplan.terminals:
        return both

    # re-aggregate / re-sort old ∪ delta with an in-memory plan; the scan
    # keeps channel names so terminal sort keys resolve
    scan = N.TableScan("memory", "__mv_merge__",
                       tuple((c, c, mplan.types[c]) for c in mplan.channels))
    node: N.PlanNode = scan
    if mplan.kind == "aggregate":
        node = N.Aggregate(
            node,
            tuple(ColumnRef(g, mplan.types[g]) for g in mplan.group_names),
            mplan.group_names,
            mplan.merge_aggs,
        )
    for tn in reversed(mplan.terminals):
        node = dataclasses.replace(tn, child=node)
    plan = N.Output(node, mplan.channels, mplan.channels)
    cat = MemoryCatalog({"__mv_merge__": both}, device=device)
    return Executor(cat, device=device).run(plan)


def patch_pages(catalog, mplan: MaintenancePlan, old: Page, deltas: Dict[str, Page],
                device) -> Tuple[Page, int]:
    """old (channel-named) + base-table delta pages -> (merged page, delta
    rows consumed)."""
    delta_rows = sum(int(p.count) for p in deltas.values())
    delta = run_core(catalog, mplan, deltas, device)
    return merge_pages(mplan, old, delta, device), delta_rows
