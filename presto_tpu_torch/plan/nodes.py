"""Logical plan nodes.

Mirrors the reference's plan-node vocabulary (presto-main/.../sql/planner/
plan/) with TPU-relevant reductions: expressions are already-typed
RowExpressions (expr/ir.py), and every node carries its output schema as
(channel_name, Type) pairs. Channel names are globally unique per planning
session (the analog of the reference's Symbol allocator,
sql/planner/SymbolAllocator.java), so joins can concatenate columns without
collisions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .. import types as T
from ..expr.ir import RowExpression
from ..ops.aggregate import AggSpec
from ..ops.sort import SortKey

Field = Tuple[str, T.Type]  # (channel name, type)


@dataclasses.dataclass(frozen=True)
class PlanNode:
    @property
    def fields(self) -> Tuple[Field, ...]:
        raise NotImplementedError

    @property
    def children(self) -> Tuple["PlanNode", ...]:
        return ()

    def field_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.fields)

    def field_type(self, name: str) -> T.Type:
        for n, t in self.fields:
            if n == name:
                return t
        raise KeyError(name)


@dataclasses.dataclass(frozen=True)
class TableScan(PlanNode):
    """Scan of a connector table (reference TableScanNode). `columns` maps
    output channel -> source column name."""

    catalog: str
    table: str
    columns: Tuple[Tuple[str, str, T.Type], ...]  # (channel, source col, type)
    # runtime dynamic-filter consumers (plan/rules.annotate_dynamic_filters):
    # (filter_id, channel, source column, apply_mask). apply_mask=False
    # means a Filter above this scan applies the device mask (fused into
    # its compaction) and the scan only forwards SPI pruning hints.
    dynamic_filters: Tuple[Tuple[str, str, str, bool], ...] = ()

    @property
    def fields(self):
        return tuple((c, t) for c, _, t in self.columns)


@dataclasses.dataclass(frozen=True)
class Sample(PlanNode):
    """TABLESAMPLE BERNOULLI/SYSTEM(p) (reference SampleNode; both
    sample types execute as row-level bernoulli here — SYSTEM's
    split-level granularity has no analog when a scan is one device
    array). Seeded at plan time so each query samples differently but
    one query's plan is deterministic under kernel caching."""

    child: PlanNode
    fraction: float  # 0..1
    seed: int

    @property
    def fields(self):
        return self.child.fields

    @property
    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class Unnest(PlanNode):
    """Expand array expressions into rows: child columns replicate per
    element, arrays zip by position (reference UnnestNode +
    operator/UnnestOperator.java). One element channel per array, plus an
    optional 1-based ordinality channel. `replicate`, when set by column
    pruning, names the child columns that are replicated (the others, such
    as the unnested array itself, are not needed above the node and are not
    copied once per element)."""

    child: PlanNode
    array_exprs: Tuple[RowExpression, ...]
    elem_channels: Tuple[str, ...]
    ordinality_channel: Optional[str] = None
    replicate: Optional[Tuple[str, ...]] = None

    @property
    def children(self):
        return (self.child,)

    @property
    def fields(self):
        out = [f for f in self.child.fields
               if self.replicate is None or f[0] in self.replicate]
        for e, ch in zip(self.array_exprs, self.elem_channels):
            out.append((ch, e.type.element))
        if self.ordinality_channel is not None:
            out.append((self.ordinality_channel, T.BIGINT))
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class SingleRow(PlanNode):
    """Leaf producing exactly one row with a single dummy column. VALUES
    rows are planned as Project(SingleRow) per row, unioned (reference
    ValuesNode, sql/planner/plan/ValuesNode.java — re-designed so literal
    rows flow through the same expression compiler as every projection)."""

    channel: str

    @property
    def fields(self):
        return ((self.channel, T.BIGINT),)


@dataclasses.dataclass(frozen=True)
class Filter(PlanNode):
    child: PlanNode
    predicate: RowExpression
    # dynamic-filter consumers fused into this filter's keep mask:
    # (filter_id, channel) — pruning shares the predicate's one compaction
    dynamic_filters: Tuple[Tuple[str, str], ...] = ()

    @property
    def fields(self):
        return self.child.fields

    @property
    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class Project(PlanNode):
    child: PlanNode
    exprs: Tuple[RowExpression, ...]
    names: Tuple[str, ...]

    @property
    def fields(self):
        return tuple((n, e.type) for n, e in zip(self.names, self.exprs))

    @property
    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class Aggregate(PlanNode):
    """Grouped aggregation (reference AggregationNode). Empty group_exprs =
    global aggregation (one output row)."""

    child: PlanNode
    group_exprs: Tuple[RowExpression, ...]
    group_names: Tuple[str, ...]
    aggs: Tuple[AggSpec, ...]
    # fused selection: rows failing `mask` don't contribute and don't form
    # groups — the executor-level fusion of Filter into aggregation (on TPU
    # the filter's compaction costs more than masked reductions; see
    # optimizer.fuse_filter_into_aggregates)
    mask: Optional[RowExpression] = None

    @property
    def fields(self):
        out = tuple(
            (n, e.type) for n, e in zip(self.group_names, self.group_exprs)
        )
        return out + tuple((a.name, a.output_type) for a in self.aggs)

    @property
    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class Join(PlanNode):
    """Equi-join with optional residual filter (reference JoinNode).

    kind: inner | left. Output = left fields then right fields (for `left`
    joins the right side's values are NULL on no match)."""

    kind: str
    left: PlanNode
    right: PlanNode
    left_keys: Tuple[RowExpression, ...]
    right_keys: Tuple[RowExpression, ...]
    residual: Optional[RowExpression] = None  # over combined channels
    unique_build: bool = False  # planner knows build keys are unique (n:1)
    # dynamic filters PRODUCED from this join's build side after it
    # materializes: (filter_id, build key index, has_scan_consumer). With
    # no scan consumer the executor applies the filter as an on-device
    # pre-probe mask instead (inner joins only).
    dynamic_filters: Tuple[Tuple[str, int, bool], ...] = ()

    @property
    def fields(self):
        return self.left.fields + self.right.fields

    @property
    def children(self):
        return (self.left, self.right)


@dataclasses.dataclass(frozen=True)
class SemiJoin(PlanNode):
    """EXISTS/IN-subquery join (reference SemiJoinNode): keeps probe rows
    with (anti: without) a match in `source`. Residual (for correlated
    EXISTS with extra predicates) references both sides' channels.

    With `mark` set, NO rows are filtered: every probe row passes through
    plus a boolean `mark` column recording match membership (the
    reference's semi-join output symbol, HashSemiJoinOperator) — how
    EXISTS/IN under OR plans."""

    child: PlanNode
    source: PlanNode
    probe_keys: Tuple[RowExpression, ...]
    source_keys: Tuple[RowExpression, ...]
    anti: bool = False
    residual: Optional[RowExpression] = None
    mark: Optional[str] = None
    # dynamic filters produced from `source` (plain semi joins only —
    # anti/mark keep or annotate non-matching probe rows)
    dynamic_filters: Tuple[Tuple[str, int, bool], ...] = ()
    # NOT IN (subquery): an anti join with SQL's three-valued IN. A NULL
    # probe value, or a NULL among the source keys, makes `v NOT IN (S)`
    # NULL (row dropped) unless S is empty. NOT EXISTS leaves it False.
    null_aware: bool = False

    @property
    def fields(self):
        if self.mark is not None:
            return self.child.fields + ((self.mark, T.BOOLEAN),)
        return self.child.fields

    @property
    def children(self):
        return (self.child, self.source)


@dataclasses.dataclass(frozen=True)
class ScalarApply(PlanNode):
    """Append an uncorrelated single-row subquery's outputs as broadcast
    columns (reference: EnforceSingleRowNode + cross join of a 1-row side)."""

    child: PlanNode
    subquery: PlanNode

    @property
    def fields(self):
        return self.child.fields + self.subquery.fields

    @property
    def children(self):
        return (self.child, self.subquery)


@dataclasses.dataclass(frozen=True)
class Window(PlanNode):
    """Window functions over one (partition, order) spec (reference
    WindowNode). Output = child fields + one field per function; rows come
    out sorted by (partition, order)."""

    child: PlanNode
    partition_exprs: Tuple[RowExpression, ...]
    order_keys: Tuple[SortKey, ...]
    funcs: Tuple[object, ...]  # ops.window.WindowFunc

    @property
    def fields(self):
        return self.child.fields + tuple(
            (f.name, f.output_type) for f in self.funcs
        )

    @property
    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class Sort(PlanNode):
    child: PlanNode
    keys: Tuple[SortKey, ...]

    @property
    def fields(self):
        return self.child.fields

    @property
    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class TopN(PlanNode):
    child: PlanNode
    keys: Tuple[SortKey, ...]
    count: int

    @property
    def fields(self):
        return self.child.fields

    @property
    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class Limit(PlanNode):
    child: PlanNode
    count: int

    @property
    def fields(self):
        return self.child.fields

    @property
    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class Distinct(PlanNode):
    child: PlanNode

    @property
    def fields(self):
        return self.child.fields

    @property
    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class Union(PlanNode):
    """UNION ALL of same-arity inputs (reference UnionNode); inputs are
    renamed to the first input's channels by the planner."""

    inputs: Tuple[PlanNode, ...]
    distinct: bool = False

    @property
    def fields(self):
        return self.inputs[0].fields

    @property
    def children(self):
        return self.inputs


@dataclasses.dataclass(frozen=True)
class Output(PlanNode):
    """Final projection to user-visible column names (reference OutputNode)."""

    child: PlanNode
    channels: Tuple[str, ...]
    titles: Tuple[str, ...]

    @property
    def fields(self):
        return tuple(
            (t, self.child.field_type(c))
            for c, t in zip(self.channels, self.titles)
        )

    @property
    def children(self):
        return (self.child,)


def _sort_key_str(k) -> str:
    """`expr desc nulls first` rendering for one SortKey (reference
    planPrinter orderings)."""
    s = f"{k.expr} {'asc' if k.ascending else 'desc'}"
    if k.nulls_first is not None:
        s += " nulls first" if k.nulls_first else " nulls last"
    return s


def plan_tree_str(
    node: PlanNode, indent: int = 0, collector=None, stats_of=None
) -> str:
    """EXPLAIN-style rendering (reference sql/planner/planPrinter). With a
    StatsCollector (exec/stats.py) this is the EXPLAIN ANALYZE view — per-
    operator wall/rows/bytes/retries (reference ExplainAnalyzeContext +
    PlanNodeStatsSummarizer). `stats_of(node)` (plan/stats.PlanStats)
    annotates ESTIMATED rows, the reference's `{rows: N}` cost prints."""
    pad = "  " * indent
    name = type(node).__name__
    detail = ""
    if isinstance(node, TableScan):
        detail = f" {node.table} [{', '.join(c for c, _, _ in node.columns)}]"
        if node.dynamic_filters:
            dfs = ", ".join(
                f"{fid}->{ch}" + ("" if apply else " (hints)")
                for fid, ch, _src, apply in node.dynamic_filters
            )
            detail += f" [df: {dfs}]"
    elif isinstance(node, Filter):
        detail = f" [{node.predicate}]"
        if node.dynamic_filters:
            detail += " [df: " + ", ".join(
                f"{fid}->{ch}" for fid, ch in node.dynamic_filters
            ) + "]"
    elif isinstance(node, Sample):
        detail = f" [bernoulli {node.fraction * 100:g}%]"
    elif isinstance(node, Project):
        detail = f" [{', '.join(f'{n} := {e}' for n, e in zip(node.names, node.exprs))}]"
    elif isinstance(node, Aggregate):
        keys = ", ".join(node.group_names)
        aggs = ", ".join(
            f"{a.name} := {a.func}({a.input}, {a.input2})"
            if a.input2 is not None
            else f"{a.name} := {a.func}({a.input})"
            for a in node.aggs
        )
        detail = f" [keys: {keys}] [{aggs}]"
        if node.mask is not None:
            detail += f" [mask: {node.mask}]"
    elif isinstance(node, Join):
        pairs = ", ".join(
            f"{l} = {r}" for l, r in zip(node.left_keys, node.right_keys)
        )
        detail = f" [{node.kind}] [{pairs}]" + (
            f" [residual: {node.residual}]" if node.residual else ""
        )
        if node.dynamic_filters:
            detail += " [df: " + ", ".join(
                f"{fid}<-key{i}" for fid, i, _c in node.dynamic_filters
            ) + "]"
    elif isinstance(node, SemiJoin):
        pairs = ", ".join(
            f"{l} = {r}" for l, r in zip(node.probe_keys, node.source_keys)
        )
        detail = f" [{'anti' if node.anti else 'semi'}] [{pairs}]"
    elif isinstance(node, (Sort, TopN)):
        keys = ", ".join(_sort_key_str(k) for k in node.keys)
        detail = f" [{keys}]"
        if isinstance(node, TopN):
            detail = f" [{node.count}]{detail}"
    elif isinstance(node, Window):
        parts = ", ".join(str(e) for e in node.partition_exprs)
        order = ", ".join(_sort_key_str(k) for k in node.order_keys)
        funcs = ", ".join(getattr(f, "name", str(f)) for f in node.funcs)
        detail = f" [partition: {parts}] [order: {order}] [{funcs}]"
    elif isinstance(node, Unnest):
        detail = f" [{', '.join(node.elem_channels)}]"
        if node.ordinality_channel is not None:
            detail += f" [ordinality: {node.ordinality_channel}]"
    elif isinstance(node, Union):
        detail = f" [{len(node.inputs)} inputs]" + (
            " [distinct]" if node.distinct else ""
        )
    elif isinstance(node, Limit):
        detail = f" [{node.count}]"
    elif isinstance(node, Output):
        detail = f" [{', '.join(node.titles)}]"
    elif isinstance(node, (Distinct, SingleRow, ScalarApply)):
        # name-only nodes: no config beyond their children. The explicit
        # branch keeps the prestolint exhaustiveness surface green — a
        # NEW node class must show up here deliberately, one way or the
        # other.
        pass
    if name == "Exchange":
        keys = ", ".join(str(k) for k in node.keys)
        detail = f" [{node.kind}]" + (f" [{keys}]" if keys else "")
    if name == "AggFinalize":
        detail = f" [{', '.join(a.name for a in node.aggs)}]"
    stat = ""
    if collector is not None:
        s = collector.lookup(node)
        if s is not None:
            stat = " " + s.line()
    if stats_of is not None:
        try:
            est = stats_of(node)
            stat += f" {{est: {est.rows:,.0f} rows}}"
        except Exception:  # noqa: BLE001 — estimates are best-effort
            # decoration; EXPLAIN itself must never fail on a stats gap
            pass
    lines = [f"{pad}- {name}{detail}{stat}"]
    for c in node.children:
        lines.append(plan_tree_str(c, indent + 1, collector, stats_of))
    return "\n".join(lines)
