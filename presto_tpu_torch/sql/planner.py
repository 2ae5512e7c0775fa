"""Analyzer + logical planner: AST -> typed PlanNode tree.

Combines the reference's Analyzer/StatementAnalyzer/ExpressionAnalyzer
(presto-main/.../sql/analyzer/) and LogicalPlanner + key optimizations
(sql/planner/LogicalPlanner.java, PlanOptimizers.java) into one pass that is
naturally "optimized-by-construction" for the common analytic shapes:

* predicate pushdown — WHERE conjuncts are classified while planning and
  single-relation filters land directly on their scan
  (reference PredicatePushDown.java)
* greedy join ordering over the equi-join graph using catalog row counts
  (reference ReorderJoins + DetermineJoinDistributionType, simplified)
* subquery decorrelation for the canonical patterns: uncorrelated scalar ->
  ScalarApply; correlated scalar aggregate -> group-by + left join
  (reference TransformCorrelatedScalarAggregationToJoin.java);
  [NOT] EXISTS / IN -> SemiJoin with optional residual
  (reference TransformExistsApplyToLateralNode + semi-join rewrites)
* count(DISTINCT x) -> count over Distinct (reference
  SingleDistinctAggregationToGroupBy.java)

Channel names (`name#K`) are globally unique per Planner — the reference's
SymbolAllocator.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from .. import types as T
from ..expr import ir
from ..expr.functions import FUNCTIONS
from ..ops.aggregate import AggSpec
from ..ops.sort import SortKey
from ..plan import nodes as N
from . import tree as t

AGG_FUNCS = {
    "count", "sum", "avg", "min", "max", "checksum", "approx_distinct",
    "min_by", "max_by", "approx_percentile",
    "array_agg", "map_agg", "histogram",
    "learn_linear_regression", "learn_regressor", "learn_classifier",
    "map_union", "multimap_agg", "numeric_histogram",
    "qdigest_agg", "approx_set", "merge",
}

# aggregates planned by rewriting onto the core set (reference: many of
# operator/aggregation/*'s 100+ functions decompose into sum/count states)
LAMBDA_FUNCS = {
    "transform", "filter", "reduce", "zip_with", "map_zip_with",
    "any_match", "all_match", "none_match",
    "map_filter", "transform_values", "transform_keys",
}

REWRITE_AGG_FUNCS = {
    "stddev", "stddev_samp", "stddev_pop", "variance", "var_samp", "var_pop",
    "count_if", "bool_and", "bool_or", "every", "arbitrary",
    "geometric_mean", "covar_samp", "covar_pop", "corr",
    "skewness", "kurtosis", "regr_slope", "regr_intercept",
}

_BINOP_FN = {
    "+": "add",
    "-": "subtract",
    "*": "multiply",
    "/": "divide",
    "%": "modulus",
    "||": "concat",
    "=": "eq",
    "<>": "ne",
    "<": "lt",
    "<=": "le",
    ">": "gt",
    ">=": "ge",
}
_CMP_OPS = {"=", "<>", "<", "<=", ">", ">="}


class PlanningError(ValueError):
    pass


# ---------------------------------------------------------------------------
# scope
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FieldRef:
    qualifier: Optional[str]  # relation alias (or table name)
    name: str  # user-visible column name
    channel: str
    type: T.Type


class Scope:
    def __init__(self, fields: Sequence[FieldRef]):
        self.fields = list(fields)

    def resolve(self, parts: Tuple[str, ...]) -> Optional[FieldRef]:
        if len(parts) == 1:
            hits = [f for f in self.fields if f.name == parts[0]]
        else:
            q, name = parts[-2], parts[-1]
            hits = [
                f
                for f in self.fields
                if f.name == name and f.qualifier is not None and f.qualifier == q
            ]
        if len(hits) > 1:
            raise PlanningError(f"ambiguous column {'.'.join(parts)!r}")
        return hits[0] if hits else None

    def visible(self, qualifier: Optional[str] = None) -> List[FieldRef]:
        if qualifier is None:
            return list(self.fields)
        return [f for f in self.fields if f.qualifier == qualifier]


# ---------------------------------------------------------------------------
# catalog protocol
# ---------------------------------------------------------------------------


class Catalog:
    """Connector metadata interface (reference ConnectorMetadata +
    table statistics SPI)."""

    name = "catalog"

    def table_names(self) -> List[str]:
        raise NotImplementedError

    def schema(self, table: str) -> Dict[str, T.Type]:
        raise NotImplementedError

    def row_count(self, table: str) -> int:
        raise NotImplementedError

    def unique_columns(self, table: str) -> List[Tuple[str, ...]]:
        """Column sets known unique (primary keys) — enables n:1 joins."""
        return []


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RelationPlan:
    node: N.PlanNode
    scope: Scope
    # pre-projection scope (source columns), when ORDER BY may legally
    # reference columns that are not in the select list
    pre_scope: Optional[Scope] = None


class Planner:
    def __init__(self, catalog: Catalog, views=None):
        self.catalog = catalog
        self.views = views or {}  # name -> view query SQL text
        self._view_stack: set = set()
        self._counter = itertools.count()

    def channel(self, base: str) -> str:
        return f"{base}#{next(self._counter)}"

    @staticmethod
    def _limit_count(limit) -> int:
        """Coerce a bound LIMIT parameter to its integer count."""
        if isinstance(limit, t.BoundParameter):
            limit = limit.inner
        if isinstance(limit, t.Parameter):
            raise PlanningError("LIMIT parameter is not bound")
        if isinstance(limit, t.NumberLiteral) and "." not in limit.text \
                and "e" not in limit.text.lower():
            return int(limit.text)
        raise PlanningError("LIMIT must be an integer literal")

    # -- statements --
    def plan_statement(self, ast: t.Node) -> N.PlanNode:
        if isinstance(ast, t.Query):
            rp = self.plan_query(ast, outer=None, ctes={})
            return rp.node
        if isinstance(ast, t.Explain):
            return self.plan_statement(ast.query)
        raise PlanningError(f"unsupported statement {type(ast).__name__}")

    # -- queries --
    def plan_query(
        self, q: t.Query, outer: Optional["SelectContext"], ctes: Dict[str, t.WithItem]
    ) -> RelationPlan:
        if q.with_items:
            ctes = dict(ctes)
            for item in q.with_items:
                ctes[item.name.lower()] = item

        rp = self.plan_query_body(q.body, outer, ctes)
        if q.limit is not None and not isinstance(q.limit, int):
            # LIMIT ? bound at EXECUTE time (parser stores the Parameter;
            # substitution delivers a literal AST). The count is consumed
            # HERE, at plan time — a skeleton cache (exec/qcache.py) then
            # sees the parameter index missing from the plan and correctly
            # refuses to rebind across values.
            q = dataclasses.replace(q, limit=self._limit_count(q.limit))

        node, scope = rp.node, rp.scope
        if q.order_by:
            keys = []
            hidden: List[Tuple[ir.RowExpression, str]] = []
            for si in q.order_by:
                try:
                    e = self._order_expr(si.expr, scope, outer, ctes, node)
                except PlanningError:
                    # ORDER BY repeating a select-list expression verbatim
                    # (commonly an aggregate: ORDER BY count(*)) — match
                    # structurally against the items and reuse the output
                    # channel (reference: Analyzer orders on output fields)
                    matched = self._order_item_match(q.body, si.expr, scope)
                    if matched is not None:
                        keys.append(
                            SortKey(matched, si.ascending, si.nulls_first)
                        )
                        continue
                    # ORDER BY on a column NOT in the select list: extend
                    # the projection with a hidden sort channel, drop it
                    # after sorting (reference: LogicalPlanner orders on
                    # pre-projection symbols). Ordinals stay strict.
                    if (
                        rp.pre_scope is None
                        or not isinstance(node, N.Project)
                        or isinstance(si.expr, t.NumberLiteral)
                    ):
                        raise
                    pctx = SelectContext(self, [rp.pre_scope], outer, ctes, None)
                    e_src = pctx.translate(si.expr)
                    ch = self.channel("osort")
                    hidden.append((e_src, ch))
                    e = ir.ColumnRef(ch, e_src.type)
                keys.append(SortKey(e, si.ascending, si.nulls_first))
            if hidden:
                proj: N.Project = node
                node = N.Project(
                    proj.child,
                    proj.exprs + tuple(e for e, _ in hidden),
                    proj.names + tuple(ch for _, ch in hidden),
                )
            if q.limit is not None:
                node = N.TopN(node, tuple(keys), q.limit)
            else:
                node = N.Sort(node, tuple(keys))
            if hidden:  # re-project to the visible columns only
                node = N.Project(
                    node,
                    tuple(ir.ColumnRef(f.channel, f.type) for f in scope.fields),
                    tuple(f.channel for f in scope.fields),
                )
        elif q.limit is not None:
            node = N.Limit(node, q.limit)
        return RelationPlan(node, scope)

    @staticmethod
    def _expand_group_by(group_by):
        """Expand GROUP BY items containing GROUPING SETS/ROLLUP/CUBE into
        the cross product of grouping sets (reference: the analyzer's
        computeGroupingSetsCrossProduct). None when no construct appears."""
        if not any(isinstance(g, t.GroupingSets) for g in group_by):
            return None
        sets = [()]
        for g in group_by:
            options = (
                list(g.sets) if isinstance(g, t.GroupingSets) else [(g,)]
            )
            sets = [s + tuple(o) for s in sets for o in options]
            if len(sets) > 64:
                # each set re-plans and re-executes the source; cap like
                # the reference's max-grouping-sets session limit
                raise PlanningError(
                    "too many grouping sets (limit 64); reduce the "
                    "CUBE/GROUPING SETS cross product"
                )
        full: List[t.Node] = []
        for s in sets:
            for e in s:
                if isinstance(e, t.NumberLiteral):
                    raise PlanningError(
                        "ordinals are not supported inside "
                        "ROLLUP/CUBE/GROUPING SETS; name the column"
                    )
                if e not in full:
                    full.append(e)
        return sets, full

    def _plan_grouping_sets(
        self, sel: t.Select, sets, full, outer, ctes
    ) -> RelationPlan:
        """One Aggregate per grouping set, unioned; missing group columns
        are typed NULLs (reference plans this as GroupIdNode + one shared
        aggregation — re-designed as a union of independent aggregations,
        which XLA handles as parallel fused reductions)."""
        if sel.distinct:
            raise PlanningError("SELECT DISTINCT with GROUPING SETS")
        wins: List[t.FunctionCall] = []
        for it in sel.items:
            if isinstance(it, t.SelectItem):
                _collect_windows(it.expr, wins)
        if wins:
            # a window over grouping sets runs over the UNION of all sets:
            # rewrite into (inner: per-set aggregation union exposing group
            # columns, aggregates, and grouping() bits) -> (outer: windows
            # over the union). Reference: GroupIdNode feeding WindowNode.
            return self._plan_gs_with_windows(sel, full, outer, ctes)
        parts = [
            self.plan_select(
                dataclasses.replace(sel, group_by=tuple(s)),
                outer,
                ctes,
                gs_ctx=(s, tuple(e for e in full if e not in s), full),
            )
            for s in sets
        ]
        common = [ty for _, ty in parts[0].node.fields]
        for rp in parts[1:]:
            common = [
                T.common_super_type(a, ty)
                for a, (_, ty) in zip(common, rp.node.fields)
            ]
        first = self._coerce_columns(parts[0].node, common)
        first_names = tuple(n for n, _ in first.fields)
        nodes: List[N.PlanNode] = [first]
        for rp in parts[1:]:
            cn = self._coerce_columns(rp.node, common)
            exprs = tuple(ir.ColumnRef(n, ty) for n, ty in cn.fields)
            nodes.append(N.Project(cn, exprs, first_names))
        node = (
            nodes[0]
            if len(nodes) == 1
            else N.Union(tuple(nodes), distinct=False)
        )
        scope = Scope(
            [
                FieldRef(f.qualifier, f.name, ch, ty)
                for f, (ch, ty) in zip(parts[0].scope.fields, first.fields)
            ]
        )
        return RelationPlan(node, scope)

    def _plan_gs_with_windows(self, sel: t.Select, full, outer, ctes):
        """Split a grouping-sets SELECT containing window functions into an
        inner aggregation-only select (per-set union, existing path) and an
        outer select computing the windows over that union.

        Every group expression, aggregate call, and grouping() call is
        given an inner output alias; the outer expressions are the original
        ones with those subtrees replaced by alias references."""
        aggs: List[t.FunctionCall] = []
        grps: List[t.FunctionCall] = []
        for it in sel.items:
            if isinstance(it, t.SelectItem):
                _collect_aggregates(it.expr, aggs)
                _collect_grouping_calls(it.expr, grps)
        if sel.having is not None:
            _collect_aggregates(sel.having, aggs)

        mapping: Dict[t.Node, t.Node] = {}
        inner_items: List[t.SelectItem] = []

        def add_inner(expr: t.Node, alias: str) -> None:
            inner_items.append(t.SelectItem(expr, alias))
            mapping[expr] = t.Identifier((alias,))

        seen: set = set()
        used_aliases: set = set()
        for i, g in enumerate(full):
            if g in seen:
                continue
            seen.add(g)
            # bare identifiers keep their natural name; qualified ones
            # (a.x vs b.x would collide on 'x') and expressions get
            # positional aliases
            if isinstance(g, t.Identifier) and len(g.parts) == 1 and (
                g.parts[-1] not in used_aliases
            ):
                alias = g.parts[-1]
            else:
                alias = f"_gs{i}"
            used_aliases.add(alias)
            add_inner(g, alias)
        for i, a in enumerate(aggs):
            if a in seen:
                continue
            seen.add(a)
            add_inner(a, f"_agg{i}")
        for i, g in enumerate(grps):
            if g in seen:
                continue
            seen.add(g)
            add_inner(g, f"_grp{i}")

        inner_sel = dataclasses.replace(
            sel, items=tuple(inner_items), distinct=False
        )
        outer_items = tuple(
            t.SelectItem(_ast_replace(it.expr, mapping), it.alias)
            if isinstance(it, t.SelectItem)
            else it
            for it in sel.items
        )
        derived = t.SubqueryRelation(
            t.Query(body=inner_sel), alias="_gsw", column_aliases=()
        )
        outer_sel = t.Select(
            items=outer_items,
            from_=derived,
            where=None,
            group_by=(),
            having=None,
            distinct=sel.distinct,
        )
        return self.plan_select(outer_sel, outer, ctes)

    @staticmethod
    def _order_item_match(body, order_ast, scope) -> Optional[ir.ColumnRef]:
        """If `order_ast` structurally equals a select item's expression,
        return a ref to that item's output channel. Requires positional
        item/field alignment, so bails out when the select list has a *."""
        if not isinstance(body, t.Select):
            return None
        if isinstance(order_ast, t.NumberLiteral):
            return None  # ordinals stay strict — never match a literal item
        if any(isinstance(it, t.Star) for it in body.items):
            return None
        if len(body.items) != len(scope.fields):
            return None
        for it, f in zip(body.items, scope.fields):
            if isinstance(it, t.SelectItem) and it.expr == order_ast:
                return ir.ColumnRef(f.channel, f.type)
        return None

    def plan_query_body(self, body, outer, ctes) -> RelationPlan:
        if isinstance(body, t.Select):
            return self.plan_select(body, outer, ctes)
        if isinstance(body, t.SetOperation):
            return self.plan_set_op(body, outer, ctes)
        if isinstance(body, t.Query):
            return self.plan_query(body, outer, ctes)
        if isinstance(body, t.Values):
            return self.plan_values(body, outer, ctes)
        raise PlanningError(f"unsupported query body {type(body).__name__}")

    def plan_values(self, v: t.Values, outer, ctes) -> RelationPlan:
        """Each VALUES row becomes Project(SingleRow); rows are coerced to
        per-column common super types and unioned (reference: Values.java →
        ValuesNode with per-row constant expressions)."""
        if not v.rows:
            raise PlanningError("VALUES requires at least one row")
        width = len(v.rows[0])
        row_nodes: List[N.PlanNode] = []
        for row in v.rows:
            if len(row) != width:
                raise PlanningError("VALUES rows differ in column count")
            sctx = SelectContext(self, [Scope([])], outer, ctes, None)
            exprs = tuple(sctx.translate(cell) for cell in row)
            leaf = N.SingleRow(self.channel("singlerow"))
            names = tuple(self.channel(f"_col{i}") for i in range(width))
            row_nodes.append(N.Project(leaf, exprs, names))
        common = [ty for _, ty in row_nodes[0].fields]
        for rn in row_nodes[1:]:
            common = [
                T.common_super_type(a, ty)
                for a, (_, ty) in zip(common, rn.fields)
            ]
        first = self._coerce_columns(row_nodes[0], common)
        parts: List[N.PlanNode] = [first]
        first_names = tuple(n for n, _ in first.fields)
        for rn in row_nodes[1:]:
            cn = self._coerce_columns(rn, common)
            exprs = tuple(ir.ColumnRef(n, ty) for n, ty in cn.fields)
            parts.append(N.Project(cn, exprs, first_names))
        node: N.PlanNode = (
            parts[0] if len(parts) == 1 else N.Union(tuple(parts), distinct=False)
        )
        scope = Scope(
            [
                FieldRef(None, f"_col{i}", ch, ty)
                for i, (ch, ty) in enumerate(first.fields)
            ]
        )
        return RelationPlan(node, scope)

    def _order_expr(self, ast, scope: Scope, outer, ctes, node) -> ir.RowExpression:
        """ORDER BY resolves against output columns (aliases) first."""
        if isinstance(ast, t.Identifier) and len(ast.parts) == 1:
            f = scope.resolve(ast.parts)
            if f is not None:
                return ir.ColumnRef(f.channel, f.type)
        if isinstance(ast, t.NumberLiteral) and "." not in ast.text:
            idx = int(ast.text)
            if not 1 <= idx <= len(scope.fields):
                raise PlanningError(
                    f"ORDER BY position {idx} is not in select list "
                    f"(1..{len(scope.fields)})"
                )
            f = scope.fields[idx - 1]
            return ir.ColumnRef(f.channel, f.type)
        ctx = SelectContext(self, [scope], outer, ctes, None)
        return ctx.translate(ast)

    def plan_set_op(self, op: t.SetOperation, outer, ctes) -> RelationPlan:
        left = self.plan_query_body(op.left, outer, ctes)
        right = self.plan_query_body(op.right, outer, ctes)
        lf, rf = left.node.fields, right.node.fields
        if len(lf) != len(rf):
            raise PlanningError("set operation inputs differ in column count")
        # per-column common super type; coerce both sides where needed
        common = [
            T.common_super_type(lt, rt) for (_, lt), (_, rt) in zip(lf, rf)
        ]
        lnode = self._coerce_columns(left.node, common)
        # rename right channels to the (possibly coerced) left channels
        rnode = self._coerce_columns(right.node, common)
        exprs = tuple(ir.ColumnRef(n, ty) for n, ty in rnode.fields)
        renamed = N.Project(rnode, exprs, tuple(n for n, _ in lnode.fields))
        if op.op in ("union", "union_all"):
            node: N.PlanNode = N.Union((lnode, renamed), distinct=op.op == "union")
        elif op.op in ("intersect", "except"):
            node = self._plan_intersect_except(op.op, lnode, renamed)
        else:
            raise PlanningError(
                f"set operation {op.op.replace('_', ' ').upper()} "
                "is not supported (only the DISTINCT variants are)"
            )
        scope = Scope(
            [
                FieldRef(f.qualifier, f.name, ch, ty)
                for f, (ch, ty) in zip(left.scope.fields, lnode.fields)
            ]
        )
        return RelationPlan(node, scope)

    def _plan_intersect_except(self, op: str, lnode, rnode) -> N.PlanNode:
        """INTERSECT/EXCEPT (distinct) as a side-tagged union + grouped
        per-side counts + filter (reference: SetOperationNodeTranslator
        rewrites these the same way onto a marker-aggregation). GROUP BY
        treats NULL keys as equal, which is exactly the set-op semantics —
        no null-safe join machinery needed."""
        names = tuple(n for n, _ in lnode.fields)
        refs = tuple(ir.ColumnRef(n, ty) for n, ty in lnode.fields)
        side = self.channel("setop_side")
        lp = N.Project(
            lnode, refs + (ir.lit(0),), names + (side,)
        )
        rrefs = tuple(ir.ColumnRef(n, ty) for n, ty in rnode.fields)
        rp = N.Project(rnode, rrefs + (ir.lit(1),), names + (side,))
        u = N.Union((lp, rp), distinct=False)
        side_ref = ir.ColumnRef(side, T.BIGINT)
        cl = self.channel("cnt_l")
        cr = self.channel("cnt_r")

        def count_side(v):
            cond = ir.Call("eq", (side_ref, ir.lit(v)), T.BOOLEAN)
            return ir.Call(
                "if", (cond, ir.lit(1), ir.Literal(None, T.BIGINT)), T.BIGINT
            )

        agg = N.Aggregate(
            u,
            refs,
            names,
            (
                AggSpec("count", count_side(0), cl, T.BIGINT),
                AggSpec("count", count_side(1), cr, T.BIGINT),
            ),
        )
        cl_ref = ir.ColumnRef(cl, T.BIGINT)
        cr_ref = ir.ColumnRef(cr, T.BIGINT)
        zero = ir.lit(0)
        if op == "intersect":
            pred = ir.Call(
                "and",
                (
                    ir.Call("gt", (cl_ref, zero), T.BOOLEAN),
                    ir.Call("gt", (cr_ref, zero), T.BOOLEAN),
                ),
                T.BOOLEAN,
            )
        else:  # except
            pred = ir.Call(
                "and",
                (
                    ir.Call("gt", (cl_ref, zero), T.BOOLEAN),
                    ir.Call("eq", (cr_ref, zero), T.BOOLEAN),
                ),
                T.BOOLEAN,
            )
        flt = N.Filter(agg, pred)
        return N.Project(flt, refs, names)

    def _coerce_columns(self, node: N.PlanNode, target_types) -> N.PlanNode:
        if all(ty == tt for (_, ty), tt in zip(node.fields, target_types)):
            return node
        exprs = []
        names = []
        for (ch, ty), tt in zip(node.fields, target_types):
            ref = ir.ColumnRef(ch, ty)
            if ty == tt:
                exprs.append(ref)
                names.append(ch)
            else:
                exprs.append(ir.cast(ref, tt))
                names.append(self.channel("coerce"))
        return N.Project(node, tuple(exprs), tuple(names))

    def _resolve_table_name(self, name: str) -> str:
        """Resolve a possibly-qualified `[catalog.][schema.]table` against
        the session catalog (reference: MetadataManager qualified-name
        resolution; connectors here expose one implicit 'default' schema,
        except names the catalog itself registers with dots, e.g.
        system.runtime.queries)."""
        known = {t.lower() for t in self.catalog.table_names()}
        if name in known:
            return name
        parts = name.split(".")
        if len(parts) == 1:
            raise PlanningError(f"unknown table {name!r}")
        cat_name = str(getattr(self.catalog, "name", "")).lower()
        # a catalog store mounts members as dotted `<catalog>.<table>`
        # names; collapse the implicit `default` schema against those
        if (
            len(parts) == 3
            and parts[1] == "default"
            and f"{parts[0]}.{parts[2]}" in known
        ):
            return f"{parts[0]}.{parts[2]}"
        if len(parts) == 3 and parts[0] != cat_name:
            raise PlanningError(
                f"unknown catalog {parts[0]!r} (session catalog is "
                f"{cat_name!r})"
            )
        schema_part = parts[-2]
        if schema_part not in ("default", cat_name):
            raise PlanningError(f"unknown schema {schema_part!r}")
        if parts[-1] in known:
            return parts[-1]
        raise PlanningError(f"unknown table {name!r}")

    # -- relations --
    def plan_relation(self, rel, outer, ctes) -> RelationPlan:
        if isinstance(rel, t.TableSample):
            import random as _random

            inner = self.plan_relation(rel.relation, outer, ctes)
            if not 0.0 <= rel.percentage <= 100.0:
                # reference semantics: SAMPLE_PERCENTAGE_OUT_OF_RANGE
                # fails the query — clamping would silently change results
                raise PlanningError(
                    f"TABLESAMPLE percentage must be in [0, 100], got "
                    f"{rel.percentage!r}"
                )
            frac = rel.percentage / 100.0
            # plan-time seed: each query samples a fresh subset while the
            # compiled kernel stays deterministic (reference SampleNode)
            node = N.Sample(
                inner.node, frac, _random.getrandbits(62)
            )
            return RelationPlan(node, inner.scope)
        if isinstance(rel, t.Table):
            return self.plan_table(rel, ctes, outer)
        if isinstance(rel, t.SubqueryRelation):
            sub = self.plan_query(rel.query, outer, ctes)
            names = rel.column_aliases or tuple(
                f.name for f in sub.scope.fields
            )
            if len(names) != len(sub.scope.fields):
                raise PlanningError("subquery column alias count mismatch")
            scope = Scope(
                [
                    FieldRef(rel.alias, n, f.channel, f.type)
                    for n, f in zip(names, sub.scope.fields)
                ]
            )
            return RelationPlan(sub.node, scope)
        if isinstance(rel, t.Join):
            raise PlanningError("join nodes handled by plan_select")
        raise PlanningError(f"unsupported relation {type(rel).__name__}")

    def plan_table(self, rel: t.Table, ctes, outer) -> RelationPlan:
        name = rel.name.lower()
        if name in ctes:
            item = ctes[name]
            sub = self.plan_query(item.query, outer, {k: v for k, v in ctes.items() if k != name})
            names = item.column_aliases or tuple(f.name for f in sub.scope.fields)
            alias = rel.alias or rel.name
            scope = Scope(
                [
                    FieldRef(alias, n, f.channel, f.type)
                    for n, f in zip(names, sub.scope.fields)
                ]
            )
            return RelationPlan(sub.node, scope)
        if name in self.views:
            # planner-time view expansion (reference StatementAnalyzer
            # view resolution + execution/CreateViewTask.java): the stored
            # query text is parsed and planned inline like a CTE
            if name in self._view_stack:
                raise PlanningError(f"view {name!r} is recursive")
            from .parser import parse as _parse

            vast = _parse(self.views[name])
            if not isinstance(vast, t.Query):
                raise PlanningError(f"view {name!r} is not a SELECT query")
            self._view_stack.add(name)
            try:
                sub = self.plan_query(vast, outer, {})
            finally:
                self._view_stack.discard(name)
            alias = rel.alias or rel.name
            scope = Scope(
                [
                    FieldRef(alias, f.name, f.channel, f.type)
                    for f in sub.scope.fields
                ]
            )
            return RelationPlan(sub.node, scope)
        name = self._resolve_table_name(name)
        schema = self.catalog.schema(name)
        # qualified names default-alias to the last segment, so
        # `from system.runtime.queries` resolves `queries.state`
        alias = rel.alias or name.split(".")[-1]
        columns = []
        fields = []
        for cname, ctype in schema.items():
            ch = self.channel(cname)
            columns.append((ch, cname, ctype))
            fields.append(FieldRef(alias, cname, ch, ctype))
        node = N.TableScan(self.catalog.name, name, tuple(columns))
        return RelationPlan(node, Scope(fields))

    # -- SELECT --
    def plan_select(
        self, sel: t.Select, outer, ctes, gs_ctx=None
    ) -> RelationPlan:
        expanded = self._expand_group_by(sel.group_by)
        if expanded is not None:
            # always route through the grouping-sets planner (even a single
            # set) so GROUP BY () / ROLLUP() force aggregation semantics
            sets, full = expanded
            return self._plan_grouping_sets(sel, sets, full, outer, ctes)
        ctx = FromPlanner(self, outer, ctes)
        if sel.from_ is not None:
            ctx.add_relation(sel.from_)
        plan, scope = ctx.assemble(sel.where)

        holder = PlanHolder(plan)
        sctx = SelectContext(self, [scope], outer, ctes, holder)

        # apply deferred subquery conjuncts (EXISTS / IN / scalar comparisons)
        for conj in ctx.subquery_conjuncts:
            pred = sctx.translate(conj)
            if pred is not None:
                holder.plan = N.Filter(holder.plan, pred)

        # aggregate extraction over select items, HAVING, ORDER BY handled by
        # the caller via output scope
        items = self._expand_stars(sel.items, scope)
        agg_calls: List[t.FunctionCall] = []
        for item in items:
            _collect_aggregates(item.expr, agg_calls)
        if sel.having is not None:
            _collect_aggregates(sel.having, agg_calls)

        group_exprs: List[ir.RowExpression] = []
        group_names: List[str] = []
        # AST -> (channel, type) of each grouping expression, so select
        # items / HAVING containing the same expression resolve to the
        # grouped channel instead of re-translating (reference: the
        # analyzer's grouping-expression matching in AggregationAnalyzer)
        group_map: Dict[t.Node, Tuple[str, T.Type]] = {}
        if sel.group_by or agg_calls or gs_ctx is not None:
            for g in sel.group_by:
                ast_g = g
                if isinstance(g, t.NumberLiteral) and "." not in g.text:
                    idx = int(g.text)
                    if not 1 <= idx <= len(items):
                        raise PlanningError(
                            f"GROUP BY position {idx} is not in select list "
                            f"(1..{len(items)})"
                        )
                    ast_g = items[idx - 1].expr
                elif (
                    isinstance(g, t.Identifier)
                    and len(g.parts) == 1
                    and scope.resolve(g.parts) is None
                ):
                    # select-list alias (extension over the reference;
                    # ambiguity -> error below via normal resolution)
                    matches = [
                        it
                        for it in items
                        if (it.alias or "").lower() == g.parts[0].lower()
                    ]
                    if len(matches) == 1:
                        ast_g = matches[0].expr
                e = sctx.translate(ast_g)
                if isinstance(e, ir.ColumnRef):
                    ch = e.name
                else:
                    ch = self.channel("gk")
                group_exprs.append(e)
                group_names.append(ch)
                group_map[ast_g] = (ch, e.type)

            aggs, agg_map, agg_order = self._plan_aggregates(agg_calls, sctx)
            if not aggs and not group_exprs:
                # GROUP BY (): exactly one output row regardless of input
                # (the empty grouping set of a ROLLUP). A hidden count(*)
                # drives the global-aggregation machinery; nothing reads it.
                aggs = [
                    AggSpec("count_star", None, self.channel("gcount"), T.BIGINT)
                ]
            if agg_order is not None:
                holder.plan = N.Sort(holder.plan, agg_order)
            holder.plan, distinct_rewritten = self._build_aggregate(
                holder.plan, group_exprs, group_names, aggs
            )
            # post-aggregation scope: group channels + agg channels
            post_fields = []
            for e, ch, g in zip(group_exprs, group_names, sel.group_by):
                typ = e.type
                # keep user name resolvable: if group expr was a column,
                # reuse its field name/qualifier
                fr = _field_for_channel(scope, ch)
                if fr is not None:
                    post_fields.append(FieldRef(fr.qualifier, fr.name, ch, typ))
                else:
                    post_fields.append(FieldRef(None, ch, ch, typ))
            for a in aggs:
                post_fields.append(FieldRef(None, a.name, a.name, a.output_type))
            agg_scope = Scope(post_fields)
            pre_sctx = sctx
            sctx = SelectContext(self, [agg_scope], outer, ctes, holder, agg_map)
            sctx.group_map = group_map
            if gs_ctx is not None:
                cur_set, null_asts, full = gs_ctx
                # grouping-set columns absent from this set read as typed
                # NULLs; grouping() resolves to this set's bitmask
                sctx.group_null_map = {
                    a: pre_sctx.translate(a).type for a in null_asts
                }
                sctx.grouping_ctx = (tuple(full), tuple(cur_set))
            else:
                # plain GROUP BY: grouping() over grouped columns is 0
                plain = tuple(group_map)
                sctx.grouping_ctx = (plain, plain)

        if sel.having is not None:
            pred = sctx.translate(sel.having)
            holder.plan = N.Filter(holder.plan, pred)

        # window functions: computed after WHERE/GROUP BY/HAVING, before the
        # final projection (reference WindowNode placement in LogicalPlanner)
        window_calls: List[t.FunctionCall] = []
        for item in items:
            _collect_windows(item.expr, window_calls)
        if window_calls:
            # windows evaluate AFTER aggregation (reference: WindowNode
            # sits above AggregationNode in LogicalPlanner); over an
            # aggregated query, window inputs resolve through agg_map /
            # group channels of the post-aggregation context
            win_map = self._plan_windows(window_calls, sctx, holder)
            sctx.agg_map.update(win_map)

        # final projection
        out_exprs: List[ir.RowExpression] = []
        out_names: List[str] = []
        out_fields: List[FieldRef] = []
        for i, item in enumerate(items):
            e = sctx.translate(item.expr)
            name = item.alias or _derive_name(item.expr) or f"_col{i}"
            if isinstance(e, ir.ColumnRef):
                ch = e.name
            else:
                ch = self.channel(name)
            out_exprs.append(e)
            out_names.append(ch)
            out_fields.append(FieldRef(None, name, ch, e.type))
        node = N.Project(holder.plan, tuple(out_exprs), tuple(out_names))
        if sel.distinct:
            # SQL: ORDER BY under DISTINCT must use select-list columns
            return RelationPlan(N.Distinct(node), Scope(out_fields))
        return RelationPlan(node, Scope(out_fields), pre_scope=sctx.scopes[0])

    def _expand_stars(self, items, scope: Scope) -> List[t.SelectItem]:
        out = []
        for item in items:
            if isinstance(item, t.Star):
                for f in scope.visible(item.qualifier):
                    out.append(
                        t.SelectItem(t.Identifier((f.qualifier, f.name) if f.qualifier else (f.name,)), f.name)
                    )
            else:
                out.append(item)
        return out

    @staticmethod
    def _translate_frame(frame_spec, order):
        """(type, start, end) strings -> ops.window.Frame. RANGE offsets are
        scaled into the single order key's storage units (reference
        FrameInfo + RANGE frame value coercion)."""
        import decimal as _dec

        from ..ops.window import (
            CURRENT,
            FOLLOWING,
            PRECEDING,
            UNB_FOLLOWING,
            UNB_PRECEDING,
            Frame,
        )

        ftype, fstart, fend = frame_spec

        def key_unit(text: str):
            if ftype == "rows":
                v = int(text)
                if v < 0:
                    raise PlanningError("frame offset must be non-negative")
                return v
            if not order:
                raise PlanningError("RANGE offset frame requires ORDER BY")
            kt = order[0].expr.type
            if isinstance(kt, T.DecimalType):
                return int(_dec.Decimal(text).scaleb(kt.scale))
            if T.is_floating(kt):
                return float(text)
            return int(text)

        def bound(s: str):
            if s == "unbounded preceding":
                return UNB_PRECEDING, 0
            if s == "unbounded following":
                return UNB_FOLLOWING, 0
            if s == "current row":
                return CURRENT, 0
            num, _, kind = s.rpartition(" ")
            return (
                PRECEDING if kind == "preceding" else FOLLOWING,
                key_unit(num),
            )

        sk, so = bound(fstart)
        ek, eo = bound(fend)
        if sk == UNB_FOLLOWING or ek == UNB_PRECEDING:
            raise PlanningError(f"invalid window frame {frame_spec}")
        return Frame(ftype, sk, so, ek, eo)

    def _plan_windows(self, calls, sctx, holder) -> Dict:
        """Group window calls by spec, append one Window node per spec."""
        from ..ops.window import AGGREGATE, OFFSET, RANKING, VALUE, WindowFunc

        win_map: Dict[t.Node, Tuple[str, T.Type]] = {}
        by_spec: Dict[t.WindowSpec, List[t.FunctionCall]] = {}
        for c in calls:
            by_spec.setdefault(c.window, []).append(c)
        for spec, group in by_spec.items():
            part = tuple(sctx.translate(p) for p in spec.partition_by)
            order = tuple(
                SortKey(sctx.translate(si.expr), si.ascending, si.nulls_first)
                for si in spec.order_by
            )
            running_default = bool(spec.order_by)
            frame_obj = None
            if spec.frame is not None:
                frame_obj = self._translate_frame(spec.frame, order)
            funcs = []
            for c in group:
                if c in win_map:
                    continue
                name = c.name
                if c.filter is not None and name not in AGGREGATE:
                    raise PlanningError(
                        f"FILTER is not supported for window function {name!r}"
                    )
                ch = self.channel(name)
                if name in ("row_number", "rank", "dense_rank"):
                    wf = WindowFunc(name, None, ch, T.BIGINT)
                elif name in ("percent_rank", "cume_dist"):
                    wf = WindowFunc(name, None, ch, T.DOUBLE)
                elif name == "ntile":
                    n = c.args[0]
                    if not isinstance(n, t.NumberLiteral):
                        raise PlanningError("ntile requires a literal count")
                    wf = WindowFunc(name, None, ch, T.BIGINT, offset=int(n.text))
                elif name in OFFSET:
                    inp = sctx.translate(c.args[0])
                    off = 1
                    if len(c.args) > 1:
                        if not isinstance(c.args[1], t.NumberLiteral):
                            raise PlanningError(f"{name} offset must be literal")
                        off = int(c.args[1].text)
                    default = None
                    if len(c.args) > 2:
                        default = sctx.translate(c.args[2])
                        if default.type != inp.type:
                            default = ir.cast(default, inp.type)
                    wf = WindowFunc(
                        name, inp, ch, inp.type, offset=off, default=default
                    )
                elif name in VALUE:
                    inp = sctx.translate(c.args[0])
                    off = 1
                    if name == "nth_value":
                        if len(c.args) < 2 or not isinstance(
                            c.args[1], t.NumberLiteral
                        ):
                            raise PlanningError(
                                "nth_value requires a literal position"
                            )
                        off = int(c.args[1].text)
                        if off < 1:
                            raise PlanningError("nth_value position must be >= 1")
                    wf = WindowFunc(
                        name, inp, ch, inp.type, offset=off, frame=frame_obj
                    )
                elif name in AGGREGATE:
                    wfilt = None
                    if c.filter is not None:
                        wfilt = sctx.translate(c.filter)
                        if wfilt is None or wfilt.type != T.BOOLEAN:
                            raise PlanningError(
                                "FILTER (WHERE ...) must be boolean"
                            )
                    if c.is_star:
                        func = "count"
                        out_t = T.BIGINT
                        if wfilt is not None:
                            inp = ir.Call(
                                "if",
                                (wfilt, ir.lit(1), ir.Literal(None, T.BIGINT)),
                                T.BIGINT,
                            )
                        else:
                            inp = None
                    else:
                        inp = sctx.translate(c.args[0])
                        if wfilt is not None:
                            inp = ir.Call(
                                "if",
                                (wfilt, inp, ir.Literal(None, inp.type)),
                                inp.type,
                            )
                        func = "count" if name == "count" else name
                        if (
                            isinstance(inp.type, T.DecimalType)
                            and inp.type.is_long
                            and not (
                                frame_obj is not None
                                and func in ("sum", "avg", "min", "max")
                            )
                        ):
                            # unframed long-decimal windows compute in
                            # double (documented precision trade); FRAMED
                            # sum/avg/min/max stay exact — _frame_agg
                            # carries two-lane sums and the lexicographic
                            # sparse table covers framed min/max
                            inp = ir.cast(inp, T.DOUBLE)
                        out_t = AggSpec.infer_output_type(func, inp.type)
                    wf = WindowFunc(
                        func, inp, ch, out_t, running=running_default,
                        frame=frame_obj,
                    )
                else:
                    raise PlanningError(f"unknown window function {name!r}")
                funcs.append(wf)
                win_map[c] = (ch, wf.output_type)
            holder.plan = N.Window(holder.plan, part, order, tuple(funcs))
        return win_map

    def _plan_aggregates(
        self, agg_calls, sctx
    ) -> Tuple[List[AggSpec], Dict, Optional[tuple]]:
        """Returns (specs, call->channel map, agg-internal ORDER BY keys).
        The ordering is RETURNED, not stashed on the planner: mutable
        planner-wide state would leak stale sort keys into the next
        aggregation whenever a PlanningError fired between set and
        consume (ADVICE round-5)."""
        aggs: List[AggSpec] = []
        agg_map: Dict[t.Node, Tuple[str, T.Type]] = {}
        seen: Dict[t.Node, int] = {}
        agg_order: Optional[tuple] = None
        for call in agg_calls:
            if call in agg_map:
                continue
            fname = call.name
            orig_call = call
            if getattr(call, "order_by", ()) and call.window is None:
                # agg(x ORDER BY k): pre-sort the aggregation input; the
                # grouped machinery's stable group sort preserves the
                # within-group order (reference AggregationNode orderBy +
                # SortedAggregation)
                keys = tuple(
                    SortKey(
                        sctx.translate(si.expr), si.ascending, si.nulls_first
                    )
                    for si in call.order_by
                )
                if agg_order is not None and agg_order != keys:
                    raise PlanningError(
                        "aggregates with DIFFERENT ORDER BY orderings in "
                        "one aggregation are not supported"
                    )
                agg_order = keys
            if fname == "approx_distinct":
                # real HyperLogLog estimate (reference
                # ApproximateCountDistinctAggregations + airlift HLL) with
                # mergeable register partials for the distributed path.
                # The optional second argument (max standard error) is
                # dropped: the engine runs one register width (p=10).
                if not 1 <= len(call.args) <= 2:
                    raise PlanningError(
                        "approx_distinct takes 1 or 2 arguments"
                    )
                call = dataclasses.replace(call, args=call.args[:1])
            if fname in REWRITE_AGG_FUNCS:
                agg_map[call] = self._rewrite_aggregate(call, sctx, aggs)
                continue
            if fname not in AGG_FUNCS:
                raise PlanningError(f"unsupported aggregate {fname!r}")
            # agg(x) FILTER (WHERE p) masks the input to NULL where p is not
            # true (reference: AggregationNode mask channels); NULL inputs
            # never contribute, which is exactly FILTER's semantics.
            filt = None
            if call.filter is not None:
                filt = sctx.translate(call.filter)
                if filt is None or filt.type != T.BOOLEAN:
                    raise PlanningError("FILTER (WHERE ...) must be boolean")
            if call.is_star:
                if filt is not None:
                    inp = ir.Call(
                        "if",
                        (filt, ir.lit(1), ir.Literal(None, T.BIGINT)),
                        T.BIGINT,
                    )
                    spec = AggSpec("count", inp, self.channel("count"), T.BIGINT)
                else:
                    spec = AggSpec(
                        "count_star", None, self.channel("count"), T.BIGINT
                    )
            elif fname == "approx_percentile":
                # computed EXACTLY by selection (the reference's qdigest is
                # an estimate; exact satisfies the contract)
                if len(call.args) != 2:
                    raise PlanningError(
                        "approx_percentile takes (value, percentile); the "
                        "weighted/accuracy forms are not supported"
                    )
                if call.distinct:
                    raise PlanningError(
                        "approx_percentile does not support DISTINCT"
                    )
                import decimal as _dec

                e = sctx.translate(call.args[0])
                p = sctx.translate(call.args[1])
                if (
                    isinstance(p, ir.Call)
                    and p.name == "array_constructor"
                    and all(isinstance(x, ir.Literal) for x in p.args)
                ):
                    # approx_percentile(x, ARRAY[f...]) -> one percentile
                    # aggregate per fraction + an array post-formula
                    # (reference ApproximateLongPercentileArrayAggregations)
                    if filt is not None:
                        e = ir.Call(
                            "if", (filt, e, ir.Literal(None, e.type)),
                            e.type,
                        )
                    refs = []
                    for x in p.args:
                        frac = float(x.value)
                        if not 0.0 <= frac <= 1.0:
                            raise PlanningError(
                                "percentile must be in [0, 1]"
                            )
                        sp = AggSpec(
                            "percentile", e, self.channel(fname), e.type,
                            input2=ir.Literal(frac, T.DOUBLE),
                        )
                        aggs.append(sp)
                        refs.append(ir.ColumnRef(sp.name, sp.output_type))
                    agg_map[orig_call] = ir.Call(
                        "array_constructor",
                        tuple(refs),
                        T.ArrayType(e.type),
                    )
                    continue
                if not isinstance(p, ir.Literal) or not isinstance(
                    p.value, (int, float, _dec.Decimal)
                ):
                    raise PlanningError(
                        "approx_percentile requires a literal percentile"
                    )
                frac = float(p.value)
                if not 0.0 <= frac <= 1.0:
                    raise PlanningError("percentile must be in [0, 1]")
                unsupported = isinstance(
                    e.type,
                    (T.VarcharType, T.BooleanType, T.UnknownType, T.ArrayType),
                )
                if unsupported:
                    raise PlanningError(
                        f"approx_percentile over {e.type} is not supported"
                    )
                if filt is not None:
                    e = ir.Call(
                        "if", (filt, e, ir.Literal(None, e.type)), e.type
                    )
                spec = AggSpec(
                    "percentile", e, self.channel(fname), e.type,
                    input2=ir.Literal(frac, T.DOUBLE),
                )
            elif fname in ("learn_linear_regression", "learn_regressor",
                           "learn_classifier"):
                # presto-ml's learn_regressor(label, features) — model =
                # ARRAY(DOUBLE) weights via mergeable normal equations
                # (ops/mlreg.py); features is an ARRAY(DOUBLE)
                if len(call.args) != 2:
                    raise PlanningError(
                        f"{fname} takes (label, features)"
                    )
                if call.distinct:
                    raise PlanningError(
                        f"{fname} does not support DISTINCT"
                    )
                label = sctx.translate(call.args[0])
                feats = sctx.translate(call.args[1])
                if not isinstance(feats.type, T.ArrayType):
                    raise PlanningError(
                        f"{fname} features must be an array"
                    )
                if filt is not None:
                    label = ir.Call(
                        "if",
                        (filt, label, ir.Literal(None, label.type)),
                        label.type,
                    )
                spec = AggSpec(
                    "linreg", feats, self.channel(fname),
                    T.ArrayType(T.DOUBLE), input2=label,
                )
            elif fname == "map_union":
                if len(call.args) != 1:
                    raise PlanningError("map_union takes 1 argument")
                m = sctx.translate(call.args[0])
                if not isinstance(m.type, T.MapType):
                    raise PlanningError("map_union expects a map argument")
                if filt is not None:
                    m = ir.Call(
                        "if", (filt, m, ir.Literal(None, m.type)), m.type
                    )
                spec = AggSpec(
                    "map_union", m, self.channel(fname), m.type
                )
            elif fname == "multimap_agg":
                if len(call.args) != 2:
                    raise PlanningError("multimap_agg takes 2 arguments")
                k = sctx.translate(call.args[0])
                v = sctx.translate(call.args[1])
                if filt is not None:
                    k = ir.Call(
                        "if", (filt, k, ir.Literal(None, k.type)), k.type
                    )
                spec = AggSpec(
                    "multimap_agg", k, self.channel(fname),
                    T.MapType(k.type, T.ArrayType(v.type)), input2=v,
                )
            elif fname == "numeric_histogram":
                if len(call.args) != 2:
                    raise PlanningError(
                        "numeric_histogram takes (buckets, value)"
                    )
                b = sctx.translate(call.args[0])
                e = sctx.translate(call.args[1])
                if not isinstance(b, ir.Literal):
                    raise PlanningError(
                        "numeric_histogram bucket count must be a literal"
                    )
                if filt is not None:
                    e = ir.Call(
                        "if", (filt, e, ir.Literal(None, e.type)), e.type
                    )
                spec = AggSpec(
                    "num_hist", e, self.channel(fname),
                    T.MapType(T.DOUBLE, T.DOUBLE),
                    input2=ir.Literal(int(b.value), T.BIGINT),
                )
            elif fname == "qdigest_agg":
                e = sctx.translate(call.args[0])
                if filt is not None:
                    e = ir.Call(
                        "if", (filt, e, ir.Literal(None, e.type)), e.type
                    )
                spec = AggSpec(
                    "qsketch", e, self.channel(fname),
                    T.ArrayType(T.BIGINT),
                )
            elif fname == "approx_set":
                e = sctx.translate(call.args[0])
                if filt is not None:
                    e = ir.Call(
                        "if", (filt, e, ir.Literal(None, e.type)), e.type
                    )
                spec = AggSpec(
                    "hll_registers", e, self.channel(fname),
                    T.ArrayType(T.TINYINT, sketch="hll"),
                )
            elif fname == "merge":
                # merge(approx_set sketch) or merge(qdigest sketch):
                # dispatch on the sketch's element type
                e = sctx.translate(call.args[0])
                if not isinstance(e.type, T.ArrayType):
                    raise PlanningError("merge expects a sketch value")
                if filt is not None:
                    e = ir.Call(
                        "if", (filt, e, ir.Literal(None, e.type)), e.type
                    )
                if isinstance(e.type.element, T.TinyintType):
                    spec = AggSpec(
                        "hll_merge", e, self.channel(fname), e.type
                    )
                else:
                    spec = AggSpec(
                        "qsketch_merge", e, self.channel(fname), e.type
                    )
            elif fname == "map_agg":
                if len(call.args) != 2:
                    raise PlanningError("map_agg takes 2 arguments")
                if call.distinct:
                    raise PlanningError("map_agg does not support DISTINCT")
                k = sctx.translate(call.args[0])
                v = sctx.translate(call.args[1])
                if filt is not None:
                    k = ir.Call(
                        "if", (filt, k, ir.Literal(None, k.type)), k.type
                    )
                spec = AggSpec(
                    "map_agg", k, self.channel(fname),
                    T.MapType(k.type, v.type), input2=v,
                )
            elif fname in ("min_by", "max_by"):
                if len(call.args) != 2:
                    raise PlanningError(f"{fname} takes 2 arguments")
                if call.distinct:
                    raise PlanningError(f"{fname} does not support DISTINCT")
                e = sctx.translate(call.args[0])
                k = sctx.translate(call.args[1])
                if filt is not None:
                    # null ordering keys never contribute, so FILTER masks
                    # the key
                    k = ir.Call(
                        "if", (filt, k, ir.Literal(None, k.type)), k.type
                    )
                spec = AggSpec(
                    fname, e, self.channel(fname), e.type, input2=k
                )
            else:
                if len(call.args) == 2 and call.distinct and fname == "count":
                    # count(DISTINCT a, b): dedupe jointly over both
                    # channels (the Distinct-rewrite projects input AND
                    # input2), count tuples with no NULL component
                    e = sctx.translate(call.args[0])
                    e2 = sctx.translate(call.args[1])
                    if filt is not None:
                        e = ir.Call(
                            "if", (filt, e, ir.Literal(None, e.type)), e.type
                        )
                    spec = AggSpec(
                        "distinct_count", e, self.channel(fname), T.BIGINT,
                        input2=e2,
                    )
                    aggs.append(spec)
                    agg_map[orig_call] = (spec.name, spec.output_type)
                    continue
                if len(call.args) != 1:
                    raise PlanningError(
                        f"{fname} takes one argument"
                        + (
                            " (DISTINCT over more than 2 columns not "
                            "supported)" if call.distinct else ""
                        )
                    )
                (arg,) = call.args
                e = sctx.translate(arg)
                if filt is not None:
                    e = ir.Call("if", (filt, e, ir.Literal(None, e.type)), e.type)
                func = "count" if fname == "count" else fname
                out_t = AggSpec.infer_output_type(func, e.type)
                spec = AggSpec(func, e, self.channel(fname), out_t)
                if call.distinct:
                    spec = dataclasses.replace(spec, func=f"distinct_{func}")
            aggs.append(spec)
            agg_map[orig_call] = (spec.name, spec.output_type)
        return aggs, agg_map, agg_order

    def _rewrite_aggregate(self, call, sctx, aggs) -> ir.RowExpression:
        """Plan a derived aggregate as core aggregates + a post-formula
        (the reference compiles each as its own Accumulator,
        operator/aggregation/ — here the sum/count states are first-class
        aggregate columns and the finalizer is ordinary expression code that
        fuses into the post-aggregation projection)."""
        D = T.DOUBLE
        fname = call.name
        filt = None
        if call.filter is not None:
            filt = sctx.translate(call.filter)
            if filt is None or filt.type != T.BOOLEAN:
                raise PlanningError("FILTER (WHERE ...) must be boolean")

        def masked(e):
            if filt is None:
                return e
            return ir.Call("if", (filt, e, ir.Literal(None, e.type)), e.type)

        def emit(func, e, base):
            out_t = AggSpec.infer_output_type(func, None if e is None else e.type)
            sp = AggSpec(func, e, self.channel(base), out_t)
            aggs.append(sp)
            return ir.ColumnRef(sp.name, out_t)

        def c(name, *args, typ=D):
            return ir.Call(name, tuple(args), typ)

        def dlit(x):
            return ir.Literal(float(x), D)

        def null_if_under(n_ref, minimum, value):
            cond = c("gt", n_ref, ir.Literal(minimum - 1, T.BIGINT), typ=T.BOOLEAN)
            return ir.Call("if", (cond, value, ir.Literal(None, D)), D)

        def moments(arg_ast):
            # stable M2 from the central-moments accumulator — the raw
            # power-sum form (ss - s*s/n) cancels catastrophically for
            # large-mean data, same failure class as skewness/kurtosis
            x = masked(ir.cast(sctx.translate(arg_ast), D))
            arr_t = T.ArrayType(D)
            sp = AggSpec("cmoments", x, self.channel("mom"), arr_t)
            aggs.append(sp)
            mom = ir.ColumnRef(sp.name, arr_t)
            n = emit("count", x, "cnt")
            nd = ir.cast(n, D)
            num = ir.Call("element_at", (mom, ir.lit(3)), D)
            return n, nd, num

        if fname in ("stddev", "stddev_samp", "variance", "var_samp"):
            n, nd, num = moments(call.args[0])
            var = c("divide", num, c("subtract", nd, dlit(1.0)))
            out = var if fname in ("variance", "var_samp") else c("sqrt", var)
            return null_if_under(n, 2, out)
        if fname in ("stddev_pop", "var_pop"):
            n, nd, num = moments(call.args[0])
            var = c("divide", num, nd)
            out = var if fname == "var_pop" else c("sqrt", var)
            return null_if_under(n, 1, out)
        if fname in ("skewness", "kurtosis"):
            # stable central moments via the mergeable accumulator
            # (ops/moments.py; reference CentralMomentsAggregation,
            # operator/aggregation/AggregationUtils.java) — the old raw
            # power-sum rewrite catastrophically cancelled for large-mean
            # data (round-4 advisor: (nan, -inf) at mean ~1e9)
            x = masked(ir.cast(sctx.translate(call.args[0]), D))
            arr_t = T.ArrayType(D)
            sp = AggSpec("cmoments", x, self.channel("mom"), arr_t)
            aggs.append(sp)
            mom = ir.ColumnRef(sp.name, arr_t)
            n = emit("count", x, "cnt")
            nd = ir.cast(n, D)

            def elem(i):
                return ir.Call("element_at", (mom, ir.lit(i)), D)

            m2, m3, m4 = elem(3), elem(4), elem(5)
            if fname == "skewness":
                out = c(
                    "divide",
                    c("multiply", c("sqrt", nd), m3),
                    c("power", m2, dlit(1.5)),
                )
                return null_if_under(n, 3, out)
            out = c(
                "subtract",
                c("divide", c("multiply", nd, m4), c("multiply", m2, m2)),
                dlit(3.0),
            )
            return null_if_under(n, 4, out)
        if fname == "count_if":
            p = sctx.translate(call.args[0])
            inp = masked(
                ir.Call("if", (p, ir.lit(1), ir.Literal(None, T.BIGINT)), T.BIGINT)
            )
            return emit("count", inp, "count_if")
        if fname in ("bool_and", "every"):
            return emit("min", masked(sctx.translate(call.args[0])), "bool_and")
        if fname == "bool_or":
            return emit("max", masked(sctx.translate(call.args[0])), "bool_or")
        if fname == "arbitrary":
            return emit("min", masked(sctx.translate(call.args[0])), "arbitrary")
        if fname == "geometric_mean":
            xd = masked(ir.cast(sctx.translate(call.args[0]), D))
            a = emit("avg", c("ln", xd), "geomean")
            return c("exp", a)
        if fname in ("covar_samp", "covar_pop", "corr", "regr_slope",
                     "regr_intercept"):
            # regr_* (reference RealRegrSlopeAggregation family): both
            # args are (y, x) — slope = covar_pop(y,x)/var_pop(x),
            # intercept = avg(y) - slope * avg(x)
            x0 = ir.cast(sctx.translate(call.args[0]), D)
            y0 = ir.cast(sctx.translate(call.args[1]), D)
            both = c(
                "and",
                c("is_not_null", x0, typ=T.BOOLEAN),
                c("is_not_null", y0, typ=T.BOOLEAN),
                typ=T.BOOLEAN,
            )
            x = masked(ir.Call("if", (both, x0, ir.Literal(None, D)), D))
            y = masked(ir.Call("if", (both, y0, ir.Literal(None, D)), D))
            sx = emit("sum", x, "sx")
            sy = emit("sum", y, "sy")
            sxy = emit("sum", c("multiply", x, y), "sxy")
            n = emit("count", x, "cnt")
            nd = ir.cast(n, D)
            cov_num = c("subtract", sxy, c("divide", c("multiply", sx, sy), nd))
            if fname == "covar_pop":
                return null_if_under(n, 1, c("divide", cov_num, nd))
            if fname == "covar_samp":
                return null_if_under(
                    n, 2, c("divide", cov_num, c("subtract", nd, dlit(1.0)))
                )
            if fname in ("regr_slope", "regr_intercept"):
                # args are (y, x): x carries arg0=y, y carries arg1=x here
                sxx2 = emit("sum", c("multiply", y, y), "sxx")
                var_x = c(
                    "subtract", sxx2, c("divide", c("multiply", sy, sy), nd)
                )
                slope = c("divide", cov_num, var_x)
                cond = c("ne", var_x, dlit(0.0), typ=T.BOOLEAN)
                slope = ir.Call("if", (cond, slope, ir.Literal(None, D)), D)
                if fname == "regr_slope":
                    return null_if_under(n, 1, slope)
                mean_y = c("divide", sx, nd)
                mean_x = c("divide", sy, nd)
                out = c("subtract", mean_y, c("multiply", slope, mean_x))
                return null_if_under(n, 1, out)
            sxx = emit("sum", c("multiply", x, x), "sxx")
            syy = emit("sum", c("multiply", y, y), "syy")
            vx = c(
                "greatest",
                c("subtract", sxx, c("divide", c("multiply", sx, sx), nd)),
                dlit(0.0),
            )
            vy = c(
                "greatest",
                c("subtract", syy, c("divide", c("multiply", sy, sy), nd)),
                dlit(0.0),
            )
            denom = c("sqrt", c("multiply", vx, vy))
            corr = c("divide", cov_num, denom)
            cond = c("gt", denom, dlit(0.0), typ=T.BOOLEAN)
            return null_if_under(
                n, 2, ir.Call("if", (cond, corr, ir.Literal(None, D)), D)
            )
        raise PlanningError(f"unsupported aggregate {fname!r}")

    def _build_aggregate(self, child, group_exprs, group_names, aggs):
        """Build the Aggregate node, rewriting distinct aggregates as
        aggregation over Distinct (reference
        SingleDistinctAggregationToGroupBy)."""
        distinct_specs = [a for a in aggs if a.func.startswith("distinct_")]
        if not distinct_specs:
            return (
                N.Aggregate(child, tuple(group_exprs), tuple(group_names), tuple(aggs)),
                False,
            )
        if len({(a.input, a.input2) for a in distinct_specs}) > 1:
            # the dedupe below is joint over all distinct arguments; with
            # different arguments it would overcount — refuse loudly
            raise PlanningError(
                "multiple DISTINCT aggregates with different arguments "
                "are not supported"
            )
        if len(distinct_specs) != len(aggs):
            return self._build_mixed_distinct_aggregate(
                child, group_exprs, group_names, aggs, distinct_specs
            )
        # project group keys + distinct args, dedupe, then aggregate plainly
        proj_exprs = list(group_exprs)
        proj_names = list(group_names)
        inner_names = []
        pair_names = {}
        for a in distinct_specs:
            ch = self.channel("darg")
            proj_exprs.append(a.input)
            proj_names.append(ch)
            inner_names.append(ch)
            if a.input2 is not None:
                # multi-column DISTINCT: the second channel joins the
                # dedupe key (count(DISTINCT a, b) = distinct tuples)
                ch2 = self.channel("darg")
                proj_exprs.append(a.input2)
                proj_names.append(ch2)
                pair_names[ch] = (ch2, a.input2.type)
        pre = N.Distinct(N.Project(child, tuple(proj_exprs), tuple(proj_names)))
        new_groups = tuple(
            ir.ColumnRef(n, e.type) for n, e in zip(group_names, group_exprs)
        )

        def final_input(a, ch):
            inp = ir.ColumnRef(ch, a.input.type)
            if ch in pair_names:
                ch2, t2 = pair_names[ch]
                # SQL count over multiple args: tuples with ANY null
                # component do not count
                guard = ir.Call(
                    "and",
                    (
                        ir.Call("is_not_null", (inp,), T.BOOLEAN),
                        ir.Call(
                            "is_not_null",
                            (ir.ColumnRef(ch2, t2),),
                            T.BOOLEAN,
                        ),
                    ),
                    T.BOOLEAN,
                )
                return ir.Call(
                    "if", (guard, inp, ir.Literal(None, inp.type)),
                    inp.type,
                )
            return inp

        new_aggs = tuple(
            dataclasses.replace(
                a,
                func=a.func.replace("distinct_", ""),
                input=final_input(a, ch),
                input2=None,
            )
            for a, ch in zip(distinct_specs, inner_names)
        )
        return (
            N.Aggregate(pre, new_groups, tuple(group_names), new_aggs),
            True,
        )

    def _build_mixed_distinct_aggregate(
        self, child, group_exprs, group_names, aggs, distinct_specs
    ):
        """Mixed plain + DISTINCT aggregates: pre-aggregate grouped by
        (group keys, distinct argument) with decomposable partials, then
        finalize grouped by the group keys alone. Stage-2 counting of the
        distinct-argument channel IS the distinct count (reference:
        OptimizeMixedDistinctAggregations)."""
        plain_specs = [a for a in aggs if not a.func.startswith("distinct_")]
        mergeable = {"sum", "count", "count_star", "min", "max", "avg"}
        if any(a.func not in mergeable for a in plain_specs):
            raise PlanningError(
                "mixing DISTINCT with non-decomposable aggregates "
                "(checksum/min_by/...) is not supported"
            )
        darg = distinct_specs[0].input
        dch = self.channel("darg")
        # avg decomposes into (sum, count) partials merged by sum, divided
        # in a final projection — decimal divide rounds HALF_UP at the
        # output scale, identical to the engine's avg finalization
        s1_aggs: List[AggSpec] = []
        parts: Dict[str, tuple] = {}  # plain name -> partial spec(s)
        for a in plain_specs:
            if a.func == "avg":
                sum_t = AggSpec.infer_output_type("sum", a.input.type)
                s = AggSpec("sum", a.input, self.channel("part_sum"), sum_t)
                c = AggSpec("count", a.input, self.channel("part_cnt"), T.BIGINT)
                s1_aggs.extend((s, c))
                parts[a.name] = ("avg", s, c)
            else:
                p = AggSpec(
                    a.func, a.input, self.channel(f"part_{a.func}"),
                    a.output_type,
                )
                s1_aggs.append(p)
                parts[a.name] = ("simple", p)
        stage1 = N.Aggregate(
            child,
            tuple(group_exprs) + (darg,),
            tuple(group_names) + (dch,),
            tuple(s1_aggs),
        )
        s2_groups = tuple(
            ir.ColumnRef(n, e.type) for n, e in zip(group_names, group_exprs)
        )
        merge_func = {
            "sum": "sum", "count": "sum", "count_star": "sum",
            "min": "min", "max": "max",
        }
        s2_aggs = []
        for a in plain_specs:
            kind = parts[a.name]
            if kind[0] == "avg":
                _, s, c = kind
                s2_aggs.append(
                    AggSpec(
                        "sum", ir.ColumnRef(s.name, s.output_type),
                        s.name, s.output_type,
                    )
                )
                s2_aggs.append(
                    AggSpec(
                        "sum", ir.ColumnRef(c.name, T.BIGINT),
                        c.name, T.BIGINT,
                    )
                )
            else:
                p = kind[1]
                s2_aggs.append(
                    AggSpec(
                        merge_func[a.func],
                        ir.ColumnRef(p.name, p.output_type),
                        a.name,
                        a.output_type,
                    )
                )
        for a in distinct_specs:
            s2_aggs.append(
                dataclasses.replace(
                    a,
                    func=a.func.replace("distinct_", ""),
                    input=ir.ColumnRef(dch, darg.type),
                )
            )
        node = N.Aggregate(
            stage1, s2_groups, tuple(group_names), tuple(s2_aggs)
        )
        # final projection: original output order; avg = sum/count; empty
        # global input leaves merged counts NULL where SQL answers 0
        count_names = {
            a.name for a in plain_specs if a.func in ("count", "count_star")
        }
        avg_names = {a.name for a in plain_specs if a.func == "avg"}
        if count_names or avg_names:
            exprs, names = [], []
            for nm, e in zip(group_names, group_exprs):
                exprs.append(ir.ColumnRef(nm, e.type))
                names.append(nm)
            for a in aggs:
                if a.name in avg_names:
                    _, s, c = parts[a.name]
                    exprs.append(
                        ir.Call(
                            "divide",
                            (
                                ir.ColumnRef(s.name, s.output_type),
                                ir.ColumnRef(c.name, T.BIGINT),
                            ),
                            a.output_type,
                        )
                    )
                elif a.name in count_names:
                    ref = ir.ColumnRef(a.name, a.output_type)
                    exprs.append(
                        ir.Call(
                            "coalesce",
                            (ref, ir.Literal(0, a.output_type)),
                            a.output_type,
                        )
                    )
                else:
                    exprs.append(ir.ColumnRef(a.name, a.output_type))
                names.append(a.name)
            node = N.Project(node, tuple(exprs), tuple(names))
        return node, True


def _field_for_channel(scope: Scope, channel: str) -> Optional[FieldRef]:
    for f in scope.fields:
        if f.channel == channel:
            return f
    return None


def _derive_name(expr: t.Node) -> Optional[str]:
    if isinstance(expr, t.Identifier):
        return expr.name
    if isinstance(expr, t.FunctionCall):
        return expr.name
    return None


def _collect_windows(expr: t.Node, out: List[t.FunctionCall]):
    """Find window function calls (FunctionCall with an OVER clause)."""
    if isinstance(expr, t.FunctionCall) and expr.window is not None:
        out.append(expr)
        return
    if isinstance(expr, (t.ScalarSubquery, t.InSubquery, t.Exists)):
        return
    for f in dataclasses.fields(expr):
        v = getattr(expr, f.name)
        if isinstance(v, t.Node):
            _collect_windows(v, out)
        elif isinstance(v, tuple):
            for x in v:
                if isinstance(x, t.Node):
                    _collect_windows(x, out)


def _contains_subquery_pred(expr: t.Node) -> bool:
    """True if expr contains an EXISTS / IN-subquery predicate (these can only
    be planned as top-level WHERE conjuncts — they mutate the plan with a
    SemiJoin). Does not descend into nested subqueries' own bodies."""
    if isinstance(expr, (t.Exists, t.InSubquery)):
        return True
    if isinstance(expr, t.ScalarSubquery):
        return False
    for f in dataclasses.fields(expr):
        v = getattr(expr, f.name)
        if isinstance(v, t.Node) and _contains_subquery_pred(v):
            return True
        if isinstance(v, tuple):
            for x in v:
                if isinstance(x, t.Node) and _contains_subquery_pred(x):
                    return True
                if isinstance(x, tuple):  # e.g. Case.whens: ((cond, val), ...)
                    for y in x:
                        if isinstance(y, t.Node) and _contains_subquery_pred(y):
                            return True
    return False


def _collect_grouping_calls(expr: t.Node, out: List[t.FunctionCall]):
    """Find grouping(...) calls (grouping-sets level indicators)."""
    if isinstance(expr, t.FunctionCall) and expr.name == "grouping":
        out.append(expr)
        return
    if isinstance(expr, (t.ScalarSubquery, t.InSubquery, t.Exists)):
        return
    for f in dataclasses.fields(expr):
        v = getattr(expr, f.name)
        if isinstance(v, t.Node):
            _collect_grouping_calls(v, out)
        elif isinstance(v, tuple):
            for x in v:
                if isinstance(x, t.Node):
                    _collect_grouping_calls(x, out)


def _ast_replace(node: t.Node, mapping: Dict[t.Node, t.Node]) -> t.Node:
    """Structurally replace subtrees (equality-keyed) in a frozen AST; does
    not descend into nested subqueries."""
    if node in mapping:
        return mapping[node]
    if isinstance(node, (t.ScalarSubquery, t.InSubquery, t.Exists)):
        return node
    if not dataclasses.is_dataclass(node):
        return node
    changes = {}
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, t.Node):
            nv = _ast_replace(v, mapping)
            if nv is not v:
                changes[f.name] = nv
        elif isinstance(v, tuple):
            nv = _tuple_replace(v, mapping)
            if nv != v:
                changes[f.name] = nv
    return dataclasses.replace(node, **changes) if changes else node


def _tuple_replace(v: tuple, mapping) -> tuple:
    out = []
    for x in v:
        if isinstance(x, t.Node):
            out.append(_ast_replace(x, mapping))
        elif isinstance(x, tuple):
            out.append(_tuple_replace(x, mapping))
        else:
            out.append(x)
    return tuple(out)


def _collect_aggregates(expr: t.Node, out: List[t.FunctionCall]):
    """Find aggregate function calls (not descending into subqueries)."""
    if isinstance(expr, t.FunctionCall):
        if (
            expr.name in AGG_FUNCS or expr.name in REWRITE_AGG_FUNCS
        ) and expr.window is None:
            out.append(expr)
            return  # aggregates cannot nest
    if isinstance(expr, (t.ScalarSubquery, t.InSubquery, t.Exists)):
        return
    for f in dataclasses.fields(expr):
        v = getattr(expr, f.name)
        if isinstance(v, t.Node):
            _collect_aggregates(v, out)
        elif isinstance(v, tuple):
            for x in v:
                if isinstance(x, t.Node):
                    _collect_aggregates(x, out)
                elif isinstance(x, tuple):
                    for y in x:
                        if isinstance(y, t.Node):
                            _collect_aggregates(y, out)


def collect_channels(e: ir.RowExpression, out: set):
    if isinstance(e, ir.ColumnRef):
        out.add(e.name)
    elif isinstance(e, ir.Call):
        for a in e.args:
            collect_channels(a, out)


def _contains_subquery(expr: t.Node) -> bool:
    if isinstance(expr, (t.ScalarSubquery, t.InSubquery, t.Exists)):
        return True
    for f in dataclasses.fields(expr):
        v = getattr(expr, f.name)
        if isinstance(v, t.Node) and not isinstance(v, (t.Query,)):
            if _contains_subquery(v):
                return True
        elif isinstance(v, tuple):
            for x in v:
                if isinstance(x, t.Node) and not isinstance(x, t.Query):
                    if _contains_subquery(x):
                        return True
                elif isinstance(x, tuple):
                    for y in x:
                        if (
                            isinstance(y, t.Node)
                            and not isinstance(y, t.Query)
                            and _contains_subquery(y)
                        ):
                            return True
    return False


def split_conjuncts(expr: Optional[t.Node]) -> List[t.Node]:
    if expr is None:
        return []
    if isinstance(expr, t.LogicalOp) and expr.op == "and":
        out = []
        for x in expr.terms:
            out.extend(split_conjuncts(x))
        return out
    return [expr]


def extract_common_or_conjuncts(conjuncts: List[t.Node]) -> List[t.Node]:
    """Factor conjuncts common to every OR disjunct up to the top level
    (reference ExtractCommonPredicatesExpressionRewriter): Q19's
    `(p=l and A...) or (p=l and B...)` exposes the p=l join key."""
    out: List[t.Node] = []
    for c in conjuncts:
        if isinstance(c, t.LogicalOp) and c.op == "or":
            dis = [split_conjuncts(d) for d in c.terms]
            common = [x for x in dis[0] if all(x in d for d in dis[1:])]
            if common:
                out.extend(common)
                rest_terms = []
                degenerate = False
                for d in dis:
                    rem = [x for x in d if x not in common]
                    if not rem:
                        degenerate = True
                        break
                    rest_terms.append(
                        rem[0] if len(rem) == 1 else t.LogicalOp("and", tuple(rem))
                    )
                if not degenerate:
                    out.append(t.LogicalOp("or", tuple(rest_terms)))
                continue
        out.append(c)
    return out


# ---------------------------------------------------------------------------
# FROM clause: relation pool + join graph assembly
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PoolItem:
    plan: RelationPlan
    channels: set
    estimate: float
    stats: object = None  # plan.stats.PlanStats


class FromPlanner:
    """Flattens the FROM clause into a relation pool + join edges, classifies
    WHERE conjuncts, and assembles a cost-based greedy join order: the next
    relation is the one whose join with the current tree has the smallest
    ESTIMATED OUTPUT (reference ReorderJoins + JoinStatsRule), with the
    smaller estimated side as the build side. Estimates come from the
    stats framework (plan/stats.py: connector NDV/min/max/null-fraction
    derived through filters)."""

    def __init__(self, planner: Planner, outer, ctes):
        self.p = planner
        self.outer = outer
        self.ctes = ctes
        self.pool: List[PoolItem] = []
        self.subquery_conjuncts: List[t.Node] = []
        self._pending_on: List[t.Node] = []
        self.unnests: List[t.Unnest] = []

    def add_relation(self, rel: t.Node):
        if isinstance(rel, t.Unnest):
            # lateral: applies to the joined FROM result (assemble())
            self.unnests.append(rel)
            return
        if isinstance(rel, t.Join) and rel.kind in ("cross", "inner"):
            self.add_relation(rel.left)
            self.add_relation(rel.right)
            if rel.condition is not None:
                self._pending_on.extend(split_conjuncts(rel.condition))
            if rel.using:
                raise PlanningError("USING joins not yet supported")
            return
        if isinstance(rel, t.Join):
            item = self._plan_outer_join(rel)
            self.pool.append(item)
            return
        rp = self.p.plan_relation(rel, self.outer, self.ctes)
        st = self._stats(rp.node)
        self.pool.append(
            PoolItem(
                rp, {f.channel for f in rp.scope.fields}, st.rows, st
            )
        )

    def _plan_join_side(self, rel) -> RelationPlan:
        """One side of an outer join may itself be a join tree (e.g.
        `a join b on .. left outer join c on ..` associates the whole
        inner-join chain as the outer join's left side): plan inner/cross
        chains through a nested FromPlanner (keeping the greedy join
        order), and nested outer joins recursively."""
        if isinstance(rel, t.Join) and rel.kind in ("cross", "inner"):
            sub = FromPlanner(self.p, self.outer, self.ctes)
            sub.add_relation(rel)
            node, scope = sub.assemble(None)
            # assemble() is what classifies ON conjuncts: only AFTER it can
            # we see subquery conjuncts, which nothing would consume here
            if sub.subquery_conjuncts or sub.unnests:
                raise PlanningError(
                    "subqueries/UNNEST inside a joined ON-side not supported"
                )
            return RelationPlan(node, scope)
        if isinstance(rel, t.Join):
            return self._plan_outer_join(rel).plan
        return self.p.plan_relation(rel, self.outer, self.ctes)

    def _plan_outer_join(self, rel: t.Join) -> PoolItem:
        kind = rel.kind
        if kind == "right":
            rel = t.Join("left", rel.right, rel.left, rel.condition, rel.using)
            kind = "left"
        left = self._plan_join_side(rel.left)
        right = self._plan_join_side(rel.right)
        combined = Scope(left.scope.fields + right.scope.fields)
        ctx = SelectContext(self.p, [combined], self.outer, self.ctes, None)
        left_chs = {f.channel for f in left.scope.fields}
        right_chs = {f.channel for f in right.scope.fields}
        lkeys, rkeys, residual = [], [], []
        rfilters = []
        for conj in split_conjuncts(rel.condition):
            e = ctx.translate(conj)
            refs: set = set()
            collect_channels(e, refs)
            if (
                isinstance(e, ir.Call)
                and e.name == "eq"
                and refs & left_chs
                and refs & right_chs
            ):
                a, b = e.args
                ra: set = set()
                collect_channels(a, ra)
                rb: set = set()
                collect_channels(b, rb)
                if ra <= left_chs and rb <= right_chs:
                    lkeys.append(a)
                    rkeys.append(b)
                    continue
                if rb <= left_chs and ra <= right_chs:
                    lkeys.append(b)
                    rkeys.append(a)
                    continue
            if kind == "left" and refs <= right_chs:
                rfilters.append(e)  # safe to push below a left join
            else:
                # full-outer: one-sided ON filters stay residual (pushing
                # them below would drop the side's unmatched rows)
                residual.append(e)
        rnode = right.node
        if rfilters:
            rnode = N.Filter(rnode, ir.and_(*rfilters) if len(rfilters) > 1 else rfilters[0])
        if not lkeys:
            raise PlanningError("outer join requires at least one equi condition")
        res = None
        if residual:
            res = ir.and_(*residual) if len(residual) > 1 else residual[0]
        unique = _build_side_unique(rnode, rkeys, self.p.catalog)
        node = N.Join(
            kind, left.node, rnode, tuple(lkeys), tuple(rkeys), res, unique
        )
        rp = RelationPlan(node, combined)
        st = self._stats(node)
        return PoolItem(rp, left_chs | right_chs, st.rows, st)

    def _stats(self, node: N.PlanNode):
        from ..plan.stats import derive

        return derive(node, self.p.catalog)

    def assemble(self, where: Optional[t.Node]) -> Tuple[N.PlanNode, Scope]:
        if not self.pool:
            # FROM-less SELECT (reference: Query without QuerySpecification
            # relation plans over a values row) and UNNEST of constants
            # both expand over a one-row base
            leaf = N.SingleRow(self.p.channel("singlerow"))
            self.pool.append(
                PoolItem(
                    RelationPlan(leaf, Scope([])), set(), 1.0
                )
            )

        combined = Scope([f for it in self.pool for f in it.plan.scope.fields])
        combined_chs = {f.channel for f in combined.fields}
        ctx = SelectContext(self.p, [combined], self.outer, self.ctes, None)

        # plan UNNEST relations against the joined FROM scope; their
        # output fields join the visible scope, and conjuncts referencing
        # them apply after the expansion
        unnest_specs = []  # (array_exprs, elem_channels, ord_channel)
        unnest_chs: set = set()
        unnest_fields: List[FieldRef] = []
        for un in self.unnests:
            exprs = tuple(ctx.translate(a) for a in un.exprs)
            for e in exprs:
                if not isinstance(e.type, T.ArrayType):
                    raise PlanningError(
                        f"UNNEST argument must be an array, got {e.type}"
                    )
            n_cols = len(exprs) + (1 if un.ordinality else 0)
            if un.column_aliases and len(un.column_aliases) != n_cols:
                raise PlanningError(
                    f"UNNEST alias has {len(un.column_aliases)} columns, "
                    f"expected {n_cols}"
                )
            names = list(un.column_aliases) or [
                f"_unnest{i}" for i in range(n_cols)
            ]
            chans = tuple(self.p.channel(nm) for nm in names[: len(exprs)])
            ord_ch = None
            if un.ordinality:
                ord_ch = self.p.channel(names[-1])
            unnest_specs.append((exprs, chans, ord_ch))
            alias = un.alias
            for nm, ch, e in zip(names, chans, exprs):
                unnest_fields.append(
                    FieldRef(alias, nm, ch, e.type.element)
                )
                unnest_chs.add(ch)
            if ord_ch is not None:
                unnest_fields.append(
                    FieldRef(alias, names[-1], ord_ch, T.BIGINT)
                )
                unnest_chs.add(ord_ch)
        post_unnest_filters: List[ir.RowExpression] = []
        if unnest_fields:
            combined = Scope(list(combined.fields) + unnest_fields)
            combined_chs = combined_chs | unnest_chs
            ctx = SelectContext(self.p, [combined], self.outer, self.ctes, None)

        conjuncts = extract_common_or_conjuncts(
            self._pending_on + split_conjuncts(where)
        )
        edges: List[Tuple[int, int, ir.RowExpression, ir.RowExpression]] = []
        residuals: List[Tuple[set, ir.RowExpression]] = []
        for conj in conjuncts:
            if _contains_subquery(conj):
                self.subquery_conjuncts.append(conj)
                continue
            e = ctx.translate(conj)
            refs: set = set()
            collect_channels(e, refs)
            outer_chs = refs - combined_chs
            if outer_chs:
                # correlated conjunct: record on the enclosing subquery
                # collector and keep it OUT of the local plan
                self._record_correlation(e, refs, combined_chs)
                continue
            if refs & unnest_chs:
                post_unnest_filters.append(e)
                continue
            owners = {
                i for i, it in enumerate(self.pool) if refs & it.channels
            }
            if len(owners) == 1:
                (i,) = owners
                it = self.pool[i]
                it.plan = RelationPlan(
                    N.Filter(it.plan.node, e), it.plan.scope
                )
                it.stats = self._stats(it.plan.node)
                it.estimate = it.stats.rows
                continue
            if len(owners) == 2 and isinstance(e, ir.Call) and e.name == "eq":
                a, b = e.args
                ra: set = set()
                collect_channels(a, ra)
                rb: set = set()
                collect_channels(b, rb)
                ia = {i for i, it in enumerate(self.pool) if ra & it.channels}
                ib = {i for i, it in enumerate(self.pool) if rb & it.channels}
                if len(ia) == 1 and len(ib) == 1 and ia != ib:
                    edges.append((next(iter(ia)), next(iter(ib)), a, b))
                    continue
            residuals.append((owners, e))

        def finish(plan: N.PlanNode) -> Tuple[N.PlanNode, Scope]:
            for exprs, chans, ord_ch in unnest_specs:
                plan = N.Unnest(plan, exprs, chans, ord_ch)
            for e in post_unnest_filters:
                plan = N.Filter(plan, e)
            return plan, combined

        # greedy assembly with COSTED ALTERNATIVES: build a complete greedy
        # order from each of the two smallest-estimate start relations,
        # cost each full order as the sum of estimated intermediate rows
        # (the dominant exchange+build volume on TPU), keep the cheaper —
        # the reference compares alternative join orders with
        # CostComparator inside ReorderJoins (sql/planner/iterative/rule/
        # ReorderJoins.java); two greedy seeds is the bounded analog.
        n_items = len(self.pool)
        if n_items == 1:
            plan = self.pool[0].plan.node
            for owners, e in residuals:
                plan = N.Filter(plan, e)
            return finish(plan)

        from ..plan.stats import join_output_rows

        def build_order(start: int) -> Tuple[N.PlanNode, float]:
            remaining = set(range(n_items))
            joined = {start}
            remaining.discard(start)
            plan = self.pool[start].plan.node
            cur_stats = self.pool[start].stats
            applied_res: set = set()
            cost = 0.0

            def edge_keys(nxt: int):
                """(tree-side, candidate-side) key expression lists."""
                lkeys, rkeys = [], []
                for (i, j, a, b) in edges:
                    if i in joined and j == nxt:
                        lkeys.append(a)
                        rkeys.append(b)
                    elif j in joined and i == nxt:
                        lkeys.append(b)
                        rkeys.append(a)
                return lkeys, rkeys

            while remaining:
                # candidates connected by an edge; pick the one whose join
                # with the current tree has the smallest estimated OUTPUT
                # (reference ReorderJoins cost comparison)
                cand = set()
                for (i, j, _, _) in edges:
                    if i in joined and j in remaining:
                        cand.add(j)
                    if j in joined and i in remaining:
                        cand.add(i)

                def join_est(c: int) -> float:
                    lk, rk = edge_keys(c)
                    return join_output_rows(
                        cur_stats, self.pool[c].stats, lk, rk, "inner"
                    )

                if cand:
                    nxt = min(
                        cand,
                        key=lambda i: (join_est(i), self.pool[i].estimate),
                    )
                else:
                    nxt = min(remaining, key=lambda i: self.pool[i].estimate)
                lkeys, rkeys = edge_keys(nxt)
                rnode = self.pool[nxt].plan.node
                # build side = smaller estimated side (reference: CBO flips
                # the join so the hash build is the cheaper input), except
                # keep a UNIQUE build side — the n:1 fast path beats a
                # smaller build
                tree_rows = cur_stats.rows if cur_stats else 1e9
                cand_rows = self.pool[nxt].estimate
                unique_r = _build_side_unique(rnode, rkeys, self.p.catalog)
                if not unique_r and cand_rows > tree_rows and lkeys:
                    unique_l = _build_side_unique(plan, lkeys, self.p.catalog)
                    plan = N.Join(
                        "inner",
                        rnode,
                        plan,
                        tuple(rkeys),
                        tuple(lkeys),
                        None,
                        unique_l,
                    )
                else:
                    plan = N.Join(
                        "inner",
                        plan,
                        rnode,
                        tuple(lkeys),
                        tuple(rkeys),
                        None,
                        unique_r,
                    )
                joined.add(nxt)
                remaining.discard(nxt)
                cur_stats = self._stats(plan)
                cost += cur_stats.rows if cur_stats else 0.0
                # apply residuals that became fully available
                for k, (owners, e) in enumerate(residuals):
                    if k in applied_res:
                        continue
                    if owners <= joined:
                        plan = N.Filter(plan, e)
                        applied_res.add(k)
            for k, (owners, e) in enumerate(residuals):
                if k not in applied_res:
                    plan = N.Filter(plan, e)
            return plan, cost

        by_size = sorted(range(n_items), key=lambda i: self.pool[i].estimate)
        starts = by_size[: (2 if n_items > 2 else 1)]
        best_plan: Optional[N.PlanNode] = None
        best_cost = float("inf")
        for s in starts:
            cand_plan, cand_cost = build_order(s)
            if cand_cost < best_cost:
                best_plan, best_cost = cand_plan, cand_cost
        return finish(best_plan)

    def _record_correlation(self, e: ir.RowExpression, refs: set, inner_chs: set):
        """Route a conjunct referencing outer channels to the enclosing
        CorrelationCollector: equality pairs become decorrelation keys,
        anything else a residual (used by EXISTS semi-joins)."""
        coll = self.outer
        if not isinstance(coll, CorrelationCollector):
            raise PlanningError(
                "correlated reference not supported in this context"
            )
        if isinstance(e, ir.Call) and e.name == "eq":
            a, b = e.args
            ra: set = set()
            collect_channels(a, ra)
            rb: set = set()
            collect_channels(b, rb)
            if ra <= inner_chs and not (rb & inner_chs) and isinstance(a, ir.ColumnRef):
                coll.pairs.append((a, b))
                return
            if rb <= inner_chs and not (ra & inner_chs) and isinstance(b, ir.ColumnRef):
                coll.pairs.append((b, a))
                return
        coll.residuals.append(e)


def _selectivity(e: ir.RowExpression) -> float:
    if isinstance(e, ir.Call):
        if e.name == "eq":
            return 0.05
        if e.name in ("lt", "le", "gt", "ge", "between"):
            return 0.35
        if e.name == "like":
            return 0.1
        if e.name == "in":
            return 0.2
        if e.name == "and":
            s = 1.0
            for a in e.args:
                s *= _selectivity(a)
            return s
    return 0.5


def _scan_under_filters(node: N.PlanNode) -> Optional[N.TableScan]:
    while isinstance(node, N.Filter):
        node = node.child
    return node if isinstance(node, N.TableScan) else None


def _build_side_unique(node: N.PlanNode, keys, catalog: Catalog) -> bool:
    """True if the join keys form a unique key of the build side."""
    scan = _scan_under_filters(node)
    if scan is None:
        if isinstance(node, N.Aggregate):
            # grouped output is unique on its group channels
            key_chs = {k.name for k in keys if isinstance(k, ir.ColumnRef)}
            return set(node.group_names) <= key_chs and len(keys) == len(
                node.group_names
            )
        return False
    cols = []
    for k in keys:
        if not isinstance(k, ir.ColumnRef):
            return False
        for ch, src, _ in scan.columns:
            if ch == k.name:
                cols.append(src)
                break
    key_set = set(cols)
    for uniq in catalog.unique_columns(scan.table):
        if set(uniq) <= key_set:
            return True
    return False


# ---------------------------------------------------------------------------
# expression translation
# ---------------------------------------------------------------------------


class PlanHolder:
    def __init__(self, plan: N.PlanNode):
        self.plan = plan


class SelectContext:
    """Translates AST expressions to RowExpressions against a scope chain.
    Mutates `holder.plan` when subqueries require joins/applies. Records
    outer-scope references for correlation detection."""

    def __init__(
        self,
        planner: Planner,
        scopes: List[Scope],
        outer: Optional["SelectContext"],
        ctes,
        holder: Optional[PlanHolder],
        agg_map: Optional[Dict] = None,
    ):
        self.p = planner
        self.scopes = scopes
        self.outer = outer
        self.ctes = ctes
        self.holder = holder
        self.agg_map = agg_map or {}
        self.outer_refs: List[ir.ColumnRef] = []

    # -- scope chain resolution --
    def resolve(self, parts) -> Tuple[FieldRef, bool]:
        for s in self.scopes:
            f = s.resolve(parts)
            if f is not None:
                return f, False
        if self.outer is not None:
            f, _ = self.outer.resolve(parts)
            return f, True
        raise PlanningError(f"cannot resolve column {'.'.join(parts)!r}")

    def translate(self, ast: t.Node) -> ir.RowExpression:
        # EXISTS/IN predicates plan as SemiJoins and are only legal when the
        # whole translated expression is one WHERE/HAVING conjunct: the root
        # node itself, or directly under a root-level NOT.
        self._conjunct_root = ast
        e = self._tr(ast)
        return e

    def _tr(self, ast: t.Node) -> ir.RowExpression:
        if ast in self.agg_map:
            v = self.agg_map[ast]
            if isinstance(v, ir.RowExpression):
                return v  # composite rewrite (stddev & co) over agg channels
            ch, typ = v
            return ir.ColumnRef(ch, typ)
        gnm = getattr(self, "group_null_map", None)
        if gnm is not None:
            ty = gnm.get(ast)
            if ty is not None:  # column not in this grouping set
                return ir.Literal(None, ty)
        gm = getattr(self, "group_map", None)
        if gm is not None and not isinstance(ast, t.Identifier):
            hit = gm.get(ast)
            if hit is not None:
                ch, typ = hit
                return ir.ColumnRef(ch, typ)
        if isinstance(ast, t.Identifier):
            f, is_outer = self.resolve(ast.parts)
            ref = ir.ColumnRef(f.channel, f.type)
            if is_outer:
                self.outer_refs.append(ref)
            return ref
        if isinstance(ast, t.BoundParameter):
            # EXECUTE parameter bound as a typed constant; tag the literal
            # with its index so plan skeletons rebind (exec/qcache.py). A
            # parameter planning to anything but a plain literal is left
            # untagged — the skeleton coverage check then disqualifies it.
            inner = self._tr(ast.inner)
            if isinstance(inner, ir.Literal) and inner.param is None:
                import dataclasses as _dc

                return _dc.replace(inner, param=ast.index)
            return inner
        if isinstance(ast, t.NumberLiteral):
            return _number_literal(ast.text)
        if isinstance(ast, t.StringLiteral):
            return ir.Literal(ast.value, T.VARCHAR)
        if isinstance(ast, t.BooleanLiteral):
            return ir.Literal(ast.value, T.BOOLEAN)
        if isinstance(ast, t.NullLiteral):
            return ir.Literal(None, T.UNKNOWN)
        if isinstance(ast, t.DateLiteral):
            return ir.Literal(ast.value, T.DATE)
        if isinstance(ast, t.TimestampLiteral):
            return ir.Literal(
                _parse_timestamp_literal(ast.value), T.TIMESTAMP
            )
        if isinstance(ast, t.IntervalLiteral):
            n = int(ast.value) * (-1 if ast.negative else 1)
            if ast.unit in ("year", "month"):
                months = n * (12 if ast.unit == "year" else 1)
                return ir.Literal(months, T.INTERVAL_YEAR_MONTH)
            if ast.unit == "day":
                return ir.Literal(n, T.INTERVAL_DAY)
            raise PlanningError(f"interval unit {ast.unit} not supported")
        if isinstance(ast, t.UnaryOp):
            v = self._tr(ast.operand)
            if ast.op == "-":
                if isinstance(v, ir.Literal) and isinstance(
                    v.value, (int, float)
                ) and v.param is None:
                    # fold so literal-argument functions see -n as a
                    # literal (param-tagged literals stay symbolic: the
                    # fold would detach the value from its rebind tag)
                    return ir.Literal(-v.value, v.type)
                return ir.Call("negate", (v,), v.type)
            return v
        if isinstance(ast, t.BinaryOp):
            if isinstance(ast.right, t.ScalarSubquery):
                right = self._scalar_subquery(ast.right)
            else:
                right = self._tr(ast.right)
            if isinstance(ast.left, t.ScalarSubquery):
                left = self._scalar_subquery(ast.left)
            else:
                left = self._tr(ast.left)
            fn = _BINOP_FN[ast.op]
            if ast.op in _CMP_OPS:
                return ir.Call(fn, (left, right), T.BOOLEAN)
            if ast.op == "||" and (
                isinstance(left.type, T.ArrayType)
                or isinstance(right.type, T.ArrayType)
            ):
                # ARRAY || ARRAY, elem || ARRAY, ARRAY || elem (reference
                # ArrayConcatFunction + the || operator on arrays)
                def as_array(e):
                    if isinstance(e.type, T.ArrayType):
                        return e
                    return ir.Call(
                        "array_constructor", (e,), T.ArrayType(e.type)
                    )

                la, ra = as_array(left), as_array(right)
                et = T.common_super_type(
                    la.type.element, ra.type.element
                )
                return ir.Call(
                    "array_concat", (la, ra), T.ArrayType(et)
                )
            return ir.Call(
                fn, (left, right), _infer(fn, (left.type, right.type))
            )
        if isinstance(ast, t.LogicalOp):
            # EXISTS/IN translate by mutating the plan with a SemiJoin and
            # returning None — only valid as top-level WHERE conjuncts.
            # Under OR, a direct EXISTS/IN term instead plans a MARK
            # semi-join (no filtering; a boolean membership column replaces
            # the predicate — reference semiJoinOutput). NOT IN stays
            # unsupported there: its NULL semantics differ from NOT mark.
            if ast.op == "or" and any(
                _contains_subquery_pred(x) for x in ast.terms
            ):
                marked = []
                for x in ast.terms:
                    if isinstance(x, t.Exists):
                        marked.append(self._subquery_mark(x, negate=False))
                    elif isinstance(x, t.InSubquery) and not getattr(
                        x, "negated", False
                    ):
                        marked.append(self._subquery_mark(x, negate=False))
                    elif isinstance(x, t.NotOp) and isinstance(
                        x.operand, t.Exists
                    ):
                        marked.append(
                            self._subquery_mark(x.operand, negate=True)
                        )
                    elif _contains_subquery_pred(x):
                        raise PlanningError(
                            "subquery under OR is only supported as a "
                            "direct EXISTS / IN / NOT EXISTS term"
                        )
                    else:
                        marked.append(self._tr(x))
                return ir.Call("or", tuple(marked), T.BOOLEAN)
            terms = tuple(self._tr(x) for x in ast.terms)
            if any(x is None for x in terms):
                raise PlanningError(
                    "EXISTS/IN subquery in this position is not supported"
                )
            return ir.Call(ast.op, terms, T.BOOLEAN)
        if isinstance(ast, t.NotOp):
            if isinstance(ast.operand, t.Exists):
                return self._exists(ast.operand, negate=True)
            if isinstance(ast.operand, t.InSubquery):
                return self._in_subquery(ast.operand, negate=True)
            if _contains_subquery_pred(ast.operand):
                raise PlanningError(
                    "EXISTS/IN subquery under NOT is only supported directly "
                    "(NOT EXISTS / NOT IN)"
                )
            return ir.not_(self._tr(ast.operand))
        if isinstance(ast, t.IsNull):
            inner = self._tr(ast.operand)
            e = ir.is_null(inner)
            return ir.not_(e) if ast.negated else e
        if isinstance(ast, t.Between):
            e = ir.between(self._tr(ast.value), self._tr(ast.low), self._tr(ast.high))
            return ir.not_(e) if ast.negated else e
        if isinstance(ast, t.InList):
            v = self._tr(ast.value)
            opts = tuple(self._tr(o) for o in ast.options)
            e = ir.Call("in", (v,) + opts, T.BOOLEAN)
            return ir.not_(e) if ast.negated else e
        if isinstance(ast, t.Like):
            v = self._tr(ast.value)
            pat = self._tr(ast.pattern)
            args = (v, pat)
            if ast.escape is not None:
                args = args + (self._tr(ast.escape),)
            e = ir.Call("like", args, T.BOOLEAN)
            return ir.not_(e) if ast.negated else e
        if isinstance(ast, t.Case):
            return self._case(ast)
        if isinstance(ast, t.Cast):
            v = self._tr(ast.operand)
            to = T.parse_type(ast.type_name)
            if ast.try_cast and to != v.type:
                # NULL instead of error on conversion failure — its own
                # special form so the kernel knows to map bad entries to
                # NULL rather than raise (compiler._cast_varchar_entries)
                return ir.Call("try_cast", (v,), to)
            return ir.cast(v, to)
        if isinstance(ast, t.Extract):
            v = self._tr(ast.operand)
            fields = (
                "year", "month", "day", "quarter", "hour", "minute",
                "second", "week", "day_of_week", "dow", "day_of_year",
                "doy", "year_of_week", "yow",
            )
            if ast.field not in fields:
                raise PlanningError(f"extract({ast.field}) not supported")
            return ir.Call(ast.field, (v,), T.BIGINT)
        if isinstance(ast, t.ArrayLiteral):
            if not ast.items:
                raise PlanningError("empty ARRAY[] requires a typed context")
            items = [self._tr(x) for x in ast.items]
            ct = items[0].type
            for x in items[1:]:
                ct = T.common_super_type(ct, x.type)
            items = [
                x if x.type == ct else ir.cast(x, ct) for x in items
            ]
            return ir.Call(
                "array_constructor", tuple(items), T.ArrayType(ct)
            )
        if isinstance(ast, t.FunctionCall):
            return self._function(ast)
        if isinstance(ast, t.ScalarSubquery):
            return self._scalar_subquery(ast)
        if isinstance(ast, t.Exists):
            return self._exists(ast, negate=False)
        if isinstance(ast, t.InSubquery):
            return self._in_subquery(ast, negate=ast.negated)
        raise PlanningError(f"unsupported expression {type(ast).__name__}")

    def _case(self, ast: t.Case) -> ir.RowExpression:
        whens = []
        for cond, val in ast.whens:
            if ast.operand is not None:
                c = ir.Call(
                    "eq", (self._tr(ast.operand), self._tr(cond)), T.BOOLEAN
                )
            else:
                c = self._tr(cond)
            whens.append((c, self._tr(val)))
        else_ = self._tr(ast.else_) if ast.else_ is not None else ir.Literal(None, T.UNKNOWN)
        out_t = else_.type
        for _, v in whens:
            out_t = T.common_super_type(out_t, v.type)
        args = []
        for c, v in whens:
            args += [c, v]
        args.append(else_)
        return ir.Call("case", tuple(args), out_t)

    def _translate_lambda(self, lam: t.LambdaExpr, param_types) -> ir.Lambda:
        """Bind lambda params as synthetic channels visible to the body
        (reference: LambdaExpression scoping in ExpressionAnalyzer)."""
        if len(lam.params) != len(param_types):
            raise PlanningError(
                f"lambda takes {len(lam.params)} parameters, "
                f"{len(param_types)} expected"
            )
        chans = tuple(self.p.channel(p) for p in lam.params)
        fields = [
            FieldRef(None, p, ch, ty)
            for p, ch, ty in zip(lam.params, chans, param_types)
        ]
        inner = SelectContext(
            self.p, [Scope(fields)] + list(self.scopes), self.outer,
            self.ctes, self.holder,
        )
        body = inner._tr(lam.body)
        return ir.Lambda(chans, body, tuple(param_types))

    def _lambda_function(self, ast: t.FunctionCall) -> ir.RowExpression:
        """Higher-order functions over arrays (reference
        operator/scalar/ArrayTransformFunction.java & friends)."""
        name = ast.name

        def elem(e: ir.RowExpression) -> T.Type:
            if not isinstance(e.type, T.ArrayType):
                raise PlanningError(f"{name} expects an array argument")
            return e.type.element

        if name in ("transform", "filter", "any_match", "all_match",
                    "none_match"):
            if len(ast.args) != 2 or not isinstance(ast.args[1], t.LambdaExpr):
                raise PlanningError(f"{name}(array, lambda) expected")
            arr = self._tr(ast.args[0])
            lam = self._translate_lambda(ast.args[1], (elem(arr),))
            if name == "transform":
                out = T.ArrayType(lam.body.type)
            elif name == "filter":
                out = arr.type
            else:
                out = T.BOOLEAN
            return ir.Call(name, (arr, lam), out)
        if name in ("map_filter", "transform_values", "transform_keys"):
            # map higher-order functions (reference MapFilterFunction,
            # MapTransformValuesFunction, MapTransformKeysFunction)
            if len(ast.args) != 2 or not isinstance(ast.args[1], t.LambdaExpr):
                raise PlanningError(f"{name}(map, (k, v) -> ...) expected")
            m = self._tr(ast.args[0])
            if not isinstance(m.type, T.MapType):
                raise PlanningError(f"{name} expects a map argument")
            lam = self._translate_lambda(
                ast.args[1], (m.type.key, m.type.value)
            )
            if name == "map_filter":
                if not isinstance(lam.body.type, T.BooleanType):
                    raise PlanningError(
                        "map_filter lambda must return boolean"
                    )
                out = m.type
            elif name == "transform_values":
                out = T.MapType(m.type.key, lam.body.type)
            else:
                out = T.MapType(lam.body.type, m.type.value)
            return ir.Call(name, (m, lam), out)
        if name == "zip_with":
            if len(ast.args) != 3 or not isinstance(ast.args[2], t.LambdaExpr):
                raise PlanningError("zip_with(array, array, lambda) expected")
            a = self._tr(ast.args[0])
            b = self._tr(ast.args[1])
            lam = self._translate_lambda(ast.args[2], (elem(a), elem(b)))
            return ir.Call(
                "zip_with", (a, b, lam), T.ArrayType(lam.body.type)
            )
        if name == "map_zip_with":
            # reference MapZipWithFunction: (K,V1), (K,V2), (K,V1,V2)->V3
            if len(ast.args) != 3 or not isinstance(ast.args[2], t.LambdaExpr):
                raise PlanningError(
                    "map_zip_with(map, map, (k, v1, v2) -> ...) expected"
                )
            a = self._tr(ast.args[0])
            b = self._tr(ast.args[1])
            if not isinstance(a.type, T.MapType) or not isinstance(
                b.type, T.MapType
            ):
                raise PlanningError("map_zip_with expects two map arguments")
            if a.type.key != b.type.key:
                raise PlanningError(
                    "map_zip_with maps must share the key type"
                )
            lam = self._translate_lambda(
                ast.args[2], (a.type.key, a.type.value, b.type.value)
            )
            return ir.Call(
                "map_zip_with",
                (a, b, lam),
                T.MapType(a.type.key, lam.body.type),
            )
        if name == "reduce":
            if len(ast.args) != 4 or not all(
                isinstance(a, t.LambdaExpr) for a in ast.args[2:]
            ):
                raise PlanningError(
                    "reduce(array, initialState, inputFn, outputFn) expected"
                )
            arr = self._tr(ast.args[0])
            init = self._tr(ast.args[1])
            input_fn = self._translate_lambda(
                ast.args[2], (init.type, elem(arr))
            )
            output_fn = self._translate_lambda(
                ast.args[3], (input_fn.body.type,)
            )
            return ir.Call(
                "reduce", (arr, init, input_fn, output_fn),
                output_fn.body.type,
            )
        raise PlanningError(f"unsupported higher-order function {name}")

    def _function(self, ast: t.FunctionCall) -> ir.RowExpression:
        name = ast.name
        if name == "concat" and len(ast.args) >= 2:
            args = [self._tr(a) for a in ast.args]
            if any(isinstance(a.type, T.ArrayType) for a in args):
                # variadic array concat folds left (ArrayConcatFunction)
                out = args[0]
                if not isinstance(out.type, T.ArrayType):
                    out = ir.Call(
                        "array_constructor", (out,), T.ArrayType(out.type)
                    )
                for nxt in args[1:]:
                    if not isinstance(nxt.type, T.ArrayType):
                        nxt = ir.Call(
                            "array_constructor", (nxt,),
                            T.ArrayType(nxt.type),
                        )
                    et = T.common_super_type(
                        out.type.element, nxt.type.element
                    )
                    out = ir.Call(
                        "array_concat", (out, nxt), T.ArrayType(et)
                    )
                return out
        if name == "try":
            # reference TryFunction: NULL instead of an error. Device
            # kernels never raise data-dependent errors (XLA semantics:
            # 1/0, overflow etc. produce values, not exceptions), so the
            # only TRY-visible failures are cast failures — route
            # try(cast(..)) onto try_cast; everything else passes through
            if len(ast.args) != 1:
                raise PlanningError("try() takes exactly one argument")
            arg = ast.args[0]
            if isinstance(arg, t.Cast):
                arg = dataclasses.replace(arg, try_cast=True)
            return self._tr(arg)
        if name in AGG_FUNCS or name in REWRITE_AGG_FUNCS:
            raise PlanningError(
                f"aggregate {name} in invalid context (window functions later)"
            )
        if name == "grouping":
            # bitmask of which arguments are aggregated away in this
            # grouping set (reference GroupingOperationFunction); plain
            # GROUP BY: every argument is grouped -> 0
            gctx = getattr(self, "grouping_ctx", None)
            n_args = len(ast.args)
            if gctx is None:
                raise PlanningError(
                    "grouping() is only allowed in the SELECT/HAVING of "
                    "an aggregation query"
                )
            full, cur = gctx
            value = 0
            for i, arg in enumerate(ast.args):
                if arg not in full:
                    raise PlanningError(
                        "grouping() arguments must be grouping columns"
                    )
                if arg not in cur:
                    value |= 1 << (n_args - 1 - i)
            return ir.Literal(value, T.BIGINT)
        if name in LAMBDA_FUNCS or any(
            isinstance(a, t.LambdaExpr) for a in ast.args
        ):
            return self._lambda_function(ast)
        args = tuple(self._tr(a) for a in ast.args)
        if name == "ceiling":
            name = "ceil"
        # special forms handled by the expression compiler, not the
        # registry (compiler.py SPECIAL_FORMS: coalesce/nullif/if)
        if name in ("coalesce", "if", "nullif"):
            return self._special_form(name, args)
        if name in ("e", "pi", "infinity", "nan") and not args:
            val = {
                "e": 2.718281828459045,
                "pi": 3.141592653589793,
                "infinity": float("inf"),
                "nan": float("nan"),
            }[name]
            return ir.Literal(val, T.DOUBLE)
        if name == "typeof" and len(args) == 1:
            return ir.Literal(str(args[0].type), T.VARCHAR)
        if name not in FUNCTIONS:
            raise PlanningError(f"unknown function {name!r}")
        return ir.Call(name, args, _infer(name, tuple(a.type for a in args)))

    def _special_form(self, name: str, args) -> ir.RowExpression:
        if name == "coalesce":
            if not args:
                raise PlanningError("coalesce requires arguments")
            out_t = args[0].type
            for a in args[1:]:
                out_t = T.common_super_type(out_t, a.type)
            coerced = tuple(
                a if a.type == out_t else ir.cast(a, out_t) for a in args
            )
            return ir.Call("coalesce", coerced, out_t)
        if name == "nullif":
            if len(args) != 2:
                raise PlanningError("nullif requires 2 arguments")
            return ir.Call("nullif", args, args[0].type)
        # if(cond, a [, b])
        if len(args) == 2:
            args = args + (ir.Literal(None, args[1].type),)
        if len(args) != 3:
            raise PlanningError("if requires 2 or 3 arguments")
        cond, a, b = args
        out_t = T.common_super_type(a.type, b.type)
        a = a if a.type == out_t else ir.cast(a, out_t)
        b = b if b.type == out_t else ir.cast(b, out_t)
        return ir.Call("if", (cond, a, b), out_t)

    # -- subqueries --
    def _plan_sub(self, q: t.Query):
        sub_planner_ctx = SelectContext(self.p, self.scopes, self.outer, self.ctes, None)
        rp = self.p.plan_query(q, sub_planner_ctx, self.ctes)
        return rp, sub_planner_ctx

    def _require_holder(self):
        if self.holder is None:
            raise PlanningError("subquery not allowed in this context")

    def _scalar_subquery(self, ast: t.ScalarSubquery) -> ir.RowExpression:
        self._require_holder()
        sub = SubqueryPlanner(self.p, self, self.ctes)
        return sub.plan_scalar(ast.query, self.holder)

    def _require_conjunct_position(self, ast: t.Node):
        """EXISTS/IN mutate the plan (SemiJoin) and return None — legal only
        when the expression being translated IS this predicate (optionally
        under a root-level NOT). Anywhere deeper (CASE, function args, ...)
        the None would corrupt the expression tree."""
        root = getattr(self, "_conjunct_root", None)
        if ast is root:
            return
        if isinstance(root, t.NotOp) and ast is root.operand:
            return
        raise PlanningError(
            "EXISTS/IN subquery is only supported as a top-level "
            "WHERE/HAVING conjunct"
        )

    def _exists(self, ast: t.Exists, negate: bool) -> Optional[ir.RowExpression]:
        self._require_holder()
        self._require_conjunct_position(ast)
        sub = SubqueryPlanner(self.p, self, self.ctes)
        sub.plan_exists(ast.query, self.holder, anti=negate)
        return None  # applied as a SemiJoin on the holder

    def _in_subquery(self, ast: t.InSubquery, negate: bool) -> Optional[ir.RowExpression]:
        self._require_holder()
        self._require_conjunct_position(ast)
        value = self._tr(ast.value)
        sub = SubqueryPlanner(self.p, self, self.ctes)
        sub.plan_in(ast.query, value, self.holder, anti=negate)
        return None

    def _subquery_mark(self, ast, negate: bool) -> ir.RowExpression:
        """Plan EXISTS / IN as a MARK semi-join and return the boolean
        membership column (usable inside OR, unlike the filtering form).
        EXISTS is two-valued, so NOT of the mark is exact."""
        self._require_holder()
        mark = self.p.channel("mark")
        sub = SubqueryPlanner(self.p, self, self.ctes)
        if isinstance(ast, t.Exists):
            sub.plan_exists(ast.query, self.holder, anti=False, mark=mark)
        else:
            value = self._tr(ast.value)
            sub.plan_in(ast.query, value, self.holder, anti=False, mark=mark)
        ref = ir.ColumnRef(mark, T.BOOLEAN)
        return ir.not_(ref) if negate else ref

    def translate_conjunct_or_apply(self, conj) -> Optional[ir.RowExpression]:
        return self.translate(conj)


_TS_FORMATS = (
    "%Y-%m-%d %H:%M:%S.%f",
    "%Y-%m-%d %H:%M:%S",
    "%Y-%m-%d %H:%M",  # Presto-legal no-seconds shape
    "%Y-%m-%d",
)


def _parse_timestamp_literal(value: str) -> int:
    """TIMESTAMP 'literal' -> epoch micros. Accepts every Presto-legal
    datetime shape (with/without seconds or fraction, date-only) plus a
    trailing numeric zone offset (+HH:MM / -HHMM / Z / UTC — normalized
    to UTC micros). Exhaustion raises a PlanningError instead of leaking
    a raw strptime ValueError; named zones are rejected explicitly."""
    import datetime as _dt
    import re as _re

    txt = value.strip()
    off_us = 0
    m = _re.search(r"\s*(Z|UTC|[+-]\d{2}:?\d{2})$", txt)
    if m:
        z = m.group(1)
        if z not in ("Z", "UTC"):
            sign = 1 if z[0] == "+" else -1
            hh, mm = int(z[1:3]), int(z[-2:])
            off_us = sign * (hh * 3600 + mm * 60) * 1_000_000
        txt = txt[: m.start()].strip()
    elif _re.search(r"[ ]\d{1,2}:\d{2}.*[ ][A-Za-z][\w/+_-]*$", txt):
        raise PlanningError(
            f"invalid timestamp literal {value!r}: named time zones are "
            "not supported (use a numeric offset like +05:30)"
        )
    epoch = _dt.datetime(1970, 1, 1)
    for fmt in _TS_FORMATS:
        try:
            dt = _dt.datetime.strptime(txt, fmt)
        except ValueError:
            continue
        return int((dt - epoch).total_seconds() * 1_000_000) - off_us
    raise PlanningError(f"invalid timestamp literal {value!r}")


def _number_literal(text: str) -> ir.Literal:
    if "e" in text.lower():
        return ir.Literal(float(text), T.DOUBLE)
    if "." in text:
        whole, frac = text.split(".")
        scale = len(frac)
        digits = len(whole.lstrip("-")) + scale
        if digits > 15:
            # beyond double's exact-integer range: carry the literal as
            # an exact Decimal and type it long (two-lane storage)
            import decimal as _dec

            return ir.Literal(
                _dec.Decimal(text), T.DecimalType(max(digits, 19), scale)
            )
        return ir.Literal(float(text), T.DecimalType(18, scale))
    return ir.Literal(int(text), T.BIGINT)


def _infer(fn: str, arg_types) -> T.Type:
    from ..expr.functions import infer_call_type

    return infer_call_type(fn, tuple(arg_types))


# ---------------------------------------------------------------------------
# subquery planning / decorrelation
# ---------------------------------------------------------------------------


class SubqueryPlanner:
    """Plans subqueries appearing in expressions, decorrelating the
    canonical TPC-H patterns (see module docstring)."""

    def __init__(self, planner: Planner, parent_ctx: SelectContext, ctes):
        self.p = planner
        self.parent = parent_ctx
        self.ctes = ctes

    def _plan_with_correlation(self, q: t.Query):
        """Plan `q` with the parent select as outer scope. Returns
        (RelationPlan, correlations) where correlations are
        (inner ColumnRef, outer RowExpression) equality pairs removed from
        the subquery plan, plus residual correlated predicates."""
        outer_ctx = self.parent
        collector = CorrelationCollector(outer_ctx)
        rp = self.p.plan_query(q, collector, self.ctes)
        return rp, collector

    def plan_scalar(self, q: t.Query, holder: PlanHolder) -> ir.RowExpression:
        rp, corr = self._plan_with_correlation(q)
        if len(rp.node.fields) != 1:
            raise PlanningError("scalar subquery must return one column")
        if corr.residuals:
            raise PlanningError(
                "correlated scalar subquery with non-equality correlation"
            )
        if not corr.pairs:
            holder.plan = N.ScalarApply(holder.plan, rp.node)
            (name, typ) = rp.node.fields[0]
            return ir.ColumnRef(name, typ)
        # correlated scalar aggregate -> group by correlation keys + left join
        node = rp.node
        out_name, out_type = node.fields[0]
        node, group_refs = _regroup_for_correlation(node, corr.pairs)
        holder.plan = N.Join(
            "left",
            holder.plan,
            node,
            tuple(outer for (_inner, outer) in corr.pairs),
            tuple(group_refs),
            None,
            True,
        )
        return ir.ColumnRef(out_name, out_type)

    def plan_exists(self, q: t.Query, holder: PlanHolder, anti: bool,
                    mark: Optional[str] = None):
        rp, corr = self._plan_with_correlation(q)
        if not corr.pairs:
            raise PlanningError("uncorrelated EXISTS not yet supported")
        residual = None
        if corr.residuals:
            residual = (
                ir.and_(*corr.residuals)
                if len(corr.residuals) > 1
                else corr.residuals[0]
            )
        # the EXISTS select list is irrelevant; the source plan must expose
        # the correlation-key channels (and residual's inner channels), which
        # the subquery's final Project may have dropped — e.g.
        # `exists (select 1 from ...)`
        needed = {inner.name for (inner, _o) in corr.pairs}
        if residual is not None:
            res_chs: set = set()
            collect_channels(residual, res_chs)
            # residuals mix probe- and source-side channels; only the ones
            # not provided by the probe plan must come from the source
            needed |= res_chs - set(holder.plan.field_names())
        source = _ensure_channels(rp.node, needed)
        holder.plan = N.SemiJoin(
            holder.plan,
            source,
            tuple(outer for (_inner, outer) in corr.pairs),
            tuple(inner for (inner, _outer) in corr.pairs),
            anti=anti,
            residual=residual,
            mark=mark,
        )

    def plan_in(self, q: t.Query, value: ir.RowExpression, holder: PlanHolder,
                anti: bool, mark: Optional[str] = None):
        rp, corr = self._plan_with_correlation(q)
        if corr.pairs or corr.residuals:
            raise PlanningError("correlated IN subquery not yet supported")
        if len(rp.node.fields) != 1:
            raise PlanningError("IN subquery must return one column")
        (name, typ) = rp.node.fields[0]
        holder.plan = N.SemiJoin(
            holder.plan,
            rp.node,
            (value,),
            (ir.ColumnRef(name, typ),),
            anti=anti,
            mark=mark,
        )


def _ensure_channels(node: N.PlanNode, needed: set) -> N.PlanNode:
    """Make sure `needed` channels appear in the node's output, widening a
    top Project (under optional Distinct/Limit wrappers) that dropped them.
    The EXISTS rewrite only cares about existence, so for a bare Project we
    can equivalently use its child."""
    missing = needed - set(node.field_names())
    if not missing:
        return node
    if isinstance(node, N.Project):
        child_have = set(node.child.field_names())
        if missing <= child_have:
            extra = tuple(
                ir.ColumnRef(ch, node.child.field_type(ch)) for ch in sorted(missing)
            )
            return N.Project(
                node.child,
                node.exprs + extra,
                node.names + tuple(sorted(missing)),
            )
        return _ensure_channels(node.child, needed)
    if isinstance(node, (N.Distinct, N.Limit)):
        # existence is unchanged by dedup/limit's column set; recurse
        inner = _ensure_channels(node.children[0], needed)
        return inner
    raise PlanningError(
        f"EXISTS subquery does not expose correlation columns {sorted(missing)}"
    )


def _regroup_for_correlation(node: N.PlanNode, pairs):
    """Rewrite a global-aggregate subquery plan into a grouped one over the
    correlation keys (reference
    TransformCorrelatedScalarAggregationToJoin.java). `pairs` items are
    (inner ColumnRef, outer expr); inner refs must be available below the
    Aggregate."""
    proj = None
    ag = node
    if isinstance(ag, N.Project):
        proj, ag = ag, ag.child
    if not isinstance(ag, N.Aggregate) or ag.group_exprs:
        raise PlanningError(
            "correlated scalar subquery must be a single aggregate"
        )
    group_refs = tuple(inner for (inner, _outer) in pairs)
    group_names = tuple(r.name for r in group_refs)
    new_ag = N.Aggregate(ag.child, group_refs, group_names, ag.aggs)
    if proj is not None:
        new_node: N.PlanNode = N.Project(
            new_ag,
            proj.exprs + group_refs,
            proj.names + group_names,
        )
    else:
        new_node = new_ag
    return new_node, group_refs


class CorrelationCollector(SelectContext):
    """Acts as the 'outer context' for a subquery plan: resolves outer
    columns through the true parent and records correlation predicates.

    The subquery's FromPlanner classifies each WHERE conjunct; conjuncts
    referencing outer channels surface here via resolve(). The planner's
    conjunct classification calls back into `note_correlated` through
    translate when a conjunct mixes scopes.
    """

    def __init__(self, parent: SelectContext):
        super().__init__(
            parent.p, parent.scopes, parent.outer, parent.ctes, None
        )
        self.pairs: List[Tuple[ir.ColumnRef, ir.RowExpression]] = []
        self.residuals: List[ir.RowExpression] = []
