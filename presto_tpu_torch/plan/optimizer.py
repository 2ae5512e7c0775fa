"""Plan optimizations that run after logical planning.

The planner (sql/planner.py) already folds in pushdown and join ordering;
passes here are cross-cutting rewrites over the finished tree:

* prune_columns — the reference's PruneUnreferencedOutputs +
  PruneTableScanColumns (sql/planner/iterative/rule/): drop every channel a
  parent never reads. On TPU this directly cuts HBM traffic and transfer
  volume, the dominant cost.
"""

from __future__ import annotations

import dataclasses
from typing import Set, Tuple

from ..expr import ir
from ..ops.aggregate import AggSpec
from . import nodes as N


def _expr_channels(e, out: Set[str]):
    if isinstance(e, ir.ColumnRef):
        out.add(e.name)
    elif isinstance(e, ir.Call):
        for a in e.args:
            _expr_channels(a, out)


def prune_columns(node: N.PlanNode, needed: Set[str]) -> N.PlanNode:
    """Rewrite `node` so it outputs (at least) `needed` channels, recursively
    dropping everything else."""
    if isinstance(node, N.TableScan):
        cols = tuple(c for c in node.columns if c[0] in needed)
        if not cols:  # keep one column: count(*)-only scans still need rows
            cols = node.columns[:1]
        return dataclasses.replace(node, columns=cols)

    if isinstance(node, N.SingleRow):
        return node

    if isinstance(node, N.Sample):
        return dataclasses.replace(
            node, child=prune_columns(node.child, needed)
        )

    if isinstance(node, N.Unnest):
        child_have = node.child.field_names()
        replicate = tuple(n for n in child_have if n in needed)
        child_needed = set(replicate)
        for e in node.array_exprs:
            _expr_channels(e, child_needed)
        return dataclasses.replace(
            node, child=prune_columns(node.child, child_needed), replicate=replicate
        )

    if isinstance(node, N.Filter):
        child_needed = set(needed)
        _expr_channels(node.predicate, child_needed)
        return N.Filter(prune_columns(node.child, child_needed), node.predicate)

    if isinstance(node, N.Project):
        keep = [
            (e, n) for e, n in zip(node.exprs, node.names) if n in needed
        ]
        if not keep:
            keep = [(node.exprs[0], node.names[0])]
        child_needed: Set[str] = set()
        for e, _ in keep:
            _expr_channels(e, child_needed)
        child = prune_columns(node.child, child_needed)
        return N.Project(
            child, tuple(e for e, _ in keep), tuple(n for _, n in keep)
        )

    if isinstance(node, N.Aggregate):
        keep_aggs = tuple(a for a in node.aggs if a.name in needed)
        if not keep_aggs and not node.group_exprs:
            # a global aggregate must keep one accumulator to emit its one
            # row (the GROUP BY () part of a ROLLUP with no aggregates)
            keep_aggs = node.aggs[:1]
        child_needed: Set[str] = set()
        for e in node.group_exprs:
            _expr_channels(e, child_needed)
        for a in keep_aggs:
            if a.input is not None:
                _expr_channels(a.input, child_needed)
            if a.input2 is not None:
                _expr_channels(a.input2, child_needed)
        if node.mask is not None:
            _expr_channels(node.mask, child_needed)
        child = prune_columns(node.child, child_needed)
        return N.Aggregate(
            child, node.group_exprs, node.group_names, keep_aggs, node.mask
        )

    if isinstance(node, N.Join):
        left_have = set(node.left.field_names())
        right_have = set(node.right.field_names())
        left_needed = needed & left_have
        right_needed = needed & right_have
        for e in node.left_keys:
            _expr_channels(e, left_needed)
        for e in node.right_keys:
            _expr_channels(e, right_needed)
        if node.residual is not None:
            res: Set[str] = set()
            _expr_channels(node.residual, res)
            left_needed |= res & left_have
            right_needed |= res & right_have
        return dataclasses.replace(
            node,
            left=prune_columns(node.left, left_needed),
            right=prune_columns(node.right, right_needed),
        )

    if isinstance(node, N.SemiJoin):
        child_have = set(node.child.field_names())
        source_have = set(node.source.field_names())
        child_needed = needed & child_have
        source_needed: Set[str] = set()
        for e in node.probe_keys:
            _expr_channels(e, child_needed)
        for e in node.source_keys:
            _expr_channels(e, source_needed)
        if node.residual is not None:
            res = set()
            _expr_channels(node.residual, res)
            child_needed |= res & child_have
            source_needed |= res & source_have
        return dataclasses.replace(
            node,
            child=prune_columns(node.child, child_needed),
            source=prune_columns(node.source, source_needed),
        )

    if isinstance(node, N.ScalarApply):
        sub_have = set(node.subquery.field_names())
        child_needed = needed - sub_have
        return dataclasses.replace(
            node,
            child=prune_columns(node.child, child_needed),
            subquery=node.subquery,
        )

    if isinstance(node, N.Window):
        child_needed = {n for n in needed if n in set(node.child.field_names())}
        for e in node.partition_exprs:
            _expr_channels(e, child_needed)
        for k in node.order_keys:
            _expr_channels(k.expr, child_needed)
        for f in node.funcs:
            if f.input is not None:
                _expr_channels(f.input, child_needed)
        return dataclasses.replace(
            node, child=prune_columns(node.child, child_needed)
        )

    if isinstance(node, (N.Sort, N.TopN)):
        child_needed = set(needed)
        for k in node.keys:
            _expr_channels(k.expr, child_needed)
        return dataclasses.replace(
            node, child=prune_columns(node.child, child_needed)
        )

    if isinstance(node, N.Limit):
        return dataclasses.replace(
            node, child=prune_columns(node.child, set(needed))
        )

    if isinstance(node, N.Distinct):
        # DISTINCT semantics depend on the full column set — never prune
        # through it, only below via its child's own needs
        return dataclasses.replace(
            node,
            child=prune_columns(node.child, set(node.child.field_names())),
        )

    if isinstance(node, N.Union):
        # channel names are aligned across inputs by the planner
        return dataclasses.replace(
            node,
            inputs=tuple(prune_columns(c, set(needed)) for c in node.inputs),
        )

    if isinstance(node, N.Output):
        child = prune_columns(node.child, set(node.channels))
        return dataclasses.replace(node, child=child)

    raise TypeError(f"prune_columns: unhandled node {type(node).__name__}")


def fuse_filter_into_aggregates(node: N.PlanNode) -> N.PlanNode:
    """Aggregate(Filter(x, p)) -> Aggregate(x, mask=p).

    TPU-first rewrite: a standalone filter materializes a compacted page
    (sort + gathers); aggregation consumes a selection MASK for free inside
    its fused reduction kernels. The reference's analog is
    ScanFilterAndProjectOperator fusing the filter into the page processor."""
    replace = {}
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, N.PlanNode):
            nv = fuse_filter_into_aggregates(v)
            if nv is not v:
                replace[f.name] = nv
        elif (
            isinstance(v, tuple) and v and isinstance(v[0], N.PlanNode)
        ):
            nv = tuple(fuse_filter_into_aggregates(c) for c in v)
            if nv != v:
                replace[f.name] = nv
    if replace:
        node = dataclasses.replace(node, **replace)
    if (
        isinstance(node, N.Aggregate)
        and node.mask is None
        and isinstance(node.child, N.Filter)
    ):
        flt = node.child
        node = dataclasses.replace(node, child=flt.child, mask=flt.predicate)
    return node


def optimize(root: N.PlanNode) -> N.PlanNode:
    from .rules import annotate_dynamic_filters, rewrite

    root = rewrite(root)  # iterative rule pass (plan/rules.py)
    root = fuse_filter_into_aggregates(root)
    if isinstance(root, N.Output):
        root = prune_columns(root, set(root.channels))
    else:
        root = prune_columns(root, set(root.field_names()))
    # LAST: channel names are final after pruning, so build->probe dynamic
    # filter links (runtime filtering, exec/dynfilter.py) bind correctly
    return annotate_dynamic_filters(root)
