"""Plan fragmentation: exchange placement and the partitioning vocabulary
(torch counterpart of presto_tpu/plan/fragment.py, with the same rules).

Re-designed equivalent of the reference's distribution planning:
AddExchanges (presto-main/.../sql/planner/optimizations/AddExchanges.java)
decides where data must be repartitioned, replicated or gathered, and
PlanFragmenter (sql/planner/PlanFragmenter.java) cuts the plan at exchange
boundaries. The partitioning vocabulary mirrors SystemPartitioningHandle
(sql/planner/SystemPartitioningHandle.java:57-65):

  SOURCE      arbitrary row shards across workers (leaf scans / splits)
  HASH        rows co-located by hash of a key set (FIXED_HASH_DISTRIBUTION)
  SINGLE      all rows on one logical worker (SINGLE_DISTRIBUTION)
  REPLICATED  a full copy on every worker (FIXED_BROADCAST_DISTRIBUTION)

Exchanges move rows between the mesh's workers (parallel/exchange.py), and
fragments are not separately scheduled: the distributed executor
(exec/dist.py) walks ONE physical tree and switches between sharded
stages and single-worker execution at Exchange nodes. `fragments()`
recovers the reference-style fragment list. Aggregations split into
partial and final around the exchange as the reference's
AggregationNode.Step does (avg recomposed from sum and count afterwards).

One departure from the JAX package: a null-aware semi join (NOT IN) needs
its whole source, because the source's emptiness and its NULLs decide
every probe row (ops/join.null_aware_anti), so it is replicated or
gathered, never repartitioned. And `decompose_partial` is this package's:
the sketch, moment and regression aggregates, which the JAX package splits
into mergeable partial states, do not decompose here, so they gather and
aggregate on one worker.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .. import types as T
from ..expr import ir
from ..ops.aggregate import decompose_partial
from . import nodes as N

# partitioning kinds
SOURCE = "source"
HASH = "hash"
SINGLE = "single"
REPLICATED = "replicated"


@dataclasses.dataclass(frozen=True)
class Partitioning:
    """Distribution of a node's output across the worker mesh axis."""

    kind: str  # SOURCE | HASH | SINGLE | REPLICATED
    keys: Tuple[ir.RowExpression, ...] = ()

    @property
    def is_sharded(self) -> bool:
        return self.kind in (SOURCE, HASH)


@dataclasses.dataclass(frozen=True)
class Exchange(N.PlanNode):
    """Data movement between distributions (reference ExchangeNode with
    scope=REMOTE). kind: repartition (hash all_to_all) | replicate
    (broadcast full copy) | gather (collect to SINGLE)."""

    child: N.PlanNode
    kind: str  # 'repartition' | 'replicate' | 'gather'
    keys: Tuple[ir.RowExpression, ...] = ()

    @property
    def fields(self):
        return self.child.fields

    @property
    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class AggFinalize(N.PlanNode):
    """Post-final-aggregation step recomposing user-visible aggregates from
    decomposed partial columns (avg = sum/count). Output schema equals the
    original Aggregate node's."""

    child: N.PlanNode
    group_fields: Tuple[N.Field, ...]
    aggs: Tuple[object, ...]  # original AggSpecs
    post: Tuple[object, ...]  # AvgPost steps

    @property
    def fields(self):
        return self.group_fields + tuple(
            (a.name, a.output_type) for a in self.aggs
        )

    @property
    def children(self):
        return (self.child,)


class Fragmenter:
    """Insert exchanges bottom-up so every operator's co-location
    requirement is met; track each subtree's delivered Partitioning.

    broadcast_threshold=None selects COST-BASED join distribution
    (reference DetermineJoinDistributionType): broadcast replicates the
    build side onto every worker (build_rows x W moved, probe stays put);
    repartition moves both sides once. An explicit integer keeps the
    legacy fixed row cutover."""

    def __init__(
        self,
        catalog,
        broadcast_threshold: Optional[int] = None,
        num_workers: int = 8,
    ):
        self.catalog = catalog
        self.broadcast_threshold = broadcast_threshold
        self.num_workers = max(num_workers, 2)
        from .stats import StatsDeriver

        self._stats = StatsDeriver(catalog)

    def fragment(self, root: N.PlanNode) -> N.PlanNode:
        node, dist = self._visit(root)
        if dist.is_sharded:
            node = Exchange(node, "gather")
        return node

    # -- helpers --

    def _estimate(self, node: N.PlanNode) -> float:
        return self._stats.stats(node).rows

    def _should_broadcast(self, build: N.PlanNode, probe: N.PlanNode) -> bool:
        build_rows = self._estimate(build)
        if self.broadcast_threshold is not None:
            return build_rows <= self.broadcast_threshold
        probe_rows = self._estimate(probe)
        # replicate cost: every worker holds the build (W x build moved);
        # repartition cost: both sides cross the exchange once
        return build_rows * self.num_workers <= probe_rows + build_rows

    def _gather(self, node: N.PlanNode, dist: Partitioning) -> N.PlanNode:
        return Exchange(node, "gather") if dist.is_sharded else node

    @staticmethod
    def _has_varchar_keys(keys) -> bool:
        return any(isinstance(k.type, T.VarcharType) for k in keys)

    # -- dispatch --

    def _visit(self, node: N.PlanNode) -> Tuple[N.PlanNode, Partitioning]:
        m = getattr(self, f"_v_{type(node).__name__.lower()}", None)
        if m is None:
            raise NotImplementedError(
                f"fragmenter: unhandled node {type(node).__name__}"
            )
        return m(node)

    def _v_tablescan(self, node):
        return node, Partitioning(SOURCE)

    def _v_singlerow(self, node):
        return node, Partitioning(SINGLE)

    def _v_unnest(self, node):
        # row-local expansion: runs on whatever distribution the child has
        child, dist = self._visit(node.child)
        return dataclasses.replace(node, child=child), dist

    def _v_sample(self, node):
        child, dist = self._visit(node.child)
        return dataclasses.replace(node, child=child), dist

    def _v_filter(self, node):
        child, dist = self._visit(node.child)
        # dataclasses.replace keeps the dynamic-filter consumer annotation
        return dataclasses.replace(node, child=child), dist

    def _v_project(self, node):
        child, dist = self._visit(node.child)
        return N.Project(child, node.exprs, node.names), dist

    def _v_output(self, node):
        child, dist = self._visit(node.child)
        child = self._gather(child, dist)
        return N.Output(child, node.channels, node.titles), Partitioning(SINGLE)

    def _v_aggregate(self, node: N.Aggregate):
        child, dist = self._visit(node.child)
        if not dist.is_sharded:
            return (
                N.Aggregate(
                    child, node.group_exprs, node.group_names, node.aggs,
                    node.mask,
                ),
                Partitioning(SINGLE),
            )
        try:
            partial_specs, final_specs, post = decompose_partial(node.aggs)
        except KeyError:
            # non-decomposable aggregate: gather and aggregate on one worker
            child = self._gather(child, dist)
            return (
                N.Aggregate(
                    child, node.group_exprs, node.group_names, node.aggs,
                    node.mask,
                ),
                Partitioning(SINGLE),
            )
        # the fused selection mask applies to the PARTIAL step only — final
        # aggregation combines already-masked partial rows
        partial = N.Aggregate(
            child, node.group_exprs, node.group_names, partial_specs,
            node.mask,
        )
        key_refs = tuple(
            ir.ColumnRef(nm, e.type)
            for nm, e in zip(node.group_names, node.group_exprs)
        )
        group_fields = tuple(
            (nm, e.type) for nm, e in zip(node.group_names, node.group_exprs)
        )
        if not node.group_exprs:
            # global aggregation: one partial row per shard, gather, finalize
            exch = Exchange(partial, "gather")
            final = N.Aggregate(exch, (), (), final_specs)
            return (
                AggFinalize(final, (), node.aggs, post),
                Partitioning(SINGLE),
            )
        exch = Exchange(partial, "repartition", key_refs)
        final = N.Aggregate(exch, key_refs, node.group_names, final_specs)
        return (
            AggFinalize(final, group_fields, node.aggs, post),
            Partitioning(HASH, key_refs),
        )

    def _v_join(self, node: N.Join):
        left, ldist = self._visit(node.left)
        right, rdist = self._visit(node.right)
        if node.kind == "full" or (
            node.kind != "inner" and node.residual is not None
        ):
            # multi-kernel outer composition (Executor._exec_outer_join)
            # runs single-node: null-extension of the build side cannot be
            # decided per shard under replication
            left = self._gather(left, ldist)
            right = self._gather(right, rdist)
            return (
                dataclasses.replace(node, left=left, right=right),
                Partitioning(SINGLE),
            )
        if not ldist.is_sharded and not rdist.is_sharded:
            return (
                dataclasses.replace(node, left=left, right=right),
                Partitioning(SINGLE),
            )
        if not ldist.is_sharded:
            # probe single: gather the build side too (small probe side means
            # no distribution to preserve)
            right = self._gather(right, rdist)
            return (
                dataclasses.replace(node, left=left, right=right),
                Partitioning(SINGLE),
            )
        broadcast = (
            self._should_broadcast(node.right, node.left)
            or not node.left_keys
            or self._has_varchar_keys(node.left_keys)
            or self._has_varchar_keys(node.right_keys)
        )
        if broadcast:
            # replicate the build side on every worker; probe stays put
            # (reference DetermineJoinDistributionType -> REPLICATED)
            right = Exchange(self._gather(right, rdist), "replicate")
            return dataclasses.replace(node, left=left, right=right), ldist
        # repartition both sides on the join keys (-> PARTITIONED)
        left = Exchange(left, "repartition", node.left_keys)
        right = Exchange(right, "repartition", node.right_keys)
        return (
            dataclasses.replace(node, left=left, right=right),
            Partitioning(HASH, node.left_keys),
        )

    def _v_semijoin(self, node: N.SemiJoin):
        child, cdist = self._visit(node.child)
        source, sdist = self._visit(node.source)
        if not cdist.is_sharded:
            source = self._gather(source, sdist)
            return (
                dataclasses.replace(node, child=child, source=source),
                Partitioning(SINGLE),
            )
        broadcast = (
            self._should_broadcast(node.source, node.child)
            or not node.probe_keys
            or node.residual is not None
            # NOT IN reads the whole source's emptiness and NULLs
            or node.null_aware
            or self._has_varchar_keys(node.probe_keys)
            or self._has_varchar_keys(node.source_keys)
        )
        if broadcast:
            source = Exchange(self._gather(source, sdist), "replicate")
            return (
                dataclasses.replace(node, child=child, source=source),
                cdist,
            )
        child = Exchange(child, "repartition", node.probe_keys)
        source = Exchange(source, "repartition", node.source_keys)
        return (
            dataclasses.replace(node, child=child, source=source),
            Partitioning(HASH, node.probe_keys),
        )

    def _v_scalarapply(self, node: N.ScalarApply):
        child, cdist = self._visit(node.child)
        sub, sdist = self._visit(node.subquery)
        sub = self._gather(sub, sdist)
        return (
            dataclasses.replace(node, child=child, subquery=sub),
            cdist,
        )

    def _v_window(self, node: N.Window):
        child, dist = self._visit(node.child)
        if not dist.is_sharded:
            return dataclasses.replace(node, child=child), Partitioning(SINGLE)
        if not node.partition_exprs:
            child = self._gather(child, dist)
            return dataclasses.replace(node, child=child), Partitioning(SINGLE)
        child = Exchange(child, "repartition", node.partition_exprs)
        return (
            dataclasses.replace(node, child=child),
            Partitioning(HASH, node.partition_exprs),
        )

    def _v_sort(self, node: N.Sort):
        child, dist = self._visit(node.child)
        child = self._gather(child, dist)
        return N.Sort(child, node.keys), Partitioning(SINGLE)

    def _v_topn(self, node: N.TopN):
        child, dist = self._visit(node.child)
        if dist.is_sharded:
            # per-shard top-N is a superset of the global top-N
            child = Exchange(N.TopN(child, node.keys, node.count), "gather")
        return N.TopN(child, node.keys, node.count), Partitioning(SINGLE)

    def _v_limit(self, node: N.Limit):
        child, dist = self._visit(node.child)
        if dist.is_sharded:
            child = Exchange(N.Limit(child, node.count), "gather")
        return N.Limit(child, node.count), Partitioning(SINGLE)

    def _v_distinct(self, node: N.Distinct):
        child, dist = self._visit(node.child)
        if not dist.is_sharded:
            return N.Distinct(child), Partitioning(SINGLE)
        keys = tuple(ir.ColumnRef(nm, t) for nm, t in child.fields)
        if self._has_varchar_keys(keys):
            child = self._gather(child, dist)
            return N.Distinct(child), Partitioning(SINGLE)
        # local pre-distinct shrinks the exchange (reference partial distinct)
        child = Exchange(N.Distinct(child), "repartition", keys)
        return N.Distinct(child), Partitioning(HASH, keys)

    def _v_union(self, node: N.Union):
        inputs = []
        for c in node.inputs:
            cn, cd = self._visit(c)
            inputs.append(self._gather(cn, cd))
        return (
            N.Union(tuple(inputs), node.distinct),
            Partitioning(SINGLE),
        )


def fragment_plan(
    root: N.PlanNode,
    catalog,
    broadcast_threshold: Optional[int] = None,
    num_workers: int = 8,
) -> N.PlanNode:
    """AddExchanges + fragmentation entry point. broadcast_threshold=None
    = cost-based distribution from the stats framework."""
    return Fragmenter(catalog, broadcast_threshold, num_workers).fragment(root)


def fragments(root: N.PlanNode) -> List[N.PlanNode]:
    """Cut the physical plan at Exchange boundaries into reference-style
    fragments (roots listed top-down; fragment 0 is the SINGLE root)."""
    out: List[N.PlanNode] = [root]
    stack = [root]
    while stack:
        n = stack.pop()
        for c in n.children:
            if isinstance(c, Exchange):
                out.append(c.child)
                stack.append(c.child)
            else:
                stack.append(c)
    return out
