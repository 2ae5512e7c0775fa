"""Distributed operator compositions over the mesh (torch counterpart of
presto_tpu/parallel/distributed.py).

`dist_grouped_aggregate` is a whole stage pipeline: the analog of a Presto
multi-stage plan (partial aggregation at the source stage, FIXED_HASH
exchange, final aggregation at the middle stage; SqlQueryScheduler stage
wiring, SURVEY.md section 3.2). The JAX package compiles it into one
shard_map program with static group capacities that raise on overflow;
here every worker runs the stage eagerly on its own device, each
aggregation's output capacity is its input's (groups never exceed rows),
and the exchange is sized from exact counts, so nothing can overflow.
"""

from __future__ import annotations

from typing import Sequence

from ..expr.ir import ColumnRef
from ..ops.aggregate import AggSpec, apply_avg_post, decompose_partial, grouped_aggregate_sorted
from .exchange import device_scope, exchange_by_hash, gather_page
from .mesh import Mesh, shard_rows


def dist_grouped_aggregate(mesh: Mesh, page, group_exprs, group_names: Sequence[str],
                           aggs: Sequence[AggSpec], prelude=None):
    """Distributed GROUP BY: shard rows -> [prelude: the local
    scan-filter-project stage] -> partial aggregation per worker ->
    repartition the partial rows by group-key hash -> final aggregation ->
    gather on worker 0's device. Returns one Page."""
    partial_specs, final_specs, post = decompose_partial(aggs)
    partials = []
    for shard, dev in zip(shard_rows(page, mesh), mesh.devices):
        with device_scope(dev):
            local = shard if prelude is None else prelude(shard)
            partials.append(grouped_aggregate_sorted(
                local, group_exprs, group_names, partial_specs, max(local.capacity, 1)))
    key_exprs = [ColumnRef(nm, partials[0].block(nm).type) for nm in group_names]
    received, _counts = exchange_by_hash(partials, key_exprs, mesh)
    finals = []
    for recv, dev in zip(received, mesh.devices):
        with device_scope(dev):
            finals.append(grouped_aggregate_sorted(
                recv, key_exprs, group_names, final_specs, recv.capacity))
    return apply_avg_post(gather_page(finals, mesh.devices[0]), aggs, post)
