"""Hand-composed TPC-H Q1 / Q6 pipelines (torch counterpart of
presto_tpu/benchmark/handcoded.py).

The analog of the reference's hand-coded operator benchmarks
(presto-benchmark/.../HandTpchQuery1.java, HandTpchQuery6.java): the query
is written directly against the operator library, bypassing the SQL
frontend. benchmark/bench.py drives them over lineitem generated on the
device (benchmark/benchgen.py).
"""

from __future__ import annotations

import torch

from .. import types as T
from ..expr import ir
from ..expr.ir import col, comparison, lit
from ..ops.aggregate import AggSpec, global_aggregate, grouped_aggregate_direct
from ..ops.sort import SortKey, sort_page
from ..page import Block, Page

DEC12_2 = T.DecimalType(12, 2)
DEC4_2 = T.DecimalType(4, 2)

Q1_COLUMNS = (
    "l_quantity",
    "l_extendedprice",
    "l_discount",
    "l_tax",
    "l_returnflag",
    "l_linestatus",
    "l_shipdate",
)

Q6_COLUMNS = ("l_quantity", "l_extendedprice", "l_discount", "l_shipdate")


def lineitem_q1_page(sf: float, device="cuda") -> Page:
    """lineitem's Q1 columns, generated on `device`."""
    from . import benchgen

    return benchgen.device_page("lineitem", sf, Q1_COLUMNS, device=device)


def lineitem_q6_page(sf: float, device="cuda") -> Page:
    """lineitem's Q6 columns, generated on `device`."""
    from . import benchgen

    return benchgen.device_page("lineitem", sf, Q6_COLUMNS, device=device)


# ---------------------------------------------------------------------------
# Q1: pricing summary report
# ---------------------------------------------------------------------------

Q1_CUTOFF = "1998-09-02"
Q1_PREDICATE = comparison("le", col("l_shipdate", T.DATE), ir.Literal(Q1_CUTOFF, T.DATE))

Q1_GROUPS = (col("l_returnflag", T.VARCHAR), col("l_linestatus", T.VARCHAR))
Q1_GROUP_NAMES = ("l_returnflag", "l_linestatus")
Q1_DOMAINS = (3, 2)  # returnflag in {A,N,R}, linestatus in {F,O}
Q1_OUTPUT_NAMES = (
    "l_returnflag", "l_linestatus", "sum_qty", "sum_base_price", "sum_disc_price",
    "sum_charge", "avg_qty", "avg_price", "avg_disc", "count_order",
)


def q1_aggs():
    qty = col("l_quantity", DEC12_2)
    price = col("l_extendedprice", DEC12_2)
    disc = col("l_discount", DEC4_2)
    tax = col("l_tax", DEC4_2)
    disc_price = ir.binary("multiply", price, ir.binary("subtract", lit(1), disc))
    charge = ir.binary("multiply", disc_price, ir.binary("add", lit(1), tax))

    def agg(func, inp, name):
        in_t = None if inp is None else inp.type
        return AggSpec(func, inp, name, AggSpec.infer_output_type(func, in_t))

    return (
        agg("sum", qty, "sum_qty"),
        agg("sum", price, "sum_base_price"),
        agg("sum", disc_price, "sum_disc_price"),
        agg("sum", charge, "sum_charge"),
        agg("avg", qty, "avg_qty"),
        agg("avg", price, "avg_price"),
        agg("avg", disc, "avg_disc"),
        agg("count_star", None, "count_order"),
    )


def q1_local(page: Page) -> Page:
    """Q1 on one device: the filter fused as an aggregation mask (no
    compaction), the direct grouped aggregation, then the sort."""
    out = grouped_aggregate_direct(
        page, Q1_GROUPS, Q1_GROUP_NAMES, q1_aggs(), Q1_DOMAINS, pre_mask=Q1_PREDICATE,
    )
    return sort_page(out, (SortKey(Q1_GROUPS[0]), SortKey(Q1_GROUPS[1])))


def q1_local_kernel(page: Page) -> Page:
    """Q1 through the fused kernel (ops/agg_kernel.py, csrc/q1_partials.cu):
    the counterpart of the JAX package's `q1_local_pallas`. It gives the
    same Page as q1_local; groups are emitted in (returnflag, linestatus)
    order and compacted to the occupied ones, so no sort is needed. Like
    the reference, it reads the blocks' data and takes the columns as
    non-null (lineitem's Q1 columns have no nulls)."""
    from ..expr.datetime_kernels import parse_date_literal
    from ..ops import decimal128 as d128
    from ..ops.agg_kernel import q1_sums
    from ..ops.aggregate import avg_from_sum_count
    from ..ops.filter import compact

    dev = page.device
    data = [page.block(c).data for c in Q1_COLUMNS]
    cutoff = torch.tensor(parse_date_literal(Q1_CUTOFF), dtype=torch.int32, device=dev)
    s = q1_sums(*data, page.count, cutoff)

    cnt = s["count"]
    has = cnt > 0
    dec38 = {scale: T.DecimalType(38, scale) for scale in (2, 4, 6)}

    def avg(total, typ):
        return Block(avg_from_sum_count(d128.from_int64(total), cnt, typ, typ), typ, has)

    codes = torch.arange(6, dtype=torch.int32, device=dev)
    blocks = [
        Block(codes // 2, T.VARCHAR, None, page.block("l_returnflag").dict_id),
        Block(codes % 2, T.VARCHAR, None, page.block("l_linestatus").dict_id),
        Block(d128.from_int64(s["sum_qty"]), dec38[2], has),
        Block(d128.from_int64(s["sum_price"]), dec38[2], has),
        Block(s["sum_disc_price"], dec38[4], has),
        Block(s["sum_charge"], dec38[6], has),
        avg(s["sum_qty"], DEC12_2),
        avg(s["sum_price"], DEC12_2),
        avg(s["sum_disc"], DEC4_2),
        Block(cnt, T.BIGINT, None),
    ]
    out = Page.from_blocks(blocks, Q1_OUTPUT_NAMES, count=6, device=dev)
    return compact(out, has)


def _q1_prelude(page: Page) -> Page:
    """Q1's scan-filter stage on one worker."""
    from ..ops.filter import filter_page

    return filter_page(page, Q1_PREDICATE)


def q1_distributed(mesh, page: Page) -> Page:
    """Q1 over a mesh of workers: lineitem sharded over the workers (the
    split-parallel leaf stage), filtered and partially aggregated on each,
    the partial rows repartitioned by group hash (the FIXED_HASH exchange),
    final-aggregated, gathered and sorted (parallel/distributed.py)."""
    from ..parallel.distributed import dist_grouped_aggregate

    out = dist_grouped_aggregate(mesh, page, Q1_GROUPS, Q1_GROUP_NAMES, q1_aggs(),
                                 prelude=_q1_prelude)
    return sort_page(out, (SortKey(Q1_GROUPS[0]), SortKey(Q1_GROUPS[1])))


# ---------------------------------------------------------------------------
# Q6: forecasting revenue change
# ---------------------------------------------------------------------------

Q6_PREDICATE = ir.and_(
    comparison("ge", col("l_shipdate", T.DATE), ir.Literal("1994-01-01", T.DATE)),
    comparison("lt", col("l_shipdate", T.DATE), ir.Literal("1995-01-01", T.DATE)),
    ir.between(col("l_discount", DEC4_2), ir.Literal(0.05, DEC4_2), ir.Literal(0.07, DEC4_2)),
    comparison("lt", col("l_quantity", DEC12_2), lit(24)),
)


def q6_local(page: Page) -> Page:
    revenue = ir.binary("multiply", col("l_extendedprice", DEC12_2), col("l_discount", DEC4_2))
    spec = AggSpec("sum", revenue, "revenue", AggSpec.infer_output_type("sum", revenue.type))
    return global_aggregate(page, (spec,), pre_mask=Q6_PREDICATE)
