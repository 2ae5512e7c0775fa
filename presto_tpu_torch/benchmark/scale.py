"""North-star scale runs (torch counterpart of presto_tpu/benchmark/scale.py):
SF 10 end to end through the streaming SQL path, and SF 100 streamed from a
chunk-generated catalog that never holds a large table.

The texts of TPC-H Q1, Q6, Q3, Q5, Q17 and Q18 as the JAX package's scale
and north-star runners send them, adapted only where the benchmark
generator (benchmark/benchgen.py) lacks a column (Q18: c_name), plus the
Q18-shaped customer rollup. benchmark/northstar.py runs them over the
device-resident catalog; `run_scale` over TpchCatalog(sf) in a streaming
session under a device budget; `run_sf100` over ChunkedTpchCatalog, whose
batches are generated on the session's device.

    python -m presto_tpu_torch.benchmark.scale --sf 10
    python -m presto_tpu_torch.benchmark.scale --sf100   # north stars, streamed
    python -m presto_tpu_torch.benchmark.scale --sf100 --sf 10   # the same at SF 10
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import types as T
from ..connectors.spi import Connector

Q1 = (
    "select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty, "
    "sum(l_extendedprice) as sum_base_price, "
    "sum(l_extendedprice * (1 - l_discount)) as sum_disc_price, "
    "avg(l_quantity) as avg_qty, avg(l_discount) as avg_disc, "
    "count(*) as count_order "
    "from lineitem where l_shipdate <= date '1998-09-02' "
    "group by l_returnflag, l_linestatus "
    "order by l_returnflag, l_linestatus"
)
Q6 = (
    "select sum(l_extendedprice * l_discount) as revenue from lineitem "
    "where l_shipdate >= date '1994-01-01' "
    "and l_shipdate < date '1995-01-01' "
    "and l_discount between 0.05 and 0.07 and l_quantity < 24"
)
Q3 = (
    "select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as rev, "
    "o_orderdate, o_shippriority "
    "from customer, orders, lineitem "
    "where c_mktsegment = 'BUILDING' and c_custkey = o_custkey "
    "and l_orderkey = o_orderkey and o_orderdate < date '1995-03-15' "
    "and l_shipdate > date '1995-03-15' "
    "group by l_orderkey, o_orderdate, o_shippriority "
    "order by rev desc, o_orderdate limit 10"
)
Q18_SHAPE = (
    "select c_custkey, sum(o_totalprice) tp, count(*) n "
    "from customer, orders "
    "where c_custkey = o_custkey "
    "group by c_custkey order by tp desc limit 100"
)
# the BASELINE.json north stars (round-4 verdict weak#2): Q5 is the
# 6-table join-order stressor; Q17 the large-build correlated-agg /
# spill-path stressor; Q18 the big-group HAVING semi-join. Spec texts
# adapted only where the chunked generator lacks a column (Q18: c_name)
Q5 = (
    "select n_name, sum(l_extendedprice * (1 - l_discount)) as revenue "
    "from customer, orders, lineitem, supplier, nation, region "
    "where c_custkey = o_custkey and l_orderkey = o_orderkey "
    "and l_suppkey = s_suppkey and c_nationkey = s_nationkey "
    "and s_nationkey = n_nationkey and n_regionkey = r_regionkey "
    "and r_name = 'ASIA' and o_orderdate >= date '1994-01-01' "
    "and o_orderdate < date '1995-01-01' "
    "group by n_name order by revenue desc"
)
Q17 = (
    "select sum(l_extendedprice) / 7.0 as avg_yearly "
    "from lineitem, part "
    "where p_partkey = l_partkey and p_brand = 'Brand#23' "
    "and p_container = 'MED BOX' "
    "and l_quantity < ("
    "select 0.2 * avg(l_quantity) from lineitem "
    "where l_partkey = p_partkey)"
)
Q18 = (
    "select c_custkey, o_orderkey, o_orderdate, o_totalprice, "
    "sum(l_quantity) "
    "from customer, orders, lineitem "
    "where o_orderkey in ("
    "select l_orderkey from lineitem group by l_orderkey "
    "having sum(l_quantity) > 300) "
    "and c_custkey = o_custkey and o_orderkey = l_orderkey "
    "group by c_custkey, o_orderkey, o_orderdate, o_totalprice "
    "order by o_totalprice desc, o_orderdate limit 100"
)

QUERIES = {
    "q1": Q1, "q6": Q6, "q3": Q3, "q18_shape": Q18_SHAPE,
    "q5": Q5, "q17": Q17, "q18": Q18,
}



_SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")
_STARTDATE, _ENDDATE = 8035, 10591  # 1992-01-01 .. 1998-12-31 (days)


class ChunkedTpchCatalog(Connector):
    """Seven-table TPC-H catalog generating rows ON DEMAND, batch by batch,
    on its device: the SF 10 and SF 100 scan source. Every column is a pure
    function of the row index (benchgen's splitmix64 counter streams;
    customer, supplier and part come from benchgen's generators), so
    lineitem and orders agree on per-order attributes without shared
    state, and a re-scan is deterministic (the connector split contract).
    The columns equal the JAX package's numpy chunks bit for bit. Only
    per-chunk line-count prefix sums stay cached (one int64 per order of
    at most two chunks); a lineitem batch generates just the columns a
    scan asks for. Column statistics come from the connector's strided
    sample (connectors/spi.py), cheap here since a sample is generated: the
    JAX package's catalog has none, and without them the CBO orders Q5's
    joins so that customer x supplier on the nation key grows with SF^2
    (1.8e9 rows at SF 10)."""

    name = "tpch_chunked"
    CHUNK_ORDERS = 1 << 21  # ~2M orders -> ~8.4M lineitem rows per chunk

    _LI_SCHEMA = {
        "l_orderkey": T.BIGINT,
        "l_partkey": T.BIGINT,
        "l_suppkey": T.BIGINT,
        "l_quantity": T.DecimalType(12, 2),
        "l_extendedprice": T.DecimalType(12, 2),
        "l_discount": T.DecimalType(12, 2),
        "l_tax": T.DecimalType(12, 2),
        "l_returnflag": T.VARCHAR,
        "l_linestatus": T.VARCHAR,
        "l_shipdate": T.DATE,
    }
    _ORD_SCHEMA = {
        "o_orderkey": T.BIGINT,
        "o_custkey": T.BIGINT,
        "o_totalprice": T.DecimalType(12, 2),
        "o_orderdate": T.DATE,
        "o_shippriority": T.BIGINT,
    }
    _CUST_SCHEMA = {
        "c_custkey": T.BIGINT,
        "c_nationkey": T.BIGINT,
        "c_mktsegment": T.VARCHAR,
        "c_acctbal": T.DecimalType(12, 2),
    }
    _PART_SCHEMA = {"p_partkey": T.BIGINT, "p_brand": T.VARCHAR, "p_container": T.VARCHAR}
    _SUPP_SCHEMA = {"s_suppkey": T.BIGINT, "s_nationkey": T.BIGINT}
    _NATION_SCHEMA = {"n_nationkey": T.BIGINT, "n_name": T.VARCHAR, "n_regionkey": T.BIGINT}
    _REGION_SCHEMA = {"r_regionkey": T.BIGINT, "r_name": T.VARCHAR}
    _UNIQUE = {
        "orders": [("o_orderkey",)],
        "customer": [("c_custkey",)],
        "part": [("p_partkey",)],
        "supplier": [("s_suppkey",)],
        "nation": [("n_nationkey",)],
        "region": [("r_regionkey",)],
    }

    def __init__(self, sf: float, device="cuda"):
        from ..connectors.tpch import NATIONS, REGIONS
        from . import benchgen

        self.sf = sf
        self.device = torch.device(device)
        self.n_orders = int(1_500_000 * sf)
        sizes = benchgen._sizes(sf)
        # dimension sizes come from benchgen, so the delegated generators
        # and the foreign-key bounds (streams 11/3/12) cannot disagree
        self.n_cust = sizes["customer"]
        self.n_part = sizes["part"]
        self.n_supp = sizes["supplier"]
        names = sorted(n for n, _r in NATIONS)
        region_of = dict(NATIONS)
        self._nation_regions = np.array([region_of[n] for n in names], np.int64)
        self._dicts = {
            "l_returnflag": ("A", "N", "R"),
            "l_linestatus": ("F", "O"),
            "c_mktsegment": _SEGMENTS,
            "p_brand": benchgen._BRAND_POOL,
            "p_container": benchgen._CONTAINER_POOL,
            "r_name": tuple(sorted(REGIONS)),
            "n_name": tuple(names),
        }
        n_chunks = -(-self.n_orders // self.CHUNK_ORDERS)
        # deterministic per-order line counts -> exact chunk row offsets
        counts = np.zeros(max(n_chunks, 1), np.int64)
        for c in range(n_chunks):
            o0, o1 = self._order_range(c)
            counts[c] = self._lines_for(np.arange(o0, o1, dtype=np.int64)).sum()
        self._offsets = np.concatenate([[0], np.cumsum(counts)])
        self._ends: Dict[int, torch.Tensor] = {}  # chunk -> line-count prefix sums

    # -- metadata (the planner's Catalog protocol) --

    def table_names(self) -> List[str]:
        return ["lineitem", "orders", "customer", "part", "supplier", "nation", "region"]

    def _schema_for(self, table: str):
        return {
            "lineitem": self._LI_SCHEMA, "orders": self._ORD_SCHEMA,
            "customer": self._CUST_SCHEMA, "part": self._PART_SCHEMA,
            "supplier": self._SUPP_SCHEMA, "nation": self._NATION_SCHEMA,
            "region": self._REGION_SCHEMA,
        }[table]

    def schema(self, table: str):
        return dict(self._schema_for(table))

    def row_count(self, table: str) -> int:
        return {
            "lineitem": int(self._offsets[-1]), "orders": self.n_orders,
            "customer": self.n_cust, "part": self.n_part, "supplier": self.n_supp,
            "nation": 25, "region": 5,
        }[table]

    def exact_row_count(self, table: str) -> int:
        return self.row_count(table)

    def unique_columns(self, table: str):
        return self._UNIQUE.get(table, [])

    # -- stateless per-index column functions --

    def _order_range(self, chunk: int) -> Tuple[int, int]:
        o0 = chunk * self.CHUNK_ORDERS
        return o0, min(o0 + self.CHUNK_ORDERS, self.n_orders)

    @staticmethod
    def _lines_for(order_idx):
        """1..7 lineitems per order, stateless in the order index (numpy or
        torch int64; the product stays below 2^63 for any SF here)."""
        return ((order_idx * 2654435761) >> 7) % 7 + 1

    def _xp(self):
        from . import benchgen

        return benchgen._Torch(self.device)

    def _u(self, stream: int, i, lo: int, hi: int):
        from .benchgen import _uni

        return _uni(self._xp(), stream, i, lo, hi)

    def _orderdate(self, order_idx):
        return self._u(7, order_idx, _STARTDATE, _ENDDATE - 151 + 1)

    def _chunk_ends(self, c: int) -> torch.Tensor:
        """Inclusive prefix sums of chunk c's line counts, on the device."""
        ends = self._ends.get(c)
        if ends is None:
            o0, o1 = self._order_range(c)
            ends = torch.cumsum(self._lines_for(self._xp().arange(o0, o1)), 0)
            self._ends[c] = ends
            if len(self._ends) > 2:
                self._ends.pop(next(iter(self._ends)))
        return ends

    def _li_cols(self, c: int, lo: int, hi: int, names) -> dict:
        """Lineitem rows [lo, hi) of chunk c (chunk-local), `names` only."""
        o0, _o1 = self._order_range(c)
        xp = self._xp()
        local = xp.arange(lo, hi)
        order_idx = o0 + torch.searchsorted(self._chunk_ends(c), local, right=True)
        li = int(self._offsets[c]) + local
        cols = {}
        qty = None
        for nm in names:
            if nm == "l_orderkey":
                v = order_idx + 1
            elif nm == "l_partkey":
                v = self._u(3, li, 1, self.n_part + 1)
            elif nm == "l_suppkey":
                v = self._u(12, li, 1, self.n_supp + 1)
            elif nm in ("l_quantity", "l_extendedprice"):
                if qty is None:
                    qty = self._u(4, li, 1, 51)
                v = qty * 100 if nm == "l_quantity" else \
                    (90_000 + (qty * 100_000) % 110_001) * qty // 100
            elif nm == "l_discount":
                v = self._u(5, li, 0, 11)
            elif nm == "l_tax":
                v = self._u(6, li, 0, 9)
            elif nm == "l_returnflag":
                v = self._u(10, li, 0, 3)
            elif nm == "l_linestatus":
                v = self._u(13, li, 0, 2)
            elif nm == "l_shipdate":
                v = self._orderdate(order_idx) + self._u(8, li, 1, 122)
            else:
                raise KeyError(nm)
            cols[nm] = v
        return cols

    def _range_cols(self, table: str, start: int, stop: int, names) -> dict:
        """Non-lineitem columns for a row range, generated directly."""
        from . import benchgen

        xp = self._xp()
        i = xp.arange(start, stop)
        if table == "orders":
            gen = {
                "o_orderkey": lambda: i + 1,
                "o_custkey": lambda: self._u(11, i, 1, self.n_cust + 1),
                "o_totalprice": lambda: self._u(15, i, 100, 60_000_000),
                "o_orderdate": lambda: self._orderdate(i),
                "o_shippriority": lambda: xp.zeros(stop - start),
            }
            return {nm: gen[nm]() for nm in names}
        if table in ("customer", "part", "supplier"):
            # benchgen's generators produce these columns (same streams and
            # pools) for any index range
            return benchgen._generate(xp, table, self.sf, tuple(names), start, stop - start)
        if table == "nation":
            gen = {"n_nationkey": lambda: i, "n_name": lambda: i,
                   "n_regionkey": lambda: torch.from_numpy(
                       self._nation_regions[start:stop]).to(self.device)}
            return {nm: gen[nm]() for nm in names}
        return {nm: i for nm in names}  # region: key and name code

    def page(self, table: str):
        n = self.row_count(table)
        if n > 4_000_000:
            raise MemoryError("chunked catalog never materializes a large table; "
                              "use scan(start, stop)")
        # small dimensions may materialize: the streaming executor takes them
        # whole
        return self.scan(table, 0, n)

    def scan(self, table: str, start: int, stop: int, pad_to=None, columns=None,
             predicate=None):
        from ..page import Block, Page, _pad_block, intern_dictionary

        schema = self._schema_for(table)
        stop = min(stop, self.row_count(table))
        count = max(stop - start, 0)
        names = list(columns) if columns is not None else list(schema)
        if table == "lineitem":
            c0 = int(np.searchsorted(self._offsets, start, "right")) - 1
            c1 = int(np.searchsorted(self._offsets, max(stop - 1, start), "right")) - 1
            pieces = {nm: [] for nm in names}
            for c in range(max(c0, 0), max(c1, c0) + 1):
                lo = max(start - int(self._offsets[c]), 0)
                hi = min(stop - int(self._offsets[c]),
                         int(self._offsets[c + 1] - self._offsets[c]))
                if hi <= lo:
                    continue
                for nm, v in self._li_cols(c, lo, hi, names).items():
                    pieces[nm].append(v)
            data = {nm: (torch.cat(pieces[nm]) if pieces[nm] else
                         torch.empty(0, dtype=torch.int64, device=self.device))
                    for nm in names}
        else:
            data = self._range_cols(table, start, max(stop, start), names)
        blocks = []
        for nm in names:
            typ = schema[nm]
            pool = self._dicts.get(nm)
            blk = Block(data[nm].to(typ.storage_dtype), typ, None,
                        intern_dictionary(pool) if pool is not None else None)
            if pad_to is not None and pad_to > count:
                blk = _pad_block(blk, pad_to)
            blocks.append(blk)
        return Page.from_blocks(blocks, names, count=count, device=self.device)


def run_scale(sf: float, queries=("q1", "q6", "q3", "q18_shape"), memory_budget: int = 512 << 20,
              batch_rows: int = 1 << 20, device="cuda") -> dict:
    """SF-N through the full SQL path under the streaming executor."""
    from ..connectors.tpch import TpchCatalog
    from ..session import Session

    cat = TpchCatalog(sf, device=device)
    sess = Session(cat, device=device, streaming=True, batch_rows=batch_rows,
                   memory_budget=memory_budget,
                   result_cache=False)  # timing execution, not cache serving
    n_li = cat.exact_row_count("lineitem")
    out = {"sf": sf, "memory_budget": memory_budget, "queries": {}}
    for name in queries:
        sql = QUERIES[name]
        t0 = time.perf_counter()
        rows = sess.query(sql).rows()
        warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows = sess.query(sql).rows()
        hot = time.perf_counter() - t0
        out["queries"][name] = {
            "warm_s": round(warm, 2),
            "hot_s": round(hot, 2),
            "rows_per_s": round(n_li / hot) if name in ("q1", "q6") else None,
            "result_rows": len(rows),
            # within one process, equal rows give equal digests
            "digest": hash(tuple(map(str, rows[:100]))) & 0xFFFFFFFF,
            "result": [tuple(map(str, r)) for r in rows[:4]],
            "spill": list(sess.executor.spill_events),
        }
        sess.executor.spill_events.clear()
    return out


def run_sf100(sf: float = 100.0, queries=("q6", "q1", "q3", "q5", "q17", "q18"),
              memory_budget: int = 512 << 20, batch_rows: int = 1 << 22, device="cuda") -> dict:
    """The BASELINE north stars over batched chunk-generated scans: the
    large tables never exist anywhere in full; each batch is generated on
    the device, scanned and reduced."""
    from ..session import Session

    cat = ChunkedTpchCatalog(sf, device=device)
    sess = Session(cat, device=device, streaming=True, batch_rows=batch_rows,
                   memory_budget=memory_budget,
                   result_cache=False)  # timing execution, not cache serving
    n = cat.row_count("lineitem")
    out = {"sf": sf, "rows": n, "memory_budget": memory_budget, "queries": {}}
    for name in queries:
        sql = QUERIES[name]
        t0 = time.perf_counter()
        rows = sess.query(sql).rows()
        wall = time.perf_counter() - t0
        out["queries"][name] = {
            "wall_s": round(wall, 1),
            "rows_per_s": round(n / wall),
            "result": [tuple(map(str, r)) for r in rows[:4]],
            "peak_device_bytes": sess.executor.pool.peak,
            "spill": sorted(set(sess.executor.spill_events)),
        }
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=None,
                    help="scale factor (default 10, or 100 with --sf100)")
    ap.add_argument("--sf100", action="store_true",
                    help="chunk-scan north stars (q1/q6/q3/q5/q17/q18) "
                         "instead of the full SQL suite")
    ap.add_argument("--queries", nargs="*", default=None)
    ap.add_argument("--budget", type=int, default=512 << 20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.sf100:
        res = run_sf100(args.sf or 100.0,
                        queries=tuple(args.queries or ("q6", "q1", "q3", "q5", "q17", "q18")),
                        memory_budget=args.budget, device=args.device)
    else:
        res = run_scale(args.sf or 10.0, queries=tuple(args.queries or ("q1", "q6", "q3", "q18_shape")),
                        memory_budget=args.budget, device=args.device)
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
