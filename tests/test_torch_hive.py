"""The Hive warehouse of presto_tpu_torch (connectors/hive.py) on the CPU,
held to the JAX package: the cases of tests/test_hive.py (a partitioned
round trip, partition pruning and its counters, deterministic bucket
placement, the co-located bucket join against SQLite, pruning in EXPLAIN
ANALYZE, the grouped join under a budget, the metastore across reopen,
scaled writers, crossed and paired bucket keys), each run through both
packages on warehouses written from the same numpy columns: equal rows,
equal manifests (partition, bucket, rows of every file), equal arrow
files, equal `last_scan_files_read` / `_skipped`, the same
`grouped_bucket_join` decisions and the same `files: N read, M pruned`
line. `bucket_of_values` equals the JAX package's on integer and string
keys, and each package reads the warehouse the other wrote (TPC-H orders
and lineitem bucketed on the order key, lineitem partitioned by ship
mode)."""

import sqlite3

import numpy as np
import pyarrow.parquet as papq
import pytest
import torch

import chip_smoke
from presto_tpu import types as RT
from presto_tpu.connectors.hive import HiveCatalog as RHiveCatalog
from presto_tpu.connectors.hive import bucket_of_values as r_bucket_of_values
from presto_tpu.connectors.tpch import TpchCatalog as RTpchCatalog
from presto_tpu.page import Block as RBlock
from presto_tpu.page import Page as RPage
from presto_tpu.session import Session as RSession
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.hive import HiveCatalog, bucket_of_values
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.page import Block, Page
from presto_tpu_torch.session import Session

# one torch thread: the suite runs in parallel worker processes
torch.set_num_threads(1)


def same_rows(got, want, ordered=True):
    diff = chip_smoke.row_diff(got, want, ordered)
    assert diff is None, diff


class Pair:
    """A port warehouse and a JAX-package warehouse, each in a directory of
    its own, given the same DDL and the same numpy columns."""

    def __init__(self, root):
        self.wh = HiveCatalog(str(root / "port"), device="cpu")
        self.rwh = RHiveCatalog(str(root / "ref"))

    def create(self, name, schema, **kw):
        self.wh.create_partitioned_table(name, {c: T.parse_type(s) for c, s in schema.items()},
                                         **kw)
        self.rwh.create_partitioned_table(name, {c: RT.parse_type(s)
                                                 for c, s in schema.items()}, **kw)

    def append(self, name, cols):
        """cols: {column: numpy array | list of strings}."""
        self.wh.append(name, Page.from_dict(cols, device="cpu"))
        self.rwh.append(name, RPage.from_dict(cols))

    def sessions(self, **kw):
        ref = RSession(self.rwh, plan_cache=False, result_cache=False, **kw)
        ref.executor.dynamic_filtering = False
        return Session(self.wh, device="cpu", result_cache=False, **kw), ref

    def query(self, sql, **kw):
        port, ref = self.sessions(**kw)
        got, want = port.query(sql).rows(), ref.query(sql).rows()
        same_rows(got, want)
        return got, port, ref

    def same_files(self, name):
        """Equal manifests, and each file's arrow table equal."""
        ours, theirs = self.wh._manifest[name], self.rwh._manifest[name]
        assert [(e.partition, e.bucket, e.rows) for e in ours] == \
            [(e.partition, e.bucket, e.rows) for e in theirs]
        for a, b in zip(ours, theirs):
            assert papq.read_table(a.path).equals(papq.read_table(b.path)), a.path

    def counters(self):
        return ((self.wh.last_scan_files_read, self.wh.last_scan_files_skipped),
                (self.rwh.last_scan_files_read, self.rwh.last_scan_files_skipped))


@pytest.fixture()
def pair(tmp_path):
    return Pair(tmp_path)


def test_partitioned_write_read_roundtrip(pair):
    rng = np.random.default_rng(0)
    regions = ["east", "north", "south", "west"]
    pair.create("sales", {"region": "varchar", "cust": "bigint", "amount": "bigint"},
                partitioned_by=["region"])
    pair.append("sales", {"region": [regions[i] for i in rng.integers(0, 4, 1000)],
                          "cust": rng.integers(1, 101, 1000),
                          "amount": rng.integers(1, 100_000, 1000)})
    assert pair.wh.row_count("sales") == pair.rwh.row_count("sales") == 1000
    pair.same_files("sales")
    same_rows(pair.wh.page("sales").to_pylist(), pair.rwh.page("sales").to_pylist())
    assert pair.counters() == ((4, 0), (4, 0)) and len(pair.wh._manifest["sales"]) == 4


def test_partition_pruning_skips_files(pair):
    pair.create("ev", {"day": "bigint", "v": "bigint"}, partitioned_by=["day"])
    for day in (1, 2, 3):
        pair.append("ev", {"day": np.full(10, day, np.int64), "v": np.arange(10) + day * 100})
    got, _, _ = pair.query("select count(*) c, sum(v) s from ev where day = 2",
                           streaming=True, batch_rows=8)
    assert got == [(10, sum(range(200, 210)))]
    assert pair.counters() == ((1, 2), (1, 2))
    pair.query("select count(*) from ev where day > 1", streaming=True, batch_rows=8)
    assert pair.counters() == ((2, 1), (2, 1))


def test_bucketed_write_places_rows_deterministically(pair):
    pair.create("b", {"k": "bigint", "v": "bigint"}, bucketed_by=["k"], bucket_count=4)
    pair.append("b", {"k": np.arange(100, dtype=np.int64), "v": np.arange(100)})
    pair.same_files("b")
    seen, total = set(), 0
    for bkt in range(4):
        ranges = pair.wh.bucket_row_ranges("b", bkt)
        assert ranges == pair.rwh.bucket_row_ranges("b", bkt)
        for lo, hi in ranges:
            ks = [r[0] for r in pair.wh.scan("b", lo, hi).to_pylist()]
            assert (bucket_of_values([np.array(ks)], 4) == bkt).all()
            seen.update(ks)
            total += len(ks)
    assert total == 100 and len(seen) == 100


def test_bucket_of_values_equals_reference():
    rng = np.random.default_rng(9)
    ints = rng.integers(-(1 << 62), 1 << 62, 2003)
    strs = [f"key-{i}" for i in rng.integers(0, 500, 2000)] + ["", "é", None]
    for count in (1, 4, 7, 8, 64):
        assert (bucket_of_values([ints], count) == r_bucket_of_values([list(ints)], count)).all()
        assert (bucket_of_values([strs], count) == r_bucket_of_values([strs], count)).all()
        both = [ints, strs]
        assert (bucket_of_values(both, count) == r_bucket_of_values(both, count)).all()


def test_bucket_keys_of_every_kind_place_rows_as_reference(pair):
    """A write partitioned on a string and bucketed on a nullable integer,
    a double and a decimal column puts every row in the JAX package's
    file."""
    rng = np.random.default_rng(4)
    n = 600
    null = rng.random(n) < 0.1
    schema = {"s": "varchar", "k": "bigint", "f": "double", "x": "decimal(12,2)"}
    pair.create("kinds", schema, partitioned_by=["s"], bucketed_by=["k", "f", "x"],
                bucket_count=5)
    k, f, x = rng.integers(0, 50, n), rng.integers(0, 40, n) / 8, \
        rng.integers(-10 ** 6, 10 ** 6, n)
    s = [f"p{i}" for i in rng.integers(0, 3, n)]
    pair.wh.append("kinds", Page.from_dict({
        "s": s, "k": Block.from_numpy(k, T.BIGINT, ~null, device="cpu"),
        "f": f, "x": (x, T.DecimalType(12, 2))}, device="cpu"))
    pair.rwh.append("kinds", RPage.from_dict({
        "s": s, "k": RBlock.from_numpy(k, RT.BIGINT, ~null),
        "f": f, "x": (x, RT.DecimalType(12, 2))}))
    pair.same_files("kinds")


def _oracle(tables, sql):
    conn = sqlite3.connect(":memory:")
    for name, cols in tables.items():
        conn.execute(f"create table {name} ({', '.join(cols)})")
        conn.executemany(f"insert into {name} values ({', '.join('?' * len(cols))})",
                         list(zip(*[c.tolist() for c in cols.values()])))
    return [tuple(r) for r in conn.execute(sql).fetchall()]


def test_bucketed_colocated_join_oracle(pair):
    for t in ("fact", "dim"):
        pair.create(t, {"k": "bigint", f"{t}_v": "bigint"}, bucketed_by=["k"], bucket_count=4)
    rng = np.random.default_rng(3)
    fact = {"k": rng.integers(1, 50, 500), "fact_v": rng.integers(0, 1000, 500)}
    dim = {"k": np.arange(1, 50, dtype=np.int64), "dim_v": np.arange(1, 50, dtype=np.int64) * 7}
    pair.append("fact", fact)
    pair.append("dim", dim)
    sql = ("select dim.k, count(*) c, sum(fact_v + dim_v) s from fact, dim "
           "where fact.k = dim.k group by dim.k order by dim.k")
    got, port, ref = pair.query(sql, streaming=True, batch_rows=128)
    assert got == _oracle({"fact": fact, "dim": dim}, sql)
    assert "grouped_bucket_join" in port.executor.spill_events
    assert "grouped_bucket_join" in ref.executor.spill_events


def test_pruning_visible_in_explain_analyze(pair):
    pair.create("ev2", {"day": "bigint", "v": "bigint"}, partitioned_by=["day"])
    for day in (1, 2, 3, 4):
        pair.append("ev2", {"day": np.full(6, day, np.int64), "v": np.arange(6)})
    port, ref = pair.sessions(streaming=True, batch_rows=4)
    sql = "select sum(v) from ev2 where day = 3"
    for txt in (port.explain_analyze(sql), ref.explain_analyze(sql)):
        assert "files: 1 read, 3 pruned" in txt, txt


def test_grouped_join_bounds_memory(pair):
    """The build side exceeds the device budget as a whole but fits
    bucket by bucket: grouped execution carries the join."""
    for t in ("f2", "d2"):
        pair.create(t, {"k": "bigint", f"{t}_v": "bigint"}, bucketed_by=["k"], bucket_count=8)
    n = 4000
    rng = np.random.default_rng(5)
    pair.append("f2", {"k": rng.integers(1, 2000, n), "f2_v": rng.integers(0, 9, n)})
    pair.append("d2", {"k": np.arange(1, 2001, dtype=np.int64),
                       "d2_v": np.arange(1, 2001, dtype=np.int64) * 3})
    got, port, ref = pair.query("select count(*) c, sum(f2_v + d2_v) s from f2, d2 "
                                "where f2.k = d2.k", streaming=True, batch_rows=512,
                                memory_budget=3 << 20)
    assert got[0][0] == n
    assert "grouped_bucket_join" in port.executor.spill_events
    assert "grouped_bucket_join" in ref.executor.spill_events


def test_metastore_survives_reopen(pair):
    pair.create("p", {"d": "bigint", "v": "bigint"}, partitioned_by=["d"], bucketed_by=["v"],
                bucket_count=2)
    pair.append("p", {"d": np.array([1, 1, 2]), "v": np.array([7, 8, 9])})
    # each package reopens its own warehouse and the other's
    for root in (pair.wh.root, pair.rwh.root):
        wh2 = HiveCatalog(root, device="cpu")
        assert wh2.table_names() == ["p"] and wh2.bucketing("p") == (("v",), 2)
        assert wh2.row_count("p") == 3
        same_rows(wh2.page("p").to_pylist(), RHiveCatalog(root).page("p").to_pylist(),
                  ordered=False)


def test_scaled_writers(pair):
    pair.create("sw", {"p": "bigint", "v": "bigint"}, partitioned_by=["p"])
    pair.append("sw", {"p": np.arange(4) % 4, "v": np.arange(4)})
    assert pair.wh.last_write_writers == pair.rwh.last_write_writers == 1
    n = 60_000
    rng = np.random.default_rng(1)
    pair.append("sw", {"p": rng.integers(0, 8, n), "v": rng.integers(0, 100, n)})
    assert pair.wh.last_write_writers == pair.rwh.last_write_writers > 1
    assert pair.wh.row_count("sw") == n + 4
    pair.same_files("sw")
    pair.query("select sum(v) from sw")


@pytest.mark.parametrize("bucket_cols, grouped", [(("k2", "j1"), False), (("k1", "j1"), True)])
def test_bucket_key_pairing(pair, bucket_cols, grouped):
    """A multi-key join takes the grouped bucket join only when the two
    bucket columns pair at one equi-key index (crossed keys would drop
    matches)."""
    lb, rb = bucket_cols
    pair.create("xl", {"k1": "bigint", "k2": "bigint", "lv": "bigint"}, bucketed_by=[lb],
                bucket_count=4)
    pair.create("xr", {"j1": "bigint", "j2": "bigint", "rv": "bigint"}, bucketed_by=[rb],
                bucket_count=4)
    rng = np.random.default_rng(11)
    xl = {"k1": rng.integers(1, 20, 300), "k2": rng.integers(1, 20, 300),
          "lv": np.arange(300, dtype=np.int64)}
    xr = {"j1": rng.integers(1, 20, 120), "j2": rng.integers(1, 20, 120),
          "rv": np.arange(120, dtype=np.int64)}
    pair.append("xl", xl)
    pair.append("xr", xr)
    sql = ("select count(*) c, sum(lv + rv) s from xl, xr "
           "where xl.k1 = xr.j1 and xl.k2 = xr.j2")
    got, port, ref = pair.query(sql, streaming=True, batch_rows=64)
    assert got == _oracle({"xl": xl, "xr": xr}, sql)
    assert ("grouped_bucket_join" in port.executor.spill_events) == grouped
    assert ("grouped_bucket_join" in ref.executor.spill_events) == grouped


# -- warehouses crossing packages: TPC-H at SF 0.005 --

Q12_MAIL = ("select o_orderpriority, count(*) c from orders, lineitem_by_mode "
            "where o_orderkey = l_orderkey and l_shipmode = 'MAIL' "
            "and l_commitdate < l_receiptdate and l_shipdate < l_commitdate "
            "group by o_orderpriority order by o_orderpriority")
JOIN_GROUP = ("select o_orderpriority, l_returnflag, count(*) c, sum(l_quantity) q, "
              "sum(o_totalprice) p from orders, lineitem where o_orderkey = l_orderkey "
              "group by o_orderpriority, l_returnflag order by o_orderpriority, l_returnflag")
CUSTOMER = ("select c_mktsegment, count(*) c, sum(c_acctbal) b, min(c_custkey) k "
            "from customer where c_nationkey < 10 group by c_mktsegment order by c_mktsegment")


def _create(wh, name, page, **kw):
    wh.create_partitioned_table(name, {n: b.type for n, b in zip(page.names, page.blocks)},
                                **kw)
    wh.append(name, page)


def _customer(wh, page):
    _create(wh, "customer", page, partitioned_by=["c_mktsegment"], bucketed_by=["c_custkey"],
            bucket_count=4)


@pytest.fixture(scope="module")
def warehouses(tmp_path_factory):
    """The port's warehouse: orders and lineitem bucketed on the order
    key, lineitem partitioned by ship mode, customer partitioned by
    segment and bucketed on its key; the JAX package's: customer alike
    (its writer cannot write a DATE column, ROADMAP queue 3)."""
    root = tmp_path_factory.mktemp("wh")
    tpch = TpchCatalog(0.005, device="cpu")
    wh = HiveCatalog(str(root / "port"), device="cpu")
    _create(wh, "orders", tpch.page("orders"), bucketed_by=["o_orderkey"], bucket_count=4)
    _create(wh, "lineitem", tpch.page("lineitem"), bucketed_by=["l_orderkey"], bucket_count=4)
    _create(wh, "lineitem_by_mode", tpch.page("lineitem"), partitioned_by=["l_shipmode"])
    _customer(wh, tpch.page("customer"))
    _customer(RHiveCatalog(str(root / "ref")), RTpchCatalog(0.005).page("customer"))
    return root


def test_warehouses_equal_file_for_file(warehouses):
    ours = HiveCatalog(str(warehouses / "port"), device="cpu")._manifest["customer"]
    theirs = RHiveCatalog(str(warehouses / "ref"))._manifest["customer"]
    assert [(e.partition, e.bucket, e.rows) for e in ours] == \
        [(e.partition, e.bucket, e.rows) for e in theirs]
    for a, b in zip(ours, theirs):
        assert papq.read_table(a.path).equals(papq.read_table(b.path))


@pytest.mark.parametrize("streaming", [False, True])
def test_each_package_reads_the_others_warehouse(warehouses, streaming):
    kw = dict(result_cache=False, streaming=streaming, batch_rows=2048)
    theirs = Session(HiveCatalog(str(warehouses / "ref"), device="cpu"), device="cpu", **kw)
    ours = Session(HiveCatalog(str(warehouses / "port"), device="cpu"), device="cpu", **kw)
    ref = RSession(RHiveCatalog(str(warehouses / "port")), plan_cache=False, **kw)
    ref.executor.dynamic_filtering = False
    same_rows(theirs.query(CUSTOMER).rows(), ref.query(CUSTOMER).rows())
    for sql in (Q12_MAIL, JOIN_GROUP):
        same_rows(ours.query(sql).rows(), ref.query(sql).rows())
    if streaming:
        assert "grouped_bucket_join" in ours.executor.spill_events
        assert "grouped_bucket_join" in ref.executor.spill_events
        for txt in (ours.explain_analyze(Q12_MAIL), ref.explain_analyze(Q12_MAIL)):
            assert "files: 1 read, 6 pruned" in txt, txt


def test_dates_round_trip_through_the_warehouse(pair):
    """The port writes and reads DATE columns of a warehouse table, and the
    JAX package reads them back; the JAX package's own writer raises
    TypeError on a DATE column (ROADMAP queue 3)."""
    days = np.array([0, 9000, -5, 10957], np.int32)
    pair.create("d", {"k": "bigint", "d": "date"}, partitioned_by=["k"])
    pair.wh.append("d", Page.from_dict({"k": np.arange(4) % 2, "d": (days, T.DATE)},
                                       device="cpu"))
    want = [(int(k), np.datetime64("1970-01-01") + np.timedelta64(int(v), "D"))
            for k, v in zip(np.arange(4) % 2, days)]
    same_rows(Session(pair.wh, device="cpu").query("select k, d from d order by d").rows(),
              sorted(want, key=lambda r: r[1]))
    same_rows(RHiveCatalog(pair.wh.root).page("d").to_pylist(),
              pair.wh.page("d").to_pylist())
    with pytest.raises(TypeError):
        pair.rwh.append("d", RPage.from_dict({"k": np.arange(4) % 2, "d": (days, RT.DATE)}))


def test_grouped_max_over_varchar_decodes(pair):
    """A grouped max over a varchar column of a warehouse table gives the
    strings in the port; the JAX package gives their dictionary codes
    (ROADMAP queue 3)."""
    pair.create("g", {"k": "bigint", "s": "varchar"}, partitioned_by=["k"])
    pair.append("g", {"k": np.array([1, 1, 2, 2]), "s": ["b", "a", "d", "c"]})
    port, ref = pair.sessions()
    sql = "select k, max(s) from g group by k order by k"
    assert [(k, str(v)) for k, v in port.query(sql).rows()] == [(1, "b"), (2, "d")]
    assert all(isinstance(v, (int, np.integer)) for _k, v in ref.query(sql).rows())
