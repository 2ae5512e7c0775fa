"""The Parquet connector of presto_tpu_torch (connectors/parquet.py) and
the file writers on the CPU, held to the JAX package: the cases of
tests/test_parquet.py (schema round trip, the four queries, a streaming
scan, row-group pruning, a pruned streaming query) and
tests/test_file_writers.py (CTAS, CREATE/INSERT/DELETE, a CTAS from a
computation, DROP, decimals; for Parquet and ORC), each through both
packages on the same input, rows compared exactly (doubles within the
oracle's tolerance, chip_smoke.row_diff). Files cross over: the port reads
the JAX package's files and the JAX package reads the port's, with equal
arrow schemas and equal tables; every type, NULLs and long decimals
included. Also: TIMESTAMP columns keep their type through the port's
writer (the JAX package's page_to_arrow writes them as int64, ROADMAP
queue 3)."""

import decimal

import numpy as np
import pyarrow.parquet as papq
import pytest
import torch

import chip_smoke
from presto_tpu.connectors.memory import MemoryCatalog as RMemoryCatalog
from presto_tpu.connectors.orc import OrcCatalog as ROrcCatalog
from presto_tpu.connectors.parquet import ParquetCatalog as RParquetCatalog
from presto_tpu.connectors.parquet import page_to_arrow as r_page_to_arrow
from presto_tpu.connectors.parquet import write_table_parquet as r_write
from presto_tpu.connectors.tpch import TpchCatalog as RTpchCatalog
from presto_tpu.page import Page as RPage
from presto_tpu.session import Session as RSession
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.memory import MemoryCatalog
from presto_tpu_torch.connectors.orc import OrcCatalog
from presto_tpu_torch.connectors.parquet import ParquetCatalog, page_to_arrow, write_table_parquet
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.page import Page
from presto_tpu_torch.session import Session

# one torch thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

SF = 0.002
TABLES = ["nation", "region", "customer", "orders", "lineitem"]


def same_rows(got, want, ordered=True):
    diff = chip_smoke.row_diff(got, want, ordered)
    assert diff is None, diff


def port_session(cat, **kw):
    return Session(cat, device="cpu", result_cache=False, **kw)


def ref_session(cat, **kw):
    sess = RSession(cat, plan_cache=False, result_cache=False, **kw)
    sess.executor.dynamic_filtering = False
    return sess


@pytest.fixture(scope="module")
def catalogs(tmp_path_factory):
    """The same TPC-H tables written by each package (row groups of 300);
    the port over the JAX package's files and the JAX package over the
    port's."""
    tmp = tmp_path_factory.mktemp("pq")
    tpch, rtpch = TpchCatalog(SF, device="cpu"), RTpchCatalog(sf=SF)
    ours, theirs = {}, {}
    for t in TABLES:
        ours[t] = str(tmp / f"port_{t}.parquet")
        theirs[t] = str(tmp / f"ref_{t}.parquet")
        write_table_parquet(tpch.page(t), ours[t], row_group_size=300)
        r_write(rtpch.page(t), theirs[t], row_group_size=300)
    unique = {t: tpch.unique_columns(t) for t in TABLES}
    return {"tpch": tpch, "ours": ours, "theirs": theirs,
            "port": ParquetCatalog(theirs, unique=unique, device="cpu"),
            "ref": RParquetCatalog(ours, unique=unique)}


def test_files_cross_over(catalogs):
    """Each package's file holds the same arrow schema and table."""
    for t in TABLES:
        a, b = papq.read_table(catalogs["ours"][t]), papq.read_table(catalogs["theirs"][t])
        assert a.schema.equals(b.schema), t
        assert a.equals(b), t


def test_schema_round_trip(catalogs):
    tpch, port, ref = catalogs["tpch"], catalogs["port"], catalogs["ref"]
    for t in TABLES:
        ours = port.schema(t)
        assert {c: str(v) for c, v in ours.items()} == {c: str(v)
                                                       for c, v in ref.schema(t).items()}
        for c, typ in tpch.schema(t).items():
            if isinstance(typ, T.VarcharType):
                assert isinstance(ours[c], T.VarcharType)
            else:
                assert ours[c] == typ, (t, c, ours[c], typ)
        assert port.exact_row_count(t) == ref.exact_row_count(t) == int(tpch.page(t).count)


QUERIES = [
    "select n_name, r_name from nation, region where n_regionkey = r_regionkey "
    "order by n_name",
    "select o_orderpriority, count(*) c, sum(o_totalprice) s from orders "
    "group by o_orderpriority order by o_orderpriority",
    "select l_returnflag, l_linestatus, sum(l_quantity) q, "
    "avg(l_extendedprice) a, count(*) n from lineitem "
    "where l_shipdate <= date '1998-09-02' "
    "group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus",
    "select c_mktsegment, count(*) from customer group by c_mktsegment "
    "order by c_mktsegment",
]


@pytest.mark.parametrize("i", range(len(QUERIES)))
def test_queries_match_reference(catalogs, i):
    got = port_session(catalogs["port"]).query(QUERIES[i]).rows()
    want = ref_session(catalogs["ref"]).query(QUERIES[i]).rows()
    same_rows(got, want)
    same_rows(got, port_session(catalogs["tpch"]).query(QUERIES[i]).rows())


def test_streaming_from_parquet(catalogs):
    sql = QUERIES[2]
    got = port_session(catalogs["port"], streaming=True, batch_rows=256).query(sql).rows()
    same_rows(got, ref_session(catalogs["ref"], streaming=True, batch_rows=256).query(sql).rows())


def test_row_group_pruning(catalogs):
    port, ref = catalogs["port"], catalogs["ref"]
    total = port.exact_row_count("orders")
    pred = [("o_orderkey", "le", 50)]
    pruned = port.scan("orders", 0, total, predicate=pred)
    rpruned = ref.scan("orders", 0, total, predicate=pred)
    assert int(pruned.count) == int(rpruned.count) < total
    assert pruned.to_pylist() == rpruned.to_pylist()
    kept = {r[0] for r in pruned.select(["o_orderkey"]).to_pylist()}
    full = port.scan("orders", 0, total).select(["o_orderkey"]).to_pylist()
    assert {r[0] for r in full if r[0] <= 50} <= kept


def test_pruned_streaming_query_correct(catalogs):
    sql = "select count(*) c, sum(o_totalprice) s from orders where o_orderkey <= 100"
    got = port_session(catalogs["port"], streaming=True, batch_rows=256).query(sql).rows()
    same_rows(got, ref_session(catalogs["ref"], streaming=True, batch_rows=256).query(sql).rows())


def _all_types(n=500, seed=3):
    """Seeded columns of every type the bridge maps, NULLs in each."""
    rng = np.random.default_rng(seed)
    null = rng.random(n) < 0.2
    lanes = np.stack([rng.integers(-(1 << 40), 1 << 40, n), rng.integers(0, 1 << 32, n)], 1)
    return {
        "i64": rng.integers(-(1 << 50), 1 << 50, n),
        "i32": (rng.integers(-1000, 1000, n).astype(np.int32), "integer"),
        "f": rng.normal(size=n),
        "b": (rng.random(n) < 0.5, "boolean"),
        "s": ([None if z else f"w{k}" for z, k in zip(null, rng.integers(0, 40, n))], None),
        "dec": (rng.integers(-10 ** 12, 10 ** 12, n), "decimal(15,2)"),
        "ldec": (lanes, "decimal(30,4)"),
        "dt": (rng.integers(-3000, 20000, n).astype(np.int32), "date"),
    }, null


def _pages(cols, null):
    """(port page, JAX page) of the same columns, NULL where `null`."""
    from presto_tpu import types as RT
    from presto_tpu.page import Block as RBlock

    from presto_tpu_torch.page import Block

    port, ref = {}, {}
    for name, spec in cols.items():
        if isinstance(spec, tuple) and spec[1] is None:
            port[name] = spec[0]
            ref[name] = spec[0]
            continue
        arr, typ = spec if isinstance(spec, tuple) else (spec, None)
        if typ is None:
            port[name], ref[name] = arr, arr
            continue
        port[name] = Block.from_numpy(arr, T.parse_type(typ), ~null, device="cpu")
        ref[name] = RBlock.from_numpy(arr, RT.parse_type(typ), ~null)
    return Page.from_dict(port, device="cpu"), RPage.from_dict(ref)


def test_every_type_crosses_over(tmp_path):
    cols, null = _all_types()
    page, rpage = _pages(cols, null)
    ours, theirs = str(tmp_path / "ours.parquet"), str(tmp_path / "theirs.parquet")
    write_table_parquet(page, ours)
    r_write(rpage, theirs)
    a, b = papq.read_table(ours), papq.read_table(theirs)
    assert a.schema.equals(b.schema) and a.equals(b)
    want = rpage.to_pylist()
    assert page.to_pylist() == want
    assert ParquetCatalog({"t": theirs}, device="cpu").page("t").to_pylist() == want
    assert RParquetCatalog({"t": ours}).page("t").to_pylist() == want


def test_timestamp_keeps_its_type(tmp_path):
    """The port writes TIMESTAMP as timestamp[us] and reads it back as
    TIMESTAMP; the JAX package's page_to_arrow writes the column's int64
    storage, which reads back as BIGINT (ROADMAP queue 3)."""
    from presto_tpu import types as RT
    from presto_tpu.page import Block as RBlock

    from presto_tpu_torch.page import Block

    us = np.array([0, 1_600_000_000_000_000, -5], np.int64)
    page = Page.from_dict({"ts": Block.from_numpy(us, T.TIMESTAMP, device="cpu")},
                          device="cpu")
    assert str(page_to_arrow(page).schema.field("ts").type) == "timestamp[us]"
    path = str(tmp_path / "ts.parquet")
    write_table_parquet(page, path)
    back = ParquetCatalog({"t": path}, device="cpu")
    assert back.schema("t") == {"ts": T.TIMESTAMP}
    assert back.page("t").to_pylist() == page.to_pylist()
    ref_type = r_page_to_arrow(RPage.from_dict({"ts": RBlock.from_numpy(us, RT.TIMESTAMP)}))
    assert str(ref_type.schema.field("ts").type) == "int64"


# -- the file writers (tests/test_file_writers.py), Parquet and ORC --

WRITERS = {"parquet": (ParquetCatalog, RParquetCatalog), "orc": (OrcCatalog, ROrcCatalog)}


def writer_pair(kind, tmp_path):
    """(port catalog, JAX catalog), each writing into a directory of its
    own, and a maker of fresh catalogs over a package's files."""
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    ours.mkdir()
    theirs.mkdir()
    cls, rcls = WRITERS[kind]
    return cls({}, directory=str(ours), device="cpu"), rcls({}, directory=str(theirs))


@pytest.mark.parametrize("kind", list(WRITERS))
def test_ctas_roundtrip(kind, tmp_path):
    cat, rcat = writer_pair(kind, tmp_path)
    sql = ("create table t as select * from (values "
           "(1, 'alpha', 1.5, date '2021-03-04'), "
           "(2, 'beta', -2.25, date '1999-12-31'), "
           "(3, null, null, null)) v(k, name, x, d)")
    port_session(cat).query(sql)
    ref_session(rcat).query(sql)
    read = "select k, name, x, d from t order by k"
    cls, rcls = WRITERS[kind]
    # a FRESH catalog over each package's files, read by the other
    got = port_session(cls(dict(rcat.paths), device="cpu")).query(read).rows()
    want = ref_session(rcls(dict(cat.paths))).query(read).rows()
    same_rows(got, want)
    assert len(got) == 3 and got[2][1] is None and got[2][2] is None


@pytest.mark.parametrize("kind", list(WRITERS))
def test_create_insert_delete(kind, tmp_path):
    cat, rcat = writer_pair(kind, tmp_path)
    outs = []
    for c, mk in ((cat, port_session), (rcat, ref_session)):
        s = mk(c)
        s.query("create table ev (id bigint, tag varchar)")
        assert s.query("select count(*) c from ev").rows() == [(0,)]
        s.query("insert into ev values (1, 'a'), (2, 'b'), (3, 'a')")
        s.query("insert into ev values (4, 'c')")
        assert s.query("select count(*) c from ev").rows() == [(4,)]
        s.query("delete from ev where tag = 'a'")
        outs.append(s.query("select id, tag from ev order by id").rows())
    assert outs[0] == outs[1] == [(2, "b"), (4, "c")]


@pytest.mark.parametrize("kind", list(WRITERS))
def test_ctas_from_computation(kind, tmp_path):
    rng = np.random.default_rng(5)
    cols = {"g": rng.integers(0, 7, 5000).astype(np.int64),
            "v": rng.integers(0, 1000, 5000).astype(np.int64)}
    sql = "select g, sum(v) s, count(*) n from src group by g"
    summary = port_session(MemoryCatalog({"src": Page.from_dict(cols, device="cpu")},
                                         device="cpu")).query(sql)
    rsummary = ref_session(RMemoryCatalog({"src": RPage.from_dict(cols)})).query(sql)
    cat, rcat = writer_pair(kind, tmp_path)
    cat.create_table_from_page("summary", summary.page)
    rcat.create_table_from_page("summary", rsummary.page)
    read = "select g, s, n from summary order by g"
    same_rows(port_session(cat).query(read).rows(), ref_session(rcat).query(read).rows())


@pytest.mark.parametrize("kind", list(WRITERS))
def test_transaction_scans_read_only_their_columns(kind, tmp_path):
    """Inside a transaction a scan of an unwritten file table still asks
    the file catalog for its columns only; a staged table reads its staged
    page. Rows equal the JAX package's."""
    cat, rcat = writer_pair(kind, tmp_path)
    sql = ("create table t as select * from (values (1, 'a', 1.5), (2, 'b', 2.5), "
           "(3, 'a', 4.0)) v(k, tag, x)")
    outs = []
    for c, mk in ((cat, port_session), (rcat, ref_session)):
        s = mk(c)
        s.query(sql)
        s.query("create table u (k bigint)")
        s.query("start transaction")
        s.query("insert into u values (7)")
        if c is cat:  # the INSERT read u whole; the reads below must not
            asked = []
            inner = cat.page_columns
            cat.page = lambda table: pytest.fail(f"whole page of {table} read")
            cat.page_columns = lambda table, cols: asked.append(list(cols)) or inner(table, cols)
        outs.append((s.query("select tag, sum(k) from t group by tag order by tag").rows(),
                     s.query("select k from u").rows()))
        s.query("commit")
    assert outs[0] == outs[1] == ([("a", 4), ("b", 2)], [(7,)])
    assert asked == [["k", "tag"]] or asked == [["tag", "k"]]


@pytest.mark.parametrize("kind", list(WRITERS))
def test_drop_table_removes_file(kind, tmp_path):
    import os

    cat, _ = writer_pair(kind, tmp_path)
    s = port_session(cat)
    s.query("create table gone (a bigint)")
    path = cat.paths["gone"]
    assert os.path.exists(path)
    s.query("drop table gone")
    assert not os.path.exists(path) and "gone" not in cat.table_names()


def test_decimal_roundtrip_parquet(tmp_path):
    cat, rcat = writer_pair("parquet", tmp_path)
    sql = "create table d as select * from (values (12345.67), (-0.01)) v(x)"
    port_session(cat).query(sql)
    ref_session(rcat).query(sql)
    got = port_session(ParquetCatalog(dict(rcat.paths), device="cpu")).query(
        "select x from d order by x").rows()
    want = ref_session(RParquetCatalog(dict(cat.paths))).query("select x from d order by x").rows()
    assert got == want == [(decimal.Decimal("-0.01"),), (decimal.Decimal("12345.67"),)]
