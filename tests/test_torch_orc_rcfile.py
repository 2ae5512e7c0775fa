"""The ORC and RCFile connectors of presto_tpu_torch (connectors/orc.py,
connectors/rcfile.py) on the CPU, held to the JAX package: the cases of
tests/test_orc.py (schema and counts, three queries, a streaming scan,
stripe pruning through the stats sidecar) and tests/test_rcfile.py (the
round trip of every type, ranged and projected scans, files of several
row groups, SQL, CTAS/INSERT/DELETE), each through both packages on the
same input. Files cross over: ORC files, their `.stats.json` sidecars and
RCFile files written by either package read in the other with equal
rows; the RCFile bytes are identical. Equal stripe counters
(`last_scan_files_read` / `_skipped`) and EXPLAIN ANALYZE's `files: ...
pruned` line in both packages."""

import filecmp

import numpy as np
import pytest
import torch

import chip_smoke
from presto_tpu import types as RT
from presto_tpu.connectors.orc import OrcCatalog as ROrcCatalog
from presto_tpu.connectors.orc import write_table_orc as r_write_orc
from presto_tpu.connectors.rcfile import RcFileCatalog as RRcFileCatalog
from presto_tpu.connectors.tpch import TpchCatalog as RTpchCatalog
from presto_tpu.page import Page as RPage
from presto_tpu.session import Session as RSession
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.orc import OrcCatalog, write_table_orc
from presto_tpu_torch.connectors.rcfile import RcFileCatalog
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.page import Page
from presto_tpu_torch.session import Session

# one torch thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

SF = 0.002
TABLES = ["nation", "region", "orders", "lineitem"]


def same_rows(got, want, ordered=True):
    diff = chip_smoke.row_diff(got, want, ordered)
    assert diff is None, diff


def port_session(cat, **kw):
    return Session(cat, device="cpu", result_cache=False, **kw)


def ref_session(cat, **kw):
    sess = RSession(cat, plan_cache=False, result_cache=False, **kw)
    sess.executor.dynamic_filtering = False
    return sess


# -- ORC (tests/test_orc.py) --

@pytest.fixture(scope="module")
def orc(tmp_path_factory):
    """Each package's ORC files of the same TPC-H tables (16 KiB stripes);
    the port over the JAX package's files and the JAX package over the
    port's."""
    tmp = tmp_path_factory.mktemp("orc")
    tpch, rtpch = TpchCatalog(SF, device="cpu"), RTpchCatalog(sf=SF)
    ours, theirs = {}, {}
    for t in TABLES:
        ours[t], theirs[t] = str(tmp / f"port_{t}.orc"), str(tmp / f"ref_{t}.orc")
        write_table_orc(tpch.page(t), ours[t], stripe_size=1 << 14)
        r_write_orc(rtpch.page(t), theirs[t], stripe_size=1 << 14)
    unique = {t: tpch.unique_columns(t) for t in TABLES}
    return {"tpch": tpch, "ours": ours, "theirs": theirs,
            "port": OrcCatalog(theirs, unique=unique, device="cpu"),
            "ref": ROrcCatalog(ours, unique=unique)}


def test_orc_schema_and_counts(orc):
    from pyarrow import orc as paorc

    for t in TABLES:
        assert {c: str(v) for c, v in orc["port"].schema(t).items()} == \
            {c: str(v) for c, v in orc["ref"].schema(t).items()}
        assert set(orc["port"].schema(t)) == set(orc["tpch"].schema(t))
        assert orc["port"].exact_row_count(t) == int(orc["tpch"].page(t).count)
        a, b = paorc.read_table(orc["ours"][t]), paorc.read_table(orc["theirs"][t])
        assert a.schema.equals(b.schema) and a.equals(b), t


ORC_QUERIES = [
    "select n_name, r_name from nation, region where n_regionkey = r_regionkey "
    "order by n_name",
    "select l_returnflag, l_linestatus, sum(l_quantity) q, count(*) n "
    "from lineitem where l_shipdate <= date '1998-09-02' "
    "group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus",
    "select o_orderpriority, sum(o_totalprice) s from orders "
    "group by o_orderpriority order by o_orderpriority",
]


@pytest.mark.parametrize("i", range(len(ORC_QUERIES)))
def test_orc_queries_match_reference(orc, i):
    got = port_session(orc["port"]).query(ORC_QUERIES[i]).rows()
    same_rows(got, ref_session(orc["ref"]).query(ORC_QUERIES[i]).rows())
    same_rows(got, port_session(orc["tpch"]).query(ORC_QUERIES[i]).rows())


def test_streaming_from_orc(orc):
    sql = ORC_QUERIES[1]
    same_rows(port_session(orc["port"], streaming=True, batch_rows=512).query(sql).rows(),
              ref_session(orc["ref"], streaming=True, batch_rows=512).query(sql).rows())


def test_stripe_stats_pruning(tmp_path):
    """Sidecar stripe statistics prune the stripes a predicate refutes
    (reference TupleDomainOrcPredicate); each package's sidecar equals the
    other's, and the counters and EXPLAIN ANALYZE line agree."""
    n = 40_000
    cols = {"k": np.arange(n, dtype=np.int64), "v": np.arange(n) % 97}
    ours, theirs = str(tmp_path / "ours.orc"), str(tmp_path / "theirs.orc")
    write_table_orc(Page.from_dict(cols, device="cpu"), ours, stripe_size=1 << 14)
    r_write_orc(RPage.from_dict(cols), theirs, stripe_size=1 << 14)
    cat, rcat = OrcCatalog({"t": theirs}, device="cpu"), ROrcCatalog({"t": ours})
    stats = cat.stripe_stats("t")
    assert len(stats) > 3 and sum(s["rows"] for s in stats) == n
    assert stats == rcat.stripe_stats("t")
    sql = "select count(*) c, sum(v) s from t where k >= 38000"
    got = port_session(cat, streaming=True, batch_rows=4096).query(sql).rows()
    same_rows(got, ref_session(rcat, streaming=True, batch_rows=4096).query(sql).rows())
    assert got == [(2000, sum(k % 97 for k in range(38000, n)))]
    assert cat.last_scan_files_skipped > 0
    assert (cat.last_scan_files_read, cat.last_scan_files_skipped) == \
        (rcat.last_scan_files_read, rcat.last_scan_files_skipped)
    lines = [[ln for ln in s.explain_analyze(sql).splitlines() if "pruned" in ln]
             for s in (port_session(cat, streaming=True, batch_rows=4096),
                       ref_session(rcat, streaming=True, batch_rows=4096))]
    assert lines[0] and [ln.split("files:")[1] for ln in lines[0]] == \
        [ln.split("files:")[1] for ln in lines[1]]
    # the sidecar round-trips through disk, read by either package
    assert OrcCatalog({"t": theirs}, device="cpu").stripe_stats("t") == stats
    assert ROrcCatalog({"t": theirs}).stripe_stats("t") == stats


# -- RCFile (tests/test_rcfile.py) --

NAMES = ["alpha", "bravo", "charlie", None, "delta"]


def _columns(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    return {"k": np.arange(n, dtype=np.int64),
            "d": (rng.integers(0, 10_000, n), "decimal(10,2)"),
            "s": [NAMES[i % 5] for i in range(n)],
            "f": rng.random(n),
            "b": (rng.integers(0, 2, n).astype(bool), "boolean"),
            "dt": (rng.integers(-400, 20_000, n).astype(np.int32), "date"),
            "i": (rng.integers(-30_000, 30_000, n).astype(np.int32), "integer")}


def _page_pair(cols):
    port = {k: (v[0], T.parse_type(v[1])) if isinstance(v, tuple) else v for k, v in cols.items()}
    ref = {k: (v[0], RT.parse_type(v[1])) if isinstance(v, tuple) else v for k, v in cols.items()}
    return Page.from_dict(port, device="cpu"), RPage.from_dict(ref)


@pytest.fixture()
def rc(tmp_path):
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    cat = RcFileCatalog({}, directory=str(tmp_path / "p"), device="cpu")
    rcat = RRcFileCatalog({}, directory=str(tmp_path / "r"))
    page, rpage = _page_pair(_columns())
    cat.create_table_from_page("t", page)
    rcat.create_table_from_page("t", rpage)
    return cat, rcat


def test_rcfile_bytes_identical_and_cross_read(rc):
    cat, rcat = rc
    assert filecmp.cmp(cat.paths["t"], rcat.paths["t"], shallow=False)
    want = _page_pair(_columns())[1].to_pylist()
    assert cat.page("t").to_pylist() == rcat.page("t").to_pylist() == want
    assert RcFileCatalog({"t": rcat.paths["t"]}, device="cpu").page("t").to_pylist() == want
    assert RRcFileCatalog({"t": cat.paths["t"]}).page("t").to_pylist() == want


def test_rcfile_ranged_scan_and_projection(rc):
    cat, rcat = rc
    pg = cat.scan("t", 100, 160, columns=["k", "s"])
    assert list(pg.names) == ["k", "s"]
    assert pg.to_pylist() == rcat.scan("t", 100, 160, columns=["k", "s"]).to_pylist()
    assert [r[0] for r in pg.to_pylist()] == list(range(100, 160))


def test_rcfile_multi_group_files(tmp_path):
    n = 200_000  # > 2 row groups of 65,536
    cols = {"v": np.arange(n, dtype=np.int64), "s": [f"x{i % 300}" for i in range(n)]}
    cat = RcFileCatalog({}, directory=str(tmp_path), device="cpu")
    cat.create_table_from_page("big", Page.from_dict(cols, device="cpu"))
    rcat = RRcFileCatalog({"big": cat.paths["big"]})
    assert len(cat._read_header("big")["groups"]) >= 3
    assert cat._read_header("big")["groups"] == rcat._read_header("big")["groups"]
    pg = cat.scan("big", 65_530, 65_550)
    assert pg.to_pylist() == rcat.scan("big", 65_530, 65_550).to_pylist()
    assert [r[0] for r in pg.to_pylist()] == list(range(65_530, 65_550))
    assert cat.row_count("big") == n


def test_rcfile_sql(rc):
    cat, rcat = rc
    for sql in ("select s, count(*) c, sum(k) sk from t where s is not null "
                "group by s order by s",
                "select count(*) from t where s is null",
                "select min(dt), max(dt), sum(d), sum(i) from t where b"):
        got = port_session(cat, streaming=True, batch_rows=128).query(sql).rows()
        same_rows(got, ref_session(rcat, streaming=True, batch_rows=128).query(sql).rows())
    assert [r[0] for r in port_session(cat).query(
        "select s from t where s is not null group by s order by s").rows()] == \
        ["alpha", "bravo", "charlie", "delta"]


def test_rcfile_ctas_insert_delete(rc):
    outs = []
    for cat, mk in zip(rc, (port_session, ref_session)):
        sess = mk(cat)
        sess.query("create table t2 as select k, d, s from t where k < 10")
        assert sess.query("select count(*) from t2").rows() == [(10,)]
        sess.query("insert into t2 select k, d, s from t where k between 10 and 14")
        assert sess.query("select count(*) from t2").rows() == [(15,)]
        sess.query("delete from t2 where k >= 12")
        outs.append(sess.query("select k, d, s from t2 order by k").rows())
        sess.query("drop table t2")
        assert "t2" not in cat.table_names()
    assert outs[0] == outs[1] and outs[0][-1][0] == 11
    # the files both packages wrote for t2 before the drop held equal rows


def test_rcfile_long_decimals_round_trip(tmp_path):
    """A long decimal column keeps its two lanes through the port's RCFile
    writer and reader. The JAX package writes one scaled int64 per value:
    a value past 2^63 raises OverflowError, and a long decimal it did
    write reads back as one lane, which raises TypeError (ROADMAP queue
    3)."""
    lanes = np.array([[0, 5], [-1, 4294967295], [1 << 40, 7]], np.int64)
    page = Page.from_dict({"x": (lanes, T.DecimalType(30, 4))}, device="cpu")
    (tmp_path / "p").mkdir()
    cat = RcFileCatalog({}, directory=str(tmp_path / "p"), device="cpu")
    cat.create_table_from_page("l", page)
    assert cat.page("l").to_pylist() == page.to_pylist()
    for rows, err in ((lanes, OverflowError), (lanes[:2], TypeError)):
        rcat = RRcFileCatalog({}, directory=str(tmp_path))
        with pytest.raises(err):
            rcat.create_table_from_page("l", RPage.from_dict(
                {"x": (rows, RT.DecimalType(30, 4))}))
            rcat.page("l").to_pylist()
        rcat.paths.clear()
