"""The catalog store, USE catalog.schema and the blackhole connector of
presto_tpu_torch (server/catalog_store.py, session.py,
connectors/blackhole.py) on the CPU, held to the JAX package: the cases
of tests/test_catalog_store.py (a *.properties directory, qualified and
bare names, a cross-catalog join, bad configurations, a plugin factory)
and tests/test_blackhole.py (writes counted and discarded, CTAS into the
sink, synthetic rows), each through both packages. Every catalog the
store loads lands on the device it was given. `USE hive.default` and then
bare names equal the JAX package's rows; SHOW CATALOGS is the JAX
package's. The store takes no write in either package; a session over
one of its catalogs does, and the store reads the table back. Scans
through the store read only their columns from a file catalog."""

import numpy as np
import pytest
import torch

import chip_smoke
from presto_tpu import types as RT
from presto_tpu.connectors.blackhole import BlackHoleCatalog as RBlackHoleCatalog
from presto_tpu.connectors.hive import HiveCatalog as RHiveCatalog
from presto_tpu.connectors.memory import MemoryCatalog as RMemoryCatalog
from presto_tpu.connectors.spi import WriteError as RWriteError
from presto_tpu.page import Page as RPage
from presto_tpu.server import catalog_store as rstore
from presto_tpu.session import Session as RSession
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.blackhole import BlackHoleCatalog
from presto_tpu_torch.connectors.hive import HiveCatalog
from presto_tpu_torch.connectors.memory import MemoryCatalog
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.page import Page
from presto_tpu_torch.server import catalog_store as store
from presto_tpu_torch.session import Session

# one torch thread: the suite runs in parallel worker processes
torch.set_num_threads(1)


def same_rows(got, want, ordered=True):
    diff = chip_smoke.row_diff(got, want, ordered)
    assert diff is None, diff


def sessions(cat, rcat, **kw):
    ref = RSession(rcat, plan_cache=False, result_cache=False, **kw)
    ref.executor.dynamic_filtering = False
    return Session(cat, device="cpu", result_cache=False, **kw), ref


@pytest.fixture()
def catalog_dir(tmp_path):
    (tmp_path / "tiny.properties").write_text(
        "# the reference's etc/catalog/tpch.properties shape\n"
        "connector.name=tpch\ntpch.scale-factor=0.001\n")
    (tmp_path / "files.properties").write_text(
        f"connector.name=localfile\nlocalfile.data-dir={tmp_path / 'data'}\n")
    data = tmp_path / "data"
    data.mkdir()
    (data / "lookup.csv").write_text("rcode,label\n0,zero\n2,two\n")
    return str(tmp_path)


def test_every_catalog_on_the_given_device(catalog_dir):
    cat = store.load_catalog_store(catalog_dir, device="cpu")
    assert isinstance(cat, store.CatalogStore)
    assert {n: str(c.device) for n, c in cat.catalogs.items()} == {"files": "cpu", "tiny": "cpu"}
    assert store.connector_names() == rstore.connector_names()


@pytest.mark.parametrize("sql", [
    "select count(*) from tiny.region",
    "select count(*) from tiny.default.region",
    "select count(*) from region",
    "select r.r_name, l.label from tiny.region r join files.lookup l "
    "on r.r_regionkey = l.rcode order by r.r_name",
])
def test_load_and_qualified_query(catalog_dir, sql):
    port, ref = sessions(store.load_catalog_store(catalog_dir, device="cpu"),
                         rstore.load_catalog_store(catalog_dir))
    got = port.query(sql).rows()
    same_rows(got, ref.query(sql).rows())
    if "join" in sql:
        assert got == [("AFRICA", "zero"), ("ASIA", "two")]


def test_bad_configs(tmp_path):
    for text, match in (("connector.name=does-not-exist\n", "unknown connector"),
                        ("tpch.scale-factor=1\n", "missing connector.name")):
        (tmp_path / "x.properties").write_text(text)
        for load in (lambda d: store.load_catalog_store(d, device="cpu"),
                     rstore.load_catalog_store):
            with pytest.raises(ValueError, match=match):
                load(str(tmp_path))
    with pytest.raises(ValueError, match="no .*properties"):
        store.load_catalog_store(str(tmp_path / "empty-missing"), device="cpu")


def test_register_connector_plugin(tmp_path):
    """A third-party factory gets the properties and the store's device."""
    seen = []

    def factory(props, device):
        seen.append(device)
        n = int(props.get("rows", "3"))
        return MemoryCatalog({"t": Page.from_dict({"x": np.arange(n, dtype=np.int64)},
                                                  device=device)}, device=device)

    def rfactory(props):
        n = int(props.get("rows", "3"))
        return RMemoryCatalog({"t": RPage.from_dict({"x": np.arange(n, dtype=np.int64)})})

    store.register_connector("unit-test-plugin", factory)
    rstore.register_connector("unit-test-plugin", rfactory)
    assert "unit-test-plugin" in store.connector_names()
    (tmp_path / "p.properties").write_text("connector.name=unit-test-plugin\nrows=4\n")
    port, ref = sessions(store.load_catalog_store(str(tmp_path), device="cpu"),
                         rstore.load_catalog_store(str(tmp_path)))
    assert port.query("select sum(x) from p.t").rows() == \
        ref.query("select sum(x) from p.t").rows() == [(6,)]
    assert seen == [torch.device("cpu")]


# -- USE catalog.schema over a store with a Hive warehouse --

@pytest.fixture()
def hive_dir(tmp_path):
    """Each package's catalog directory: blackhole, hive (TPC-H SF
    0.002's nation in a warehouse of its own, partitioned by region) and
    tpch, loaded in that order."""
    wh = str(tmp_path / "wh")
    tpch = TpchCatalog(0.002, device="cpu")
    hive = HiveCatalog(wh, device="cpu")
    page = tpch.page("nation")
    hive.create_partitioned_table("nation", {n: b.type for n, b in
                                             zip(page.names, page.blocks)},
                                  partitioned_by=["n_regionkey"])
    hive.append("nation", page)
    rhive = RHiveCatalog(str(tmp_path / "rwh"))
    rhive.create_partitioned_table("nation", {n: RT.parse_type(str(b.type)) for n, b in
                                              zip(page.names, page.blocks)},
                                   partitioned_by=["n_regionkey"])
    from presto_tpu.connectors.tpch import TpchCatalog as RTpchCatalog

    rhive.append("nation", RTpchCatalog(0.002).page("nation"))
    d = tmp_path / "cat"
    d.mkdir()
    (d / "blackhole.properties").write_text("connector.name=blackhole\n")
    (d / "hive.properties").write_text(f"connector.name=hive\nhive.warehouse-dir={wh}\n")
    (d / "tpch.properties").write_text("connector.name=tpch\ntpch.scale-factor=0.002\n")
    rd = tmp_path / "rcat"
    rd.mkdir()
    for f in ("blackhole", "tpch"):
        (rd / f"{f}.properties").write_text((d / f"{f}.properties").read_text())
    (rd / "hive.properties").write_text(
        f"connector.name=hive\nhive.warehouse-dir={tmp_path / 'rwh'}\n")
    return str(d), str(rd)


NATION = ("select n_regionkey, count(*) c, sum(n_nationkey) k from nation "
          "group by n_regionkey order by n_regionkey")


def test_use_catalog_then_bare_names(hive_dir):
    port, ref = sessions(store.load_catalog_store(hive_dir[0], device="cpu"),
                         rstore.load_catalog_store(hive_dir[1]))
    for s in (port, ref):
        assert s.query("use hive.default").rows() == [(0,)]
    got = port.query(NATION).rows()
    same_rows(got, ref.query(NATION).rows())
    assert list(port.catalog.catalogs)[0] == "hive"
    assert sum(r[1] for r in got) == 25
    # `USE tpch` (a catalog name alone) makes tpch first
    port.query("use tpch")
    assert list(port.catalog.catalogs)[0] == "tpch"
    same_rows(port.query(NATION).rows(), ref.query(NATION).rows())
    assert port.query("show catalogs").rows() == ref.query("show catalogs").rows()


def test_use_unknown_catalog_raises(hive_dir):
    port, ref = sessions(store.load_catalog_store(hive_dir[0], device="cpu"),
                         rstore.load_catalog_store(hive_dir[1]))
    for s in (port, ref):
        with pytest.raises(ValueError, match="catalog 'nope' does not exist"):
            s.query("use nope.nothere")
    with pytest.raises(ValueError, match="does not exist"):
        Session(TpchCatalog(0.001, device="cpu"), device="cpu").query("use hive.default")


def test_writes_go_to_the_used_catalog(hive_dir):
    """The store takes no write, before or after USE, in both packages; a
    write reaches the used catalog through a session over that catalog,
    and the store reads it back by its bare name after USE."""
    from presto_tpu_torch.connectors.spi import WriteError

    pstore = store.load_catalog_store(hive_dir[0], device="cpu")
    rst = rstore.load_catalog_store(hive_dir[1])
    port, ref = sessions(pstore, rst)
    for s, err in ((port, WriteError), (ref, RWriteError)):
        with pytest.raises(err, match="read-only"):
            s.query("create table x as select 1 a")
        s.query("use hive.default")
        with pytest.raises(err, match="read-only"):
            s.query("create table x as select 1 a")
    ctas = ("create table r_out as select n_regionkey, count(*) c from nation "
            "group by n_regionkey")
    for s in sessions(pstore.catalogs["hive"], rst.catalogs["hive"]):
        assert s.query(ctas).rows() == [(5,)]
    sql = "select n_regionkey, c from r_out order by n_regionkey"
    got = port.query(sql).rows()
    same_rows(got, ref.query(sql).rows())
    assert sum(r[1] for r in got) == 25


def test_store_scans_read_only_their_columns(hive_dir):
    """A materializing scan through the store, bare or qualified, asks the
    owning file catalog for its columns (page_columns), never for the
    whole page."""
    pstore = store.load_catalog_store(hive_dir[0], device="cpu")
    hive = pstore.catalogs["hive"]
    asked = []
    hive.page = lambda table: pytest.fail(f"whole page of {table} read")
    inner = hive.page_columns
    hive.page_columns = lambda table, columns: asked.append(list(columns)) or inner(table, columns)
    port, ref = sessions(pstore, rstore.load_catalog_store(hive_dir[1]))
    for s in (port, ref):
        s.query("use hive.default")
    same_rows(port.query(NATION).rows(), ref.query(NATION).rows())
    q = "select sum(n_nationkey) from hive.default.nation"
    same_rows(port.query(q).rows(), ref.query(q).rows())
    assert asked and all(set(c) <= {"n_regionkey", "n_nationkey"} for c in asked)


# -- blackhole (tests/test_blackhole.py) --

def test_writes_discarded_reads_empty():
    outs = []
    for s in sessions(BlackHoleCatalog(device="cpu"), RBlackHoleCatalog()):
        cat = s.catalog
        s.query("create table sink (k bigint, s varchar)")
        s.query("insert into sink values (1, 'a'), (2, 'b')")
        s.query("insert into sink values (3, 'c')")
        outs.append((cat.rows_written["sink"], s.query("select count(*) from sink").rows(),
                     s.query("select * from sink").rows()))
        s.query("drop table sink")
        assert "sink" not in cat.table_names()
    assert outs[0] == outs[1] == (3, [(0,)], [])


def test_ctas_into_blackhole():
    outs = []
    for s in sessions(BlackHoleCatalog(device="cpu"), RBlackHoleCatalog()):
        s.query("create table src (v bigint)")
        s.catalog.synthetic_rows["src"] = 100
        s.query("create table sink as select v * 2 vv from src")
        outs.append((s.catalog.rows_written["sink"],
                     s.query("select count(*) from sink").rows()))
    assert outs[0] == outs[1] == (100, [(0,)])


def test_synthetic_rows_scan():
    cat = BlackHoleCatalog(synthetic_rows={"gen": 1000}, device="cpu")
    cat.create_table("gen", {"v": T.BIGINT, "s": T.VARCHAR, "x": T.DecimalType(30, 2)})
    rcat = RBlackHoleCatalog(synthetic_rows={"gen": 1000})
    rcat.create_table("gen", {"v": RT.BIGINT, "s": RT.VARCHAR, "x": RT.DecimalType(30, 2)})
    assert str(cat.page("gen").device) == "cpu"
    for kw in ({}, {"streaming": True, "batch_rows": 256}):
        port, ref = sessions(cat, rcat, **kw)
        for sql in ("select count(*) from gen", "select count(*), sum(v), min(s) from gen"):
            same_rows(port.query(sql).rows(), ref.query(sql).rows())
    assert Session(cat, device="cpu").query("select count(*), sum(v) from gen").rows() == \
        [(1000, 0)]
