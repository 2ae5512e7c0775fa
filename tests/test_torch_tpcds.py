"""TPC-DS in presto_tpu_torch (device="cpu"): the connector generates the
JAX package's tables bit for bit, its query texts are the JAX package's,
and a few cheap queries that join and group give the JAX package's rows.

(a) Every column of the 24 tables at SF 0.02 and at SF 0.005: data (dtype
    and values), validity, dictionary and type, against
    presto_tpu/connectors/tpcds.py.
(c) Q3, Q7, Q19, Q42, Q52, Q55 and Q96 through both packages'
    Session.query at SF 0.02, row for row (chip_smoke.row_diff: doubles
    within the oracle's tolerance, everything else exact); the reference
    session runs without its dynamic filters, which only prune rows. Q3
    selects no row at this SF (no item of i_manufact_id 128 sells in a
    November), so it is a weak check; the other six must return rows.

(b) All 103 texts against the SQLite oracle are held in
    test_torch_tpcds_oracle_a.py, _b.py and _c.py, through the fixture and
    check defined here.
"""

import functools

import numpy as np
import pytest
import torch

import chip_smoke
from presto_tpu.benchmark import tpcds_sql as rsql
from presto_tpu.connectors import tpcds as rtpcds
from presto_tpu.session import Session as RSession
from presto_tpu_torch.benchmark import tpcds_sql
from presto_tpu_torch.connectors import tpcds
from presto_tpu_torch.session import Session

# one torch thread: the suite runs in parallel worker processes
# (pytest-xdist), and a thread per core in each oversubscribes the host
torch.set_num_threads(1)

SF = 0.02
PARITY = (3, 7, 19, 42, 52, 55, 96)
QIDS = sorted(tpcds_sql.QUERIES)


def test_texts_are_the_reference_texts():
    assert tpcds_sql.QUERIES == rsql.QUERIES and len(tpcds_sql.QUERIES) == 103


@pytest.mark.parametrize("sf", [SF, 0.005])
@pytest.mark.parametrize("name", tpcds.TABLE_NAMES)
def test_table_is_bit_identical(name, sf):
    assert tpcds.TABLE_NAMES == rtpcds.TABLE_NAMES
    got, want = tpcds.table(name, sf), rtpcds.table(name, sf)
    assert list(got.columns) == list(want.columns)
    for cname, c in got.columns.items():
        w = want.columns[cname]
        assert str(c.type) == str(w.type), cname
        assert c.data.dtype == w.data.dtype and np.array_equal(c.data, w.data), cname
        assert (c.valid is None) == (w.valid is None), cname
        assert c.valid is None or np.array_equal(c.valid, w.valid), cname
        assert (c.dictionary is None) == (w.dictionary is None), cname
        assert c.dictionary is None or tuple(c.dictionary) == tuple(w.dictionary), cname


def test_catalog_pages_on_its_device():
    cat = tpcds.TpcdsCatalog(0.005, device="cpu")
    twin = cat.with_device("cpu")
    assert twin.host_table("store") is cat.host_table("store")
    assert cat.row_count("store_sales") == int(2_880_404 * 0.005)
    pg = cat.page("store_sales")
    assert int(pg.count) == cat.exact_row_count("store_sales")
    assert all(str(b.data.device) == "cpu" for b in pg.blocks)
    assert cat.page("store_sales") is pg
    assert tpcds.TpcdsCatalog(1.0).device == "cuda"


@functools.lru_cache(maxsize=None)
def port_session():
    """The port's CPU session at SF 0.02, one per test process: every file
    that imports this module in a worker shares it and its tables."""
    return Session(tpcds.TpcdsCatalog(SF, device="cpu"), device="cpu", result_cache=False)


@functools.lru_cache(maxsize=None)
def oracle():
    """The SQLite oracle at SF 0.02, one per test process (its set-up, the
    24 tables loaded into SQLite, is the oracle files' largest fixed cost)."""
    from presto_tpu.testing.oracle import SqliteOracle

    return SqliteOracle(sf=SF, source=rtpcds)


@pytest.fixture(scope="module")
def sessions():
    ref = RSession(rtpcds.TpcdsCatalog(sf=SF), plan_cache=False, result_cache=False)
    ref.executor.dynamic_filtering = False
    return port_session(), ref


@pytest.mark.parametrize("qid", PARITY)
def test_query_equals_reference(qid, sessions):
    port, ref = sessions
    got = port.query(tpcds_sql.QUERIES[qid]).rows()
    want = ref.query(rsql.QUERIES[qid]).rows()
    assert len(got) > 0 or qid == 3
    assert chip_smoke.row_diff(got, want) is None, chip_smoke.row_diff(got, want)


def _ref_type(t):
    """The JAX package's type of a port type (assert_same_results picks each
    column's tolerance by its type)."""
    from presto_tpu import types as RT

    return RT.parse_type(str(t))


@pytest.fixture(scope="module")
def port_and_oracle():
    return port_session(), oracle()


def check_query(qid, port, oracle):
    """(b): the port's rows of text `qid` against the oracle's, as
    tests/test_tpcds_queries.py holds the JAX package's."""
    from presto_tpu.testing.oracle import assert_same_results
    from test_tpcds_queries import ORACLE_SQL

    sql = tpcds_sql.QUERIES[qid]
    ours = port.query(sql)
    expected = oracle.query(ORACLE_SQL.get(qid, sql))
    assert_same_results(ours.rows(), expected, [_ref_type(b.type) for b in ours.page.blocks])
