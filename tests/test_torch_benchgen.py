"""Parity: presto_tpu_torch's on-device TPC-H generation
(benchmark/benchgen.py) and device-resident catalog
(connectors/tpch_device.py) against presto_tpu's.

Generation on device="cpu" (int64 splitmix64 with the emulated unsigned
modulo) and the port's numpy twin are bit-identical to the reference's
numpy twin, for every table and column, from row 0, from a mid-table start
and at row numbers near 6e8. Over DeviceTpchCatalog(0.01): scans equal the
twin, SQL Q1/Q3/Q6 give exactly the reference Session's rows over the
reference DeviceTpchCatalog, and the north-star Q5/Q17/Q18 texts agree with
the reference's SQLite oracle over the reference twin (the oracle's
tolerances: decimals within half a unit of their last digit).
"""

import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.benchmark import benchgen as rbenchgen
from presto_tpu.benchmark.tpch_sql import QUERIES as RQUERIES
from presto_tpu.connectors import tpch_device as rtpch_device
from presto_tpu.session import Session as RSession
from presto_tpu.testing.oracle import SqliteOracle, assert_same_results
from presto_tpu_torch import types as T
from presto_tpu_torch.benchmark import benchgen, northstar, scale
from presto_tpu_torch.benchmark.tpch_sql import QUERIES
from presto_tpu_torch.connectors import tpch_device
from presto_tpu_torch.connectors.tpch_device import DeviceTpchCatalog
from presto_tpu_torch.session import Session

# one torch thread: the suite runs in parallel worker processes
# (pytest-xdist), and a thread per core in each oversubscribes the host
torch.set_num_threads(1)

SF = 0.01


def _storage(col):
    return col.numpy().dtype


@pytest.mark.parametrize("table", sorted(rbenchgen.SCHEMAS))
def test_generation_bit_identical_to_reference(table):
    cols = tuple(rbenchgen.SCHEMAS[table])
    assert tuple(benchgen.SCHEMAS[table]) == cols
    n = rbenchgen._sizes(SF)[table]
    assert benchgen._sizes(SF)[table] == n
    want = rbenchgen.numpy_columns(table, SF, cols)
    twin = benchgen.numpy_columns(table, SF, cols)
    dev = benchgen.device_range(table, SF, cols, 0, n, "cpu")
    start = n // 2 + 3
    want_mid = rbenchgen.numpy_columns_range(table, SF, cols, start, 257)
    twin_mid = benchgen.numpy_columns_range(table, SF, cols, start, 257)
    dev_mid = benchgen.device_range(table, SF, cols, start, 257, "cpu")
    for c, d, dm in zip(cols, dev, dev_mid):
        typ, pool = benchgen.SCHEMAS[table][c]
        rtyp, rpool = rbenchgen.SCHEMAS[table][c]
        assert typ.display() == rtyp.display() and pool == rpool, c
        assert twin[c].dtype == want[c].dtype and np.array_equal(twin[c], want[c]), c
        assert np.array_equal(twin_mid[c], want_mid[c]), c
        assert d.dtype == typ.storage_dtype and d.shape == (n,), c
        assert np.array_equal(d.numpy(), want[c].astype(_storage(d))), c
        assert np.array_equal(dm.numpy(), want_mid[c].astype(_storage(dm))), c


def test_generation_at_high_row_numbers():
    """Rows near the end of an SF 100 lineitem: counters above 2^29 and
    every stream's wrapped base."""
    cols = tuple(rbenchgen.SCHEMAS["lineitem"])
    want = rbenchgen.numpy_columns_range("lineitem", 100.0, cols, 599_999_000, 1000)
    got = benchgen.device_range("lineitem", 100.0, cols, 599_999_000, 1000, "cpu")
    for c, d in zip(cols, got):
        assert np.array_equal(d.numpy(), want[c].astype(_storage(d))), c


def test_device_page_carries_the_schema(catalog):
    assert benchgen.supports("part", ("p_partkey", "p_brand"))
    assert not benchgen.supports("part", ("p_name",)) and not benchgen.supports("nation", ())
    page = benchgen.device_page("part", SF, ("p_partkey", "p_brand"), device="cpu")
    assert page.capacity == int(page.count) == benchgen._sizes(SF)["part"]
    assert page.block("p_brand").dictionary == rbenchgen.SCHEMAS["part"]["p_brand"][1]
    assert page.block("p_partkey").type == T.BIGINT
    padded = catalog.scan("part", 0, 1000, pad_to=2048, columns=("p_brand",))
    assert padded.capacity == 2048 and int(padded.count) == 1000


@pytest.fixture(scope="module")
def catalog():
    return DeviceTpchCatalog(SF, device="cpu")


@pytest.fixture(scope="module")
def sessions(catalog):
    """presto_tpu's session without plan and result caches and without its
    dynamic filters, which only prune rows."""
    ref = RSession(rtpch_device.DeviceTpchCatalog(sf=SF), plan_cache=False, result_cache=False)
    ref.executor.dynamic_filtering = False
    return Session(catalog, device="cpu", result_cache=False), ref


@pytest.mark.parametrize("name", tpch_device.TABLE_NAMES)
def test_catalog_pages_and_scans_equal_the_twin(catalog, name):
    assert tpch_device.TABLE_NAMES == rtpch_device.TABLE_NAMES
    want = rtpch_device.table(name, SF)
    twin = tpch_device.table(name, SF)
    page = catalog.page(name)
    n = want.num_rows
    assert catalog.row_count(name) == catalog.exact_row_count(name) == n
    assert int(page.count) == n and page.device.type == "cpu"
    assert set(catalog.schema(name)) == set(want.columns)
    hi = min(n, 69)
    part = catalog.scan(name, 1, hi, columns=tuple(want.columns))
    tail = catalog.scan(name, n - 3, n + 100)  # clamped at the table's end
    assert int(part.count) == hi - 1 and int(tail.count) == 3
    for c, rc in want.columns.items():
        tc = twin.columns[c]
        assert tc.data.dtype == rc.data.dtype and np.array_equal(tc.data, rc.data), c
        assert tuple(tc.dictionary or ()) == tuple(rc.dictionary or ()), c
        assert page.block(c).dictionary == (None if rc.dictionary is None else tuple(rc.dictionary))
        assert np.array_equal(page.block(c).data.numpy(), rc.data), c
        assert np.array_equal(part.block(c).data.numpy(), rc.data[1:hi]), c
        assert np.array_equal(tail.block(c).data.numpy(), rc.data[n - 3:]), c


def test_column_stats_sample_a_prefix_of_large_tables(monkeypatch):
    cat = DeviceTpchCatalog(SF, device="cpu")
    full = cat.column_stats("lineitem", "l_quantity")
    monkeypatch.setattr(tpch_device, "STATS_SAMPLE_ROWS", 1000)
    sampled = DeviceTpchCatalog(SF, device="cpu").column_stats("lineitem", "l_quantity")
    assert (full.min, full.max) == (1.0, 50.0) and sampled.max <= 50.0
    assert full.ndv == sampled.ndv == 50.0


@pytest.mark.parametrize("q", [1, 3, 6])
def test_sql_equals_reference(sessions, q):
    port, ref = sessions
    got = port.query(QUERIES[q]).rows()
    want = ref.query(RQUERIES[q]).rows()
    assert got == want and len(got) > 0
    assert [type(x) for x in got[0]] == [type(x) for x in want[0]]


@pytest.fixture(scope="module")
def oracle():
    return SqliteOracle(sf=SF, source=rtpch_device)


def _reference_type(t):
    if isinstance(t, T.DecimalType):
        return RT.DecimalType(t.precision, t.scale)
    return RT.DOUBLE if T.is_floating(t) else RT.BIGINT


@pytest.mark.parametrize("name", ["q5", "q17", "q18"])
def test_northstar_queries_equal_oracle(sessions, oracle, name):
    port, _ = sessions
    result = port.query(scale.QUERIES[name])
    expected = oracle.query(scale.QUERIES[name])
    types = [_reference_type(b.type) for b in result.page.blocks]
    assert_same_results(result.rows(), expected, types, ordered=True)
    if name == "q18":
        # HAVING sum(l_quantity) > 300 selects no order of this generator
        # (4 lines of at most 50 each), in both packages
        assert expected == []
    else:
        assert len(expected) > 0


def test_northstar_run_reports_each_query():
    out = northstar.run(SF, runs=1, prewarm=0, queries=["q3", "q18"], device="cpu")
    assert out["backend"] == "cpu" and out["lineitem_rows"] == benchgen._sizes(SF)["lineitem"]
    (q3, q18) = out["results"]
    assert q3["name"] == "q3" and q3["out_rows"] == 10 and q3["ms"] > 0
    assert q3["rows_pruned"] > 0 and q3["dyn_filters"]
    assert q18["out_rows"] == 0


def test_chip_smoke_benchmark_path_on_cpu(monkeypatch):
    """chip_smoke.py's benchmark path end to end at SF 0.01 on the CPU:
    every pipeline and query equals its numpy check over the host twin.
    The CPU launches no kernel, so the wrapper is counted by hand here."""
    import chip_smoke
    from presto_tpu_torch.ops import agg_kernel

    plain = agg_kernel.q1_sums

    def counted(*args):
        agg_kernel.launches += 1
        return plain(*args)

    monkeypatch.setattr(agg_kernel, "q1_sums", counted)
    report, per, counts, page = chip_smoke.benchmark_path(SF, "cpu", runs=2)
    assert counts["q1_partials"] == 2 and per["q1_local_kernel"]["q1_partials"] == 1
    assert report["northstar_q3"]["result_rows"] == 10 and int(page.count) == 60_000
