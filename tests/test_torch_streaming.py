"""The streaming executor of presto_tpu_torch (exec/stream.py) on the CPU,
held to the JAX package: the cases of tests/test_streaming.py (all 8
QUERIES at BATCH = 512, the bounded aggregate, the offloaded join, the
outer join that raises, the dictionary unification), each streaming
result equal to the JAX package's materializing Session on the same
tables (that file holds the JAX streaming output equal to its plain
Session, so the plain rows are the reference). The port's pool.peak stays
within each budget and no spill file outlives a query
(spillspace.all_active_bytes() == 0). Also: the Session wiring (SET
SESSION streaming / batch_rows / memory_budget, the matmul_groupby refusal,
EXPLAIN ANALYZE's `-- memory:` footer).

Left out: nothing of tests/test_streaming.py; the streaming exchange
(tests/test_streaming_exchange.py) belongs to the server port (ROADMAP
queue 1 item 9)."""

import numpy as np
import pytest
import torch

import chip_smoke
from presto_tpu.connectors.memory import MemoryCatalog as RMemoryCatalog
from presto_tpu.connectors.tpch import TpchCatalog as RTpchCatalog
from presto_tpu.page import Page as RPage
from presto_tpu.session import Session as RSession
from presto_tpu_torch.connectors.memory import MemoryCatalog
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.exec import spillspace
from presto_tpu_torch.exec.memory import MemoryExceededError
from presto_tpu_torch.expr.functions import NotPortedError
from presto_tpu_torch.page import Page
from presto_tpu_torch.session import Session

# one torch thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

SF = 0.01
BATCH = 512  # tiny batches so every query crosses many batch boundaries

QUERIES = {
    "q1_shape": (
        "select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty, "
        "sum(l_extendedprice * (1 - l_discount)) as rev, "
        "avg(l_extendedprice) as avg_price, count(*) as n "
        "from lineitem where l_shipdate <= date '1998-09-02' "
        "group by l_returnflag, l_linestatus "
        "order by l_returnflag, l_linestatus"
    ),
    "q6_shape": (
        "select sum(l_extendedprice * l_discount) as revenue from lineitem "
        "where l_shipdate >= date '1994-01-01' "
        "and l_shipdate < date '1995-01-01' "
        "and l_discount between 0.05 and 0.07 and l_quantity < 24"
    ),
    "q3_shape": (
        "select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as rev "
        "from customer, orders, lineitem "
        "where c_mktsegment = 'BUILDING' and c_custkey = o_custkey "
        "and l_orderkey = o_orderkey and o_orderdate < date '1995-03-15' "
        "group by l_orderkey order by rev desc limit 10"
    ),
    "semijoin": (
        "select count(*) c from orders where o_custkey in "
        "(select c_custkey from customer where c_acctbal > 0)"
    ),
    "distinct": "select distinct l_returnflag, l_linestatus from lineitem",
    "topn": (
        "select o_orderkey, o_totalprice from orders "
        "order by o_totalprice desc limit 7"
    ),
    "limit": "select l_orderkey from lineitem limit 25",
    "left_join": (
        "select c_custkey, count(o_orderkey) n from customer "
        "left join orders on c_custkey = o_custkey "
        "group by c_custkey order by c_custkey limit 20"
    ),
}


class Reference:
    """The JAX package's materializing Session over TPC-H at `sf`, rows
    cached per SQL text (its jit compiles dominate the file's time;
    dynamic filters off halve them and change no rows)."""

    def __init__(self, sf=SF):
        self.sess = RSession(RTpchCatalog(sf=sf), plan_cache=False, result_cache=False)
        self.sess.executor.dynamic_filtering = False
        self._rows = {}

    def rows(self, sql):
        if sql not in self._rows:
            self._rows[sql] = self.sess.query(sql).rows()
        return self._rows[sql]


def same_rows(got, want, ordered=True):
    diff = chip_smoke.row_diff(got, want, ordered)
    assert diff is None, diff


def streaming(catalog, **kw):
    kw.setdefault("batch_rows", BATCH)
    return Session(catalog, device="cpu", streaming=True, result_cache=False, **kw)


@pytest.fixture(scope="module")
def catalog():
    return TpchCatalog(SF, device="cpu")


@pytest.fixture(scope="module")
def reference():
    return Reference()


@pytest.fixture(autouse=True)
def no_spill_left():
    yield
    assert spillspace.all_active_bytes() == 0
    assert spillspace.all_active_files() == 0


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_streaming_matches_reference(catalog, reference, name):
    sql = QUERIES[name]
    got = streaming(catalog).query(sql).rows()
    want = reference.rows(sql)
    if name == "limit":  # LIMIT without ORDER BY: the row set is unordered
        assert len(got) == len(want)
        return
    same_rows(got, want, ordered="order by" in sql)


def test_aggregation_state_stays_bounded(catalog, reference):
    # Q1 shape under a budget far below the base table's footprint:
    # partial aggregation keeps only group state resident
    s = streaming(catalog, memory_budget=24 << 20)
    sql = QUERIES["q1_shape"]
    same_rows(s.query(sql).rows(), reference.rows(sql))
    assert s.executor.pool.peak <= 24 << 20


def test_join_build_offloads_and_chunks(catalog, reference):
    # budget below the build side's bytes: the build offloads to the host
    # and the inner join runs as the hybrid hash join
    sql = QUERIES["q3_shape"]
    s = streaming(catalog, memory_budget=64 << 10)
    same_rows(s.query(sql).rows(), reference.rows(sql))
    assert s.executor.pool.peak <= 64 << 10
    assert "join_build" in s.executor.spill_events
    assert "hybrid_hash_join" in s.executor.spill_events


def test_outer_join_over_budget_raises(catalog):
    s = streaming(catalog, memory_budget=64 << 10)
    with pytest.raises(MemoryExceededError):
        s.query(QUERIES["left_join"]).rows()


def _dictionary_tables(page_from_dict):
    return {
        "l": page_from_dict({"k": np.arange(64, dtype=np.int64), "name": ["x", "y"] * 32}),
        "r1": page_from_dict({"rk": np.arange(0, 32, dtype=np.int64), "tag": ["aa", "bb"] * 16}),
        "r2": page_from_dict({"rk": np.arange(32, 64, dtype=np.int64), "tag": ["cc", "bb"] * 16}),
    }


def test_host_offload_unifies_dictionaries():
    # build side = UNION ALL of tables with DIFFERENT string dictionaries;
    # the tiny budget forces the offload, which must unify codes
    sql = ("select k, tag from l join "
           "(select rk, tag from r1 union all select rk, tag from r2) r "
           "on k = rk order by k")
    want = RSession(RMemoryCatalog(_dictionary_tables(RPage.from_dict))).query(sql).rows()
    cat = MemoryCatalog(_dictionary_tables(lambda c: Page.from_dict(c, device="cpu")),
                        device="cpu")
    s = Session(cat, device="cpu", streaming=True, batch_rows=16, memory_budget=4 << 10,
                result_cache=False)
    same_rows(s.query(sql).rows(), want)
    assert s.executor.pool.peak <= 4 << 10
    # at 512 bytes the 768-byte union build offloads (the sort above would
    # not fit its 1,024-row minimum chunk, so this text has no ORDER BY)
    unordered = sql.replace(" order by k", "")
    s = Session(cat, device="cpu", streaming=True, batch_rows=16, memory_budget=512,
                result_cache=False)
    same_rows(s.query(unordered).rows(), want, ordered=False)
    assert "join_build" in s.executor.spill_events
    assert s.executor.pool.peak <= 512


def test_set_session_streaming(catalog, reference):
    s = Session(catalog, device="cpu", result_cache=False)
    for stmt in ("set session streaming = true", "set session batch_rows = 512",
                 "set session memory_budget = 65536"):
        s.query(stmt)
    derived = s.with_properties(s._session_overrides)
    assert derived.streaming and derived.batch_rows == 512
    assert derived.memory_budget == 65536
    sql = QUERIES["q3_shape"]
    same_rows(s.query(sql).rows(), reference.rows(sql))
    assert "hybrid_hash_join" in derived.executor.spill_events
    assert derived._engine_env_key() != Session(catalog, device="cpu")._engine_env_key()
    with pytest.raises(NotPortedError):
        s.query("set session matmul_groupby = true")


def test_explain_analyze_memory_footer(catalog):
    s = streaming(catalog, memory_budget=64 << 10)
    txt = s.explain_analyze(QUERIES["q3_shape"])
    line = [ln for ln in txt.splitlines() if ln.startswith("-- memory:")]
    assert line, txt
    assert "spill " in line[0] and "hybrid parts=" in line[0] and "ragged pages=" in line[0]
    # the materializing session prints no memory line
    assert "-- memory:" not in Session(catalog, device="cpu").explain_analyze(QUERIES["q6_shape"])


class BucketedCatalog(MemoryCatalog):
    """A memory catalog whose tables `f` and `d` are stored bucketed by
    their first column (rows sorted by `k % BUCKETS`), and whose `dim` table
    serves point lookups: the connector hooks the streaming executor's
    grouped bucket join and index join read (the JAX package's hive and
    jdbc connectors provide them; their port is ROADMAP queue 1 item 6)."""

    BUCKETS = 4

    def bucketing(self, table):
        return ((self.schema(table).__iter__().__next__(),), self.BUCKETS) \
            if table in ("f", "d") else None

    def bucket_row_ranges(self, table, bucket):
        keys = self.page(table).blocks[0].data.numpy() % self.BUCKETS
        rows = np.flatnonzero(keys == bucket)
        return [(int(rows[0]), int(rows[-1]) + 1)] if len(rows) else []

    def supports_index(self, table, column):
        return table == "dim" and column == "dk"

    def index_lookup(self, table, column, keys, columns):
        self.lookups.append(len(keys))
        page = self.page(table)
        hit = np.isin(page.block(column).data.numpy(), np.asarray(keys, np.int64))
        cols = {c: page.block(c).data.numpy()[hit] for c in columns}
        return Page.from_dict(cols, device="cpu")


def _bucketed_tables():
    rng = np.random.default_rng(21)
    fk = rng.integers(0, 400, 3_000)
    fk = fk[np.argsort(fk % BucketedCatalog.BUCKETS, kind="stable")]
    dk = np.arange(400)
    dk = dk[np.argsort(dk % BucketedCatalog.BUCKETS, kind="stable")]
    return {
        "f": {"fk": fk.astype(np.int64), "fv": rng.integers(0, 100, 3_000).astype(np.int64)},
        "d": {"dk": dk.astype(np.int64), "dv": rng.integers(0, 100, 400).astype(np.int64)},
        "dim": {"dk": np.arange(20_000, dtype=np.int64),
                "dv": rng.integers(0, 100, 20_000).astype(np.int64)},
        "p": {"pk": rng.integers(0, 80_000, 30_000).astype(np.int64),
              "pv": rng.integers(0, 100, 30_000).astype(np.int64)},
    }


@pytest.mark.parametrize("case", ["grouped_bucket_join", "index_join"])
def test_connector_driven_joins(case):
    """The grouped bucket join (bucket by bucket, its build within budget)
    and the index join (point lookups per probe batch) equal the JAX
    package's materializing join over the same tables."""
    tables = _bucketed_tables()
    cat = BucketedCatalog({n: Page.from_dict(c, device="cpu") for n, c in tables.items()},
                          device="cpu")
    cat.lookups = []
    ref = RSession(RMemoryCatalog({n: RPage.from_dict(c) for n, c in tables.items()}))
    sql = ("select count(*), sum(fv + dv) from f join d on fk = dk" if case == "grouped_bucket_join"
           else "select count(*), sum(pv + dv) from p join dim on pk = dk")
    s = Session(cat, device="cpu", streaming=True, batch_rows=128 if case != "index_join"
                else 4096, result_cache=False)
    same_rows(s.query(sql).rows(), ref.query(sql).rows())
    assert case in s.executor.spill_events
    if case == "index_join":  # one lookup per probe batch, of its distinct keys
        assert len(cat.lookups) == 8 and sum(cat.lookups) < 30_000
    else:
        assert not cat.lookups


def test_coalesce_pages_equals_reference():
    from presto_tpu.exec.stream import coalesce_pages as rcoalesce
    from presto_tpu_torch.exec.stream import coalesce_pages

    sizes = [3, 0, 7, 12, 1, 1, 0, 9]
    port = [Page.from_dict({"a": np.arange(n, dtype=np.int64)}, device="cpu") for n in sizes]
    ref = [RPage.from_dict({"a": np.arange(n, dtype=np.int64)}) for n in sizes]
    got = [p.to_pylist() for p in coalesce_pages(iter(port), 8)]
    want = [p.to_pylist() for p in rcoalesce(iter(ref), 8)]
    assert got == want and len(got) > 1
    assert list(coalesce_pages(iter([]), 8)) == []


@pytest.mark.parametrize("kind", ["inlist", "bloom_int", "bloom_double"])
def test_host_filter_summary_equals_reference(kind):
    """The host half of dynamic filtering (a spilled build's summary) is
    the JAX package's, field for field and bloom word for bloom word, and
    the filter rebuilt from it keeps every build key."""
    from presto_tpu import types as RT
    from presto_tpu.exec import dynfilter as rdf
    from presto_tpu_torch import types as PT
    from presto_tpu_torch.exec import dynfilter as df

    rng = np.random.default_rng(5)
    data = {"inlist": np.arange(100, dtype=np.int64) * 7,
            "bloom_int": rng.integers(0, 10 ** 9, 50_000),
            "bloom_double": rng.normal(size=20_000)}[kind]
    rtyp, ptyp = (RT.DOUBLE, PT.DOUBLE) if data.dtype.kind == "f" else (RT.BIGINT, PT.BIGINT)
    valid = rng.random(len(data)) > 0.1
    ref = rdf.HostFilterAccumulator("k")
    ref.add_numpy(data, valid, rtyp)
    port = df.HostFilterAccumulator("k")
    port.add_numpy(data, valid, ptyp)
    assert port.summary() == ref.summary()
    assert np.array_equal(df._words_of(port.summary()), rdf._words_of(ref.summary()))
    f = df.filter_from_summary(port.summary(), ptyp)

    from types import SimpleNamespace

    key = SimpleNamespace(data=torch.from_numpy(data[valid]), valid=None)
    assert bool(f.mask(key).all())  # no build key is ever pruned
