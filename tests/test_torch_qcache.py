"""The plan and result caches of presto_tpu_torch (exec/qcache.py) against
presto_tpu's: the cases of the JAX package's tests/test_query_cache.py on
the plan cache, the result cache and EXECUTE's plan skeletons (its kernel
cache, shard store, DB-API, worker-pool and cluster cases need modules
that are not ported). Each package's caches are reset before every case,
the same statements run through both, and the rows and the hit, miss and
store counters of both caches are compared."""

import threading
import time

import numpy as np
import pytest
import torch

from presto_tpu.connectors.memory import MemoryCatalog as RMemoryCatalog
from presto_tpu.exec import qcache as rqcache
from presto_tpu.page import Page as RPage
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.memory import MemoryCatalog
from presto_tpu_torch.exec import qcache
from presto_tpu_torch.exec.executor import Executor
from presto_tpu_torch.exec.stats import page_device_bytes
from presto_tpu_torch.page import Block, Page
from presto_tpu_torch.session import Session
from test_torch_statements import Pair

# one torch thread: the suite runs in parallel worker processes
# (pytest-xdist), and a thread per core in each oversubscribes the host
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh_caches():
    """Both packages' process-wide caches empty, counters at 0."""
    qcache.reset_all()
    rqcache.reset_all()


def columns(n=64):
    return {"x": np.arange(n, dtype=np.int64), "s": ["s%d" % (i % 7) for i in range(n)]}


def pair(n=64, **kw):
    return Pair({"t": columns(n)}, **kw)


COUNTERS = ("hits", "misses", "stores", "invalidations")


def counters():
    """(port, reference) {cache: (hits, misses, stores, invalidations)}."""
    def of(snap):
        return {c: tuple(snap[c][k] for k in COUNTERS) for c in ("plan", "result")}

    return of(qcache.snapshot_all()), of(rqcache.snapshot_all())


def same_counters(caches=("plan", "result")):
    port, ref = counters()
    for c in caches:
        assert port[c] == ref[c], (c, port[c], ref[c])
    return port


# -- plan + result cache basics ---------------------------------------------


def test_repeat_query_hits_plan_and_result_cache():
    p = pair()
    assert p.q("select count(*) from t where x > 5") == [(58,)]
    assert p.q("select count(*) from t where x > 5") == [(58,)]
    got = same_counters()
    assert got["plan"][0] >= 1 and got["result"][0] >= 1
    assert qcache.RESULT_CACHE.stats.bytes > 0


def test_result_cache_hit_returns_the_cached_page():
    """A hit serves the cached Page object itself (so nothing on the path
    may write into a result page in place)."""
    p = pair()
    a = p.port.query("select s, count(*) from t group by s")
    b = p.port.query("select s, count(*) from t group by s")
    assert b.page is a.page and a.rows() == b.rows()


def test_session_property_disables_caches():
    p = pair(plan_cache=False, result_cache=False)
    p.q("select count(*) from t")
    p.q("select count(*) from t")
    assert same_counters() == {"plan": (0, 0, 0, 0), "result": (0, 0, 0, 0)}
    # the SET SESSION property routes through the same switches
    p2 = pair()
    p2.q("set session result_cache = false")
    p2.q("select count(*) from t")
    p2.q("select count(*) from t")
    assert same_counters()["result"][0] == 0


def test_nondeterministic_queries_bypass_result_cache():
    """now() and TABLESAMPLE results are never stored. The port does not
    cache their plans either (TABLESAMPLE's seed is drawn at plan time;
    the JAX package caches both plans), so only the result cache's
    counters are compared."""
    p = pair(256)
    for sql in ("select max(x) from t where now() is not null",
                "select count(*) from t tablesample bernoulli (50)"):
        for sess in (p.port, p.ref):
            sess.query(sql).rows()
            sess.query(sql).rows()
    got = same_counters(("result",))
    assert got["result"][0] == 0 and got["result"][2] == 0
    assert qcache.PLAN_CACHE.stats.stores == 0 < rqcache.PLAN_CACHE.stats.stores


def test_unversioned_connector_is_provably_bypassed():
    class NoVersion(MemoryCatalog):
        def table_version(self, table):  # connector without snapshots
            return None

    class RNoVersion(RMemoryCatalog):
        def table_version(self, table):
            return None

    x = np.arange(8, dtype=np.int64)
    p = Pair(port_catalog=NoVersion({"t": Page.from_dict({"x": x}, device="cpu")},
                                    device="cpu"),
             ref_catalog=RNoVersion({"t": RPage.from_dict({"x": x})}))
    assert p.q("select sum(x) from t") == p.q("select sum(x) from t") == [(28,)]
    got = same_counters()
    assert got["result"][2] == 0 and got["plan"][2] == 0


# -- staleness oracle (zero stale reads) ------------------------------------


def test_staleness_oracle_interleaved_writes_memory():
    """Interleave INSERT/DELETE/CTAS/DROP with cached reads: every read
    equals a cache-free session's over the same catalog, in both
    packages, and the result cache's counters and the plan cache's hits
    move alike."""
    p = pair(16)
    oracle = Session(p.port.catalog, device="cpu", plan_cache=False, result_cache=False)
    reads = ("select count(*) c, sum(x) s from t",
             "select s, count(*) c from t group by s order by s")
    writes = (
        "insert into t values (100, 'zz')",
        "insert into t select x + 200, s from t where x < 3",
        "delete from t where x >= 200",
        "create table t2 as select x, s from t where x < 50",
        "insert into t2 values (7777, 'w')",
        "drop table t2",
        "delete from t where x = 100",
    )
    for r in reads:  # populate
        assert p.q(r) == oracle.query(r).rows()
    for w in writes:
        p.q(w)
        for _ in range(2):  # the first read after a write misses, the second hits
            for r in reads:
                assert p.q(r) == oracle.query(r).rows(), (w, r)
    # the port plans DELETE's victim query outside the plan cache (the JAX
    # package's CASE rewrite misses it and stores a plan each time), so
    # the plan cache's hits are compared, not its misses and stores
    got = same_counters(("result",))
    assert got["result"][0] >= len(writes) * len(reads)
    assert qcache.PLAN_CACHE.stats.hits == rqcache.PLAN_CACHE.stats.hits


def test_plan_cache_entry_invalidated_by_write():
    p = pair(16)
    p.q("select count(*) from t")
    p.port.catalog.append("t", Page.from_dict(
        {"x": np.array([500], dtype=np.int64), "s": ["zz"]}, device="cpu"))
    p.ref.catalog.append("t", RPage.from_dict(
        {"x": np.array([500], dtype=np.int64), "s": ["zz"]}))
    assert p.q("select count(*) from t") == [(17,)]  # stale entry dropped, replanned
    assert same_counters()["plan"][3] > 0


def test_concurrent_writer_reader_chaos():
    """A writer appends rows while two readers poll a cached aggregate on
    one shared session: the counts each reader sees never go backwards (a
    stale cached result would), and the final read sees every row. (The
    JAX package's test compares counts ACROSS readers, which two readers
    whose queries overlap can finish out of order without any cache: here
    that happens with the caches off too.)"""
    cat = MemoryCatalog({"t": Page.from_dict({"x": np.arange(4, dtype=np.int64)},
                                             device="cpu")}, device="cpu")
    sess = Session(cat, device="cpu")
    n_writes = 10
    errors = []
    stop = threading.Event()

    def writer():
        w = Session(cat, device="cpu", result_cache=False)
        try:
            for i in range(n_writes):
                w.query(f"insert into t values ({100 + i})")
        finally:
            stop.set()

    def reader():
        last = 4
        try:
            while not stop.is_set():
                c = sess.query("select count(*) c from t").rows()[0][0]
                if c < last:
                    errors.append((last, c))
                last = max(last, c)
        except Exception as e:  # noqa: BLE001
            errors.append(repr(e))

    threads = [threading.Thread(target=writer)] + [threading.Thread(target=reader)
                                                   for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=180)
    assert not errors, errors[:5]
    assert sess.query("select count(*) c from t").rows() == [(4 + n_writes,)]


def test_time_dependent_results_not_shared_across_sessions():
    p = pair(8)
    t1 = Session(p.port.catalog, device="cpu").query("select max(now()) n from t").rows()[0][0]
    time.sleep(0.05)
    t2 = Session(p.port.catalog, device="cpu").query("select max(now()) n from t").rows()[0][0]
    assert t2 > t1, (t1, t2)


# -- EXECUTE typed binding + skeleton rebinding -----------------------------


def test_execute_skeleton_rebinds_across_values():
    p = pair()
    p.q("prepare px from select count(*) c from t where x > ?")
    a = p.q("execute px using 9")
    hits0 = qcache.PLAN_CACHE.stats.hits
    b = p.q("execute px using 31")
    c = p.q("execute px using 9")
    assert (a, b, c) == ([(54,)], [(32,)], [(54,)])
    # both warm executions served their plan from the skeleton cache
    assert qcache.PLAN_CACHE.stats.hits >= hits0 + 2
    same_counters()


@pytest.mark.parametrize("stmt,values", [
    # a parameter under a negation the planner folds: the skeleton's first
    # rebind fails its verification and the statement falls back
    ("select count(*) c from t where x > -? + 40", ["3", "5", "3", "7"]),
    # LIMIT ? is consumed at plan time: never rebindable
    ("select x from t order by x desc limit ?", ["3", "7", "2", "3"]),
    # a parameter under a cast to the column's type
    ("select count(*) c from t where x > cast(? as bigint)", ["3.5", "5.5", "3.5"]),
    # a parameter inside arithmetic on a column
    ("select count(*) c from t where x + ? > 10", ["3", "5", "3"]),
])
def test_execute_skeleton_kinds_equal_reference(stmt, values):
    """Each kind of parameter through both packages' skeleton caches: the
    same rows and the same plan- and result-cache counters after every
    EXECUTE."""
    p = pair()
    p.q("prepare pk from " + stmt)
    for v in values:
        p.q("execute pk using " + v)
        same_counters()


def test_execute_binds_strings_as_constants_not_sql():
    p = pair()
    p.q("prepare ps from select count(*) c from t where s = ?")
    assert p.q("execute ps using 's1'") == [(9,)]
    # classic injection shapes arrive as plain varchar constants
    assert p.q("execute ps using 's1'' or ''1''=''1'") == [(0,)]
    assert p.q("execute ps using '''; drop table t; --'") == [(0,)]
    assert "t" in p.port.catalog.table_names()


def test_execute_param_types_round_trip():
    p = Pair()
    p.q("create table d (w date, v double)")
    p.q("insert into d values (date '2020-01-01', 1.5), "
        "(date '2021-06-15', 2.5), (date '2022-12-31', 3.5)")
    p.q("prepare pd from select count(*) c from d where w >= ?")
    assert p.q("execute pd using date '2021-01-01'") == [(2,)]
    assert p.q("execute pd using date '1999-01-01'") == [(3,)]
    p.q("prepare pv from select count(*) c from d where v > ?")
    assert p.q("execute pv using 2.0") == [(2,)]
    assert p.q("execute pv using 3.25") == [(1,)]
    p.q("prepare pn from select count(*) c from d where v > ? or ? is null")
    assert p.q("execute pn using 99.0, null") == [(3,)]
    same_counters()


def test_execute_limit_parameter():
    p = pair()
    p.q("prepare pl from select x from t order by x desc limit ?")
    assert len(p.q("execute pl using 3")) == 3
    assert len(p.q("execute pl using 7")) == 7
    assert p.q("execute pl using 2") == [(63,), (62,)]


def test_execute_parameter_count_errors():
    p = pair()
    p.q("prepare pc from select count(*) from t where x > ? and x < ?")
    p.fails("execute pc using 1", match="expects 2 parameters")
    p.fails("execute pc using 1, 2, 3", match="expects 2 parameters")


# -- bounded LRU, byte accounting ----------------------------------------------


def test_lru_cache_evicts_oldest_not_everything():
    c = qcache.LRUCache(max_entries=4)
    for i in range(4):
        c.put(i, i)
    assert c.get(0) == 0  # refresh 0
    c.put(9, 9)  # evicts 1 (LRU), NOT everything
    assert len(c) == 4
    assert c.get(1) is None
    assert c.get(0) == 0 and c.get(9) == 9
    assert c.stats.evictions == 1


def test_executor_stat_caches_bounded():
    ex = Executor(MemoryCatalog({"t": Page.from_dict(columns(), device="cpu")}, device="cpu"),
                  device="cpu")
    for i in range(5000):
        ex._est_rows(("fake", i))
    assert len(ex._est_cache) <= 4096
    # recent keys survive (LRU, not clear-on-threshold); a key is the node
    # and the estimate environment (the feedback generation), as in the
    # JAX package's test_query_cache.py
    key = (("fake", 4999),) + ex._est_env()
    assert ex._est_cache.get(key, count=False) is not None


def test_reset_concurrent_with_put_keeps_bytes_ledger_consistent():
    """reset() swaps the stats object UNDER the cache lock: hammer put/get
    against reset and check the ledger matches the live entries."""
    cache = qcache.LRUCache(max_entries=64, name="race-test")
    stop = threading.Event()

    def hammer(i):
        k = 0
        while not stop.is_set():
            key = ("k", i, k % 17)
            cache.put(key, "v", 128)
            cache.get(key)
            k += 1

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    try:
        for _ in range(300):
            cache.reset()
    finally:
        stop.set()
        for th in threads:
            th.join()
    with cache._lock:
        assert cache.stats.bytes == sum(nb for _v, nb in cache._data.values())


def test_result_bytes_count_every_tensor_of_a_collection_block():
    """The result cache's byte bound is device bytes: data and validity,
    and a collection block's lengths, element mask and map keys."""
    n, w = 5, 3
    keys = Block(torch.zeros((n, w), dtype=torch.int64), T.ArrayType(T.BIGINT), None,
                 lengths=torch.ones(n, dtype=torch.int32))
    m = Block(torch.zeros((n, w), dtype=torch.float64), T.MapType(T.BIGINT, T.DOUBLE),
              torch.ones(n, dtype=torch.bool), lengths=torch.ones(n, dtype=torch.int32),
              elem_valid=torch.ones((n, w), dtype=torch.bool), key_block=keys)
    page = Page.from_blocks((m,), ("m",), n)
    want = n * w * 8 + n + n * 4 + n * w + (n * w * 8 + n * 4)
    assert page_device_bytes(page) == want
    p = Pair({"t": {"k": np.arange(6, dtype=np.int64) % 3, "v": np.arange(6.0)}})
    res = p.port.query("select k, array_agg(v) a from t group by k")
    (ent,) = [e for e, _nb in qcache.RESULT_CACHE._data.values()]
    assert ent.page is res.page and ent.nbytes == page_device_bytes(res.page) > 0


def test_explain_analyze_exposes_caches():
    p = pair()
    p.q("select count(*) from t")
    txt = p.port.explain_analyze("select count(*) from t")
    line = [ln for ln in txt.splitlines() if ln.startswith("-- caches:")]
    assert line and "plan" in line[0] and "result" in line[0]
