"""The port's HTTP cluster (presto_tpu_torch/server/cluster.py over
in-process WorkerServers on the CPU, real HTTP between them), the cases of
tests/test_server.py, test_fault_tolerance.py, test_dynfilter.py's cluster
cases, test_feedback.py's mid-query replan and test_cluster_memory.py:

* test_server.py's CLUSTER_QUERIES and its repartitioned join through a
  two-worker port cluster, held against the JAX package's local Session;
  a dead worker is excluded by the failure detector;
* retries survive fault injection, fatal causes are never retried, the
  blacklist drains and re-admits, status deadlines name their task;
* cross-task dynamic filters: merge_summaries equal to the JAX package's
  over the same summaries, malformed summaries raise, the filtered query
  keeps its rows, an expired wait proceeds without the filter;
* the mid-query replan, the low-memory kill and its victim selection;
* a mixed fleet negotiates down to per-page dictionaries and the flat
  loop, and EXPLAIN ANALYZE renders the wire.

Every HTTP call has a timeout, and every worker stops in a finally."""

import threading
import time

import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.connectors.tpch import TpchCatalog as RCatalog
from presto_tpu.exec import dynfilter as ref_dynfilter
from presto_tpu.session import Session as RSession
from presto_tpu_torch import types as T
from presto_tpu_torch.benchmark.tpch_sql import QUERIES
from presto_tpu_torch.connectors.memory import MemoryCatalog
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.exec import dynfilter
from presto_tpu_torch.exec import qcache
from presto_tpu_torch.page import Page
from presto_tpu_torch.plan import history as H
from presto_tpu_torch.plan.fragment import fragment_plan
from presto_tpu_torch.server import HttpClusterSession, NodeManager, TaskFailure, WorkerServer
from presto_tpu_torch.server import serde
from presto_tpu_torch.server.cluster import ClusterMemoryManager, HttpScheduler
from presto_tpu_torch.server.serde import local_capabilities
from presto_tpu_torch.session import Session

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _no_stripe_threads_left():
    """The stripe pool's threads stop with the module."""
    yield
    serde.shutdown_stripe_pool()

SF = 0.01

# tests/test_server.py's CLUSTER_QUERIES, its repartitioned join, and
# tests/test_cluster_memory.py's queries
CLUSTER_QUERIES = [
    "select l_returnflag, l_linestatus, sum(l_quantity) q, "
    "avg(l_extendedprice) a, count(*) n from lineitem "
    "where l_shipdate <= date '1998-09-02' "
    "group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus",
    "select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as rev "
    "from customer, orders, lineitem "
    "where c_mktsegment = 'BUILDING' and c_custkey = o_custkey "
    "and l_orderkey = o_orderkey and o_orderdate < date '1995-03-15' "
    "group by l_orderkey order by rev desc limit 10",
    "select count(*), sum(o_totalprice) from orders",
    "select distinct o_orderpriority from orders order by o_orderpriority",
]
REPARTITIONED_SQL = ("select c_custkey, count(o_orderkey) n from customer, orders "
                     "where c_custkey = o_custkey group by c_custkey "
                     "order by n desc, c_custkey limit 5")
BIG = ("select l_orderkey, sum(l_extendedprice * (1 - l_discount)) rev "
       "from lineitem, orders where l_orderkey = o_orderkey "
       "group by l_orderkey order by rev desc limit 10")
SMALL = "select count(*) c from region"


def _start(n=2, sf=SF, **kw):
    return [WorkerServer(TpchCatalog(sf, device="cpu"), **kw).start() for _ in range(n)]


def _stop(workers):
    for w in workers:
        w.stop()


@pytest.fixture(scope="module")
def cluster():
    workers = _start()
    try:
        yield workers, NodeManager([w.uri for w in workers], interval=3600)
    finally:
        _stop(workers)


@pytest.fixture(scope="module")
def catalog():
    return TpchCatalog(SF, device="cpu")


@pytest.fixture(scope="module")
def reference_rows():
    """The JAX package's local Session rows of each text, computed once."""
    sess = RSession(RCatalog(sf=SF), plan_cache=False, result_cache=False)
    cache = {}

    def rows(sql):
        if sql not in cache:
            cache[sql] = [tuple(_norm(v) for v in r) for r in sess.query(sql).rows()]
        return cache[sql]

    return rows


def _norm(v):
    return None if v is None else str(v)


def _rows(result):
    return [tuple(_norm(v) for v in r) for r in result.rows()]


@pytest.mark.parametrize("i", range(len(CLUSTER_QUERIES)))
def test_cluster_matches_the_jax_package(cluster, catalog, reference_rows, i):
    _workers, nodes = cluster
    sess = HttpClusterSession(catalog, nodes, result_cache=False)
    assert _rows(sess.query(CLUSTER_QUERIES[i])) == reference_rows(CLUSTER_QUERIES[i])


def test_cluster_repartitioned_join(cluster, catalog, reference_rows):
    _workers, nodes = cluster
    sess = HttpClusterSession(catalog, nodes, broadcast_threshold=0, result_cache=False)
    assert _rows(sess.query(REPARTITIONED_SQL)) == reference_rows(REPARTITIONED_SQL)
    hier = sess.scheduler.stats_snapshot()["hier"]
    assert hier["exchanges"] > 0 and hier["wire_pages"] > 0


def test_explain_analyze_renders_the_wire(cluster, catalog):
    _workers, nodes = cluster
    sess = HttpClusterSession(catalog, nodes, broadcast_threshold=0)
    text = sess.explain_analyze(REPARTITIONED_SQL)
    assert "-- wire: v2, codecs" in text and "-- exchange s0:" in text and "-- hier:" in text
    wire = sess.scheduler.stats_snapshot()["wire"]
    assert wire["pages"] > 0 and wire["wire_bytes"] > 0 and wire["exec_ms"] > 0


def test_failure_detection_excludes_dead_worker(catalog):
    workers = _start(sf=0.002)
    try:
        nodes = NodeManager([w.uri for w in workers], interval=3600, failure_threshold=2)
        sess = HttpClusterSession(TpchCatalog(0.002, device="cpu"), nodes, result_cache=False)
        assert len(nodes.active_workers()) == 2
        workers[1].stop()
        nodes.probe_all()
        nodes.probe_all()
        assert nodes.active_workers() == [workers[0].uri]
        got = sess.query("select count(*) from orders").rows()
        want = Session(TpchCatalog(0.002, device="cpu"), device="cpu").query(
            "select count(*) from orders").rows()
        assert got == want
    finally:
        workers[0].stop()


# -- fault tolerance (tests/test_fault_tolerance.py) --------------------------


def test_cluster_survives_fault_rate(catalog, reference_rows):
    workers = _start(fault_rate=0.3)
    try:
        nodes = NodeManager([w.uri for w in workers], interval=3600, task_failure_threshold=50)
        sess = HttpClusterSession(catalog, nodes, result_cache=False, scheduler_opts={
            "backoff_base": 0.01, "backoff_cap": 0.1, "max_task_retries": 4,
            "max_query_retries": 4})
        for sql in CLUSTER_QUERIES:
            assert _rows(sess.query(sql)) == reference_rows(sql)
        stats = sess.scheduler.stats
        for _ in range(10):
            if stats.task_retries + stats.query_retries > 0:
                break
            assert _rows(sess.query(CLUSTER_QUERIES[2])) == reference_rows(CLUSTER_QUERIES[2])
        assert stats.task_retries + stats.query_retries > 0 and stats.tasks_failed > 0
        assert "injected fault" in stats.last_error
    finally:
        _stop(workers)


def test_faulty_worker_beside_a_healthy_one(catalog):
    """Every task a fault_rate=1.0 worker takes fails at start and is
    retried on the healthy worker."""
    workers = _start(1) + _start(1, fault_rate=1.0)
    try:
        nodes = NodeManager([w.uri for w in workers], interval=3600, task_failure_threshold=50)
        sess = HttpClusterSession(catalog, nodes, result_cache=False,
                                  scheduler_opts={"backoff_base": 0.01, "backoff_cap": 0.05})
        got = sess.query(QUERIES[5]).rows()
        assert got == Session(catalog, device="cpu", result_cache=False).query(QUERIES[5]).rows()
        st = sess.scheduler.stats_snapshot()
        assert st["task_retries"] > 0 and st["worker_failures"].get(workers[1].uri, 0) > 0
        assert st["query_retries"] == 0
    finally:
        _stop(workers)


class _Raising:
    def __init__(self, exc):
        self.exc, self.calls = exc, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        raise self.exc


@pytest.mark.parametrize("exc, attempts", [
    (TaskFailure("task t_1 failed: Query killed: the cluster ran out of memory",
                 retryable=False), 1),
    (RuntimeError("worker memory exhausted: 100B requested"), 1),
    (RuntimeError("spill file corrupt: crc mismatch"), 1),
    (TaskFailure("upstream task t_2 on w connection lost mid-stream"), 3),
])
def test_fatal_causes_are_never_retried(catalog, monkeypatch, exc, attempts):
    nodes = NodeManager(["http://127.0.0.1:1"], interval=3600)
    sched = HttpScheduler(catalog, nodes, max_query_retries=2, backoff_base=0.001)
    raising = _Raising(exc)
    monkeypatch.setattr(sched, "_run_attempt", raising)
    with pytest.raises(RuntimeError):
        sched.run(None)
    assert raising.calls == attempts
    assert sched.stats.query_retries == attempts - 1


def test_deterministic_failure_is_not_retried_and_keeps_the_fleet(cluster, catalog):
    """A NotImplementedError recurs on any worker: the JAX package retries
    it until its workers are blacklisted; the port fails the query once."""
    _workers, nodes = cluster
    sess = HttpClusterSession(catalog, nodes, result_cache=False)
    with pytest.raises(TaskFailure, match="unsorted dictionary"):
        sess.query("select c_phone from customer order by c_phone limit 5")
    st = sess.scheduler.stats_snapshot()
    assert st["task_retries"] == 0 and st["query_retries"] == 0
    assert len(nodes.active_workers()) == 2


def test_blacklist_not_laundered_through_probe_failure():
    w = _start(1, sf=0.002)[0]
    nodes = NodeManager([w.uri], interval=3600, failure_threshold=1,
                        task_failure_threshold=1, blacklist_recovery=60.0)
    nodes.record_task_failure(w.uri, "boom")
    assert nodes.workers[w.uri]["state"] == "BLACKLISTED"
    w.stop()
    nodes.probe_all()
    assert nodes.workers[w.uri]["state"] == "BLACKLISTED"  # not FAILED
    w2 = _start(1, sf=0.002)[0]
    try:
        nodes.workers[w2.uri] = dict(nodes.workers[w.uri], blacklisted_at=time.time())
        del nodes.workers[w.uri]
        nodes.probe_all()
        assert nodes.workers[w2.uri]["state"] == "BLACKLISTED"
    finally:
        w2.stop()


def test_blacklist_drains_and_readmits_with_events():
    seen = []

    class Bus:
        def fire_worker_state(self, uri, state, reason):
            seen.append((uri, state))

    w = _start(1, sf=0.002)[0]
    try:
        nodes = NodeManager([w.uri], interval=3600, task_failure_threshold=2,
                            blacklist_recovery=0.05, event_bus=Bus())
        nodes.record_task_failure(w.uri, "injected fault")
        assert nodes.active_workers() == [w.uri]
        nodes.record_task_failure(w.uri, "injected fault")
        assert nodes.active_workers() == [] and (w.uri, "BLACKLISTED") in seen
        other = NodeManager([w.uri], interval=3600, task_failure_threshold=2)
        other.record_task_failure(w.uri)
        other.record_task_success(w.uri)
        other.record_task_failure(w.uri)
        assert other.active_workers() == [w.uri]
        time.sleep(0.06)
        nodes.probe_all()
        assert nodes.active_workers() == [w.uri] and (w.uri, "ACTIVE") in seen
    finally:
        w.stop()


def test_task_status_deadline_names_worker_task_attempt(catalog):
    sched = HttpScheduler(catalog, NodeManager(["http://127.0.0.1:1"], interval=3600),
                          status_deadline=0.3, status_timeout=0.2)
    with pytest.raises(TaskFailure) as info:
        sched._task_status("http://127.0.0.1:1", "t_9", attempt=2)
    msg = str(info.value)
    assert "t_9" in msg and "127.0.0.1:1" in msg and "attempt 2" in msg
    assert info.value.retryable


# -- cross-task dynamic filters (tests/test_dynfilter.py) ---------------------


def _summaries(seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "values":
        parts = [np.arange(10, dtype=np.int64), np.arange(5, 30, dtype=np.int64)]
    elif kind == "bloom":
        parts = [rng.integers(0, 1 << 30, 300).astype(np.int64),
                 rng.integers(0, 1 << 30, 300).astype(np.int64)]
    elif kind == "mixed":
        parts = [np.arange(10, dtype=np.int64), rng.integers(1000, 1 << 30, 500).astype(np.int64)]
    else:  # doubles, one part empty
        parts = [rng.standard_normal(20), np.zeros(0)]
    port, ref = [], []
    for data in parts:
        typ, rtyp = (T.DOUBLE, RT.DOUBLE) if data.dtype.kind == "f" else (T.BIGINT, RT.BIGINT)
        a = dynfilter.HostFilterAccumulator("k")
        a.add_numpy(data, None, typ)
        r = ref_dynfilter.HostFilterAccumulator("k")
        r.add_numpy(data, None, rtyp)
        port.append(a.summary())
        ref.append(r.summary())
    return port, ref


@pytest.mark.parametrize("kind", ["values", "bloom", "mixed", "doubles"])
def test_merge_summaries_equals_the_jax_package(monkeypatch, kind):
    monkeypatch.setenv("PRESTO_TPU_DYNFILTER_IN_LIMIT", "64")
    monkeypatch.setattr(dynfilter, "IN_LIST_LIMIT", 64)
    port, ref = _summaries(3, kind)
    assert port == ref  # the accumulators agree first
    merged = dynfilter.merge_summaries(port)
    assert merged == ref_dynfilter.merge_summaries(ref)
    assert dynfilter.merge_summaries(port + [None]) is None
    assert dynfilter.merge_summaries([]) is None


@pytest.mark.parametrize("bad", [
    "not a summary",
    {"count": 3, "bloom_b64": "AAAA"},  # a bloom without log2_bits
    {"count": 2, "values": 7},
    {"count": 2, "lo": 1},  # one bound without the other
])
def test_malformed_summary_raises(bad):
    with pytest.raises(ValueError, match="malformed"):
        dynfilter.filter_from_summary(bad, None)
    with pytest.raises(ValueError, match="malformed"):
        dynfilter.merge_summaries([bad, bad])


def test_accumulator_refuses_unsummarisable_types():
    page = Page.from_dict({"s": ["a", "b"], "k": np.arange(2, dtype=np.int64)}, device="cpu")
    acc = dynfilter.HostFilterAccumulator("s")
    acc.add_page(page)
    assert acc.unsupported and acc.summary() is None
    missing = dynfilter.HostFilterAccumulator("nope")
    missing.add_page(page)
    assert missing.unsupported
    ok = dynfilter.HostFilterAccumulator("k")
    ok.add_page(page)
    assert ok.summary()["values"] == [0, 1]


def _force_filters(monkeypatch):
    monkeypatch.setenv("PRESTO_TPU_DYNFILTER_FORCE", "1")


def test_cluster_cross_task_filter_ships_and_keeps_rows(cluster, catalog, monkeypatch):
    _force_filters(monkeypatch)
    monkeypatch.setenv("PRESTO_TPU_DYNFILTER_WAIT_S", "120")
    _workers, nodes = cluster
    sched = HttpScheduler(catalog, nodes)
    local = Session(catalog, device="cpu", dynamic_filtering=False, result_cache=False)
    # broadcast_threshold 0: the probe scan and the build land in separate
    # repartition stages, so the filter travels through the coordinator
    frag = fragment_plan(local.plan(QUERIES[3]), catalog, 0, num_workers=2)
    got = sorted(map(repr, sched.run(frag).to_pylist()))
    assert got == sorted(map(repr, local.query(QUERIES[3]).rows()))
    assert sched.stats.dynfilters_shipped > 0


def test_cluster_wait_timeout_proceeds_without_filter(cluster, catalog, monkeypatch):
    _force_filters(monkeypatch)
    _workers, nodes = cluster
    sched = HttpScheduler(catalog, nodes)
    # expired before the first status poll: with tests/test_dynfilter.py's
    # 1 ms a finished build stage can answer inside the window
    sched.dynfilter_wait = 1e-9
    local = Session(catalog, device="cpu", dynamic_filtering=False, result_cache=False)
    frag = fragment_plan(local.plan(QUERIES[3]), catalog, 0, num_workers=2)
    got = sorted(map(repr, sched.run(frag).to_pylist()))
    assert got == sorted(map(repr, local.query(QUERIES[3]).rows()))
    assert sched.stats.dynfilter_timeouts > 0


# -- the mid-query replan (tests/test_feedback.py) ----------------------------


def _skew_catalog():
    """40,000 rows whose filter the static model underestimates ~16x."""
    rng = np.random.default_rng(11)
    n = 40_000
    return MemoryCatalog({"t": Page.from_dict({
        "k": (np.arange(n, dtype=np.int64), T.BIGINT),
        "v": (rng.integers(0, 100, n).astype(np.int64), T.BIGINT)}, device="cpu")},
        device="cpu")


def test_mid_query_replan_oracle_equal(monkeypatch):
    monkeypatch.setenv("PRESTO_TPU_FEEDBACK", "1")
    qcache.reset_all()
    sql = "select k, v from t where k*1 >= 0 and v*1 >= 0 and k+v >= 0"
    workers = [WorkerServer(_skew_catalog()).start() for _ in range(2)]
    try:
        nodes = NodeManager([w.uri for w in workers], interval=3600)
        sess = HttpClusterSession(_skew_catalog(), nodes)
        res = sorted(sess.query(sql).rows())
        assert sess.scheduler.stats.adaptive_replans >= 1
        assert H.HISTORY.stats.snapshot()["replans"] >= 1
        assert res == sorted(Session(_skew_catalog(), device="cpu").query(sql).rows())
        # the same frame planned from the recorded observation: no replan
        replans = sess.scheduler.stats.adaptive_replans
        qcache.RESULT_CACHE.reset()
        assert sorted(sess.query(sql).rows()) == res
        assert sess.scheduler.stats.adaptive_replans == replans
    finally:
        _stop(workers)
        qcache.reset_all()


# -- the low-memory killer (tests/test_cluster_memory.py) ---------------------


def _memory_cluster(limit, manager=True):
    workers = _start(sf=0.002, memory_limit=limit)
    nodes = NodeManager([w.uri for w in workers], interval=3600)
    return workers, HttpClusterSession(TpchCatalog(0.002, device="cpu"), nodes,
                                       memory_manager=manager, result_cache=False)


def test_memory_endpoint_reports_reservation():
    workers, sess = _memory_cluster(None, manager=False)
    try:
        assert sess.query(SMALL).rows() == [(5,)]
        snap = workers[0].pool.snapshot()
        assert snap["limit"] is None and snap["blocked"] == []
    finally:
        _stop(workers)


def test_cluster_oom_kills_largest_query():
    workers, sess = _memory_cluster(2_000)
    try:
        with pytest.raises(TaskFailure, match="ran out of memory"):
            sess.query(BIG).rows()
        assert sess.memory_manager.killed
        deadline = time.time() + 10
        while time.time() < deadline and any(w.pool.snapshot()["reserved"] for w in workers):
            time.sleep(0.05)
        assert all(w.pool.snapshot()["reserved"] == 0 for w in workers)
        assert sess.query(SMALL).rows() == [(5,)]
    finally:
        sess.close()
        _stop(workers)


def test_within_limit_queries_complete():
    workers, sess = _memory_cluster(64 << 20)
    try:
        got = sess.query(BIG).rows()
        plain = HttpClusterSession(TpchCatalog(0.002, device="cpu"),
                                   NodeManager([w.uri for w in workers], interval=3600),
                                   result_cache=False)
        assert got == plain.query(BIG).rows() and len(got) == 10
        assert not sess.memory_manager.killed
    finally:
        sess.close()
        _stop(workers)


def test_worker_memory_ladder_spills_and_drains(catalog, monkeypatch):
    """Workers under a small executor budget and memory limit take the
    ladder to disk inside their tasks (the worker side of the streaming
    executor's ladder):
    the rows hold, the rollup names the spills, every pool and spill space
    drains."""
    monkeypatch.setenv("PRESTO_TPU_HOST_SPILL_BYTES", "0")
    workers = _start(exec_budget=96 << 10, revoke_watermark=0.02, memory_limit=2 << 20)
    try:
        nodes = NodeManager([w.uri for w in workers], interval=3600)
        sess = HttpClusterSession(catalog, nodes, broadcast_threshold=0, result_cache=False)
        got = sess.query(QUERIES[18]).rows()
        assert got == Session(catalog, device="cpu", result_cache=False).query(
            QUERIES[18]).rows()
        memory = sess.scheduler.stats_snapshot()["memory"]
        assert memory["spilled_bytes"] > 0 and "aggregate" in memory["events"]
        for w in workers:
            snap = w.pool.snapshot()
            assert snap["reserved"] == 0 and snap["leaked_exec_bytes"] == 0
            assert w.spill.snapshot()["active_bytes"] == 0
        assert any(w.pool.snapshot()["revocations"]["watermark_breaches"] for w in workers)
    finally:
        _stop(workers)


def test_victim_selection_total_reservation():
    states = [("w1", {"limit": 100, "reserved": 90, "queries": {"qa": 60, "qb": 30},
                      "blocked": ["qb"]}),
              ("w2", {"limit": 100, "reserved": 50, "queries": {"qa": 10, "qc": 40},
                      "blocked": []})]
    assert ClusterMemoryManager.choose_victim(states) == "qa"
    assert ClusterMemoryManager.choose_victim([("w", {"queries": {}})]) is None


# -- negotiation over a fleet -------------------------------------------------


@pytest.mark.parametrize("advert", [
    {"version": 2, "codecs": ["zlib", "raw"]},  # no lz4, no hier, no dict_cache
    {"version": 1, "codecs": ["lz4", "zlib", "raw"]},
])
def test_mixed_fleet_negotiates_down(catalog, advert):
    workers = _start(1) + _start(1, wire_caps=advert)
    try:
        nodes = NodeManager([w.uri for w in workers], interval=3600)
        sess = HttpClusterSession(catalog, nodes, broadcast_threshold=0, result_cache=False)
        got = sess.query(REPARTITIONED_SQL).rows()
        assert got == Session(catalog, device="cpu", result_cache=False).query(
            REPARTITIONED_SQL).rows()
        st = sess.scheduler.stats_snapshot()
        assert st["wire_caps"]["version"] == advert["version"]
        assert "hier" not in st["wire_caps"] and "dict_cache" not in st["wire_caps"]
        assert not st["hier"]  # every producer took the flat loop
    finally:
        _stop(workers)


def test_hier_knob_off_takes_the_flat_loop(cluster, catalog, monkeypatch):
    monkeypatch.setenv("PRESTO_TPU_HIER_EXCHANGE", "0")
    _workers, nodes = cluster
    sess = HttpClusterSession(catalog, nodes, broadcast_threshold=0, result_cache=False)
    got = sess.query(REPARTITIONED_SQL).rows()
    assert got == Session(catalog, device="cpu", result_cache=False).query(
        REPARTITIONED_SQL).rows()
    assert not sess.scheduler.stats_snapshot()["hier"]
    assert local_capabilities()["hier"] == {"ragged": True}


def test_no_thread_left_behind():
    """Workers stopped in the tests above leave no serving or task thread."""
    deadline = time.time() + 10
    names = ("ptpu-worker-", "ptpu-task-", "ptpu-pull-")
    while time.time() < deadline:
        left = [t.name for t in threading.enumerate() if t.name.startswith(names)]
        # the module-scoped cluster's two serving threads are still up
        if len([n for n in left if not n.startswith("ptpu-worker-")]) == 0:
            break
        time.sleep(0.05)
    assert not [n for n in left if not n.startswith("ptpu-worker-")], left
