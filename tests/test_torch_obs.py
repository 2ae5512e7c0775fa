"""The port's observability plane (presto_tpu_torch/obs/) against the JAX
package's, the cases of tests/test_tracing.py:

* span trees: begin and finish, the idempotent remote merge, retries as
  siblings, exclusive walls, the bounded store; the critical-path string
  of both packages' renderers over the same spans;
* the metrics registry: counters, gauges, histograms, producers, label
  escaping; the Prometheus text of both packages' registries fed the same
  sequence;
* the kernel profile: record, snapshot, reset and wrap against the JAX
  package's class; the port's event pairs (parked, read once complete,
  bounded, none dropped unread) with stand-in CUDA events; the CPU
  wrappers record nothing;
* the traced Session, EXPLAIN ANALYZE's `-- trace:` footer,
  system.runtime.metrics and tasks, the query_completed event's trace,
  NodeStats;
* a traced HttpClusterSession over two in-process CPU workers: the merged
  trace holds every task's span and the wait split under it; a worker's
  /v1/metrics.

Every HTTP call has a timeout, and every server stops in a finally."""

import json
import urllib.request

import pytest
import torch

from presto_tpu.obs import kernelprof as rkp
from presto_tpu.obs import span as rspan
from presto_tpu.obs.metrics import MetricsRegistry as RRegistry
from presto_tpu.server import knobs as rknobs
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.obs.kernelprof import KERNEL_PROFILE, KernelProfile, kernels_line
from presto_tpu_torch.obs.metrics import METRICS, MetricsRegistry
from presto_tpu_torch.obs.span import TRACES, Trace, TraceStore, render_critical_path
from presto_tpu_torch.server import knobs
from presto_tpu_torch.session import Session

torch.set_num_threads(1)

SF = 0.002


# -- span trees ---------------------------------------------------------------


def test_span_tree_basics():
    tr = Trace()
    root = tr.begin("query", sql="select 1")
    child = tr.begin("plan", parent=root)
    tr.finish(child)
    tr.finish(root, rows=1)
    assert root.parent_id is None
    assert child.parent_id == root.span_id
    assert tr.root() is root
    assert tr.children(root.span_id) == [child]
    assert tr.orphans() == []
    assert root.wall_s >= child.wall_s >= 0
    assert root.attrs["rows"] == 1


def test_remote_merge_is_idempotent_and_upgrades():
    coord = Trace("abc123")
    worker = Trace("abc123")
    anchor = coord.begin("dispatch t_1")
    span = worker.begin("task t_1", parent_id=anchor.span_id)
    assert coord.add_remote(worker.to_dicts()) == 1
    merged = {s.span_id: s for s in coord.spans()}[span.span_id]
    assert merged.end is None
    worker.finish(span, rows=7)
    assert coord.add_remote(worker.to_dicts()) == 1
    assert len(coord.spans()) == 2
    merged = {s.span_id: s for s in coord.spans()}[span.span_id]
    assert merged.end is not None and merged.attrs["rows"] == 7
    assert coord.add_remote([{"name": "no-id"}, None]) == 0


def test_retry_attempts_are_siblings():
    tr = Trace()
    stage = tr.begin("stage hash:Aggregate")
    d1 = tr.begin("dispatch t_1", parent=stage, worker="w1")
    tr.finish(d1, "error", error="injected fault")
    d2 = tr.begin("dispatch t_2", parent=stage, worker="w2")
    tr.finish(d2)
    assert [k.status for k in tr.children(stage.span_id)] == ["error", "ok"]
    assert "!" + d1.name in render_critical_path(tr, topk=10)


def test_exclusive_wall_and_critical_path():
    tr = Trace()
    root = tr.add_synthetic("query", None, wall_s=1.0)
    inner = tr.add_synthetic("execute", root, wall_s=0.9)
    tr.add_synthetic("plan", root, wall_s=0.05)
    excl = {s.name: e for s, e in tr.exclusive_walls()}
    assert excl["query"] == pytest.approx(0.05, abs=1e-6)
    assert excl["execute"] == pytest.approx(0.9, abs=1e-6)
    assert tr.critical_path(topk=1)[0][0] is inner


def test_trace_store_bounded(monkeypatch):
    monkeypatch.setenv("PRESTO_TPU_TRACE_KEEP", "3")
    store = TraceStore()
    ids = [store.new_trace().trace_id for _ in range(5)]
    assert store.get(ids[0]) is None
    assert store.get(ids[-1]) is not None
    assert len(store.recent()) == 3


# spans with fixed starts and ends: (name, span id, parent id, start, end,
# status) of a query over a cluster, with a failed dispatch and a task
# still running
_SPANS = [
    ("query", "s0", None, 100.0, 101.25, "ok"),
    ("plan", "s1", "s0", 100.0, 100.05, "ok"),
    ("execute", "s2", "s0", 100.05, 101.25, "ok"),
    ("attempt 0", "s3", "s2", 100.06, 101.24, "ok"),
    ("stage hash:Aggregate", "s4", "s3", 100.07, 100.2, "ok"),
    ("dispatch t_1", "s5", "s4", 100.08, 100.09, "error"),
    ("dispatch t_2", "s6", "s4", 100.1, 100.11, "ok"),
    ("task t_2", "s7", "s6", 100.11, 100.9, "ok"),
    ("exec", "s8", "s7", 100.12, 100.7, "ok"),
    ("wait", "s9", "s8", 100.3, 100.5, "ok"),
    ("emit", "s10", "s7", 100.7, 100.89, "ok"),
    ("encode", "s11", "s10", 100.7, 100.8, "ok"),
    ("exchange s0", "s12", "s3", 100.2, 101.0, "ok"),
    ("root-fragment", "s13", "s3", 101.0, 101.2, "ok"),
    ("task t_3", "s14", "s6", 100.11, None, "ok"),
]


def _fixed_trace(trace_cls):
    tr = trace_cls("fixedtrace01")
    tr.add_remote([{"name": n, "span_id": sid, "parent_id": pid, "start": st, "end": en,
                    "status": status, "attrs": {"rows": 3}}
                   for n, sid, pid, st, en, status in _SPANS])
    return tr


@pytest.mark.parametrize("topk", [1, 3, 5, 20])
def test_critical_path_string_equal_across_packages(topk):
    got = render_critical_path(_fixed_trace(Trace), topk)
    want = rspan.render_critical_path(_fixed_trace(rspan.Trace), topk)
    assert got == want
    assert got.startswith("trace fixedtrace01 wall 1250.0ms; top exclusive: ")


def test_orphans_and_walls_equal_across_packages():
    mine, ref = _fixed_trace(Trace), _fixed_trace(rspan.Trace)
    assert [s.name for s in mine.orphans()] == [s.name for s in ref.orphans()] == []
    assert ([(s.name, round(e, 9)) for s, e in mine.exclusive_walls()]
            == [(s.name, round(e, 9)) for s, e in ref.exclusive_walls()])
    assert mine.to_dicts() == ref.to_dicts()


@pytest.mark.parametrize("env,expect", [
    ({}, (True, 64, 5)),
    ({"PRESTO_TPU_TRACE": "0", "PRESTO_TPU_TRACE_KEEP": "3", "PRESTO_TPU_TRACE_TOPK": "9"},
     (False, 3, 9)),
    ({"PRESTO_TPU_TRACE": "false", "PRESTO_TPU_TRACE_KEEP": "x", "PRESTO_TPU_TRACE_TOPK": ""},
     (False, 64, 5)),
    ({"PRESTO_TPU_TRACE": "yes"}, (True, 64, 5)),
])
def test_trace_knobs_equal_across_packages(monkeypatch, env, expect):
    for k in ("PRESTO_TPU_TRACE", "PRESTO_TPU_TRACE_KEEP", "PRESTO_TPU_TRACE_TOPK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = (knobs.trace_enabled(), knobs.trace_keep(), knobs.trace_topk())
    want = (rknobs.trace_enabled(), rknobs.trace_keep(), rknobs.trace_topk())
    assert got == want == expect


# -- metrics registry ---------------------------------------------------------


def _feed_counters(reg):
    reg.counter("t_hits_total", 2, {"cache": "plan"}, help="hits")
    reg.counter("t_hits_total", 1, {"cache": "plan"})
    reg.counter("t_hits_total", 5, {"cache": "result"})
    reg.declare_counter("t_zero_total", "declared")


def _feed_gauges(reg):
    reg.gauge("t_bytes", 42.0, help="bytes")
    reg.gauge("t_bytes", 43.5)
    reg.gauge("t_ratio", 0.1, {"role": "task"})


def _feed_histograms(reg):
    for v in (0.0001, 0.001, 0.002, 0.5, 3.0, 1e6):
        reg.observe("t_seconds", v, help="wall")
    reg.observe("t_other_seconds", 0.004)


def _feed_escaping(reg):
    reg.counter("t_esc_total", 1, {"q": 'a"b\\c\nd'}, help='a "help"\nline')


def _feed_producers(reg):
    reg.register_producer("good", lambda: [("t_pull", "gauge", (("k", "v"),), 1.0)])
    reg.register_producer("bad", lambda: 1 / 0)
    reg.counter("t_after_total", 1)


@pytest.mark.parametrize("feed", [_feed_counters, _feed_gauges, _feed_histograms,
                                  _feed_escaping, _feed_producers],
                         ids=["counters", "gauges", "histograms", "escaping", "producers"])
def test_prometheus_text_equal_across_packages(feed):
    mine, ref = MetricsRegistry(), RRegistry()
    feed(mine)
    feed(ref)
    assert mine.render() == ref.render()
    assert mine.collect() == ref.collect()


def test_registry_render_and_reset():
    reg = MetricsRegistry()
    reg.counter("t_hits_total", 2, {"cache": "plan"}, help="hits")
    reg.observe("t_seconds", 0.001)
    reg.observe("t_seconds", 0.002)
    text = reg.render()
    assert 't_hits_total{cache="plan"} 2' in text
    assert 't_seconds_bucket{le="0.002"} 2' in text
    assert "t_seconds_count 2" in text
    reg.register_producer("bad", lambda: 1 / 0)
    assert "presto_scrape_errors_total 1" in reg.render()
    reg.reset()
    assert reg.render() == ("# TYPE presto_scrape_errors_total counter\n"
                            "presto_scrape_errors_total 0\n")


# -- kernel profile -----------------------------------------------------------


@pytest.mark.parametrize("calls", [1, 3])
def test_kernel_profile_splits_compile_from_execute(calls):
    mine, ref = KernelProfile(), rkp.KernelProfile()
    for prof in (mine, ref):
        fn = prof.wrap(lambda x: x + 1)
        assert [fn(i) for i in range(calls)] == list(range(1, calls + 1))
    got, want = mine.snapshot(), ref.snapshot()
    for key in ("compiles", "executions"):
        assert got[key] == want[key]
    assert (got["compiles"], got["executions"]) == (1, calls - 1)
    mine.record(True, 0.5)
    mine.record(False, 0.25)
    assert mine.snapshot()["compile_s"] >= 0.5
    mine.reset()
    assert {k: mine.snapshot()[k] for k in want} == {k: 0 for k in want}


def test_kernel_profile_exceptions_escape_unrecorded():
    for prof in (KernelProfile(), rkp.KernelProfile()):
        def boom(x):
            raise RuntimeError("launch failed: injected")

        fn = prof.wrap(boom)
        with pytest.raises(RuntimeError):
            fn(1)
        snap = prof.snapshot()
        assert snap["compiles"] == 0 and snap["executions"] == 0


class _Event:
    """A stand-in torch.cuda.Event: complete once `done` is set; its
    elapsed time is the two records' ticks apart, in ms."""

    clock = 0

    def __init__(self, enable_timing=True):
        self.at = None
        self.done = False

    def record(self, stream=None):  # a new record is pending, as on the card
        _Event.clock += 1
        self.at = _Event.clock
        self.done = False

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert end.done, "read before completion"
        return float(end.at - self.at)


class _Stream:
    cuda_stream = 7  # the raw handle


@pytest.fixture()
def fake_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda idx: 7, raising=False)
    monkeypatch.delenv("PRESTO_TPU_TRACE", raising=False)


def test_event_pairs_read_only_once_complete(fake_cuda):
    prof = KernelProfile(max_pending=8)
    for _ in range(3):  # each launch one tick: 1 ms between its events
        prof.stop(prof.start("join_probe", "cuda"))
    pairs = [p for _k, p in prof._pending]
    snap = prof.snapshot()
    assert snap["pending"] == 3 and snap["executions"] == 0
    assert snap["kernels"]["join_probe"] == {"launches": 3, "timed": 0, "device_s": 0.0}
    pairs[1][1].done = True  # a later pair completes first: the oldest still blocks
    assert prof.drain() == 0
    pairs[0][1].done = True
    assert prof.drain() == 2
    snap = prof.snapshot()
    assert snap["pending"] == 1 and snap["executions"] == 2
    assert snap["kernels"]["join_probe"]["timed"] == 2
    assert snap["kernels"]["join_probe"]["device_s"] == pytest.approx(2e-3)
    pairs[2][1].done = True
    assert prof.snapshot()["pending"] == 0


def test_event_pairs_bounded_none_dropped(fake_cuda):
    prof = KernelProfile(max_pending=2)
    for _ in range(2):
        prof.stop(prof.start("groupby_partials", "cuda"))
    # both still running: the third launch is counted untimed, not parked
    assert prof.start("groupby_partials", "cuda") is None
    snap = prof.snapshot()
    assert (snap["pending"], snap["untimed"]) == (2, 1)
    assert snap["kernels"]["groupby_partials"]["launches"] == 3
    for _k, pair in list(prof._pending):
        pair[1].done = True
    # completed pairs make room: read first, then the next launch parks
    tok = prof.start("groupby_partials", "cuda")
    assert tok is not None
    prof.stop(tok)
    snap = prof.snapshot()
    assert snap["executions"] == 2 and snap["pending"] == 1
    assert snap["kernels"]["groupby_partials"] == {"launches": 4, "timed": 2,
                                                   "device_s": pytest.approx(2e-3)}


def test_event_pairs_follow_the_trace_switch(fake_cuda, monkeypatch):
    monkeypatch.setenv("PRESTO_TPU_TRACE", "0")
    prof = KernelProfile()
    assert prof.start("join_insert", "cuda") is None
    prof.stop(None)
    assert prof.snapshot()["kernels"] == {}


def test_compiles_by_library_and_kernels_line():
    prof = KernelProfile()
    before = prof.snapshot()
    prof.record_compile("join_probe", 2.0)
    prof.record_compile("join_probe", 0.001)
    after = prof.snapshot()
    assert after["libraries"]["join_probe"] == {"compiles": 2, "seconds": 2.001}
    assert kernels_line(before, after) == "compile +2 (2,001.0ms), execute +0 (0.0ms)"
    assert kernels_line(after, after) == ""
    after = dict(after, executions=3, execute_s=0.0015, pending=1, kernels={
        "join_probe": {"launches": 4, "timed": 3, "device_s": 0.0015}})
    assert kernels_line(before, after) == (
        "compile +2 (2,001.0ms), execute +3 (1.5ms); join_probe 4 (3 timed, 1.500ms device)"
        "; 1 unread")


def test_cpu_wrappers_record_nothing():
    KERNEL_PROFILE.reset()
    s = Session(TpchCatalog(SF, device="cpu"), device="cpu", result_cache=False)
    s.query("select n_name, count(*) from nation, customer where n_nationkey = c_nationkey "
            "group by n_name").rows()
    snap = KERNEL_PROFILE.snapshot()
    assert snap["kernels"] == {} and snap["executions"] == 0 and snap["pending"] == 0


# -- single-process session ---------------------------------------------------


@pytest.fixture(scope="module")
def sess():
    return Session(TpchCatalog(SF, device="cpu"), device="cpu")


def test_session_query_carries_trace(sess):
    res = sess.query("select count(*) from region")
    assert res.trace_id is not None
    assert set(res.phase_ms) == {"plan", "execute"}
    tr = TRACES.get(res.trace_id)
    root = tr.root()
    kids = tr.children(root.span_id)
    assert sorted(k.name for k in kids) == ["execute", "plan"]
    assert abs(sum(k.wall_s for k in kids) - root.wall_s) <= max(0.01, 0.1 * root.wall_s)
    assert root.attrs["sql"] == "select count(*) from region"


def test_session_trace_disabled(monkeypatch):
    monkeypatch.setenv("PRESTO_TPU_TRACE", "0")
    s = Session(TpchCatalog(SF, device="cpu"), device="cpu")
    res = s.query("select count(*) from nation")
    assert res.trace_id is None and res.phase_ms is None
    assert "-- trace:" not in s.explain_analyze("select count(*) from nation")


def test_explain_analyze_trace_footer(sess):
    out = sess.query("explain analyze select r_name, count(*) from region group by r_name")
    text = "\n".join(r[0] for r in out.rows())
    assert "-- trace: trace " in text
    assert "top exclusive:" in text
    footer = text.split("-- trace:")[1]
    assert "Aggregate" in footer or "TableScan" in footer
    # on the CPU no kernel library is built or launched: no kernels line
    assert "-- kernels:" not in text
    assert text.rstrip().split("\n")[-1].startswith("-- total ")


def test_query_error_traced(sess):
    with pytest.raises(Exception):
        sess.query("select no_such_column from region")
    assert any(s.status == "error" for tr in TRACES.recent() for s in tr.spans())


def test_queries_total_counts_outcomes(sess):
    def total(outcome):
        return sum(v for n, _t, labels, v in METRICS.collect()
                   if n == "presto_queries_total" and dict(labels).get("outcome") == outcome)

    ok, err = total("ok"), total("error")
    sess.query("select count(*) from nation").rows()
    with pytest.raises(Exception):
        sess.query("select nope from nation")
    assert (total("ok"), total("error")) == (ok + 1, err + 1)


# -- system tables ------------------------------------------------------------


def test_system_runtime_metrics_and_tasks():
    from presto_tpu_torch.connectors.system import SystemCatalog

    s = Session(SystemCatalog(TpchCatalog(SF, device="cpu")), device="cpu")
    s.query("select count(*) from nation")
    rows = s.query("select name, value from system.runtime.metrics "
                   "where name = 'presto_queries_total'").rows()
    assert rows and all(v >= 1 for _, v in rows)
    names = {r[0] for r in s.query("select name from system.runtime.metrics").rows()}
    assert {"presto_qcache_hits_total", "presto_kernel_compiles_total",
            "presto_feedback_hits_total"} <= names
    assert not any(n.startswith("presto_breaker") for n in names)
    task_rows = s.query("select trace_id, name, status, wall_ms from system.runtime.tasks").rows()
    assert any(name == "query" for _, name, _, _ in task_rows)
    assert all(status in ("ok", "error") for _, _, status, _ in task_rows)
    proc = s.query("select backend, devices from system.jmx.process").rows()
    assert proc == [("cpu", 1)]


def test_query_completed_event_carries_trace_and_phases():
    from presto_tpu_torch.server.client import Client
    from presto_tpu_torch.server.coordinator import CoordinatorServer
    from presto_tpu_torch.server.events import EventListener

    class Capture(EventListener):
        def __init__(self):
            self.events = []

        def query_completed(self, event):
            self.events.append(event)

    cap = Capture()
    srv = CoordinatorServer(Session(TpchCatalog(SF, device="cpu"), device="cpu"),
                            listeners=[cap]).start()
    try:
        Client(srv.uri, timeout=30).execute("select count(*) from region")
        ev = cap.events[-1]
        assert ev.state == "FINISHED" and ev.rows == 1
        assert ev.trace_id is not None
        assert ev.phase_ms and "execute" in ev.phase_ms
        assert TRACES.get(ev.trace_id) is not None
        with urllib.request.urlopen(srv.uri + "/v1/metrics", timeout=30) as r:
            assert "text/plain" in r.headers.get("Content-Type", "")
            text = r.read().decode()
        for needle in ("presto_queries_total", "presto_qcache_hits_total",
                       "presto_kernel_compiles_total", "presto_resource_group_running"):
            assert needle in text
        assert "presto_breakers_open_count" not in text  # the port has no breaker
    finally:
        srv.stop()


def test_node_stats_tracks_cumulative_and_peak_bytes():
    from presto_tpu_torch.exec.stats import NodeStats, StatsCollector

    coll = StatsCollector()
    node = object()
    for b in (100, 300, 50):
        coll.record(node, 0.01, 1, 1, out_bytes=b)
    coll.resolve()
    s = coll.lookup(node)
    assert (s.out_bytes, s.out_bytes_total, s.out_bytes_peak) == (50, 450, 300)
    assert (s.rows_in, s.rows_out, s.calls) == (3, 3, 3)
    assert "Σ" in s.line() and "peak" in s.line()
    assert "Σ" not in NodeStats(calls=1, out_bytes=10, out_bytes_total=10).line()


def test_resolve_exports_node_stats():
    from presto_tpu_torch.exec.stats import StatsCollector

    def calls():
        return sum(v for n, _t, _l, v in METRICS.collect() if n == "presto_exec_node_calls_total")

    before = calls()
    coll = StatsCollector()
    coll.record(object(), 0.01, 1, torch.tensor(4), out_bytes=8)
    coll.resolve()
    assert calls() == before + 1


# -- the HTTP cluster ----------------------------------------------------------


@pytest.fixture(scope="module")
def cluster():
    from presto_tpu_torch.server import HttpClusterSession, NodeManager, WorkerServer

    workers = [WorkerServer(TpchCatalog(SF, device="cpu")).start() for _ in range(2)]
    try:
        nodes = NodeManager([w.uri for w in workers], interval=3600)
        yield workers, HttpClusterSession(TpchCatalog(SF, device="cpu"), nodes,
                                          broadcast_threshold=0, result_cache=False)
    finally:
        for w in workers:
            w.stop()


_CLUSTER_SQL = ("select n_name, count(*) from nation, customer where n_nationkey = c_nationkey "
                "group by n_name order by n_name")


def test_cluster_trace_holds_every_task(cluster):
    _workers, sess = cluster
    res = sess.query(_CLUSTER_SQL)
    want = Session(TpchCatalog(SF, device="cpu"), device="cpu").query(_CLUSTER_SQL).rows()
    assert res.rows() == want
    assert set(res.phase_ms) == {"plan", "execute"}
    tr = TRACES.get(res.trace_id)
    assert tr.orphans() == []
    spans = tr.spans()
    dispatches = [s for s in spans if s.name.startswith("dispatch ")]
    tasks = [s for s in spans if s.name.startswith("task ")]
    assert dispatches and len(tasks) == len(dispatches)
    for d in dispatches:
        kids = tr.children(d.span_id)
        assert [k.name for k in kids] == ["task " + d.name.split(" ", 1)[1]]
        task = kids[0]
        assert task.status == "ok" and task.end is not None
        assert {"serve_wait_ms", "serve_send_ms", "pages", "bytes"} <= set(task.attrs)
        names = sorted(c.name for c in tr.children(task.span_id))
        assert names == ["emit", "exec"]
        emit = next(c for c in tr.children(task.span_id) if c.name == "emit")
        assert [c.name for c in tr.children(emit.span_id)] == ["encode"]
    consumers = [t for t in tasks
                 if any(c.name == "wait" for e in tr.children(t.span_id)
                        for c in tr.children(e.span_id))]
    assert consumers
    for t in consumers:
        ex = next(c for c in tr.children(t.span_id) if c.name == "exec")
        wait = next(c for c in tr.children(ex.span_id) if c.name == "wait")
        assert sorted(c.name for c in tr.children(wait.span_id)) == ["decode", "pull"]
    names = {s.name for s in spans}
    assert {"query", "plan", "execute", "attempt 0", "root-fragment"} <= names
    assert any(n.startswith("stage hash:") for n in names)
    assert any(n.startswith("exchange ") for n in names)


def test_cluster_explain_analyze_trace_and_metrics(cluster):
    workers, sess = cluster
    text = sess.explain_analyze(_CLUSTER_SQL)
    assert "-- trace: trace " in text and "top exclusive:" in text
    with urllib.request.urlopen(workers[0].uri + "/v1/metrics", timeout=30) as r:
        metrics = r.read().decode()
    for needle in ("presto_exchange_pages_total", "presto_kernel_executions_total",
                   'presto_worker_tasks_total{state="FINISHED"}', "presto_wire_pages_total",
                   "presto_hier_wire_bytes_total"):
        assert needle in metrics
    status = json.loads(urllib.request.urlopen(workers[0].uri + "/v1/status", timeout=30).read())
    assert status["state"] == "ACTIVE"


def test_untraced_cluster_query(cluster, monkeypatch):
    _workers, sess = cluster
    monkeypatch.setenv("PRESTO_TPU_TRACE", "0")
    res = sess.query(_CLUSTER_SQL)
    assert res.trace_id is None and res.phase_ms is None
    assert len(res.rows()) == 25
