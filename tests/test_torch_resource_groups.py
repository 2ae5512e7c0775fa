"""The port's resource groups, query manager and events
(presto_tpu_torch/server/resource_groups.py, state.py, events.py) against
the JAX package's, after tests/test_resource_groups.py: both packages'
managers fed the same sequence of submissions, finishes, cancellations
and pressure take the same decisions (the queries started, in order, the
rejections, each group's running, queued and CPU seconds after every
step); both QueryManagers over the same blocking stand-in session walk
the same states and fire the same events; and the port's session
properties, system tables and REST header cases.

Every wait has a timeout."""

import threading

import numpy as np
import pytest
import torch

from presto_tpu.server import events as revents
from presto_tpu.server import resource_groups as rrg
from presto_tpu.server import state as rstate
from presto_tpu_torch.connectors.memory import MemoryCatalog
from presto_tpu_torch.page import Page
from presto_tpu_torch.server import events, resource_groups as rg, state
from presto_tpu_torch.session import Session, parse_session_properties

torch.set_num_threads(1)

TIMEOUT = 30


class Info:
    def __init__(self, qid, user="user", source=None, priority=1):
        self.query_id = qid
        self.user = user
        self.source = source
        self.priority = priority


TWO_LEVEL = {
    "name": "global", "hard_concurrency_limit": 3, "max_queued": 20,
    "sub_groups": [
        {"name": "etl", "hard_concurrency_limit": 1, "max_queued": 2},
        {"name": "adhoc", "hard_concurrency_limit": 2, "max_queued": 3},
    ],
}
SELECTORS = [{"user": "etl_.*", "group": "global.etl"}, {"group": "global.adhoc"}]
WEIGHTED = {
    "name": "g", "hard_concurrency_limit": 1, "scheduling_policy": "weighted",
    "sub_groups": [
        {"name": "light", "scheduling_weight": 1, "max_queued": 9, "hard_concurrency_limit": 1},
        {"name": "heavy", "scheduling_weight": 5, "max_queued": 9, "hard_concurrency_limit": 1},
    ],
}
WEIGHTED_SELECTORS = [{"source": "l", "group": "g.light"}, {"source": "h", "group": "g.heavy"}]
FAIR = dict(WEIGHTED, scheduling_policy="fair")
PRIORITY = {"name": "p", "hard_concurrency_limit": 1, "max_queued": 10,
            "scheduling_policy": "query_priority"}
QUOTA = {"name": "q", "hard_concurrency_limit": 4, "max_queued": 10,
         "cpu_quota_period_s": 3600.0, "hard_cpu_limit_s": 1.0}

# (root spec, selectors, steps); a step is ("submit", id, user, source,
# priority), ("finish", id, cpu seconds), ("cancel", id) or ("pressure", on)
SCENARIOS = {
    "fifo_release": ({"name": "root", "hard_concurrency_limit": 2, "max_queued": 10}, None, [
        ("submit", "q0", "u", None, 1), ("submit", "q1", "u", None, 1),
        ("submit", "q2", "u", None, 1), ("submit", "q3", "u", None, 1),
        ("finish", "q0", 0.1), ("finish", "q1", 0.1), ("finish", "q2", 0.1),
        ("finish", "q3", 0.1)]),
    "queue_full": ({"name": "root", "hard_concurrency_limit": 1, "max_queued": 1}, None, [
        ("submit", "a", "u", None, 1), ("submit", "b", "u", None, 1),
        ("submit", "c", "u", None, 1), ("finish", "a", 0.0), ("submit", "d", "u", None, 1),
        ("submit", "e", "u", None, 1)]),
    "selectors": (TWO_LEVEL, SELECTORS, [
        ("submit", "a", "etl_nightly", None, 1), ("submit", "b", "etl_hourly", None, 1),
        ("submit", "c", "alice", None, 1), ("submit", "d", "bob", None, 1),
        ("submit", "e", "carol", None, 1), ("submit", "f", "etl_x", None, 1),
        ("submit", "g", "etl_y", None, 1), ("finish", "a", 0.0), ("finish", "c", 0.5),
        ("cancel", "f"), ("finish", "b", 0.0), ("finish", "d", 0.0)]),
    "weighted": (WEIGHTED, WEIGHTED_SELECTORS, [
        ("submit", "blocker", "u", "l", 1), ("submit", "l1", "u", "l", 1),
        ("submit", "h1", "u", "h", 1), ("submit", "l2", "u", "l", 1),
        ("submit", "h2", "u", "h", 1), ("finish", "blocker", 0.0), ("finish", "h1", 0.0),
        ("finish", "h2", 0.0), ("finish", "l1", 0.0)]),
    "fair": (FAIR, WEIGHTED_SELECTORS, [
        ("submit", "blocker", "u", "h", 1), ("submit", "h1", "u", "h", 1),
        ("submit", "l1", "u", "l", 1), ("submit", "h2", "u", "h", 1),
        ("finish", "blocker", 0.0), ("finish", "l1", 0.0), ("finish", "h1", 0.0)]),
    "query_priority": (PRIORITY, None, [
        ("submit", "run", "u", None, 1), ("submit", "low", "u", None, 1),
        ("submit", "high", "u", None, 9), ("submit", "mid", "u", None, 5),
        ("finish", "run", 0.0), ("finish", "high", 0.0), ("finish", "mid", 0.0)]),
    "cpu_quota": (QUOTA, None, [
        ("submit", "a", "u", None, 1), ("finish", "a", 2.0), ("submit", "b", "u", None, 1),
        ("submit", "c", "u", None, 1), ("cancel", "b")]),
    "pressure": ({"name": "root", "hard_concurrency_limit": 2, "max_queued": 2}, None, [
        ("pressure", True), ("submit", "a", "u", None, 1), ("submit", "b", "u", None, 1),
        ("submit", "c", "u", None, 1), ("cancel", "a")]),
}


def _drive(module, spec, selectors, steps):
    """Every decision of one package's manager over `steps`."""
    started, log = [], []
    pressure = [False]
    mgr = module.ResourceGroupManager(spec, selectors, dispatch=lambda i: started.append(
        i.query_id), poll_interval_s=3600.0, cluster_pressure=lambda: pressure[0])
    infos = {}
    for step in steps:
        op = step[0]
        if op == "submit":
            _op, qid, user, source, priority = step
            infos[qid] = Info(qid, user, source, priority)
            try:
                mgr.submit(infos[qid])
                outcome = "ok"
            except module.QueryRejected as e:
                outcome = "rejected: " + str(e)
        elif op == "finish":
            mgr.finished(infos[step[1]], step[2])
            outcome = "ok"
        elif op == "cancel":
            outcome = mgr.remove_queued(infos[step[1]])
        else:
            pressure[0] = step[1]
            outcome = "ok"
        log.append((step, outcome, list(started),
                    [(s.name, s.running, s.queued, round(s.cpu_used_s, 6))
                     for s in mgr.stats()], mgr.pressure_deferrals))
    return log


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_same_decisions_across_packages(name):
    spec, selectors, steps = SCENARIOS[name]
    got = _drive(rg, spec, selectors, steps)
    want = _drive(rrg, spec, selectors, steps)
    assert got == want


def test_scenarios_decide_what_they_name():
    log = _drive(rg, *SCENARIOS["queue_full"])
    assert log[2][1].startswith("rejected: queue full")
    log = _drive(rg, *SCENARIOS["weighted"])
    assert log[5][2][1] == "h1"  # the heavier group first
    log = _drive(rg, *SCENARIOS["query_priority"])
    assert log[-1][2] == ["run", "high", "mid", "low"]
    log = _drive(rg, *SCENARIOS["cpu_quota"])
    assert log[2][2] == ["a"] and log[4][1] is True  # quota spent: b waits, then cancels
    log = _drive(rg, *SCENARIOS["pressure"])
    assert log[3][2] == [] and log[3][1].startswith("rejected") and log[3][4] >= 2


# -- the query manager over a stand-in session ---------------------------------


class _Block:
    type = "bigint"


class _Result:
    titles = ["n"]

    class page:
        blocks = (_Block(),)

    trace_id = None
    phase_ms = None

    def __init__(self, n):
        self.n = n

    def rows(self):
        return [(self.n,)]


class _BlockingSession:
    """query() waits until released; `fail` texts raise."""

    def __init__(self):
        self.release = {}

    def query(self, sql):
        if sql.startswith("fail"):
            raise ValueError("boom")
        ev = self.release.setdefault(sql, threading.Event())
        assert ev.wait(TIMEOUT)
        return _Result(len(sql))


def _manager_run(smod, emod):
    class Capture(emod.EventListener):
        def __init__(self):
            self.seen = []

        def query_created(self, e):
            self.seen.append(("created", e.query_id, e.sql))

        def query_completed(self, e):
            self.seen.append(("completed", e.query_id, e.state, e.rows))

    sess, cap = _BlockingSession(), Capture()
    mgr = smod.QueryManager(sess, resource_groups={"name": "g", "hard_concurrency_limit": 1,
                                                   "max_queued": 2}, listeners=[cap])
    for sql in ("a", "bb", "ccc"):
        sess.release[sql] = threading.Event()
    infos = [mgr.submit(sql) for sql in ("a", "bb", "ccc", "dddd")]
    for _ in range(100):
        if infos[0].state == "RUNNING":
            break
        mgr.wait(infos[0].query_id, 0.05)
    states = [[i.state for i in infos]]
    assert mgr.cancel(infos[1].query_id) is True
    states.append([i.state for i in infos])
    for sql in ("a", "ccc"):
        sess.release[sql].set()
    for i in (infos[0], infos[2]):
        mgr.wait(i.query_id, TIMEOUT)
    fail = mgr.submit("fail now")
    mgr.wait(fail.query_id, TIMEOUT)
    states.append([i.state for i in infos + [fail]])
    rows = [i.rows for i in infos + [fail]]
    errors = [("boom" in (i.error or ""), "queue full" in (i.error or "")) for i in infos + [fail]]
    return states, rows, errors, sorted(cap.seen)


def test_query_manager_same_states_and_events_across_packages():
    got = _manager_run(state, events)
    want = _manager_run(rstate, revents)
    assert got == want
    states, rows, errors, _seen = got
    assert states[0] == ["RUNNING", "QUEUED", "QUEUED", "FAILED"]
    assert states[-1] == ["FINISHED", "CANCELED", "FINISHED", "FAILED", "FAILED"]
    assert rows[0] == [(1,)] and rows[2] == [(3,)]
    assert errors[3] == (False, True) and errors[4] == (True, False)


# -- session properties and the system tables ---------------------------------


def test_session_properties_parse_like_the_reference():
    from presto_tpu.session import parse_session_properties as rparse

    text = "broadcast_threshold=5, streaming=true,query_priority=3"
    assert parse_session_properties(text) == rparse(text) == {
        "broadcast_threshold": 5, "streaming": True, "query_priority": 3}
    for bad in ("nope=1", "streaming=maybe", "x"):
        with pytest.raises(ValueError):
            parse_session_properties(bad)
        with pytest.raises(ValueError):
            rparse(bad)


def test_query_priority_property_orders_the_queue():
    info = state.QueryInfo("q_1", "select 1", properties={"query_priority": 7})
    rinfo = rstate.QueryInfo("q_1", "select 1", properties={"query_priority": 7})
    assert info.priority == rinfo.priority == 7
    assert state.QueryInfo("q_2", "x").priority == 1


def test_system_runtime_queries_and_passthrough():
    from presto_tpu_torch.connectors.system import SystemCatalog

    cat = MemoryCatalog({"t": Page.from_dict({"v": np.arange(5, dtype=np.int64)},
                                             device="cpu")}, device="cpu")
    syscat = SystemCatalog(cat)
    sess = Session(syscat, device="cpu")
    mgr = state.QueryManager(sess)
    syscat.manager = mgr
    info = mgr.submit("select sum(v) from t")
    mgr.wait(info.query_id, TIMEOUT)
    assert info.rows == [(10,)]
    rows = sess.query("select query_id, state, output_rows from system.runtime.queries").rows()
    assert (info.query_id, "FINISHED", 1) in rows
    assert sess.query("select count(*) from system.jmx.memory").rows() == [(1,)]
    assert sess.query("select count(*) from system.runtime.plan_history").rows()[0][0] >= 0
    sess.query("create table t2 (a bigint)")  # DDL passes through to the memory catalog
    sess.query("insert into t2 values (4)")
    assert sess.query("select a from t2").rows() == [(4,)]
    assert syscat.table_version("system.runtime.queries") is None


def test_system_materialized_views_attach():
    from presto_tpu_torch.connectors.system import SystemCatalog

    cat = MemoryCatalog({"t": Page.from_dict({"v": np.arange(5, dtype=np.int64)},
                                             device="cpu")}, device="cpu")
    syscat = SystemCatalog(cat)
    sess = Session(syscat, device="cpu")
    assert syscat.matview_manager is sess.matviews_mgr
    derived = sess.with_properties({"pallas_groupby": False})
    assert syscat.matview_manager is sess.matviews_mgr and derived is not sess
    assert sess.query("select count(*) from system.runtime.materialized_views").rows() == [(0,)]
