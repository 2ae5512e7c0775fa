"""The port's coordinator (presto_tpu_torch/server/coordinator.py, state.py)
on the CPU, the cases of tests/test_server.py's statement protocol:

* POST /v1/statement end to end, nextUri paging of PAGE_ROWS, errors,
  the query listing and /v1/info, graceful shutdown, the bounded history
  and DELETE, the web pages (index, query detail, timeline, resource
  groups), the X-Presto-Session header;
* the raw QueryResults JSON of both packages' coordinators for one query
  with decimals, dates and NULLs (the JAX package's coordinator serves
  only that query: its jit compiles cost seconds a text);
* the port's coordinator rows against the port's Session for TPC-H texts;
* an HttpClusterSession served as it is, with the admission gate fed by
  ClusterMemoryManager.above_watermark, whose verdict equals the JAX
  package's manager polling the same workers.

Every server binds port 0 and stops in a finally; every HTTP call has a
timeout."""

import json
import re
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from presto_tpu_torch.benchmark.tpch_sql import QUERIES
from presto_tpu_torch.connectors.memory import MemoryCatalog
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.page import Page
from presto_tpu_torch.server import Client, CoordinatorServer, QueryError
from presto_tpu_torch.server.coordinator import PAGE_ROWS
from presto_tpu_torch.session import Session

torch.set_num_threads(1)

SF = 0.01
TIMEOUT = 60


def _session(sf=SF):
    return Session(TpchCatalog(sf, device="cpu"), device="cpu")


@pytest.fixture(scope="module")
def coordinator():
    server = CoordinatorServer(_session()).start()
    try:
        yield server
    finally:
        server.stop()


@pytest.fixture(scope="module")
def local():
    return _session()


def _get(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
        return r.read().decode(), r.headers.get("Content-Type", "")


def _post(url, body: bytes, headers=None):
    req = urllib.request.Request(url, data=body, method="POST", headers=headers or {})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def test_statement_protocol_end_to_end(coordinator, local):
    sql = ("select o_orderpriority, count(*) c from orders "
           "group by o_orderpriority order by o_orderpriority")
    cols, rows = Client(coordinator.uri, timeout=TIMEOUT).execute(sql)
    assert [c["name"] for c in cols] == ["o_orderpriority", "c"]
    assert [c["type"] for c in cols] == ["varchar", "bigint"]
    assert [tuple(r) for r in rows] == local.query(sql).rows()


@pytest.mark.parametrize("q", [1, 3, 5, 6, 10, 13, 18, 22])
def test_coordinator_rows_equal_session_rows(coordinator, local, q):
    from presto_tpu_torch.server.coordinator import _json_default

    _cols, rows = Client(coordinator.uri, timeout=TIMEOUT).execute(QUERIES[q])
    want = json.loads(json.dumps([list(r) for r in local.query(QUERIES[q]).rows()],
                                 default=_json_default))
    assert rows == want


def test_statement_paging(coordinator):
    sql = "select o_orderkey from orders order by o_orderkey limit 2500"
    first = _post(coordinator.uri + "/v1/statement", sql.encode())
    assert first["stats"]["state"] in ("QUEUED", "RUNNING", "FINISHED")
    chunks, payload = [], first
    while payload.get("nextUri"):
        body, _ = _get(payload["nextUri"] + "?maxWait=5")
        payload = json.loads(body)
        if "data" in payload:
            chunks.append(len(payload["data"]))
    assert chunks == [PAGE_ROWS, PAGE_ROWS, 500]
    _cols, rows = Client(coordinator.uri, timeout=TIMEOUT).execute(sql)
    assert len(rows) == 2500 and rows[0][0] == 1 and rows[-1][0] == sorted(
        r[0] for r in rows)[-1]


def test_statement_error_reported(coordinator):
    with pytest.raises(QueryError):
        Client(coordinator.uri, timeout=TIMEOUT).execute("select no_such_column from orders")


def test_bad_session_property_is_400(coordinator):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(coordinator.uri + "/v1/statement", b"select 1",
              {"X-Presto-Session": "no_such_property=1"})
    assert e.value.code == 400


def test_session_property_header_applies(coordinator):
    out = _post(coordinator.uri + "/v1/statement", b"select count(*) from region",
                {"X-Presto-Session": "pallas_groupby=false"})
    info = coordinator.manager.wait(out["id"], TIMEOUT)
    assert info.state == "FINISHED" and info.rows == [(5,)]
    assert info.properties == {"pallas_groupby": False}


def test_query_listing_and_info(coordinator):
    client = Client(coordinator.uri, timeout=TIMEOUT)
    client.execute("select count(*) from nation")
    assert any(q["state"] == "FINISHED" for q in client.queries())
    info = client.node_info()
    assert info["coordinator"] is True and info["state"] == "ACTIVE"
    status = json.loads(_get(coordinator.uri + "/v1/status")[0])
    assert set(status["caches"]) == {"plan", "result", "history"}
    detail = json.loads(_get(f"{coordinator.uri}/v1/query/{client.queries()[0]['queryId']}")[0])
    assert "TableScan" in (detail["plan"] or "") or detail["error"]


def test_resource_group_state(coordinator):
    groups = json.loads(_get(coordinator.uri + "/v1/resourceGroupState")[0])
    assert [g["group"] for g in groups] == ["global"]
    assert groups[0]["running"] == 0


def test_graceful_shutdown_drains():
    server = CoordinatorServer(_session(0.002)).start()
    try:
        client = Client(server.uri, timeout=TIMEOUT)
        client.execute("select count(*) from region")
        req = urllib.request.Request(f"{server.uri}/v1/info/state", data=b'"SHUTTING_DOWN"',
                                     method="PUT")
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            assert json.loads(r.read())["state"] == "SHUTTING_DOWN"
        with pytest.raises(QueryError):
            client.execute("select count(*) from region")
        assert client.node_info()["state"] == "SHUTTING_DOWN"
    finally:
        server.stop()


def test_query_history_bounded_and_delete_purges():
    from presto_tpu_torch.server.state import QueryManager

    mgr = QueryManager(_session(0.002), max_history=3)
    ids = []
    for _ in range(6):
        info = mgr.submit("select count(*) from region")
        mgr.wait(info.query_id, TIMEOUT)
        ids.append(info.query_id)
    assert len([q for q in mgr.list_queries() if q.done]) <= 4
    assert mgr.cancel(ids[-1]) is True
    assert mgr.get(ids[-1]) is None


def test_transactions_rejected_over_rest(coordinator):
    with pytest.raises(QueryError, match="transactions"):
        Client(coordinator.uri, timeout=TIMEOUT).execute("start transaction")


def test_query_detail_page_and_index(coordinator):
    c = Client(coordinator.uri, timeout=TIMEOUT)
    c.execute("select count(*) from region")
    qid = max(coordinator.manager.list_queries(), key=lambda i: i.created_at).query_id
    page, ctype = _get(f"{coordinator.uri}/query/{qid}")
    assert "text/html" in ctype
    assert "Plan" in page and "select count(*)" in page and "FINISHED" in page
    assert "TableScan" in page
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(f"{coordinator.uri}/query/nope", timeout=TIMEOUT)
    index, _ = _get(coordinator.uri + "/")
    assert "presto-tpu coordinator" in index and qid in index


def test_web_ui_timeline_and_stages():
    cat = MemoryCatalog({"t": Page.from_dict({"v": np.arange(10, dtype=np.int64)},
                                             device="cpu")}, device="cpu")
    srv = CoordinatorServer(Session(cat, device="cpu")).start()
    try:
        qid = _post(f"{srv.uri}/v1/statement", b"select sum(v) from t")["id"]
        srv.manager.wait(qid, TIMEOUT)
        assert srv.manager.get(qid).rows == [(45,)]
        tl, _ = _get(f"{srv.uri}/timeline")
        assert "Query timeline" in tl and qid in tl
        qd, _ = _get(f"{srv.uri}/query/{qid}")
        assert "Stages" in qd
    finally:
        srv.stop()


def test_served_session_keeps_the_device_and_system_tables(coordinator):
    served = coordinator.manager.session
    assert served.device == torch.device("cpu")
    assert served.catalog.device == torch.device("cpu")
    assert coordinator.syscat.self_uri == coordinator.uri
    _c, rows = Client(coordinator.uri, timeout=TIMEOUT).execute(
        "select node_id, state, coordinator from system.runtime.nodes")
    assert rows == [[coordinator.uri, "ACTIVE", "true"]]


# -- the QueryResults JSON of both packages ----------------------------------

# decimals (a sum and a column), dates, NULLs (nullif), varchar and bigint
JSON_SQL = ("select o_orderkey, o_totalprice, o_orderdate, nullif(o_orderpriority, '1-URGENT') p, "
            "o_totalprice * 2 t2 from orders where o_orderkey < 40 order by o_orderkey")


def _raw_results(server):
    """Every QueryResults payload of JSON_SQL, the server's address
    replaced."""
    out = [_post(server.uri + "/v1/statement", JSON_SQL.encode())]
    while out[-1].get("nextUri"):
        body, _ = _get(out[-1]["nextUri"] + "?maxWait=30")
        out.append(json.loads(body))
    text = json.dumps(out[-1], sort_keys=True).replace(server.uri, "URI")
    return json.loads(text)


def test_query_results_json_equal_across_packages():
    from presto_tpu.connectors.tpch import TpchCatalog as RCatalog
    from presto_tpu.server.coordinator import CoordinatorServer as RCoordinator
    from presto_tpu.session import Session as RSession

    mine = CoordinatorServer(_session(0.002)).start()
    ref = RCoordinator(RSession(RCatalog(sf=0.002))).start()
    try:
        got, want = _raw_results(mine), _raw_results(ref)
    finally:
        mine.stop()
        ref.stop()
    assert got == want
    assert got["columns"][1]["type"].startswith("decimal")
    assert any(row[3] is None for row in got["data"])
    assert re.match(r"\d{4}-\d{2}-\d{2}$", got["data"][0][2])
    assert isinstance(got["data"][0][1], str)  # decimals travel as strings


# -- an HttpClusterSession behind the coordinator -------------------------------


@pytest.fixture(scope="module")
def workers():
    from presto_tpu_torch.server import WorkerServer

    ws = [WorkerServer(TpchCatalog(0.002, device="cpu"), memory_limit=1 << 30).start()
          for _ in range(2)]
    try:
        yield ws
    finally:
        for w in ws:
            w.stop()


@pytest.mark.parametrize("watermark,pressure", [(0.8, False), (0.0, True)])
def test_above_watermark_equal_across_packages(workers, watermark, pressure):
    from presto_tpu.server.cluster import ClusterMemoryManager as RManager
    from presto_tpu.server.cluster import NodeManager as RNodes
    from presto_tpu_torch.server.cluster import ClusterMemoryManager, NodeManager

    uris = [w.uri for w in workers]
    mine = ClusterMemoryManager(NodeManager(uris, interval=3600), revoke_watermark=watermark)
    ref = RManager(RNodes(uris, interval=3600), revoke_watermark=watermark)
    assert mine.above_watermark() is ref.above_watermark() is False  # before any poll
    mine.poll_once()
    ref.poll_once()
    assert mine.above_watermark() == ref.above_watermark() == pressure


def test_cluster_session_served_and_gated(workers):
    from presto_tpu_torch.server import HttpClusterSession, NodeManager

    nodes = NodeManager([w.uri for w in workers], interval=3600)
    sess = HttpClusterSession(TpchCatalog(0.002, device="cpu"), nodes, result_cache=False,
                              memory_manager=True)
    sess.memory_manager.revoke_watermark = 0.0  # every poll reports pressure
    srv = CoordinatorServer(sess).start()
    try:
        assert srv.syscat is None and srv.manager.session is sess
        sess.memory_manager.poll_once()
        out = _post(srv.uri + "/v1/statement", b"select count(*) from orders")
        time.sleep(0.5)
        assert srv.manager.get(out["id"]).state == "QUEUED"  # held by the gate
        sess.memory_manager.revoke_watermark = 0.8
        sess.memory_manager.poll_once()
        info = srv.manager.wait(out["id"], TIMEOUT)
        deadline = time.time() + TIMEOUT
        while not info.done and time.time() < deadline:
            info = srv.manager.wait(out["id"], 1.0)
        assert info.state == "FINISHED" and info.rows == [(3000,)]
        assert info.trace_id is not None and set(info.phase_ms) == {"plan", "execute"}
        assert srv.manager.groups.pressure_deferrals >= 1
    finally:
        srv.stop()
        sess.close()
