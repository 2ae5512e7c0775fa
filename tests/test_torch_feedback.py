"""History-based feedback of presto_tpu_torch (plan/history.py) on the
CPU, held to the JAX package with PRESTO_TPU_FEEDBACK=1: join-order
invariant fingerprints; the same fingerprints of the recordable nodes of
the 22 TPC-H plans at SF 0.01 (the strings are equal: both packages'
literals print alike in these plans); each recordable node's
StatsDeriver row count after one observed run of Q3, Q5, Q9 and Q18;
those queries run twice with feedback on; invalidation on upsert and on
DROP/re-CREATE; the executor's estimate caches keyed by the store's
generation; a thread hammer on record and lookup. A fault in the store
raises, where the JAX package trips its adaptive_plan breaker and plans
statically (the port has no breaker). The JAX package's mid-query replan
case needs its coordinator (ROADMAP queue 1 item 9)."""

import threading

import numpy as np
import pytest
import torch

import chip_smoke
from presto_tpu import types as RT
from presto_tpu.benchmark.tpch_sql import QUERIES
from presto_tpu.connectors.memory import MemoryCatalog as RMemoryCatalog
from presto_tpu.connectors.shardstore import ShardStoreCatalog as RShardStoreCatalog
from presto_tpu.connectors.tpch import TpchCatalog as RTpchCatalog
from presto_tpu.exec.breaker import BREAKERS
from presto_tpu.page import Page as RPage
from presto_tpu.plan import history as RH
from presto_tpu.plan.stats import StatsDeriver as RStatsDeriver
from presto_tpu.session import Session as RSession
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.memory import MemoryCatalog
from presto_tpu_torch.connectors.shardstore import ShardStoreCatalog
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.exec import qcache
from presto_tpu_torch.exec.executor import Executor
from presto_tpu_torch.page import Page
from presto_tpu_torch.plan import history as H
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.plan.stats import StatsDeriver
from presto_tpu_torch.session import Session

# one torch thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

OBSERVED = (3, 5, 9, 18)


def _reset():
    qcache.reset_all()
    RH.HISTORY.reset()
    BREAKERS.reset()


@pytest.fixture(scope="module", autouse=True)
def feedback_on():
    """The whole module runs with feedback on over fresh stores; the knob
    is off by default everywhere else."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PRESTO_TPU_FEEDBACK", "1")
        _reset()
        yield
        _reset()


def _tables(n=8192, seed=7):
    rng = np.random.default_rng(seed)
    return {"t": {"k": np.arange(n, dtype=np.int64),
                  "v": rng.integers(0, 1000, n).astype(np.int64)},
            "u": {"k": rng.integers(0, 64, 512).astype(np.int64),
                  "w": rng.integers(0, 1000, 512).astype(np.int64)}}


def _mem_catalogs(n=8192):
    tables = _tables(n)
    port = MemoryCatalog({name: Page.from_dict({c: (a, T.BIGINT) for c, a in cols.items()},
                                               device="cpu")
                          for name, cols in tables.items()}, device="cpu")
    ref = RMemoryCatalog({name: RPage.from_dict({c: (a, RT.BIGINT) for c, a in cols.items()})
                          for name, cols in tables.items()})
    return port, ref


def _recordable(node, hist):
    """(node kind, fingerprint) of every recordable node, in walk order."""
    out, memo = [], {}
    hist._walk_plan(node, lambda n: out.append((type(n).__name__, hist.fingerprint(n, memo)))
                    if isinstance(n, hist._RECORDABLE) else None)
    return out


def _first_join(node, hist):
    found = []
    hist._walk_plan(node, lambda n: found.append(n) if type(n).__name__ == "Join" else None)
    return found[0]


@pytest.fixture(scope="module")
def tpch():
    """Port and JAX-package sessions over TPC-H SF 0.01, without the
    reference's dynamic filters (they only prune rows; the port's are off
    too, so both collectors count the same rows)."""
    pc, rc = TpchCatalog(0.01, device="cpu"), RTpchCatalog(0.01)
    return (Session(pc, device="cpu", dynamic_filtering=False),
            RSession(rc, dynamic_filtering=False))


@pytest.fixture(scope="module")
def observed(tpch):
    """Q3, Q5, Q9 and Q18 each run twice in both packages with feedback
    on: {q: (port rows of both runs, reference rows of both runs, port
    deriver rows per recordable node after the first run, reference's,
    the port's static derivation)}."""
    ps, rs = tpch
    out = {}
    for q in OBSERVED:
        p1, r1 = ps.query(QUERIES[q]).rows(), rs.query(QUERIES[q]).rows()
        pn, rn = ps.plan(QUERIES[q]), rs.plan(QUERIES[q])
        pd, rd = StatsDeriver(ps.catalog), RStatsDeriver(rs.catalog)
        prow, rrow = [], []
        H._walk_plan(pn, lambda n: prow.append((type(n).__name__, pd.stats(n).rows))
                     if isinstance(n, H._RECORDABLE) else None)
        RH._walk_plan(rn, lambda n: rrow.append((type(n).__name__, rd.stats(n).rows))
                      if isinstance(n, RH._RECORDABLE) else None)
        sd = StatsDeriver(ps.catalog, use_history=False)
        static = []
        H._walk_plan(pn, lambda n: static.append((type(n).__name__, sd.stats(n).rows))
                     if isinstance(n, H._RECORDABLE) else None)
        p2, r2 = ps.query(QUERIES[q]).rows(), rs.query(QUERIES[q]).rows()
        out[q] = ((p1, p2), (r1, r2), prow, rrow, static)
    return out


def test_fingerprint_join_order_invariant():
    """(A JOIN B) and (B JOIN A) are one observed frame in both packages,
    with equal fingerprints; another predicate is another frame."""
    pcat, rcat = _mem_catalogs()
    ps, rs = Session(pcat, device="cpu"), RSession(rcat)
    fps = {}
    for name, sql in (("ab", "select count(*) from t join u on t.k = u.k"),
                      ("ba", "select count(*) from u join t on u.k = t.k"),
                      ("pred", "select count(*) from t join u on t.k = u.k where t.v > 10")):
        fps[name] = H.fingerprint(_first_join(ps.plan(sql), H))
        assert fps[name] == RH.fingerprint(_first_join(rs.plan(sql), RH))
    assert fps["ab"] == fps["ba"] != fps["pred"]


@pytest.mark.parametrize("q", range(1, 23))
def test_tpch_fingerprints_equal_reference(q, tpch):
    ps, rs = tpch
    got = _recordable(ps.plan(QUERIES[q]), H)
    assert got == _recordable(rs.plan(QUERIES[q]), RH) and got


@pytest.mark.parametrize("q", OBSERVED)
def test_observed_stats_equal_reference(q, observed):
    """After one observed run, every recordable node's row estimate is
    the observation, equal to the reference's."""
    _rows, _rrows, prow, rrow, static = observed[q]
    assert prow == rrow and prow != static


@pytest.mark.parametrize("q", OBSERVED)
def test_double_run_equals_reference(q, observed):
    (p1, p2), (r1, r2), *_derived = observed[q]
    for got, want in ((p1, r1), (p2, r2), (p2, p1)):
        diff = chip_smoke.row_diff(got, want)
        assert diff is None, diff


def test_feedback_counters_and_explain(tpch, observed):
    ps, _rs = tpch
    snap = H.HISTORY.stats.snapshot()
    assert snap["records"] > 0 and snap["hits"] > 0
    txt = ps.explain_analyze(QUERIES[5])
    (line,) = [ln for ln in txt.split("\n") if ln.startswith("-- feedback:")]
    assert line.startswith("-- feedback: hits=") and " replans=0" in line
    assert int(line.split("hits=")[1].split()[0]) > 0
    # a plan whose frames are all remembered runs unobserved
    assert not H.HISTORY.wants_observation(ps.plan(QUERIES[5]), ps.catalog)


def test_observed_rows_feed_planner_estimates():
    pcat, _rcat = _mem_catalogs()
    sess = Session(pcat, device="cpu")
    sql = "select count(*) from t join u on t.k = u.k where t.v >= 0"
    node = sess.plan(sql)
    static = StatsDeriver(pcat, use_history=False).stats(node.children[0])
    sess.query(sql)  # observe-once records the actuals
    warm = StatsDeriver(pcat).stats(node.children[0])
    assert warm.rows == 1.0 and static.rows >= warm.rows


def _shardstores(root):
    rng = np.random.default_rng(5)
    k, v = np.arange(6000, dtype=np.int64), rng.integers(0, 100, 6000).astype(np.int64)
    port = ShardStoreCatalog(str(root / "port"), device="cpu")
    ref = RShardStoreCatalog(str(root / "ref"))
    for cat, types, page in ((port, T, lambda d: Page.from_dict(d, device="cpu")),
                             (ref, RT, RPage.from_dict)):
        cat.create_table("events", {"k": types.BIGINT, "v": types.BIGINT}, unique_columns=["k"])
        cat.append("events", page({"k": (k, types.BIGINT), "v": (v, types.BIGINT)}))
    return port, ref


def _live_fps(hist, table):
    return [fp for fp, e in hist.HISTORY.rows_snapshot() if table in e.tables]


SHARD_SQL = "select count(*) from events where v*1 >= 0"


def test_history_dropped_on_upsert(tmp_path):
    port, ref = _shardstores(tmp_path)
    Session(port, device="cpu").query(SHARD_SQL)
    RSession(ref).query(SHARD_SQL)
    fps = _live_fps(H, "events")
    assert fps and sorted(fps) == sorted(_live_fps(RH, "events"))
    inv0 = H.HISTORY.stats.snapshot()["invalidations"]
    k = np.arange(10, dtype=np.int64)
    port.upsert("events", Page.from_dict({"k": (k, T.BIGINT), "v": (k * 0 + 999, T.BIGINT)},
                                         device="cpu"))
    assert all(H.HISTORY.lookup(fp, port) is None for fp in fps)
    assert H.HISTORY.stats.snapshot()["invalidations"] >= inv0 + len(fps)


def test_history_dropped_on_drop_recreate(tmp_path):
    """DROP + re-CREATE must not alias: shard-store versions carry a
    never-reused creation id."""
    port, _ref = _shardstores(tmp_path)
    sess = Session(port, device="cpu")
    sess.query(SHARD_SQL)
    fps = _live_fps(H, "events")
    assert fps
    port.drop_table("events")
    port.create_table("events", {"k": T.BIGINT, "v": T.BIGINT}, unique_columns=["k"])
    z = np.zeros(3, np.int64)
    port.append("events", Page.from_dict({"k": (np.arange(3, dtype=np.int64), T.BIGINT),
                                          "v": (z, T.BIGINT)}, device="cpu"))
    assert all(H.HISTORY.lookup(fp, port) is None for fp in fps)
    assert Session(port, device="cpu").query(SHARD_SQL).rows() == [(3,)]
    assert _live_fps(H, "events")


def test_estimate_caches_keyed_by_generation():
    pcat, _rcat = _mem_catalogs(64)
    ex = Executor(pcat, device="cpu")
    env0 = ex._est_env()
    H.HISTORY.record("join:genkey", catalog=pcat, tables=("t",), rows=5.0)
    assert ex._est_env() != env0 and ex._est_env()[-1] == 1
    # a recorded observation is never answered from a stale estimate
    sess = Session(pcat, device="cpu", result_cache=False)
    sql = "select k from t where v*1 >= 0"
    found = []
    H._walk_plan(sess.plan(sql), lambda n: found.append(n) if isinstance(n, N.Filter) else None)
    before = ex._est_rows(found[0])
    assert before < 64.0  # the static default selectivity
    sess.query(sql)
    assert ex._est_rows(found[0]) == 64.0
    # feedback off pins the token, so toggling the knob re-plans
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PRESTO_TPU_FEEDBACK", "0")
        assert H.plan_env_token() == -1 and not H.feedback_on()


def test_concurrent_record_lookup_hammer():
    """8 threads interleaving record/lookup/snapshot/observed_rows on one
    store: no exception, coherent counters, bounded size."""
    pcat, _rcat = _mem_catalogs(64)
    errors = []
    barrier = threading.Barrier(8)

    def worker(tid):
        rng = np.random.default_rng(tid)
        try:
            barrier.wait()
            for i in range(400):
                fp = f"join:hammer{int(rng.integers(0, 32)):02d}"
                op = i % 4
                if op == 0:
                    H.HISTORY.record(fp, catalog=pcat, tables=("t",),
                                     rows=float(rng.integers(1, 10_000)), est_rows=100.0,
                                     kind="Join")
                elif op == 1:
                    ent = H.HISTORY.lookup(fp, pcat)
                    assert ent is None or ent.rows is None or ent.rows > 0
                elif op == 2:
                    H.HISTORY.rows_snapshot(limit=8)
                else:
                    H.HISTORY.observed_rows(fp, pcat)
        except Exception as exc:  # noqa: BLE001 — reported by the main thread
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    snap = H.HISTORY.stats.snapshot()
    assert snap["records"] > 0 and H.HISTORY.generation >= snap["records"]
    hsnap = qcache.snapshot_all()["history"]
    assert hsnap["entries"] <= hsnap["max_entries"]


def test_store_fault_raises(monkeypatch):
    """A fault in the history store fails the query: no breaker, no
    static fallback."""
    pcat, _rcat = _mem_catalogs(64)
    sess = Session(pcat, device="cpu", result_cache=False)

    def broken(*_a, **_k):
        raise RuntimeError("history store fault")

    monkeypatch.setattr(H.HISTORY.cache, "get", broken)
    with pytest.raises(RuntimeError, match="history store fault"):
        sess.query("select count(*) from t join u on t.k = u.k")
    monkeypatch.setenv("PRESTO_TPU_FEEDBACK", "0")
    assert sess.query("select count(*) from u").rows() == [(512,)]
