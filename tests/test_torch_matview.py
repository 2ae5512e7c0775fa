"""Materialized views of presto_tpu_torch (matview/) on the CPU, held to
the JAX package: the cases of tests/test_matview.py (the classifier with
its reasons; create, query and drop; delta refresh of the aggregate and
append kinds; REFRESH FULL; the join, upsert, too-large and no-op
fallbacks; IF [NOT] EXISTS; the name collisions; the result cache's
patch verdict, on and off; staleness; the auto-refresh thread; a derived
session sharing the registry), each run on a port shard store and a JAX
package shard store given the same writes from the same seeded numpy
tables: equal rows, modes, reasons and counters. Each package reads the
view tables the other wrote. The system.runtime.materialized_views case
waits for connectors/system.py (ROADMAP queue 1 item 9); the EXPLAIN
ANALYZE footer is held here.

Also a deterministic port of tests/test_matview_chaos.py's ingest chaos
(whose JAX version passes and fails from run to run, ROADMAP queue 3):
appenders, an upserter, refreshers and readers on threads for a fixed
number of steps, every read equal to numpy over exactly the rows of the
token its refresh recorded."""

import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke
from presto_tpu import types as RT
from presto_tpu.connectors.shardstore import ShardStoreCatalog as RShardStoreCatalog
from presto_tpu.exec import qcache as rqcache
from presto_tpu.matview import maintenance as rmaintenance
from presto_tpu.page import Page as RPage
from presto_tpu.session import Session as RSession
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.shardstore import ShardStoreCatalog
from presto_tpu_torch.connectors.spi import WriteError
from presto_tpu_torch.exec import qcache
from presto_tpu_torch.matview import maintenance
from presto_tpu_torch.page import Page
from presto_tpu_torch.session import Session

# one torch thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

EV = {"k": np.array([1, 2, 3, 1, 2], np.int64), "v": np.array([10, 20, 30, 40, 50], np.int64)}
GROUP_SQL = "select k, count(*) as n, sum(v) as total from ev group by k"
SUM_SQL = "select k, sum(v) as total from ev group by k"


def same_rows(got, want, ordered=False):
    diff = chip_smoke.row_diff(got, want, ordered)
    assert diff is None, diff


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("matview")


@pytest.fixture()
def frac(monkeypatch):
    """Set DELTA_MAX_FRAC in both packages."""
    def set_frac(x):
        monkeypatch.setattr(maintenance, "DELTA_MAX_FRAC", x)
        monkeypatch.setattr(rmaintenance, "DELTA_MAX_FRAC", x)
    return set_frac


class Pair:
    """A port store and a JAX-package store given the same writes, and a
    session over each."""

    _n = 0

    def __init__(self, root, unique=None, tables=("ev",), fill=True, **kw):
        Pair._n += 1
        d = root / f"p{Pair._n}"
        self.port = ShardStoreCatalog(str(d / "port"), device="cpu")
        self.ref = RShardStoreCatalog(str(d / "ref"))
        for name in tables:
            self.port.create_table(name, {"k": T.BIGINT, "v": T.BIGINT}, unique_columns=unique)
            self.ref.create_table(name, {"k": RT.BIGINT, "v": RT.BIGINT}, unique_columns=unique)
        if fill:
            self.append(EV["k"], EV["v"])
        self.ps = Session(self.port, device="cpu", **kw)
        self.rs = RSession(self.ref, **kw)

    @staticmethod
    def pages(ks, vs):
        ks, vs = np.asarray(ks, np.int64), np.asarray(vs, np.int64)
        return (Page.from_dict({"k": (ks, T.BIGINT), "v": (vs, T.BIGINT)}, device="cpu"),
                RPage.from_dict({"k": (ks, RT.BIGINT), "v": (vs, RT.BIGINT)}))

    def append(self, ks, vs, table="ev"):
        p, r = self.pages(ks, vs)
        self.port.append(table, p)
        self.ref.append(table, r)

    def upsert(self, ks, vs):
        p, r = self.pages(ks, vs)
        got = self.port.upsert("ev", p)
        assert got == self.ref.upsert("ev", r)
        return got

    def query(self, sql, ordered=False):
        got = self.ps.query(sql).rows()
        same_rows(got, self.rs.query(sql).rows(), ordered)
        return got

    def both(self, fn):
        a, b = fn(self.ps), fn(self.rs)
        assert a == b, (a, b)
        return a

    def refresh(self, name, full=False):
        return self.both(lambda s: s.matviews_mgr.refresh(name, full))

    def view(self, name):
        """(last_mode, last_reason, rows_patched, refreshes) of a view,
        equal in both packages."""
        return self.both(lambda s: (lambda mv: (mv.last_mode, mv.last_reason, mv.rows_patched,
                                                mv.refreshes))(s.matviews_mgr.views[name]))

    def raises(self, sql, match):
        for s in (self.ps, self.rs):
            with pytest.raises(ValueError, match=match):
                s.query(sql)


def oracle_groupby(pair):
    page = pair.ref.page("ev")
    n = int(page.count)
    out = {}
    for k, v in zip(np.asarray(page.block("k").data[:n]).tolist(),
                    np.asarray(page.block("v").data[:n]).tolist()):
        c, s = out.get(k, (0, 0))
        out[k] = (c + 1, s + v)
    return sorted((k, c, s) for k, (c, s) in out.items())


# -- classifier --

CLASSIFY = {
    "aggregate": (GROUP_SQL, "aggregate", ""),
    "aggregate_filter_order": ("select k, min(v) as lo, max(v) as hi from ev where v > 5 "
                               "group by k order by k", "aggregate", ""),
    "append": ("select k, v from ev where v > 15", "append", ""),
    "join": ("select a.k from ev a join dim b on a.k = b.k", None, "Join"),
    "avg": ("select k, avg(v) as m from ev group by k", None, "non-decomposable aggregate"),
    "limit_above_agg": ("select k, count(*) as n from ev group by k limit 2", None,
                        "LIMIT/TopN/DISTINCT above an aggregation"),
    "window": ("select k, rank() over (order by v) as r from ev", None, "Window"),
}


@pytest.mark.parametrize("case", sorted(CLASSIFY))
def test_classifier_matrix(case, root):
    sql, kind, reason = CLASSIFY[case]
    pair = Pair(root, tables=("ev", "dim"))
    mplan, why = maintenance.classify(pair.ps.plan(sql))
    rplan, rwhy = rmaintenance.classify(pair.rs.plan(sql))
    assert why == rwhy and reason in why
    assert (mplan is None) == (rplan is None) and (None if mplan is None else mplan.kind) == kind
    if mplan is not None:
        assert mplan.tables == rplan.tables == ("ev",)
        assert mplan.channels == rplan.channels and mplan.titles == rplan.titles
        assert [a.func for a in mplan.merge_aggs] == [a.func for a in rplan.merge_aggs]
        assert len(mplan.terminals) == len(rplan.terminals)


# -- DDL lifecycle against each other and numpy --

def test_create_query_drop(root):
    pair = Pair(root)
    pair.query("create materialized view daily as " + GROUP_SQL)
    assert sorted(pair.query("select * from daily")) == oracle_groupby(pair)
    assert pair.query("select sum(n) from daily") == [(5,)]
    # each package reads the view table the other wrote
    same_rows(ShardStoreCatalog(pair.ref.directory, device="cpu").page("daily").to_pylist(),
              pair.port.page("daily").to_pylist())
    same_rows(RShardStoreCatalog(pair.port.directory).page("daily").to_pylist(),
              pair.ref.page("daily").to_pylist())
    pair.query("drop materialized view daily")
    assert "daily" not in pair.ps.matviews_mgr.views and "daily" not in pair.port.table_names()
    assert "daily" not in pair.ref.table_names()


def test_refresh_delta_aggregate(root, frac):
    frac(1.0)
    pair = Pair(root)
    pair.query("create materialized view daily as " + GROUP_SQL)
    pair.append([2, 7], [5, 77])
    assert pair.refresh("daily") == "delta"
    assert sorted(pair.query("select * from daily")) == oracle_groupby(pair)
    assert pair.view("daily") == ("delta", "2 delta rows", 2, 2)


def test_refresh_delta_append_kind(root, frac):
    frac(1.0)
    pair = Pair(root)
    pair.query("create materialized view hot as select k, v from ev where v >= 30")
    pair.append([8, 9], [3, 300])
    assert pair.refresh("hot") == "delta"
    assert sorted(pair.query("select * from hot")) == [(1, 40), (2, 50), (3, 30), (9, 300)]
    # the append kind keeps the stored table append-only: a new shard
    assert pair.both(lambda s: s.catalog.shard_count("hot")) == 2


def test_refresh_full_statement(root, frac):
    frac(1.0)
    pair = Pair(root)
    pair.query("create materialized view daily as " + SUM_SQL)
    pair.append([5], [500])
    pair.query("refresh materialized view daily full")
    assert pair.view("daily")[:2] == ("full", "forced full")
    assert sorted(pair.query("select * from daily")) == [(k, s) for k, _c, s in
                                                          oracle_groupby(pair)]
    # the statement without FULL takes the delta path
    pair.append([6], [600])
    pair.query("refresh materialized view daily")
    assert pair.view("daily")[0] == "delta"


def test_join_view_falls_back_full(root):
    pair = Pair(root)
    pair.query("create materialized view selfj as "
               "select a.k as k, a.v as v from ev a join ev b on a.k = b.k")
    assert pair.both(lambda s: s.matviews_mgr.views["selfj"].reason) == "Join"
    pair.append([1], [1])
    assert pair.refresh("selfj") == "full"
    pair.query("select * from selfj")


def test_upsert_rewrite_falls_back_full(root, frac):
    frac(1.0)
    pair = Pair(root, unique=["k"], fill=False)
    pair.append([1, 2, 3], [10, 20, 30])
    pair.query("create materialized view daily as " + SUM_SQL)
    # a key collision rewrites: the nonappend version moves, full refresh
    assert pair.upsert([2, 4], [99, 44]) == {"appended": 1, "updated": 1}
    assert pair.refresh("daily") == "full"
    assert pair.view("daily")[:2] == ("full", "delta not applicable (rewrite/large delta/race)")
    assert sorted(pair.query("select * from daily")) == [(1, 10), (2, 99), (3, 30), (4, 44)]


def test_delta_too_large_falls_back_full(root, frac):
    frac(0.1)
    pair = Pair(root)
    pair.query("create materialized view daily as " + SUM_SQL)
    pair.append([1, 2, 3], [1, 2, 3])  # 60% of the base
    assert pair.refresh("daily") == "full"
    assert sorted(pair.query("select * from daily")) == [(k, s) for k, _c, s in
                                                          oracle_groupby(pair)]


def test_noop_refresh_is_delta(root, frac):
    frac(1.0)
    pair = Pair(root)
    pair.query("create materialized view daily as " + SUM_SQL)
    assert pair.refresh("daily") == "delta"
    assert pair.view("daily")[:2] == ("delta", "no-op (base unchanged)")


def test_noop_refresh_racing_append_keeps_its_rows(root, frac, monkeypatch):
    """A refresh reads the version vector, then the delta tokens. An append
    landing between the two reads makes the JAX package's no-op path keep
    tokens past a row it never applied: its view claims to be current and
    lacks the row for good (the intermittent failure of its
    test_matview_chaos.py, ROADMAP queue 3). The port validates the
    versions again and takes the row by delta in the same refresh."""
    frac(1.0)
    pair = Pair(root)
    pair.query("create materialized view daily as " + SUM_SQL)
    for sess, cat, mod in ((pair.ps, pair.port, qcache), (pair.rs, pair.ref, rqcache)):
        real, fired = mod.delta_tokens, []

        def racing(c, tables, real=real, fired=fired, cat=cat):
            if not fired:
                fired.append(True)
                cat.append("ev", Pair.pages([7], [70])[cat is pair.ref])
            return real(c, tables)

        monkeypatch.setattr(mod, "delta_tokens", racing)
        sess.matviews_mgr.refresh("daily")
        monkeypatch.setattr(mod, "delta_tokens", real)
    port, ref = pair.ps.matviews_mgr.views["daily"], pair.rs.matviews_mgr.views["daily"]
    assert (port.last_mode, port.last_reason) == ("delta", "1 delta rows")
    assert (7, 70) in pair.ps.query("select * from daily").rows()
    assert ref.last_reason == "no-op (base unchanged)"
    assert ref.tokens == rqcache.delta_tokens(pair.ref, ("ev",))
    assert (7, 70) not in pair.rs.query("select * from daily").rows()


# -- DDL breadth and error paths --

def test_if_not_exists_and_if_exists(root):
    pair = Pair(root)
    pair.query("create materialized view m as select k from ev")
    pair.raises("create materialized view m as select k from ev", "already exists")
    pair.query("create materialized view if not exists m as select v from ev")
    # IF NOT EXISTS kept the first definition
    assert pair.query("select count(*), sum(k) from m") == [(5, 9)]
    pair.query("drop materialized view m")
    pair.raises("drop materialized view m", "does not exist")
    pair.query("drop materialized view if exists m")
    pair.raises("refresh materialized view nope", "does not exist")


@pytest.mark.parametrize("sql,match", [
    ("create view m as select k from ev", "materialized view"),
    ("create table m (k bigint)", "materialized view"),
    ("drop table m", "DROP MATERIALIZED VIEW"),
    ("create materialized view ev as select k from ev", "already exists"),
    ("create materialized view pv as select k from ev", "already exists"),
])
def test_name_collisions(sql, match, root):
    pair = Pair(root)
    pair.query("create materialized view m as select k from ev")
    pair.query("create view pv as select k from ev")
    pair.raises(sql, match)


# -- the result cache's patch verdict --

def test_result_cache_patch(root, frac):
    frac(1.0)
    pair = Pair(root)
    pair.query(GROUP_SQL)
    snaps = [qcache.RESULT_CACHE.stats.snapshot(), rqcache.RESULT_CACHE.stats.snapshot()]
    pair.append([3, 6], [7, 60])
    assert sorted(pair.query(GROUP_SQL)) == oracle_groupby(pair)
    mid = [qcache.RESULT_CACHE.stats.snapshot(), rqcache.RESULT_CACHE.stats.snapshot()]
    assert [m["patches"] - s["patches"] for m, s in zip(mid, snaps)] == [1, 1]
    # a patched entry serves plain hits until the next write
    pair.query(GROUP_SQL)
    end = [qcache.RESULT_CACHE.stats.snapshot(), rqcache.RESULT_CACHE.stats.snapshot()]
    assert [e["hits"] - m["hits"] for e, m in zip(end, mid)] == [1, 1]
    assert [e["patches"] for e in end] == [m["patches"] for m in mid]
    assert "/" in qcache.format_summary(qcache.snapshot_all()).split("result ")[1]


def test_result_cache_patch_disabled(root, monkeypatch):
    monkeypatch.setattr(maintenance, "PATCH_ENABLED", False)
    monkeypatch.setattr(rmaintenance, "PATCH_ENABLED", False)
    pair = Pair(root)
    pair.query(SUM_SQL)
    snaps = [qcache.RESULT_CACHE.stats.snapshot(), rqcache.RESULT_CACHE.stats.snapshot()]
    pair.append([9], [900])
    assert (9, 900) in pair.query(SUM_SQL)
    end = [qcache.RESULT_CACHE.stats.snapshot(), rqcache.RESULT_CACHE.stats.snapshot()]
    assert [e["patches"] - s["patches"] for e, s in zip(end, snaps)] == [0, 0]
    assert [e["invalidations"] - s["invalidations"] for e, s in zip(end, snaps)] == [1, 1]


def test_result_cache_join_never_patches(root, frac):
    frac(1.0)
    pair = Pair(root)
    sql = "select a.k as k, sum(a.v) as s from ev a join ev b on a.k = b.k group by a.k"
    before = pair.query(sql)
    p0 = qcache.RESULT_CACHE.stats.snapshot()["patches"]
    pair.append([1], [1])
    assert sorted(pair.query(sql)) != sorted(before)  # the rerun saw the new row
    assert qcache.RESULT_CACHE.stats.snapshot()["patches"] == p0


def test_patch_fault_propagates(root, frac, monkeypatch):
    """A fault inside the delta pipeline fails the query (the JAX package
    swallows it and invalidates)."""
    frac(1.0)
    pair = Pair(root)
    pair.ps.query(SUM_SQL)
    pair.append([4], [4])

    def broken(*_a, **_k):
        raise RuntimeError("delta pipeline fault")

    monkeypatch.setattr(maintenance, "patch_pages", broken)
    with pytest.raises(RuntimeError, match="delta pipeline fault"):
        pair.ps.query(SUM_SQL)


# -- observability and the background thread --

def test_staleness_and_explain_footer(root, frac):
    frac(1.0)
    pair = Pair(root)
    pair.query("create materialized view daily as " + SUM_SQL)
    pair.query("create materialized view selfj as "
               "select a.k as k from ev a join ev b on a.k = b.k")
    stale = lambda s: s.matviews_mgr._staleness(s.matviews_mgr.views["daily"])  # noqa: E731
    assert pair.both(stale) == 0
    pair.append([1], [1])
    pair.append([2], [2])
    assert pair.both(stale) == 2
    pair.refresh("daily")
    assert pair.both(stale) == 0
    assert pair.both(lambda s: [{k: v for k, v in r.items() if k != "last_refresh_at"}
                                for r in s.matviews_mgr.rows()])
    (line,) = [ln for ln in pair.ps.explain_analyze("select count(*) from ev").split("\n")
               if ln.startswith("-- matview:")]
    assert "daily aggregate mode=delta" in line and "selfj full(Join)" in line
    assert line == "-- matview: " + pair.rs.matviews_mgr.format_summary()


def test_auto_refresh_thread(root, frac):
    frac(1.0)
    pair = Pair(root)
    sess, mgr = pair.ps, pair.ps.matviews_mgr
    sess.query("create materialized view daily as " + SUM_SQL)
    pair.append([6], [600])
    assert mgr.start_auto_refresh(0.05)
    assert not mgr.start_auto_refresh(0.05)  # one thread at a time
    try:
        deadline = time.time() + 5.0
        while time.time() < deadline and mgr.views["daily"].versions != \
                qcache.table_versions(pair.port, ("ev",)):
            time.sleep(0.02)
        assert (6, 600) in sess.query("select * from daily").rows()
        assert mgr.views["daily"].last_mode == "delta"
    finally:
        mgr.stop_auto_refresh()
    assert mgr._auto_thread is None and not mgr.start_auto_refresh(0)


def test_derived_session_shares_registry(root):
    pair = Pair(root)
    pair.ps.query("create materialized view m as select k from ev")
    derived = pair.ps.with_properties({"streaming": True})
    assert derived is not pair.ps and derived.matviews_mgr is pair.ps.matviews_mgr
    derived.query("refresh materialized view m")
    assert pair.ps.matviews_mgr.views["m"].refreshes == 2


def test_readonly_catalog_raises(root):
    """A view over a catalog that cannot store it raises as a write
    would, after planning and running its query."""
    from presto_tpu_torch.connectors.tpch import TpchCatalog

    s = Session(TpchCatalog(0.001, device="cpu"), device="cpu")
    with pytest.raises(WriteError, match="read-only"):
        s.query("create materialized view mv as select 1 x")
    assert "mv" not in s.matviews_mgr.views


# -- concurrent ingest, deterministic steps --

def _oracle_counts(cat, hi_seq):
    """{k: (count, sum v)} over exactly the rows with seq <= hi_seq."""
    page = cat.scan_delta("ev", 0.0, hi_seq)
    n = int(page.count)
    out = {}
    for k, v in zip(page.block("k").data[:n].tolist(), page.block("v").data[:n].tolist()):
        c, s = out.get(k, (0, 0))
        out[k] = (c + 1, s + v)
    return out


def test_concurrent_ingest_chaos(root, frac):
    """Three appenders (30 single-row appends each, seeded), an upserter
    (20 seeded upserts), two refresh-and-read threads (8 rounds each) and
    a reader of an upserted table's view, all at once: every view read
    equals numpy over the rows its refresh recorded, an upserted key is
    never counted twice, and a last quiet refresh holds every row. Each
    reader reads through a session of its own over the store; refreshes
    go through the one registry."""
    frac(1.0)
    cat = ShardStoreCatalog(str(root / "chaos"), device="cpu")
    cat.create_table("ev", {"k": T.BIGINT, "v": T.BIGINT})
    cat.create_table("kv", {"k": T.BIGINT, "v": T.BIGINT}, unique_columns=["k"])
    page = lambda ks, vs: Pair.pages(ks, vs)[0]  # noqa: E731
    cat.append("ev", page([0, 1, 2], [1, 1, 1]))
    cat.append("kv", page([0], [0]))
    sess = Session(cat, device="cpu")
    mgr = sess.matviews_mgr
    for r in range(2):
        sess.query(f"create materialized view mv_r{r} as " + GROUP_SQL)
    sess.query("create materialized view mv_kv as select k, count(*) as n, sum(v) as total "
               "from kv group by k")
    errors, done, reads = [], [0, 0, 0], [0, 0]
    t_end = time.time() + 10.0

    def appender(i):
        rng = np.random.default_rng(i)
        for _ in range(30):
            cat.append("ev", page([int(rng.integers(0, 8))], [int(rng.integers(1, 10))]))
            done[i] += 1

    def upserter():
        rng = np.random.default_rng(99)
        for i in range(20):
            cat.upsert("kv", page([int(rng.integers(0, 6))], [i]))

    def reader(r):
        own = Session(cat, device="cpu")
        for _ in range(8):
            if time.time() > t_end:
                return
            mgr.refresh(f"mv_r{r}")
            tok = mgr.views[f"mv_r{r}"].tokens
            if tok is None:
                continue  # racing writers used up the retry budget
            got = {k: (n, s) for k, n, s in own.query(f"select k, n, total from mv_r{r}").rows()}
            want = _oracle_counts(cat, tok[0][0])
            if got != want:
                errors.append(f"reader{r}: {got} != {want} at {tok}")
                return
            reads[r] += 1

    def kv_reader():
        own = Session(cat, device="cpu")
        for _ in range(6):
            mgr.refresh("mv_kv")
            dups = [k for k, n in own.query("select k, n from mv_kv").rows() if n != 1]
            if dups:
                errors.append(f"kv_reader: duplicate keys {dups}")
                return

    def guard(fn, *a):
        def run():
            try:
                fn(*a)
            except Exception as e:  # noqa: BLE001 — reported by the main thread
                errors.append(f"{fn.__name__}{a}: {e!r}")
        return threading.Thread(target=run)

    threads = ([guard(appender, i) for i in range(3)] + [guard(upserter)]
               + [guard(reader, r) for r in range(2)] + [guard(kv_reader)])
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive(), "chaos thread wedged"
    assert not errors, errors
    assert sum(done) == 90 and sum(reads) > 0
    for r in range(2):
        mgr.refresh(f"mv_r{r}")  # delta, or full where racing writers nulled the cursor
        tok = mgr.views[f"mv_r{r}"].tokens
        assert tok is not None
        got = {k: (n, s) for k, n, s in sess.query(f"select k, n, total from mv_r{r}").rows()}
        assert got == _oracle_counts(cat, tok[0][0])
        assert sum(n for n, _s in got.values()) == 3 + 90
    mgr.refresh("mv_kv")
    assert all(n == 1 for _k, n in sess.query("select k, n from mv_kv").rows())
