"""The shard store of presto_tpu_torch (connectors/shardstore.py) on the
CPU, held to the JAX package: the cases of tests/test_shardstore.py (the
insert/query cycle, min/max shard pruning and its counters, pruning in
EXPLAIN ANALYZE, compaction, the background organizer, DELETE and DROP
with file collection, types through shards, offset pagination across
compaction, scans of row ranges across row groups, table_version and
delta tokens across organize(), the result cache across organize(),
scan_delta and DeltaUnavailable), each run on a
port store and a JAX-package store given the same writes: equal rows,
shard counts, per-shard min/max stats in metadata.db, pruned counts,
organize() reports, table versions and delta tokens. Each package opens
the store the other wrote. Also: shard stats of a column with an
unsorted dictionary hold its real string bounds (the JAX package takes
the bounds of the codes and prunes a shard that holds the value, ROADMAP
queue 3), and an empty table or delta range reads as a one-slot page."""

import os
import sqlite3
import time

import numpy as np
import pytest
import torch

import chip_smoke
from presto_tpu import types as RT
from presto_tpu.connectors.shardstore import ShardStoreCatalog as RShardStoreCatalog
from presto_tpu.connectors.spi import DeltaUnavailable as RDeltaUnavailable
from presto_tpu.connectors.tpch import TpchCatalog as RTpchCatalog
from presto_tpu.page import Page as RPage
from presto_tpu.session import Session as RSession
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.shardstore import ShardStoreCatalog
from presto_tpu_torch.connectors.spi import DeltaUnavailable
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.exec import qcache
from presto_tpu_torch.page import Page
from presto_tpu_torch.session import Session

# one torch thread: the suite runs in parallel worker processes
torch.set_num_threads(1)


def same_rows(got, want, ordered=True):
    diff = chip_smoke.row_diff(got, want, ordered)
    assert diff is None, diff


def _cols(lo, hi, seg="x"):
    n = hi - lo
    return {"k": np.arange(lo, hi, dtype=np.int64),
            "v": (np.arange(n, dtype=np.int64) * 7) % 100,
            "d": (np.full(n, 9000 + lo % 50, np.int32), "date"),
            "s": [f"{seg}{i % 5}" for i in range(n)]}


class Stores:
    """A port store and a JAX-package store given the same writes."""

    def __init__(self, root, compact_rows=1000):
        self.port = ShardStoreCatalog(str(root / "port"), compact_rows=compact_rows,
                                      device="cpu")
        self.ref = RShardStoreCatalog(str(root / "ref"), compact_rows=compact_rows)

    @staticmethod
    def pages(cols):
        port = {k: (v[0], T.parse_type(v[1])) if isinstance(v, tuple) else v
                for k, v in cols.items()}
        ref = {k: (v[0], RT.parse_type(v[1])) if isinstance(v, tuple) else v
               for k, v in cols.items()}
        return Page.from_dict(port, device="cpu"), RPage.from_dict(ref)

    def create_from(self, table, cols):
        page, rpage = self.pages(cols)
        self.port.create_table_from_page(table, page)
        self.ref.create_table_from_page(table, rpage)

    def append(self, table, cols):
        page, rpage = self.pages(cols)
        self.port.append(table, page)
        self.ref.append(table, rpage)

    def sessions(self, **kw):
        ref = RSession(self.ref, plan_cache=False, result_cache=False, **kw)
        ref.executor.dynamic_filtering = False
        return Session(self.port, device="cpu", result_cache=False, **kw), ref

    def query(self, sql, **kw):
        port, ref = self.sessions(**kw)
        got = port.query(sql).rows()
        same_rows(got, ref.query(sql).rows())
        return got

    def each(self, fn):
        a, b = fn(self.port), fn(self.ref)
        assert a == b, (a, b)
        return a

    def stats(self):
        """Every shard's (rows, seq, column stats) in each metadata.db."""
        out = []
        for store in (self.port, self.ref):
            conn = sqlite3.connect(os.path.join(store.directory, "metadata.db"))
            out.append(conn.execute(
                "SELECT s.table_name, s.rows, s.seq, s.max_seq, t.column_name, t.kind, "
                "t.min_v, t.max_v FROM shards s JOIN shard_stats t ON t.shard_id = s.id "
                "ORDER BY s.table_name, s.seq, t.column_name").fetchall())
            conn.close()
        assert out[0] == out[1]
        return out[0]


@pytest.fixture()
def stores(tmp_path):
    return Stores(tmp_path)


def test_ctas_insert_query_cycle(stores):
    for s in stores.sessions():
        s.query("create table t (k bigint, v bigint)")
    for i in range(4):
        stores.append("t", {"k": np.arange(i * 100, i * 100 + 100, dtype=np.int64),
                            "v": np.arange(100, dtype=np.int64)})
    assert stores.each(lambda c: (c.shard_count("t"), c.row_count("t"))) == (4, 400)
    assert stores.query("select count(*), min(k), max(k) from t") == [(400, 0, 399)]
    stores.query("select sum(v) from t where k >= 150 and k < 250")
    stores.stats()


def test_shard_pruning_by_minmax(stores):
    stores.create_from("t", {"k": np.arange(0, 100, dtype=np.int64)})
    for lo in (100, 200, 300):
        stores.append("t", {"k": np.arange(lo, lo + 100, dtype=np.int64)})
    assert stores.query("select count(*) from t where k >= 350", streaming=True,
                        batch_rows=4096) == [(50,)]
    assert stores.each(lambda c: (c.last_scan_files_read, c.last_scan_files_skipped)) == (1, 3)
    stores.stats()


def test_pruning_visible_in_explain_analyze(stores):
    stores.create_from("ev", {"k": np.arange(0, 100, dtype=np.int64)})
    for lo in (100, 200, 300):
        stores.append("ev", {"k": np.arange(lo, lo + 100, dtype=np.int64)})
    for s in stores.sessions(streaming=True, batch_rows=4096):
        txt = s.explain_analyze("select count(*) from ev where k < 50")
        assert "files: 1 read, 3 pruned" in txt, txt


def _eight_shards(stores):
    stores.create_from("t", _cols(0, 200))
    for i in range(1, 8):
        stores.append("t", _cols(i * 200, i * 200 + 200))


def test_compaction_merges_small_shards(stores):
    _eight_shards(stores)
    assert stores.each(lambda c: c.shard_count("t")) == 8
    before = stores.query("select k, v, s, d from t order by k")
    report = stores.each(lambda c: c.organize())
    assert report.get("t", 0) >= 4
    assert stores.each(lambda c: c.shard_count("t")) < 8
    stores.stats()
    same_rows(stores.query("select k, v, s, d from t order by k"), before)
    assert stores.query("select count(*) from t where k >= 1500", streaming=True,
                        batch_rows=8192) == [(100,)]


def test_background_organizer_thread(stores):
    store = stores.port
    page, _ = stores.pages(_cols(0, 50))
    store.create_table_from_page("t", page)
    for i in range(1, 6):
        store.append("t", stores.pages(_cols(i * 50, i * 50 + 50))[0])
    store.start_organizer(interval_s=0.2)
    try:
        deadline = time.time() + 10
        while time.time() < deadline and store.shard_count("t") > 2:
            time.sleep(0.1)
    finally:
        store.stop_organizer()
    assert store.shard_count("t") <= 2 and store.organize_events
    assert store._organizer is None


def test_delete_and_drop_gc(stores):
    stores.create_from("t", _cols(0, 100))
    stores.append("t", _cols(100, 200))
    for s, c in zip(stores.sessions(), (stores.port, stores.ref)):
        s.query("delete from t where k < 50")
        assert s.query("select count(*) from t").rows() == [(150,)]
        s.query("drop table t")
        assert "t" not in c.table_names()
        assert not [f for f in os.listdir(c.directory) if f.endswith(".parquet")]


def test_types_roundtrip_through_shards(stores):
    cols = {"k": np.arange(5, dtype=np.int64),
            "dec": (np.array([150, 275, -300, 0, 999], np.int64), "decimal(10,2)"),
            "d": (np.array([9000, 9001, 9002, 9003, 9004], np.int32), "date"),
            "s": ["a", "b", None, "d", "e"],
            "f": np.array([1.5, -2.5, 3.25, 0.0, 9.75])}
    stores.create_from("t", cols)
    stores.append("t", cols)
    rows = stores.query("select k, dec, d, s, f from t order by k, s nulls last")
    assert len(rows) == 10 and any(r[3] is None for r in rows)
    stores.stats()
    # each package opens the store the other wrote
    same_rows(ShardStoreCatalog(stores.ref.directory, device="cpu").page("t").to_pylist(),
              RShardStoreCatalog(stores.port.directory).page("t").to_pylist())


def test_offset_pagination_stable_across_compaction(tmp_path):
    stores = Stores(tmp_path)
    stores.create_from("t", _cols(0, 300))
    for i in range(1, 6):
        stores.append("t", _cols(i * 300, i * 300 + 300))
    store = stores.port
    n = store.row_count("t")
    want = store.scan("t", 0, n).block("k").data[:n].numpy()
    got, B = [], 450
    for start in range(0, n, B):
        got.append(store.scan("t", start, start + B).block("k").data[:min(B, n - start)].numpy())
        if start == B:  # compact mid-scan
            assert store.organize().get("t", 0) >= 2
    assert np.array_equal(np.concatenate(got), want)


def test_scan_ranges_read_only_their_row_groups(stores):
    """A shard file holds row groups of SHARD_ROW_GROUP rows; a scan of a
    row range (the column-stats sample reads 8 strided ranges) reads only
    the groups that hold it, and returns the rows the JAX package's store
    returns over the same writes, across group and shard boundaries."""
    import pyarrow.parquet as pq

    from presto_tpu_torch.connectors import shardstore

    g = shardstore.SHARD_ROW_GROUP
    n = 2 * g + 1000
    stores.create_from("t", {"k": np.arange(n, dtype=np.int64),
                             "v": np.arange(n, dtype=np.int64) % 97})
    stores.append("t", {"k": np.arange(n, n + 500, dtype=np.int64),
                        "v": np.zeros(500, np.int64)})
    (path,) = [p for _i, p, r in stores.port._shards("t") if r == n]
    assert pq.ParquetFile(path).metadata.num_row_groups == 3
    for lo, hi in ((0, n + 500), (5, 17), (g - 3, g + 4), (g + 10, 2 * g + 999),
                   (2 * g + 990, n + 20), (n - 1, n + 500)):
        got = stores.port.scan("t", lo, hi)
        want = stores.ref.scan("t", lo, hi)
        same_rows(got.to_pylist(), want.to_pylist())
        assert got.block("k").data[:hi - lo].tolist() == list(range(lo, hi))


def test_empty_ranges_keep_one_slot(stores):
    """A table without rows, or a delta range without shards, reads as a
    zero-row page of one slot (ops/union.empty_page's rule), so a grouped
    aggregate over it returns no row; the JAX package's store returns
    capacity 0 and its grouped aggregate raises IndexError (ROADMAP queue
    3)."""
    for s in stores.sessions():
        s.query("create table e (k bigint, v bigint)")
    port = stores.port
    assert port.page("e").capacity == 1 and int(port.page("e").count) == 0
    assert port.scan_delta("e", 0.0, 9.0).capacity == 1
    port_sess, _ref = stores.sessions()
    assert port_sess.query("select k, count(*), sum(v) from e group by k").rows() == []
    assert port_sess.query("select count(*) from e").rows() == [(0,)]
    with pytest.raises(IndexError):
        _ref.query("select k, count(*), sum(v) from e group by k")


def test_organize_does_not_bump_table_version(stores):
    _eight_shards(stores)
    v0 = stores.each(lambda c: c.table_version("t"))
    tok0 = stores.each(lambda c: c.delta_token("t"))
    assert stores.each(lambda c: c.organize()).get("t", 0) >= 4
    assert stores.each(lambda c: c.table_version("t")) == v0
    assert stores.each(lambda c: c.delta_token("t")) == tok0
    stores.append("t", _cols(1600, 1700))
    assert stores.each(lambda c: c.table_version("t")) != v0


def test_result_cache_survives_organize(stores):
    _eight_shards(stores)
    qcache.reset_all()
    sess = Session(stores.port, device="cpu")
    sql = "select count(*) as c, sum(v) as s from t"
    want = sess.query(sql).rows()
    s0 = qcache.RESULT_CACHE.stats.snapshot()
    assert stores.port.organize().get("t", 0) >= 4
    assert sess.query(sql).rows() == want
    s1 = qcache.RESULT_CACHE.stats.snapshot()
    assert s1["hits"] - s0["hits"] == 1 and s1["invalidations"] == s0["invalidations"]


def test_scan_delta_survives_compaction_of_consumed_shards(stores):
    _eight_shards(stores)
    tok = stores.each(lambda c: c.delta_token("t"))
    assert stores.each(lambda c: c.organize()).get("t", 0) >= 4
    stores.append("t", _cols(1600, 1650))
    tok2 = stores.each(lambda c: c.delta_token("t"))
    delta = stores.port.scan_delta("t", tok[0], tok2[0])
    same_rows(delta.to_pylist(), stores.ref.scan_delta("t", tok[0], tok2[0]).to_pylist())
    assert sorted(r[0] for r in delta.to_pylist()) == list(range(1600, 1650))


def test_scan_delta_straddling_merge_raises(stores):
    stores.create_from("t", _cols(0, 200))
    tok = stores.each(lambda c: c.delta_token("t"))
    for i in range(1, 8):
        stores.append("t", _cols(i * 200, i * 200 + 200))
    assert stores.each(lambda c: c.organize()).get("t", 0) >= 4
    tok2 = stores.each(lambda c: c.delta_token("t"))
    with pytest.raises(DeltaUnavailable):
        stores.port.scan_delta("t", tok[0], tok2[0])
    with pytest.raises(RDeltaUnavailable):
        stores.ref.scan_delta("t", tok[0], tok2[0])


def test_unsorted_dictionary_stats_keep_real_bounds(tmp_path):
    """c_phone's dictionary is not in string order: the port stores the
    shard's real minimum and maximum phone and finds the customer with the
    smallest phone; the JAX package stores the strings of the smallest and
    largest codes, refutes the shard and returns nothing."""
    tpch, rtpch = TpchCatalog(0.01, device="cpu"), RTpchCatalog(0.01)
    ss = ShardStoreCatalog(str(tmp_path / "port"), device="cpu")
    rss = RShardStoreCatalog(str(tmp_path / "ref"))
    ss.create_table_from_page("customer", tpch.page("customer"))
    rss.create_table_from_page("customer", rtpch.page("customer"))
    phones = [r[0] for r in Session(ss, device="cpu").query(
        "select c_phone from customer").rows()]
    low = min(phones)
    conn = sqlite3.connect(os.path.join(ss.directory, "metadata.db"))
    assert conn.execute("SELECT min_v, max_v FROM shard_stats WHERE column_name = "
                        "'c_phone'").fetchall() == [(low, max(phones))]
    sql = f"select c_custkey from customer where c_phone = '{low}'"
    # the whole-table read prunes nothing
    want = Session(ss, device="cpu").query(sql).rows()
    assert len(want) == 1 and want == RSession(rss, plan_cache=False,
                                               result_cache=False).query(sql).rows()
    assert Session(ss, device="cpu", streaming=True, batch_rows=512).query(sql).rows() == want
    ref = RSession(rss, plan_cache=False, result_cache=False, streaming=True, batch_rows=512)
    assert ref.query(sql).rows() == []
