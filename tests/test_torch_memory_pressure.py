"""The memory ladder of presto_tpu_torch under pressure, on the CPU: the
disk tier below the pinned host offload (exec/spillspace.py), the
partitioned hybrid hash join with bounded recursive repartitioning
(exec/stream.py), revocation and the accounting invariants. The cases of
tests/test_memory_pressure.py that need no server and no breaker, each
result equal to the JAX package's materializing Session over the same
tables (or, for the varchar join, to the Python count that file uses).
Also the port's own rung: a semi join (IN, EXISTS, IN under OR, NOT IN)
whose source exceeds the budget runs partitioned on the disk tier, where
the JAX package raises MemoryExceededError.

Left out, and why:
* test_hybrid_join_breaker_fallback and test_hybrid_join_setup_fault_degrades:
  the port has no breaker and routes around no fault. Their counterparts
  here inject the same faults (hybrid partitioning, and host dynamic
  filter building) and assert that the query FAILS.
* test_worker_pool_counts_over_frees, test_worker_pool_revokes_largest_first,
  test_exec_pool_mirrors_into_worker_ledger,
  test_output_buffer_bound_never_overshoots, the two memory-manager
  cases and test_admission_queues_under_pressure: the worker, cluster and
  resource-group layers belong to the server port (ROADMAP queue 1 item 9).
"""

import numpy as np
import pytest
import torch

from presto_tpu.connectors.memory import MemoryCatalog as RMemoryCatalog
from presto_tpu.page import Page as RPage
from presto_tpu.session import Session as RSession
from presto_tpu_torch.connectors.memory import MemoryCatalog
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.exec import spillspace
from presto_tpu_torch.exec import stream as stream_mod
from presto_tpu_torch.exec.memory import GLOBAL_ACCOUNTING, MemoryPool
from presto_tpu_torch.exec.spillspace import (
    DiskRows,
    SpillCorruptionError,
    SpillQuotaExceededError,
    SpillSpaceManager,
)
from presto_tpu_torch.page import Page
from presto_tpu_torch.session import Session
from test_torch_streaming import SF, Reference, same_rows, streaming

torch.set_num_threads(1)


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


def pair(tables):
    """(port MemoryCatalog, the JAX package's Session) over the same numpy
    tables {name: {column: array | list of str}}."""
    port = MemoryCatalog({n: Page.from_dict(c, device="cpu") for n, c in tables.items()},
                         device="cpu")
    ref = RSession(RMemoryCatalog({n: RPage.from_dict(c) for n, c in tables.items()}),
                   plan_cache=False, result_cache=False)
    return port, ref


def stream_session(cat, **kw):
    return Session(cat, device="cpu", streaming=True, result_cache=False, **kw)


# -- the disk tier: host ceiling 0, so every spilled byte goes through the
# CRC-checked spill files --


def test_disk_tier_external_sort(catalog, reference, monkeypatch):
    monkeypatch.setenv("PRESTO_TPU_HOST_SPILL_BYTES", "0")
    sql = ("select l_orderkey, l_extendedprice, l_shipdate from lineitem "
           "order by l_extendedprice desc, l_orderkey")
    s = streaming(catalog, memory_budget=1 << 20)
    same_rows(s.query(sql).rows(), reference.rows(sql))
    assert "sort" in s.executor.spill_events
    assert s.executor.spill_stats["disk_bytes"] > 0, "disk tier never hit"
    assert s.executor.pool.peak <= 1 << 20


def test_disk_tier_aggregation(catalog, reference, monkeypatch):
    monkeypatch.setenv("PRESTO_TPU_HOST_SPILL_BYTES", "0")
    sql = "select l_orderkey, sum(l_quantity) q, count(*) n from lineitem group by l_orderkey"
    s = streaming(catalog, memory_budget=192 << 10, batch_rows=4096)
    same_rows(s.query(sql).rows(), reference.rows(sql), ordered=False)
    assert "aggregate" in s.executor.spill_events
    assert s.executor.spill_stats["disk_bytes"] > 0


def test_disk_tier_window(catalog, reference, monkeypatch):
    monkeypatch.setenv("PRESTO_TPU_HOST_SPILL_BYTES", "0")
    sql = ("select o_orderkey, rank() over "
           "(partition by o_custkey order by o_totalprice desc) r from orders")
    s = streaming(catalog, memory_budget=256 << 10)
    same_rows(s.query(sql).rows(), reference.rows(sql), ordered=False)
    assert "window" in s.executor.spill_events
    assert s.executor.spill_stats["disk_bytes"] > 0


def test_varchar_key_join_value_rehash_hybrid(monkeypatch):
    # varchar keys hash by dictionary VALUE (ops/hashing.hash_rows_values),
    # so a varchar equi-join takes the partitioned hybrid path although the
    # build and probe dictionaries differ; only a dictionary beyond the
    # value-hash cap routes to the chunked build loop
    monkeypatch.setenv("PRESTO_TPU_HOST_SPILL_BYTES", "0")
    rng = np.random.default_rng(4)
    n_b, n_p = 10_000, 20_000
    bv = rng.integers(0, 100, n_b).astype(np.int64)
    pk = [f"key_{i:05d}" for i in rng.integers(0, n_b, n_p)]
    pv = rng.integers(0, 100, n_p).astype(np.int64)
    tables = {
        "b": {"bk": [f"key_{i:05d}" for i in range(n_b)], "bv": bv},
        "p": {"pk": pk, "pv": pv},
        # p2's values cover b's whole domain, so both columns intern ONE
        # dictionary: the only shape the code-hash route serves soundly
        "p2": {"pk": [f"key_{i % n_b:05d}" for i in range(2 * n_b)],
               "pv": rng.integers(0, 100, 2 * n_b).astype(np.int64)},
    }
    cat, ref = pair(tables)
    sql = "select count(*) c, sum(bv + pv) s from p join b on pk = bk"
    # the Python count (the engine-vs-engine comparison would bless a
    # code-hash join that silently drops cross-dictionary matches)
    bl = {f"key_{i:05d}": int(v) for i, v in enumerate(bv)}
    want = [(sum(1 for k in pk if k in bl), sum(bl[k] + int(v) for k, v in zip(pk, pv) if k in bl))]
    assert ref.query(sql).rows() == want
    s = stream_session(cat, batch_rows=2048, memory_budget=64 << 10)
    assert s.query(sql).rows() == want
    assert "hybrid_hash_join" in s.executor.spill_events
    assert s.executor.spill_stats["disk_bytes"] > 0
    assert s.executor.pool.peak <= 64 << 10
    # dictionaries over the value-hash cap take the chunked build loop
    from presto_tpu_torch.ops import hashing

    monkeypatch.setattr(hashing, "_VALUE_HASH_MAX_DICT_DEFAULT", 16)
    sql2 = "select count(*) c, sum(bv + pv) s from p2 join b on pk = bk"
    assert cat.page("b").block("bk").dict_id == cat.page("p2").block("pk").dict_id
    s2 = stream_session(cat, batch_rows=2048, memory_budget=64 << 10)
    same_rows(s2.query(sql2).rows(), ref.query(sql2).rows())
    assert "hybrid_hash_join" not in s2.executor.spill_events
    assert s2.executor.spill_stats["chunk_fallbacks"] >= 1


# -- the partitioned hybrid hash join --


def join_tables(n_build=4_000, n_probe=8_000, seed=3, build_key=None):
    rng = np.random.default_rng(seed)
    bk = np.arange(n_build, dtype=np.int64) if build_key is None else build_key
    return {
        "b": {"bk": bk, "bv": rng.integers(0, 1000, n_build).astype(np.int64)},
        "p": {"pk": rng.integers(0, max(n_build, 1), n_probe).astype(np.int64),
              "pv": rng.integers(0, 1000, n_probe).astype(np.int64)},
    }


JOIN_SQL = "select count(*) c, sum(bv + pv) s from p join b on pk = bk"


def test_hybrid_join_recursion_at_sixteenth_budget(monkeypatch):
    """Equal rows at a budget <= 1/16 of the build bytes, with recursive
    repartitioning exercised (depth >= 1)."""
    monkeypatch.setenv("PRESTO_TPU_HOST_SPILL_BYTES", "0")
    monkeypatch.setenv("PRESTO_TPU_HYBRID_JOIN_PARTS", "4")
    cat, ref = pair(join_tables())
    budget = 4_000 * 16 // 16  # 2 int64 columns of 4,000 rows, over 16
    s = stream_session(cat, batch_rows=2048, memory_budget=budget)
    same_rows(s.query(JOIN_SQL).rows(), ref.query(JOIN_SQL).rows())
    st = s.executor.spill_stats
    assert "hybrid_hash_join" in s.executor.spill_events
    assert st["hybrid_depth"] >= 1, st
    assert st["disk_bytes"] > 0
    assert s.executor.pool.peak <= budget


def test_hybrid_join_auto_partitions(monkeypatch):
    monkeypatch.setenv("PRESTO_TPU_HOST_SPILL_BYTES", "0")
    cat, ref = pair(join_tables(n_build=8_000, n_probe=16_000, seed=5))
    s = stream_session(cat, batch_rows=2048, memory_budget=32 << 10)
    same_rows(s.query(JOIN_SQL).rows(), ref.query(JOIN_SQL).rows())
    assert "hybrid_hash_join" in s.executor.spill_events
    assert s.executor.spill_stats["hybrid_parts"] >= 2
    assert s.executor.pool.peak <= 32 << 10
    txt = s.explain_analyze(JOIN_SQL)
    assert "hybrid" in txt and "-- memory:" in txt


def test_hybrid_join_all_ties_build_key(monkeypatch):
    """One build key value defeats hash partitioning at every salt: the
    join detects no progress and takes the chunked build loop."""
    monkeypatch.setenv("PRESTO_TPU_HOST_SPILL_BYTES", "0")
    rng = np.random.default_rng(9)
    tables = {
        "b": {"bk": np.full(4_000, 7, np.int64),
              "bv": rng.integers(0, 100, 4_000).astype(np.int64)},
        "p": {"pk": rng.integers(0, 500, 20_000).astype(np.int64),
              "pv": rng.integers(0, 100, 20_000).astype(np.int64)},
    }
    cat, ref = pair(tables)
    s = stream_session(cat, batch_rows=1024, memory_budget=32 << 10)
    same_rows(s.query(JOIN_SQL).rows(), ref.query(JOIN_SQL).rows())
    assert "hybrid_hash_join" in s.executor.spill_events
    assert s.executor.spill_stats["chunk_fallbacks"] >= 1


def test_hybrid_join_partitioning_fault_fails_the_query(monkeypatch):
    """The JAX package's breaker catches a hybrid-partitioning fault and
    takes the chunked path; the port has no fallback: the query fails, and
    neither a reservation nor a spill file survives it."""
    cat, _ref = pair(join_tables(n_build=20_000, n_probe=40_000, seed=8))

    def boom(self, total_bytes, share, cap=64, node=None):
        raise RuntimeError("injected hybrid partitioning fault")

    monkeypatch.setattr(stream_mod.StreamingExecutor, "_hybrid_partition_count", boom)
    s = stream_session(cat, batch_rows=2048, memory_budget=64 << 10)
    with pytest.raises(RuntimeError, match="injected hybrid partitioning"):
        s.query(JOIN_SQL).rows()
    assert "join_build" in s.executor.spill_events
    assert "hybrid_hash_join" not in s.executor.spill_events
    assert s.executor.spill_stats["chunk_fallbacks"] == 0
    assert s.executor.pool.reserved == 0


def test_host_filter_fault_fails_the_query(monkeypatch):
    """A fault while deriving a dynamic filter from an offloaded build side
    (the JAX package's `dynamic_filter` breaker degrades) fails the query."""
    from presto_tpu_torch.exec import dynfilter

    tables = join_tables(n_build=20_000, n_probe=40_000, seed=6)
    tables["b"]["bk"] = tables["b"]["bk"] * 4  # a quarter of the probe keys match
    cat, ref = pair(tables)
    sql = JOIN_SQL + " where bv < 500"
    s = stream_session(cat, batch_rows=2048, memory_budget=64 << 10)
    same_rows(s.query(sql).rows(), ref.query(sql).rows())
    assert s.executor.dyn_ctx.snapshot()["filters"], "no host filter was derived"

    def boom(self, data, valid, typ):
        raise RuntimeError("injected host filter fault")

    monkeypatch.setattr(dynfilter.HostFilterAccumulator, "add_numpy", boom)
    s = stream_session(cat, batch_rows=2048, memory_budget=64 << 10)
    with pytest.raises(RuntimeError, match="injected host filter"):
        s.query(sql).rows()


def test_sink_aggregate_fault_frees_state_and_accumulated(catalog, monkeypatch):
    """A fault mid-aggregation leaks neither the rotating state reservation
    nor pool.accumulated."""
    from presto_tpu_torch.ops import groupby_kernel

    # the sorted strategy only, so the injected fault fires
    monkeypatch.setattr(groupby_kernel, "maybe_grouped_aggregate_hash", lambda *a, **k: None)
    real = stream_mod.grouped_aggregate_sorted
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected aggregation kernel fault")
        return real(*a, **kw)

    monkeypatch.setattr(stream_mod, "grouped_aggregate_sorted", flaky)
    s = streaming(catalog, memory_budget=1 << 20, pallas_groupby=False)
    with pytest.raises(RuntimeError, match="injected aggregation"):
        s.query("select l_orderkey, count(*), sum(l_extendedprice) "
                "from lineitem group by 1").rows()
    assert calls["n"] >= 3
    assert s.executor.pool.accumulated == 0
    assert s.executor.pool.reserved == 0


# -- spill-file integrity and quotas --


def test_spill_corruption_is_structured_error(tmp_path):
    mgr = SpillSpaceManager(directory=str(tmp_path))
    space = mgr.open("q_corrupt")
    rows = DiskRows(space, "t", ("a",), (None,))
    rows.append_chunk([np.arange(100, dtype=np.int64)], [None], (None,), 100)
    with open(rows.file.path, "r+b") as f:  # flip a payload byte
        f.seek(40)
        b = f.read(1)
        f.seek(40)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(SpillCorruptionError, match="spill file corrupt"):
        rows.read_chunk(0)
    space.release()
    assert mgr.active_bytes == 0 and mgr.active_files == 0


def test_spill_truncation_is_structured_error(tmp_path):
    mgr = SpillSpaceManager(directory=str(tmp_path))
    space = mgr.open("q_trunc")
    rows = DiskRows(space, "t", ("a",), (None,))
    rows.append_chunk([np.arange(500, dtype=np.int64)], [None], (None,), 500)
    with open(rows.file.path, "r+b") as f:
        f.truncate(64)  # a torn write
    with pytest.raises(SpillCorruptionError, match="truncated"):
        rows.read_chunk(0)
    space.release()


def test_spill_query_quota_enforced(tmp_path, monkeypatch):
    monkeypatch.setenv("PRESTO_TPU_HOST_SPILL_BYTES", "0")
    mgr = SpillSpaceManager(directory=str(tmp_path), query_quota=4 << 10)
    rng = np.random.default_rng(2)
    cat, _ref = pair({"t": {"a": rng.random(50_000), "b": np.arange(50_000, dtype=np.int64)}})
    s = stream_session(cat, batch_rows=2048, memory_budget=64 << 10)
    s.executor._spill_space = mgr.open("q_quota")
    with pytest.raises(SpillQuotaExceededError, match="spill quota exceeded"):
        s.query("select a, b from t order by a").rows()
    # guaranteed cleanup even on a quota failure
    assert mgr.active_bytes == 0 and mgr.active_files == 0


def test_spill_node_quota_enforced(tmp_path):
    mgr = SpillSpaceManager(directory=str(tmp_path), node_quota=1 << 10)
    space = mgr.open("qa")
    rows = DiskRows(space, "t", ("a",), (None,))
    with pytest.raises(SpillQuotaExceededError, match="per-node quota"):
        rows.append_chunk([np.arange(10_000, dtype=np.int64)], [None], (None,), 10_000)
    assert mgr.snapshot()["quota_rejections"] >= 1
    space.release()
    assert mgr.active_bytes == 0


# -- accounting and revocation --


def test_memory_pool_counts_over_frees():
    before = dict(GLOBAL_ACCOUNTING)
    pool = MemoryPool(max_bytes=1000)
    pool.reserve(100)
    pool.free(150)  # a double free: 50 bytes never reserved
    assert pool.over_frees == 1 and pool.over_freed_bytes == 50
    assert pool.reserved == 0
    assert pool.snapshot()["over_frees"] == 1
    assert GLOBAL_ACCOUNTING["over_frees"] == before["over_frees"] + 1
    GLOBAL_ACCOUNTING.update(before)


def test_revoke_forces_offload_and_is_counted(catalog, reference):
    """A pending revoke makes the executor offload at the next batch even
    with NO budget, and the completion is counted."""
    sql = "select o_orderkey from orders order by o_totalprice"
    s = streaming(catalog)  # no budget: would never spill
    s.executor.pool.request_revoke()
    same_rows(s.query(sql).rows(), reference.rows(sql))
    assert "sort" in s.executor.spill_events
    assert s.executor.pool.revocations >= 1


def test_revoke_request_expires():
    import time

    pool = MemoryPool()
    pool.revoke_grace_s = 0.05
    pool.request_revoke()
    assert pool.revoke_pending
    time.sleep(0.1)
    assert not pool.revoke_pending  # a stuck executor is not punished forever


# -- semi joins past the budget (the JAX package raises; the port
# partitions them) --


SEMI_SQL = {
    "in": "select count(*), sum(pv) from p where pk in (select bk from b where bv < 700)",
    "exists": "select count(*), sum(pv) from p where exists "
              "(select 1 from b where bk = pk and bv < 700)",
    "in_under_or": "select count(*), sum(pv) from p where pv < 10 or pk in "
                   "(select bk from b where bv < 700)",
    "not_in": "select count(*), sum(pv) from p where pk not in (select bk from b where bv < 700)",
}


@pytest.mark.parametrize("name", sorted(SEMI_SQL))
def test_semijoin_source_offloads_partitioned(name, monkeypatch):
    monkeypatch.setenv("PRESTO_TPU_HOST_SPILL_BYTES", "0")
    tables = join_tables(n_build=6_000, n_probe=20_000, seed=11)
    tables["b"]["bk"] = tables["b"]["bk"] * 3  # a third of the probe keys can match
    cat, ref = pair(tables)
    sql = SEMI_SQL[name]
    s = stream_session(cat, batch_rows=2048, memory_budget=16 << 10)
    same_rows(s.query(sql).rows(), ref.query(sql).rows())
    assert "partitioned_semijoin" in s.executor.spill_events
    assert s.executor.spill_stats["disk_bytes"] > 0
    assert s.executor.pool.peak <= 16 << 10


def test_partitioned_not_in_is_null_aware(monkeypatch):
    """NOT IN over an offloaded source holding a NULL selects nothing; with
    the NULL filtered out, NULL probe values are still dropped."""
    monkeypatch.setenv("PRESTO_TPU_HOST_SPILL_BYTES", "0")
    rng = np.random.default_rng(13)
    s = Session(MemoryCatalog({}, device="cpu"), device="cpu", result_cache=False)
    s.query("create table p (a bigint)")
    s.query("create table u (b bigint)")
    probe = [None if i % 10 == 0 else int(v) for i, v in enumerate(rng.integers(0, 3000, 3000))]
    src = [int(v) for v in rng.integers(0, 3000, 2500)] + [None]
    s.query("insert into p values " + ", ".join(f"({'null' if v is None else v})" for v in probe))
    s.query("insert into u values " + ", ".join(f"({'null' if v is None else v})" for v in src))
    st = Session(s.catalog, device="cpu", result_cache=False, streaming=True, batch_rows=512,
                 memory_budget=8 << 10)
    assert st.query("select count(*) from p where a not in (select b from u)").rows() == [(0,)]
    assert "partitioned_semijoin" in st.executor.spill_events
    keys = {v for v in src if v is not None}
    want = sum(1 for v in probe if v is not None and v not in keys)
    got = st.query("select count(*) from p where a not in "
                   "(select b from u where b is not null)").rows()
    assert got == [(want,)]
