"""The worker side of the port's HTTP data plane, on the CPU
(presto_tpu_torch/server/worker.py, hier.py, exchange.py and
exec/taskqueue.py):

* OutputBuffers: backpressure past the bound, acks free the producer's
  budget and the worker pool, an acknowledged token cannot be read again,
  a drained buffer refuses producers, responses batch under max_bytes;
* WorkerMemoryPool: reservations, the limit blocking until a kill or a
  timeout, revocation largest-first past the watermark, leaks and
  over-frees counted;
* _classify_failure's retryable and fatal causes and kernel faults;
* MultilevelScheduler, tests/test_taskqueue.py's cases;
* hier_partition holds the rows of the flat _hash_partition and of the
  JAX package's hier_partition per partition, as multisets, on one device
  and as a collective over a mesh of CPU devices; empty partitions and
  skew; the exchange client keeps each producer's order and acks.
"""

import threading
import time

import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.expr.ir import col as ref_col
from presto_tpu.page import Page as RPage
from presto_tpu.server.hier import hier_partition as ref_hier_partition
from presto_tpu.server.serde import deserialize_page as ref_deserialize
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.exec.memory import GLOBAL_ACCOUNTING, MemoryPool
from presto_tpu_torch.exec.taskqueue import LEVEL_THRESHOLD_SECONDS, MultilevelScheduler
from presto_tpu_torch.expr.ir import col
from presto_tpu_torch.page import Page
from presto_tpu_torch.parallel import default_mesh
from presto_tpu_torch.server import hier, serde
from presto_tpu_torch.server.exchange import ExchangeClient, ExchangeError, ExchangeStats
from presto_tpu_torch.server.hier import HierExchangeStats, hier_partition
from presto_tpu_torch.server.serde import deserialize_page, serialize_page
from presto_tpu_torch.server.worker import (
    OutputBuffers,
    QueryKilledError,
    WorkerMemoryPool,
    WorkerServer,
    _classify_failure,
    _hash_partition,
    _pull_buffer,
    dumps_fragment,
    loads_fragment,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _no_stripe_threads_left():
    """The stripe pool's threads stop with the module."""
    yield
    serde.shutdown_stripe_pool()


# -- output buffers -----------------------------------------------------------


def _buffers(bound=100, limit=None):
    pool = WorkerMemoryPool(limit)
    return pool, OutputBuffers(pool, "q", threading.Event(), bound=bound)


def test_output_buffer_backpressure_until_ack():
    pool, buf = _buffers(bound=100)
    buf.put(0, b"a" * 60)
    done = threading.Event()

    def producer():
        buf.put(0, b"b" * 60)  # past the bound: blocks until the ack
        done.set()

    t = threading.Thread(target=producer)
    t.start()
    assert not done.wait(0.3)
    assert pool.snapshot()["buffer_reserved"] == 60
    page, complete, ready = buf.get(0, 0, timeout=1)
    assert page == b"a" * 60 and ready and not complete
    buf.ack(0, 1)
    assert done.wait(5)
    t.join(5)
    assert pool.snapshot()["buffer_reserved"] == 60
    buf.finish()
    assert buf.get(0, 1, timeout=1)[0] == b"b" * 60
    assert buf.get(0, 2, timeout=1) == (None, True, True)


def test_acked_token_cannot_be_read_again():
    _pool, buf = _buffers(bound=None)
    buf.put(3, b"x")
    buf.ack(3, 1)
    with pytest.raises(RuntimeError, match="protocol violation"):
        buf.get(3, 0, timeout=0.1)


def test_get_many_batches_under_max_bytes():
    pool, buf = _buffers(bound=None)
    for i in range(5):
        buf.put(0, bytes([i]) * 10)
    pages, complete, ready = buf.get_many(0, 0, 25, timeout=1)
    assert [p[0] for p in pages] == [0, 1, 2] and ready and not complete
    buf.finish()
    pages, complete, _ = buf.get_many(0, 3, 1 << 20, timeout=1)
    assert [p[0] for p in pages] == [3, 4] and complete
    buf.ack(0, 5)
    assert pool.snapshot()["reserved"] == 0


def test_drained_buffer_refuses_producers_and_frees():
    pool, buf = _buffers(bound=None)
    buf.put(0, b"z" * 40)
    buf.drain()
    assert pool.snapshot()["reserved"] == 0
    with pytest.raises(QueryKilledError):
        buf.put(0, b"z")


# -- the worker memory pool ---------------------------------------------------


def test_pool_limit_blocks_until_killed_or_timeout():
    pool = WorkerMemoryPool(limit=100)
    abort = threading.Event()
    pool.reserve("q1", 80, abort)
    with pytest.raises(MemoryError, match="memory exhausted"):
        pool.reserve("q2", 40, abort, timeout=0.2)
    threading.Timer(0.2, abort.set).start()
    with pytest.raises(QueryKilledError, match="ran out of memory"):
        pool.reserve("q2", 40, abort, timeout=10)
    assert pool.snapshot()["blocked"] == []
    pool.free("q1", 80)
    assert pool.snapshot()["reserved"] == 0


def test_pool_revokes_largest_first_past_the_watermark():
    pool = WorkerMemoryPool(limit=1000, revoke_watermark=0.5)
    small = MemoryPool(None, name="small", parent=pool, query_id="qa")
    big = MemoryPool(None, name="big", parent=pool, query_id="qb")
    pool.register_exec_pool(small)
    pool.register_exec_pool(big)
    small.reserve(100)
    assert not small.revoke_pending and not big.revoke_pending
    big.reserve(450)  # 550 > 500: the largest revocable is asked first
    assert big.revoke_pending and not small.revoke_pending
    snap = pool.snapshot()
    assert snap["exec_reserved"] == 550 and snap["queries"] == {"qa": 100, "qb": 450}
    assert snap["revocations"]["requested"] == 1
    big.note_revoked(450)
    big.free(450)
    assert pool.revocations_completed() == 1
    # a pool unregistered with bytes still held is a counted leak
    pool.unregister_exec_pool(small)
    pool.unregister_exec_pool(big)
    assert pool.snapshot()["leaked_exec_bytes"] == 100
    assert pool.total_reserved() == 0


def test_pool_over_free_is_counted():
    pool = WorkerMemoryPool()
    before = GLOBAL_ACCOUNTING["over_frees"]
    pool.reserve("q", 10, threading.Event())
    pool.free("q", 15)
    assert pool.over_frees == 1 and pool.over_freed_bytes == 5
    assert GLOBAL_ACCOUNTING["over_frees"] == before + 1
    GLOBAL_ACCOUNTING["over_frees"] = before  # the guard of other tests


# -- failure classification ---------------------------------------------------


@pytest.mark.parametrize("exc, retryable, kernel", [
    (RuntimeError("injected fault on worker x"), True, False),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), True, True),
    (RuntimeError("join_probe kernel launch failed: error 700"), True, True),
    (QueryKilledError("Query killed: the cluster ran out of memory"), False, False),
    (MemoryError("worker memory exhausted: 10B"), False, False),
    (RuntimeError("buffer 0 token 1 was already acknowledged (exchange protocol violation)"),
     False, False),
    (RuntimeError("spill quota exceeded for query q"), False, False),
    (NotImplementedError("ORDER BY on a column with an unsorted dictionary"), False, False),
])
def test_classify_failure(exc, retryable, kernel):
    info = _classify_failure(exc)
    assert info["retryable"] is retryable and info["kernelFault"] is kernel
    assert info["type"] == type(exc).__name__


# -- the multilevel scheduler (tests/test_taskqueue.py's cases) ---------------


def test_level_assignment_by_accumulated_time():
    s = MultilevelScheduler(1)
    assert s.level_of("q") == 0
    s.charge("q", 1.5)
    assert s.level_of("q") == 1
    s.charge("q", 10.0)
    assert s.level_of("q") == 2
    s.charge("q", 300.0)
    assert s.level_of("q") == len(LEVEL_THRESHOLD_SECONDS) - 1


def test_fresh_query_preempts_long_runner_between_quanta():
    s = MultilevelScheduler(1)
    s.charge("old", 20.0)
    order = []
    gate_in, gate_go = threading.Event(), threading.Event()

    def holder():
        with s.quantum("holder"):
            gate_in.set()
            gate_go.wait(5)

    def run(qid):
        with s.quantum(qid):
            order.append(qid)

    th = threading.Thread(target=holder)
    th.start()
    gate_in.wait(5)
    t_old = threading.Thread(target=run, args=("old",))
    t_new = threading.Thread(target=run, args=("new",))
    t_old.start()
    time.sleep(0.1)
    t_new.start()
    time.sleep(0.1)
    gate_go.set()
    for t in (t_old, t_new, th):
        t.join(10)
    assert order[0] == "new"


def test_throughput_and_accounting_many_threads():
    s = MultilevelScheduler(2)
    done = []

    def run(qid):
        for _ in range(5):
            with s.quantum(qid):
                time.sleep(0.002)
        done.append(qid)

    ts = [threading.Thread(target=run, args=(f"q{i}",)) for i in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    snap = s.snapshot()
    assert len(done) == 6 and snap["waiting"] == 0 and snap["running"] == 0
    assert len(snap["queries"]) == 6 and all(t > 0 for t in snap["queries"].values())


def test_bounded_wait_prevents_deadlock():
    s = MultilevelScheduler(1)
    produced, finished = threading.Event(), threading.Event()

    def consumer():
        with s.quantum("consumer"):
            produced.wait(10)
        finished.set()

    def producer():
        with s.quantum("producer", max_wait=0.2):
            produced.set()

    tc, tp = threading.Thread(target=consumer), threading.Thread(target=producer)
    tc.start()
    time.sleep(0.05)
    tp.start()
    tc.join(10)
    tp.join(10)
    assert finished.is_set()


def test_worker_server_schedules_through_gate():
    from presto_tpu_torch.server import HttpClusterSession, NodeManager

    w = WorkerServer(TpchCatalog(0.005, device="cpu")).start()
    try:
        sess = HttpClusterSession(TpchCatalog(0.005, device="cpu"),
                                  NodeManager([w.uri], interval=3600), result_cache=False)
        assert sess.query("select count(*) from lineitem where l_quantity > 10").row_count() == 1
        snap = w.scheduler.snapshot()
        assert snap["queries"] and snap["running"] == 0 and snap["waiting"] == 0
    finally:
        w.stop()


# -- the hierarchical exchange against the flat loop and the JAX package ------


def _columns(n, seed=0, skew=False):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 1_000_000, n).astype(np.int64)
    if skew:
        k[: n * 99 // 100] = 7  # one hot key: 99 % of the rows
    return {"k": k, "v": rng.standard_normal(n)}


def _multiset(datas, decode):
    ks, vs = [], []
    for raw in datas:
        pg = decode(raw)
        n = int(pg.count)
        ks.append(np.asarray(pg.blocks[0].data)[:n])
        vs.append(np.asarray(pg.blocks[1].data)[:n])
    k, v = np.concatenate(ks), np.concatenate(vs)
    order = np.lexsort((v, k))
    return k[order], v[order]


def _port_decode(raw):
    return deserialize_page(raw, device="cpu")


@pytest.mark.parametrize("nparts", [1, 2, 3, 5])
def test_hier_matches_flat_and_the_jax_package(nparts):
    cols = _columns(5000, seed=nparts)
    page = Page.from_dict(cols, device="cpu")
    keys = (col("k", T.BIGINT),)
    stats = HierExchangeStats()
    got = hier_partition(page, keys, nparts, hier=stats, page_rows=512)
    flat = _hash_partition(page, keys, nparts)
    ref = ref_hier_partition(RPage.from_dict(cols), (ref_col("k", RT.BIGINT),), nparts)
    assert set(got) == set(flat) == set(ref) == set(range(nparts))
    for p in range(nparts):
        hk, hv = _multiset(got[p], _port_decode)
        for other, decode in ((flat[p], _port_decode), (ref[p], ref_deserialize)):
            ok, ov = _multiset(other, decode)
            assert np.array_equal(hk, ok) and np.array_equal(hv, ov), f"partition {p}"
    snap = stats.snapshot()
    assert snap["exchanges"] == 1 and snap["rows"] == 5000 and snap["collective_exchanges"] == 0
    assert snap["wire_pages"] == sum(len(d) for d in got.values())


@pytest.mark.parametrize("nparts", [3, 8])
def test_hier_collective_over_a_mesh_matches_flat(monkeypatch, nparts):
    monkeypatch.setenv("PRESTO_TPU_HIER_EXCHANGE_MIN_ROWS", "100")
    page = Page.from_dict(_columns(3000, seed=11), device="cpu")
    keys = (col("k", T.BIGINT),)
    stats = HierExchangeStats()
    got = hier_partition(page, keys, nparts, hier=stats, mesh=default_mesh(4, device="cpu"))
    flat = _hash_partition(page, keys, nparts)
    assert stats.snapshot()["collective_exchanges"] == 1
    for p in range(nparts):
        assert all(np.array_equal(a, b) for a, b in zip(_multiset(got[p], _port_decode),
                                                         _multiset(flat[p], _port_decode)))


def test_hier_dead_rows_and_empty_partitions():
    cols = {"k": np.array([5, 5, 5, 9], np.int64), "v": np.arange(4, dtype=np.float64)}
    page = Page.from_dict(cols, pad_to=64, device="cpu")  # 60 dead rows
    out = hier_partition(page, (col("k", T.BIGINT),), 6)
    assert sorted(out) == list(range(6))
    assert all(len(d) >= 1 for d in out.values())  # empty partitions ship a page
    total = sum(int(_port_decode(raw).count) for d in out.values() for raw in d)
    assert total == 4


def test_skewed_partitions_ship_ragged_pages():
    """Each partition's rows in pages of at most page_rows live rows, only
    the last one partial (an empty partition one empty page); the stats
    count those pages and their bytes."""
    page = Page.from_dict(_columns(20000, seed=3, skew=True), device="cpu")
    stats = HierExchangeStats()
    out = hier_partition(page, (col("k", T.BIGINT),), 8, hier=stats, page_rows=256)
    sizes = {p: [int(_port_decode(raw).count) for raw in d] for p, d in out.items()}
    assert sum(map(sum, sizes.values())) == 20000
    assert max(map(sum, sizes.values())) > 4 * min(map(sum, sizes.values()))  # skewed
    for rows in sizes.values():
        assert all(r == 256 for r in rows[:-1]) and rows[-1] <= 256
        assert len(rows) == max(1, -(-sum(rows) // 256))
    snap = stats.snapshot()
    assert snap["wire_pages"] == sum(len(d) for d in out.values())
    assert snap["wire_bytes"] == sum(len(raw) for d in out.values() for raw in d)


def test_fragment_tensors_land_on_the_device():
    node = {"plan": ("scan", torch.arange(4)), "nested": [torch.ones(2, dtype=torch.bool)]}
    back = loads_fragment(dumps_fragment(node), "cpu")
    assert torch.equal(back["plan"][1], torch.arange(4))
    assert back["nested"][0].dtype == torch.bool


# -- the exchange client ------------------------------------------------------


def test_client_keeps_producer_order_and_acks():
    """Two producers on one worker: each location's pages arrive in token
    order, and every page is acknowledged (the pools drain)."""
    w = WorkerServer(TpchCatalog(0.001, device="cpu")).start()
    try:
        states = []
        for tid in ("tA", "tB"):
            from presto_tpu_torch.server.worker import TaskState

            st = TaskState("q")
            st.buffers = OutputBuffers(w.pool, "q", st.abort, bound=None)
            w.tasks[tid] = st
            states.append(st)
            for i in range(6):
                st.buffers.put(0, serialize_page(Page.from_dict(
                    {"src": np.full(3, ord(tid[1]), np.int64), "i": np.full(3, i, np.int64)},
                    device="cpu")))
            st.buffers.finish()
        stats = ExchangeStats()
        client = ExchangeClient([(w.uri, "tA", 0), (w.uri, "tB", 0)], stats=stats,
                                max_response_bytes=1, device="cpu")
        seen = {}
        for page in client.pages():
            src, i = page.to_pylist()[0]
            seen.setdefault(src, []).append(i)
        assert seen == {ord("A"): list(range(6)), ord("B"): list(range(6))}
        assert stats.snapshot()["pages"] == 12 and stats.snapshot()["peak_concurrent"] >= 1
        deadline = time.time() + 5
        while w.pool.snapshot()["reserved"] and time.time() < deadline:
            time.sleep(0.02)
        assert w.pool.snapshot()["reserved"] == 0
    finally:
        w.stop()


def test_pull_buffer_is_the_client_oracle():
    """The sequential pull generator yields one buffer's pages in token
    order with batched long polls, and acks them (the pool drains)."""
    w = WorkerServer(TpchCatalog(0.001, device="cpu")).start()
    try:
        from presto_tpu_torch.server.worker import TaskState

        st = TaskState("q")
        st.buffers = OutputBuffers(w.pool, "q", st.abort, bound=None)
        w.tasks["t"] = st
        sent = [serialize_page(Page.from_dict({"i": np.full(2, i, np.int64)}, device="cpu"))
                for i in range(5)]
        for d in sent:
            st.buffers.put(1, d)
        st.buffers.finish()
        got = list(_pull_buffer(w.uri, "t", 1, max_bytes=1))
        assert got == sent
        deadline = time.time() + 5
        while w.pool.snapshot()["reserved"] and time.time() < deadline:
            time.sleep(0.02)
        assert w.pool.snapshot()["reserved"] == 0
    finally:
        w.stop()


def test_pull_failure_names_the_location():
    client = ExchangeClient([("http://127.0.0.1:1", "t_9", 0)], device="cpu")
    with pytest.raises(ExchangeError) as info:
        list(client.pages())
    assert info.value.uri == "http://127.0.0.1:1" and info.value.task_id == "t_9"


def test_collective_eligibility_follows_the_knobs(monkeypatch):
    page = Page.from_dict(_columns(100), device="cpu")
    assert not hier._collective_eligible(page, 1, 100_000)
    monkeypatch.setenv("PRESTO_TPU_HIER_EXCHANGE_MIN_ROWS", "50")
    assert hier._collective_eligible(page, 2, 100)
    monkeypatch.setenv("PRESTO_TPU_HIER_EXCHANGE_MIN_DEVICES", "4")
    assert not hier._collective_eligible(page, 2, 100)
