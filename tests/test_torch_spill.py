"""Spill for sort, window and final aggregation in presto_tpu_torch's
streaming executor (exec/spill.py), on the CPU: the 10 tests of
tests/test_spill.py, each result equal to the JAX package's materializing
Session over the same tables (test_spill.py holds the JAX streaming output
equal to that Session). Queries whose state exceeds the budget must
offload, keep the card's reservations within budget (pool.peak) and leave
no spill file behind. Left out: nothing."""

import numpy as np
import pytest
import torch

from presto_tpu.connectors.memory import MemoryCatalog as RMemoryCatalog
from presto_tpu.page import Block as RBlock
from presto_tpu.page import Page as RPage
from presto_tpu.session import Session as RSession
from presto_tpu_torch.connectors.memory import MemoryCatalog
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.exec import spillspace
from presto_tpu_torch.page import Block, Page
from presto_tpu_torch.session import Session
from test_torch_streaming import SF, Reference, same_rows, streaming

torch.set_num_threads(1)

FULL_SORT = (
    "select l_orderkey, l_extendedprice, l_shipdate from lineitem "
    "order by l_extendedprice desc, l_orderkey"
)


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


def memory_pair(columns, nulls=None):
    """(port MemoryCatalog, JAX MemoryCatalog) over table t from the same
    numpy columns; `nulls` = {column: invalid mask}."""
    port = Page.from_dict(columns, device="cpu")
    ref = RPage.from_dict(columns)
    for name, null in (nulls or {}).items():
        i = port.names.index(name)
        pb, rb = list(port.blocks), list(ref.blocks)
        pb[i] = Block(pb[i].data, pb[i].type, torch.from_numpy(~null), pb[i].dict_id)
        rb[i] = RBlock(rb[i].data, rb[i].type, np.asarray(~null), rb[i].dict_id)
        port = Page(tuple(pb), port.names, port.count)
        ref = RPage(tuple(rb), ref.names, ref.count)
    return MemoryCatalog({"t": port}, device="cpu"), RMemoryCatalog({"t": ref})


def test_external_sort_matches_and_stays_bounded(catalog, reference):
    budget = 1 << 20  # far below the 3-column lineitem footprint
    s = streaming(catalog, memory_budget=budget)
    same_rows(s.query(FULL_SORT).rows(), reference.rows(FULL_SORT))
    assert "sort" in s.executor.spill_events
    assert s.executor.pool.peak <= budget


def test_external_sort_single_key_asc(catalog, reference):
    sql = "select o_orderkey from orders order by o_totalprice"
    s = streaming(catalog, memory_budget=64 << 10)
    same_rows(s.query(sql).rows(), reference.rows(sql))
    assert "sort" in s.executor.spill_events


def test_external_sort_nulls_and_ties():
    rng = np.random.default_rng(7)
    n = 20_000
    k1 = rng.integers(0, 5, n).astype(np.float64)  # heavy ties
    k1_null = rng.random(n) < 0.1
    cols = {"a": np.where(k1_null, 0.0, k1), "b": rng.integers(0, 1000, n).astype(np.int64),
            "c": np.arange(n, dtype=np.int64)}
    cat, rcat = memory_pair(cols, nulls={"a": k1_null})
    sql = "select a, b, c from t order by a desc nulls last, b, c desc"
    want = RSession(rcat).query(sql).rows()
    s = Session(cat, device="cpu", streaming=True, batch_rows=512, memory_budget=96 << 10)
    same_rows(s.query(sql).rows(), want)
    assert "sort" in s.executor.spill_events


def test_spilled_aggregation_high_cardinality(catalog, reference):
    sql = ("select l_orderkey, sum(l_quantity) q, count(*) n, "
           "avg(l_extendedprice) ap from lineitem group by l_orderkey")
    budget = 192 << 10  # below the ~15k-group state footprint
    s = streaming(catalog, memory_budget=budget)
    same_rows(s.query(sql).rows(), reference.rows(sql), ordered=False)
    assert "aggregate" in s.executor.spill_events
    assert s.executor.pool.peak <= budget


def test_spilled_aggregation_with_strings():
    rng = np.random.default_rng(3)
    n = 30_000
    cols = {"k": [f"user_{i:05d}" for i in rng.integers(0, 4000, n)],
            "v": rng.integers(0, 100, n).astype(np.int64)}
    cat, rcat = memory_pair(cols)
    sql = "select k, sum(v) s, count(*) c from t group by k"
    want = RSession(rcat).query(sql).rows()
    s = Session(cat, device="cpu", streaming=True, batch_rows=1024, memory_budget=48 << 10)
    same_rows(s.query(sql).rows(), want, ordered=False)
    assert "aggregate" in s.executor.spill_events


def test_partition_chunked_window(catalog, reference):
    sql = ("select o_orderkey, o_custkey, "
           "rank() over (partition by o_custkey order by o_totalprice desc) r, "
           "sum(o_totalprice) over (partition by o_custkey) tot from orders")
    budget = 256 << 10
    s = streaming(catalog, memory_budget=budget)
    same_rows(s.query(sql).rows(), reference.rows(sql), ordered=False)
    assert "window" in s.executor.spill_events
    assert s.executor.pool.peak <= budget


def test_window_running_sum_chunked(catalog, reference):
    sql = ("select o_orderkey, sum(o_totalprice) over "
           "(partition by o_custkey order by o_orderkey) run from orders")
    s = streaming(catalog, memory_budget=256 << 10)
    same_rows(s.query(sql).rows(), reference.rows(sql), ordered=False)
    assert "window" in s.executor.spill_events


def test_no_spill_within_budget(catalog, reference):
    # a generous budget keeps everything on the device
    s = streaming(catalog, memory_budget=1 << 30)
    same_rows(s.query(FULL_SORT).rows(), reference.rows(FULL_SORT))
    assert s.executor.spill_events == []


def test_sort_above_spilled_aggregation(catalog, reference):
    # composition: a spilled aggregation feeding an external sort
    sql = ("select l_orderkey, sum(l_quantity) q from lineitem "
           "group by l_orderkey order by q desc, l_orderkey")
    s = streaming(catalog, memory_budget=192 << 10)
    same_rows(s.query(sql).rows(), reference.rows(sql))
    assert "aggregate" in s.executor.spill_events


def test_external_sort_dominant_min_value():
    """A first key whose minimum dominates the input defeats the quantile
    boundaries; the split must still make progress."""
    n = 30_000
    a = np.zeros(n)
    a[-5:] = [1.0, 2.0, 3.0, 4.0, 5.0]
    cat, rcat = memory_pair({"a": a, "b": np.arange(n, dtype=np.int64)[::-1].copy()})
    sql = "select a, b from t order by a, b"
    want = RSession(rcat).query(sql).rows()
    s = Session(cat, device="cpu", streaming=True, batch_rows=2048, memory_budget=64 << 10)
    same_rows(s.query(sql).rows(), want)
    assert "sort" in s.executor.spill_events
