"""Set operations, grouping sets and TABLESAMPLE through
presto_tpu_torch.Session (device="cpu") against presto_tpu.Session.

UNION [ALL] across varchar columns born with different dictionaries (the
branches' blocks are remapped onto one merged dictionary), INTERSECT and
EXCEPT with NULL rows on MemoryCatalog pages (a NULL equals a NULL in a set
operation), ROLLUP / CUBE / GROUPING SETS with grouping(), and
TABLESAMPLE BERNOULLI: `sample_page` keeps exactly the reference's rows for
the same seed and offset, and a sampled query keeps the same rows for the
same plan-time seed. Rows compare with chip_smoke.row_diff: doubles within
the oracle's tolerance, everything else exactly; rows without an ORDER BY
compare as multisets.
"""

import random

import numpy as np
import pytest
import torch

import chip_smoke
from presto_tpu import page as rpage
from presto_tpu import types as RT
from presto_tpu.connectors.memory import MemoryCatalog as RMemory
from presto_tpu.connectors.tpch import TpchCatalog as RCatalog
from presto_tpu.session import Session as RSession
from presto_tpu_torch.connectors.memory import MemoryCatalog
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.exec import executor as ex
from presto_tpu_torch.ops import filter as port_filter
from presto_tpu_torch.page import page_from_reference
from presto_tpu_torch.session import Session

# one torch thread: the suite runs in parallel worker processes
# (pytest-xdist), and a thread per core in each oversubscribes the host
torch.set_num_threads(1)

TPCH_SQL = {
    "union_two_dictionaries": "select n_name from nation union select r_name from region",
    "union_all_two_dictionaries": (
        "select n_name, n_regionkey from nation union all "
        "select r_name, r_regionkey from region"),
    "union_of_joins": (
        "select n_name, r_name from nation, region where n_regionkey = r_regionkey "
        "union select r_name, n_name from nation join region on n_regionkey = r_regionkey"),
    "intersect": (
        "select c_custkey from customer where c_mktsegment = 'BUILDING' intersect "
        "select o_custkey from orders where o_orderdate >= date '1995-01-01' "
        "and o_orderdate < date '1996-01-01'"),
    "except": (
        "select c_custkey from customer where c_mktsegment = 'BUILDING' except "
        "select o_custkey from orders where o_orderdate >= date '1995-01-01' "
        "and o_orderdate < date '1996-01-01'"),
    "rollup": (
        "select l_returnflag, l_linestatus, grouping(l_returnflag, l_linestatus) g, "
        "sum(l_quantity) q, count(*) c from lineitem group by rollup(l_returnflag, l_linestatus)"),
    "cube": (
        "select l_returnflag, l_linestatus, grouping(l_returnflag) g, sum(l_extendedprice) s "
        "from lineitem group by cube(l_returnflag, l_linestatus)"),
    "grouping_sets": (
        "select l_returnflag, l_linestatus, grouping(l_linestatus) g, avg(l_discount) a, "
        "count(*) c from lineitem group by grouping sets ((l_returnflag), (l_linestatus), ())"),
}

# two tables with NULL keys and NULL strings, their varchar columns in two
# different dictionaries
T1 = {"k": ([1, 2, 2, 0, 0, 5, 7, 7], [1, 1, 1, 0, 0, 1, 1, 1]),
      "s": ["a", "b", "b", None, "x", None, "q", "q"]}
T2 = {"k": ([2, 0, 5, 9, 9, 7], [1, 0, 1, 1, 1, 1]),
      "s": ["b", None, None, "z", "z", "q"]}

MEMORY_SQL = {
    "intersect_nulls": "select k, s from t1 intersect select k, s from t2",
    "except_nulls": "select k, s from t1 except select k, s from t2",
    "except_reversed": "select k, s from t2 except select k, s from t1",
    "union_nulls": "select k, s from t1 union select k, s from t2",
    "union_all_nulls": "select s, k from t1 union all select s, k from t2",
}


def _ref_page(cols):
    blocks = {}
    for name, val in cols.items():
        if isinstance(val, tuple):
            data, valid = val
            blocks[name] = rpage.Block.from_numpy(
                np.array(data, np.int64), RT.BIGINT, np.array(valid, bool))
        else:
            blocks[name] = rpage.Block.from_strings(val)
    return rpage.Page.from_dict(blocks)


def _ref(catalog):
    """presto_tpu's session without plan and result caches, and without its
    dynamic filters: they only prune rows, and off they halve the kernels
    its jit compiles for a join query."""
    sess = RSession(catalog, plan_cache=False, result_cache=False)
    sess.executor.dynamic_filtering = False
    return sess


@pytest.fixture(scope="module")
def tpch():
    return (
        Session(TpchCatalog(0.01, device="cpu"), device="cpu"),
        _ref(RCatalog(0.01)),
    )


@pytest.fixture(scope="module")
def memory():
    pages = {"t1": _ref_page(T1), "t2": _ref_page(T2)}
    port_pages = {n: page_from_reference(p, device="cpu") for n, p in pages.items()}
    return (
        Session(MemoryCatalog(port_pages), device="cpu"),
        _ref(RMemory(pages)),
    )


def _check(sessions, sql, monkeypatch):
    port, ref = sessions
    unions = []
    handler = ex.Executor._exec_union

    def spy(self, node, *pages):
        unions.append(node.distinct)
        return handler(self, node, *pages)

    monkeypatch.setattr(ex.Executor, "_exec_union", spy)
    got = port.query(sql).rows()
    want = ref.query(sql).rows()
    diff = chip_smoke.row_diff(got, want, ordered=False)
    assert diff is None, diff
    assert len(got) > 0 and unions  # every case runs the port's Union node
    return got


@pytest.mark.parametrize("name", list(TPCH_SQL))
def test_tpch_set_operations_equal_reference(name, tpch, monkeypatch):
    got = _check(tpch, TPCH_SQL[name], monkeypatch)
    if name.startswith("union_two"):
        # the merged dictionary decodes every name of both tables
        assert len(got) == 30 and ("ASIA",) in got and ("JAPAN",) in got


@pytest.mark.parametrize("name", list(MEMORY_SQL))
def test_memory_set_operations_with_nulls(name, memory, monkeypatch):
    got = _check(memory, MEMORY_SQL[name], monkeypatch)
    if name == "intersect_nulls":
        # (NULL, NULL) and (5, NULL) are in both tables, (2, 'b') and (7, 'q') too
        assert sorted(got, key=chip_smoke._row_key) == [
            (None, None), (2, "b"), (5, None), (7, "q")]


@pytest.mark.parametrize("seed, offset", [
    (0, 0), (12345, 0), (2**62 - 3, 1 << 40), (7, 2**64 - 5),
])
@pytest.mark.parametrize("fraction", [0.1, 0.5])
def test_sample_page_keeps_reference_rows(seed, offset, fraction):
    import jax.numpy as jnp

    from presto_tpu.ops.filter import sample_page as ref_sample

    n = 3000
    ref_page = rpage.Page.from_dict(
        {"a": rpage.Block.from_numpy(np.arange(n, dtype=np.int64) * 7, RT.BIGINT)},
        pad_to=4096)
    port_page = page_from_reference(ref_page, device="cpu")
    want = ref_sample(ref_page, fraction, seed, jnp.asarray(offset, jnp.uint64)).to_pylist()
    got = port_filter.sample_page(port_page, fraction, seed, offset).to_pylist()
    assert got == want
    assert 0.5 * fraction * n < len(got) < 1.5 * fraction * n


def test_tablesample_query_keeps_reference_rows(tpch):
    port, ref = tpch
    sql = "select l_orderkey, l_linenumber from lineitem tablesample bernoulli (10)"
    random.seed(20261017)
    got = port.query(sql).rows()
    random.seed(20261017)
    want = ref.query(sql).rows()
    assert got == want and 4000 < len(got) < 8000
