"""Distributed execution in the port (presto_tpu_torch/exec/dist.py over
default_mesh(8, device="cpu"): eight logical workers in one process) at
TPC-H SF 0.01, the cases of tests/test_tpch_distributed.py,
test_distributed_sort.py and test_grouped_exchange.py:

* the 22 TPC-H texts under the cost-based join distribution, and Q3, Q5,
  Q10, Q17 and Q18 with every join repartitioned (broadcast_threshold=0),
  each held to the port's single-device session and to the SQLite oracle
  (presto_tpu/testing/oracle.py, its tolerances); Q1 and Q3 under both
  regimes also to the JAX package's mesh session (its 8 virtual devices);
* the distributed sort (per-worker sort + rank merge, and its fallbacks)
  equal to the single-device session in order;
* the bucketed exchange join under an exchange budget, a skewed key
  included, equal to the single-device rows;
* TABLESAMPLE: the rows of sample_page over each worker's shard with the
  plan's seed and offset worker x shard capacity (the JAX package's rule);
* NOT IN through a mesh session held to SQL's three-valued evaluation
  (tests/test_torch_not_in.py's inputs);
* EXPLAIN ANALYZE's `-- exchange:` footer, the plan-cache split between a
  mesh session and a local one, and a CUDA mesh raising without a card."""

import numpy as np
import pytest
import torch

import presto_tpu.types as RT
from presto_tpu.benchmark.tpch_sql import QUERIES
from presto_tpu.connectors.tpch import TpchCatalog as RCatalog
from presto_tpu.parallel.mesh import default_mesh as ref_default_mesh
from presto_tpu.session import Session as RSession
from presto_tpu.testing.oracle import SqliteOracle, assert_same_results
from presto_tpu_torch.connectors.memory import MemoryCatalog
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.exec.dist import DistributedExecutor
from presto_tpu_torch.ops.filter import sample_page
from presto_tpu_torch.page import Page
from presto_tpu_torch.parallel import default_mesh, shard_rows
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.session import Session
from test_torch_not_in import SUBQUERIES, T_A, not_in, sessions

torch.set_num_threads(1)

SF = 0.01
WIDTH = 8
REPARTITIONED = (3, 5, 10, 17, 18)


@pytest.fixture(scope="module")
def catalog():
    return TpchCatalog(SF, device="cpu")


@pytest.fixture(scope="module")
def mesh():
    return default_mesh(WIDTH, device="cpu")


@pytest.fixture(scope="module")
def local(catalog):
    return Session(catalog, device="cpu", result_cache=False)


@pytest.fixture(scope="module")
def dist(catalog, mesh):
    return Session(catalog, mesh=mesh, result_cache=False)


@pytest.fixture(scope="module")
def dist0(catalog, mesh):
    return Session(catalog, mesh=mesh, broadcast_threshold=0, result_cache=False)


@pytest.fixture(scope="module")
def oracle():
    return SqliteOracle(sf=SF)


def _key(row):
    return tuple((x is None, repr(x)) for x in row)


def check(sess, local, oracle, q):
    result = sess.query(QUERIES[q])
    got = result.rows()
    assert sorted(got, key=_key) == sorted(local.query(QUERIES[q]).rows(), key=_key), q
    # the oracle's tolerances go by the JAX package's types
    types = [RT.parse_type(b.type.display()) for b in result.page.blocks]
    assert_same_results(got, oracle.query(QUERIES[q]), types, ordered=False)
    return got


@pytest.mark.parametrize("regime", ["cost", "repartitioned"])
def test_tpch_distributed(dist, dist0, local, oracle, regime):
    sess = dist if regime == "cost" else dist0
    for q in (sorted(QUERIES) if regime == "cost" else REPARTITIONED):
        got = check(sess, local, oracle, q)
        assert len(got) > 0 or q == 20
        assert all(str(b.device) == "cpu" for b in sess.query(QUERIES[q]).page.blocks)
    assert isinstance(sess.executor, DistributedExecutor)
    assert sess.executor.local._est_env()[1] == WIDTH


@pytest.mark.parametrize("threshold", [None, 0])
def test_q1_q3_equal_jax_mesh_session(catalog, mesh, threshold):
    ref = RSession(RCatalog(SF), mesh=ref_default_mesh(WIDTH), broadcast_threshold=threshold,
                   plan_cache=False, result_cache=False)
    # dynamic filters prune rows only, and halve the JAX package's compiles
    ref.executor.local.dynamic_filtering = False
    port = Session(catalog, mesh=mesh, broadcast_threshold=threshold, result_cache=False)
    for q in (1, 3):
        got, want = port.query(QUERIES[q]).rows(), ref.query(QUERIES[q]).rows()
        assert got == want and got, q
    if threshold == 0:
        port.query(QUERIES[3])
        assert [e["kind"] for e in port.executor.exchange_events].count("repartition") >= 4


# -- distributed sort (tests/test_distributed_sort.py) ------------------------


SORT_CASES = {
    "single_key": "select o_orderkey from orders order by o_orderkey",
    "single_key_desc": "select o_custkey from orders order by o_custkey desc",
    "non_projected_and_dates": "select o_orderkey, o_orderdate from orders "
                               "order by o_orderdate, o_orderkey",
    "multi_key": "select l_orderkey, l_linenumber from lineitem "
                 "order by l_shipdate, l_orderkey, l_linenumber",
    "nullable_key": "select o_orderkey, case when o_orderkey % 7 = 0 then null "
                    "else o_totalprice end p from orders order by p, o_orderkey",
    "sorted_aggregate": "select o_orderpriority, count(*) c from orders "
                        "group by o_orderpriority order by c desc, o_orderpriority",
}


@pytest.mark.parametrize("case", sorted(SORT_CASES))
def test_distributed_sort(dist, local, monkeypatch, case):
    merges = []
    merge = DistributedExecutor._merge_sorted_runs
    monkeypatch.setattr(DistributedExecutor, "_merge_sorted_runs",
                        lambda self, *a: merges.append(1) or merge(self, *a))
    got = dist.query(SORT_CASES[case]).rows()
    assert got == local.query(SORT_CASES[case]).rows() and got
    # the single-key sorts without NULLs merge the workers' runs
    assert bool(merges) == (case in ("single_key", "single_key_desc"))


def test_nan_key_falls_back(dist, local):
    import math

    sql = ("select case when o_orderkey % 7 = 0 then nan() "
           "else o_totalprice + 0e0 end r from orders order by r")
    a = [r[0] for r in dist.query(sql).rows()]
    b = [r[0] for r in local.query(sql).rows()]
    assert len(a) == len(b)
    assert sum(math.isnan(x) for x in a) == sum(math.isnan(x) for x in b) > 0
    for x, y in zip(a, b):
        assert (math.isnan(x) and math.isnan(y)) or x == y


# -- the bucketed exchange join (tests/test_grouped_exchange.py) -------------

GX_SQL = "select count(*) c, sum(fv + dv) s from f, d where f.k = d.k"


def _gx_catalog(seed, n, keys, hot=None):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, keys, n)
    if hot is not None:
        k = np.where(rng.random(n) < 0.6, hot, k)
    fv = rng.integers(0, 100, n) if hot is None else np.arange(n)
    return MemoryCatalog({
        "f": Page.from_dict({"k": k.astype(np.int64), "fv": fv.astype(np.int64)},
                            device="cpu"),
        "d": Page.from_dict({"k": np.arange(keys, dtype=np.int64),
                             "dv": np.arange(keys, dtype=np.int64) * (3 if hot is None else 1)},
                            device="cpu"),
    }, device="cpu")


@pytest.fixture(scope="module")
def gx_catalog():
    return _gx_catalog(4, 20_000, 3_000)


@pytest.mark.parametrize("budget,min_buckets", [(200_000, 2), (40_000, 4)])
def test_grouped_join_matches_materializing(gx_catalog, mesh, budget, min_buckets):
    want = Session(gx_catalog, device="cpu").query(GX_SQL).rows()
    sess = Session(gx_catalog, mesh=mesh, broadcast_threshold=0, exchange_budget=budget)
    assert sess.query(GX_SQL).rows() == want
    ev = sess.executor.exchange_events[-1]
    assert ev["buckets"] >= min_buckets
    # the bucketed path's peak exchanged bytes beat the materializing
    # estimate
    assert ev["per_shard_bytes"] < ev["estimate"]
    txt = sess.explain_analyze(GX_SQL)
    assert f"grouped join buckets={ev['buckets']}" in txt


def test_grouped_join_skewed_key(mesh):
    # one hot key: its bucket holds most rows of one worker; the exact
    # exchange sizes take it without a retry or a lost row
    cat = _gx_catalog(9, 8_000, 500, hot=7)
    want = Session(cat, device="cpu").query(GX_SQL).rows()
    sess = Session(cat, mesh=mesh, broadcast_threshold=0, exchange_budget=60_000)
    assert sess.query(GX_SQL).rows() == want
    assert sess.executor.exchange_events[-1]["buckets"] > 1


def test_left_join_grouped(gx_catalog, mesh):
    sql = ("select count(*) c, count(dv) cd from f left join d "
           "on f.k = d.k and d.k < 1500")
    want = Session(gx_catalog, device="cpu").query(sql).rows()
    sess = Session(gx_catalog, mesh=mesh, broadcast_threshold=0, exchange_budget=100_000)
    assert sess.query(sql).rows() == want


# -- TABLESAMPLE, NOT IN, EXPLAIN ANALYZE, caches ------------------------------


def test_tablesample_rows_follow_the_worker_offsets(catalog, mesh):
    sess = Session(catalog, mesh=mesh, result_cache=False)
    sql = "select l_orderkey, l_linenumber from lineitem tablesample bernoulli (10)"
    plan = sess.plan(sql)  # the sample's seed is drawn at planning
    sample = plan
    while not isinstance(sample, N.Sample):
        sample = sample.children[0]
    got = sess.executor.run(plan).to_pylist()
    page = catalog.page("lineitem").select(["l_orderkey", "l_linenumber"])
    want = []
    for i, shard in enumerate(shard_rows(page, mesh)):
        want += sample_page(shard, sample.fraction, sample.seed, i * shard.capacity).to_pylist()
    assert got == want and 0 < len(got) < int(page.count)


def test_not_in_through_a_mesh_session(mesh):
    mat, _streaming = sessions({"t": T_A, **{f"u_{k}": v for k, v in SUBQUERIES.items()}})
    sess = Session(mat.catalog, mesh=mesh, broadcast_threshold=0, result_cache=False)
    for sub, values in SUBQUERIES.items():
        sql = f"select a from t where a not in (select u from u_{sub})"
        got = sess.query(sql).rows()
        want = [(v,) for v in T_A if not_in(v, values) is True]
        assert sorted(got, key=repr) == sorted(want, key=repr), sub
    rng = np.random.default_rng(13)
    probe = [None if rng.random() < 0.1 else int(x) for x in rng.integers(0, 300, 2_000)]
    for with_null in (False, True):
        sub = [int(x) for x in rng.integers(0, 300, 120)] + ([None] if with_null else [])
        mat, _ = sessions({"t": probe, "u": sub})
        sess = Session(mat.catalog, mesh=mesh, broadcast_threshold=0, result_cache=False)
        got = sess.query("select a from t where a not in (select u from u)").rows()
        assert sorted(got, key=repr) == sorted(((v,) for v in probe if not_in(v, sub) is True),
                                               key=repr)
        assert (len(got) == 0) == with_null


def test_explain_analyze_exchange_footer_and_plan_cache(catalog, mesh, local):
    sess = Session(catalog, mesh=mesh, broadcast_threshold=0, result_cache=False)
    txt = sess.explain_analyze(QUERIES[3])
    footer = [ln for ln in txt.split("\n") if ln.startswith("-- exchange:")]
    assert footer and f"repartitions over {WIDTH} workers" in footer[0]
    assert "Exchange [repartition]" in txt
    # one catalog, one text: the mesh session's plan is fragmented, the
    # local one's is not, and neither serves the other's
    assert "Exchange" not in N.plan_tree_str(local.plan(QUERIES[3]))
    assert "Exchange" in N.plan_tree_str(sess.plan(QUERIES[3]))
    assert "Exchange" not in N.plan_tree_str(local.plan(QUERIES[3]))
    # SET SESSION broadcast_threshold changes a mesh session's plan
    cost = Session(catalog, mesh=mesh, result_cache=False)
    before = N.plan_tree_str(cost.plan(QUERIES[3]))
    cost.query("set session broadcast_threshold = 0")
    after = N.plan_tree_str(cost.with_properties({"broadcast_threshold": 0}).plan(QUERIES[3]))
    assert before != after and "Exchange [repartition] [o_orderkey" in after


def test_statements_through_a_mesh_session(mesh):
    """DML plans run fragmented too: INSERT ... SELECT and DELETE with a
    subquery on a mesh session over the memory connector."""
    sess = Session(MemoryCatalog({}, device="cpu"), mesh=mesh, result_cache=False)
    sess.query("create table t (a bigint, b bigint)")
    sess.query("insert into t values " + ", ".join(f"({i}, {i % 7})" for i in range(200)))
    sess.query("create table u as select a from t where b = 3")
    assert sess.query("delete from t where a in (select a from u)").rows() == [(29,)]
    got = sess.query("select count(*), sum(a) from t").rows()
    assert got == [(171, sum(i for i in range(200) if i % 7 != 3))]


def test_cuda_mesh_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_mesh(8)
