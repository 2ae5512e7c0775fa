"""approx_distinct (HyperLogLog) and approx_percentile through
presto_tpu_torch.Session (device="cpu") against presto_tpu.Session, and the
sketch functions themselves against the reference's.

HLL registers come from the value hash, and the port's ops/hashing.py is a
copy of the reference's, so the estimates must be EXACTLY the reference's
(a difference would mean the hashes differ). approx_percentile is the
exact nearest-rank selection in both packages, so its values are exact
too. The quantile sketch behind qdigest_agg and the distributed
approx_percentile (ops/qsketch.py) is held bin for bin.
"""

import numpy as np
import pytest

import chip_smoke
from presto_tpu.connectors.tpch import TpchCatalog as RCatalog
from presto_tpu.session import Session as RSession
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.session import Session

SQL = {
    "distinct_global": (
        "select approx_distinct(l_orderkey), approx_distinct(l_comment), "
        "approx_distinct(l_extendedprice), approx_distinct(l_shipdate), "
        "approx_distinct(l_discount * l_quantity) from lineitem"),
    "distinct_grouped": (
        "select l_returnflag, approx_distinct(l_partkey), approx_distinct(l_suppkey) "
        "from lineitem group by l_returnflag order by l_returnflag"),
    "distinct_nulls": (
        "select approx_distinct(case when o_orderkey % 3 = 0 then null else o_custkey end), "
        "count(*) from orders"),
    "percentile_global": (
        "select approx_percentile(l_extendedprice, 0.0), approx_percentile(l_extendedprice, 0.1), "
        "approx_percentile(l_quantity, 0.5), approx_percentile(l_discount, 0.9), "
        "approx_percentile(l_shipdate, 0.25), approx_percentile(l_orderkey, 1.0) from lineitem"),
    "percentile_grouped": (
        "select o_orderstatus, approx_percentile(o_totalprice, 0.5), "
        "approx_percentile(cast(o_totalprice as double), 0.75), "
        "approx_percentile(o_custkey, 0.05) from orders group by o_orderstatus "
        "order by o_orderstatus"),
}


def _ref(catalog):
    """presto_tpu's session without plan and result caches, and without its
    dynamic filters: they only prune rows, and off they halve the kernels
    its jit compiles for a join query."""
    sess = RSession(catalog, plan_cache=False, result_cache=False)
    sess.executor.dynamic_filtering = False
    return sess


@pytest.fixture(scope="module")
def sessions():
    return (
        Session(TpchCatalog(0.01, device="cpu"), device="cpu"),
        _ref(RCatalog(0.01)),
    )


@pytest.mark.parametrize("name", list(SQL))
def test_sketch_aggregates_equal_reference(name, sessions):
    port, ref = sessions
    got = port.query(SQL[name]).rows()
    want = ref.query(SQL[name]).rows()
    # doubles within the oracle's tolerance: the reference's CAST(decimal AS
    # double) can be one ulp off the correctly rounded value the port gives
    assert chip_smoke.row_diff(got, want) is None, chip_smoke.row_diff(got, want)
    assert len(got) > 0 and all(v is not None for v in got[0])


def test_hll_functions_match_reference():
    import jax.numpy as jnp
    import torch

    from presto_tpu.ops import aggregate as ra
    from presto_tpu.expr.functions import Val as RVal
    from presto_tpu import types as RT
    from presto_tpu_torch.ops import aggregate as pa

    rng = np.random.default_rng(11)
    n, groups = 20_000, 5
    x = rng.integers(-(1 << 62), 1 << 62, n)
    x[: n // 2] = x[: n // 2] % 3000  # many duplicates
    gid = rng.integers(0, groups, n)
    contrib = rng.random(n) > 0.05
    want = np.asarray(ra.hll_group_registers(
        RVal(jnp.asarray(x), None, RT.BIGINT), jnp.asarray(contrib),
        jnp.asarray(gid, jnp.int32), groups))
    got = pa.hll_group_registers(torch.from_numpy(x), torch.from_numpy(contrib),
                                 torch.from_numpy(gid), groups)
    assert np.array_equal(got.numpy(), want)
    merge_gid = np.array([0, 1, 0, 1, 1])
    m_want = np.asarray(ra.hll_merge_registers(jnp.asarray(want), jnp.ones(groups, bool),
                                               jnp.asarray(merge_gid, jnp.int32), 2))
    m_got = pa.hll_merge_registers(got, torch.ones(groups, dtype=torch.bool),
                                   torch.from_numpy(merge_gid), 2)
    assert np.array_equal(m_got.numpy(), m_want)
    assert pa.hll_estimate(m_got).tolist() == np.asarray(ra.hll_estimate(m_want)).tolist()


@pytest.mark.parametrize("fraction", [0.0, 0.3, 0.5, 0.99, 1.0])
def test_quantile_sketch_matches_reference(fraction):
    import jax.numpy as jnp
    import torch

    from presto_tpu.ops import qsketch as rq
    from presto_tpu_torch.ops import qsketch as pq

    rng = np.random.default_rng(5)
    n, groups = 5000, 4
    x = np.concatenate([rng.normal(0, 1e3, n - 10), [0.0, -0.0, 1e-12, -3e20, 7e18,
                                                     2.0**-40, 1.0, -1.0, 1e300, 5.5]])
    gid = rng.integers(0, groups, n)
    contrib = rng.random(n) > 0.1
    want = np.asarray(rq.group_sketch(jnp.asarray(x), jnp.asarray(contrib),
                                      jnp.asarray(gid, jnp.int32), groups))
    got = pq.group_sketch(torch.from_numpy(x), torch.from_numpy(contrib),
                          torch.from_numpy(gid), groups)
    assert np.array_equal(got.numpy(), want)
    merged = pq.merge_sketches(got, torch.ones(groups, dtype=torch.bool),
                               torch.tensor([0, 1, 1, 0]), 2)
    r_merged = np.asarray(rq.merge_sketches(jnp.asarray(want), jnp.ones(groups, bool),
                                            jnp.asarray([0, 1, 1, 0], jnp.int32), 2))
    assert np.array_equal(merged.numpy(), r_merged)
    empty = torch.zeros((1, pq.B), dtype=torch.int64)
    p_got = pq.percentile_value(torch.cat([merged, empty]), fraction).tolist()
    p_want = np.asarray(rq.percentile_value(
        jnp.concatenate([jnp.asarray(r_merged), jnp.zeros((1, rq.B), jnp.int64)]),
        fraction)).tolist()
    # bin midpoints are exact powers of two times (1 + k/32) in the port;
    # the reference's exp2 can be ulps off them
    assert all(chip_smoke._value_close(a, b) for a, b in zip(p_got[:2], p_want[:2]))
    assert np.isnan(p_got[2]) and np.isnan(p_want[2])
