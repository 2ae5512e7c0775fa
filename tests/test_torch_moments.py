"""stddev / variance / skewness / kurtosis through the central-moments
accumulator (ops/moments.py): presto_tpu_torch against presto_tpu and
against numpy.

The single-process cases of tests/test_moments.py (its mesh case waits for
the port's multi-device executor), grouped and global, with NULL inputs,
including the mean ~1e9 data where raw power sums return (nan, -inf); the
TPC-H form (grouped by l_returnflag, SF 0.01); `group_moments` and
`merge_moments` on seeded data against the reference's; and `element_at`
over array values, which reads the accumulator.
"""

import numpy as np
import pytest

import chip_smoke
from presto_tpu import page as rpage
from presto_tpu import types as RT
from presto_tpu.connectors.memory import MemoryCatalog as RMemory
from presto_tpu.connectors.tpch import TpchCatalog as RCatalog
from presto_tpu.session import Session as RSession
from presto_tpu_torch.connectors.memory import MemoryCatalog
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.page import page_from_reference
from presto_tpu_torch.session import Session


def _ref(catalog):
    """presto_tpu's session without plan and result caches, and without its
    dynamic filters: they only prune rows, and off they halve the kernels
    its jit compiles for a join query."""
    sess = RSession(catalog, plan_cache=False, result_cache=False)
    sess.executor.dynamic_filtering = False
    return sess


def _skew(x):
    d = x - x.mean()
    return np.sqrt(len(x)) * (d**3).sum() / (d**2).sum() ** 1.5


def _kurt(x):
    d = x - x.mean()
    return len(x) * (d**4).sum() / (d**2).sum() ** 2 - 3.0


def _both(sql, v, g=None, valid=None):
    """Rows of `sql` over table t(v[, g]) in the port and the reference."""
    blocks = {"v": rpage.Block.from_numpy(np.asarray(v, np.float64), RT.DOUBLE, valid)}
    if g is not None:
        blocks["g"] = rpage.Block.from_numpy(np.asarray(g, np.int64), RT.BIGINT)
    page = rpage.Page.from_dict(blocks)
    port = Session(MemoryCatalog({"t": page_from_reference(page, device="cpu")}),
                   device="cpu")
    ref = _ref(RMemory({"t": page}))
    got, want = port.query(sql).rows(), ref.query(sql).rows()
    assert chip_smoke.row_diff(got, want) is None, chip_smoke.row_diff(got, want)
    return got


def test_skew_kurt_basic():
    v = np.array([1.0, 1.0, 1.0, 2.0, 10.0])
    (sk, ku), = _both("select skewness(v), kurtosis(v) from t", v)
    assert sk == pytest.approx(_skew(v), rel=1e-12)
    assert ku == pytest.approx(_kurt(v), rel=1e-12)


def test_skew_kurt_large_mean_no_cancellation():
    v = np.array([1e9 + i for i in range(1, 11)])
    (sk, ku), = _both("select skewness(v), kurtosis(v) from t", v)
    assert sk == pytest.approx(0.0, abs=1e-6)
    assert ku == pytest.approx(_kurt(np.arange(1.0, 11.0)), rel=1e-6)


def test_moments_grouped_with_nulls():
    g = np.array([1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 3], dtype=np.int64)
    v = np.array([3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0, 6.0, 5.0, 7.0, 8.0])
    valid = np.array([1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1], bool)
    rows = _both(
        "select g, skewness(v), kurtosis(v), stddev(v), var_pop(v) from t "
        "group by g order by g", v, g, valid)
    assert [r[0] for r in rows] == [1, 2, 3]
    for gv, sk, ku, sd, vp in rows[:2]:
        m = v[(g == gv) & valid]
        assert sk == pytest.approx(_skew(m), rel=1e-12)
        assert ku == pytest.approx(_kurt(m), rel=1e-12)
        assert sd == pytest.approx(np.std(m, ddof=1), rel=1e-12)
        assert vp == pytest.approx(np.var(m), rel=1e-12)
    assert rows[2][1:] == (None, None, None, 0.0)  # one row


def test_skew_kurt_null_under_min_rows():
    (sk, ku), = _both("select skewness(v), kurtosis(v) from t", np.array([1.0, 2.0]))
    assert sk is None and ku is None
    (sk3, ku3), = _both("select skewness(v), kurtosis(v) from t", np.array([1.0, 2.0, 4.0]))
    assert sk3 is not None and ku3 is None


def test_variance_family_large_mean():
    v = 1e9 + np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    row, = _both("select var_samp(v), stddev(v), var_pop(v), stddev_pop(v) from t", v)
    want = (np.var(v, ddof=1), np.std(v, ddof=1), np.var(v), np.std(v))
    for got, w in zip(row, want):
        assert got == pytest.approx(w, rel=1e-12)


@pytest.fixture(scope="module")
def tpch():
    return Session(TpchCatalog(0.01, device="cpu"), device="cpu"), _ref(RCatalog(0.01))


@pytest.mark.parametrize("sql", [
    "select l_returnflag, stddev(l_extendedprice), variance(l_discount), "
    "skewness(l_quantity) from lineitem group by l_returnflag order by l_returnflag",
    "select stddev_pop(l_extendedprice), var_samp(l_tax), kurtosis(l_quantity) from lineitem",
])
def test_tpch_moments_equal_reference(sql, tpch):
    port, ref = tpch
    got, want = port.query(sql).rows(), ref.query(sql).rows()
    assert chip_smoke.row_diff(got, want) is None, chip_smoke.row_diff(got, want)
    assert len(got) == (3 if "group by" in sql else 1)


def test_group_and_merge_moments_match_reference():
    import jax.numpy as jnp
    import torch

    from presto_tpu.ops import moments as rmo
    from presto_tpu_torch.ops import moments as pmo

    rng = np.random.default_rng(7)
    n, groups = 400, 6
    x = 1e8 + rng.random(n) * 10
    gid = rng.integers(0, groups, n)
    contrib = rng.random(n) > 0.1
    want = np.asarray(rmo.group_moments(jnp.asarray(x), jnp.asarray(contrib),
                                        jnp.asarray(gid, jnp.int32), groups))
    got = pmo.group_moments(torch.from_numpy(x), torch.from_numpy(contrib),
                            torch.from_numpy(gid), groups).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-6)
    # partial rows of 4 shards merged per group
    shard = rng.integers(0, 4, n)
    parts = [pmo.group_moments(torch.from_numpy(x), torch.from_numpy(contrib & (shard == s)),
                               torch.from_numpy(gid), groups) for s in range(4)]
    rows = torch.cat(parts)
    pgid = torch.arange(groups).repeat(4)
    pcontrib = rows[:, 0] > 0
    merged = pmo.merge_moments(rows, pcontrib, pgid, groups).numpy()
    rmerged = np.asarray(rmo.merge_moments(jnp.asarray(rows.numpy()),
                                           jnp.asarray(pcontrib.numpy()),
                                           jnp.asarray(pgid.numpy(), jnp.int32), groups))
    np.testing.assert_allclose(merged, rmerged, rtol=1e-9, atol=1e-6)
    # merging shard partials gives the one-pass n, mean and M2 (M3 and M4
    # carry the shard means' rounding at a mean of 1e8)
    np.testing.assert_allclose(merged[:, :3], got[:, :3], rtol=1e-9)


def test_element_at_over_arrays_matches_reference():
    import jax.numpy as jnp
    import torch

    from presto_tpu.expr import functions as RF
    from presto_tpu_torch import types as T
    from presto_tpu_torch.expr import functions as F

    data = np.arange(12, dtype=np.float64).reshape(4, 3)
    lengths = np.array([3, 2, 0, 3], np.int32)
    valid = np.array([1, 1, 1, 0], bool)
    idx = np.array([1, -1, 1, 3], np.int64)
    ref = RF.apply_function("element_at", [
        RF.Val(jnp.asarray(data), jnp.asarray(valid), RT.ArrayType(RT.DOUBLE),
               lengths=jnp.asarray(lengths)),
        RF.Val(jnp.asarray(idx), None, RT.BIGINT)], RT.DOUBLE)
    got = F.apply_function("element_at", [
        F.Val(torch.from_numpy(data), torch.from_numpy(valid), T.ArrayType(T.DOUBLE),
              lengths=torch.from_numpy(lengths)),
        F.Val(torch.from_numpy(idx), None, T.BIGINT)], T.DOUBLE)
    assert got.data.tolist() == np.asarray(ref.data).tolist()
    assert got.valid.tolist() == np.asarray(ref.valid).tolist() == [True, True, False, False]
