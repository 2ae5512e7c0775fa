"""ML-in-SQL in presto_tpu_torch (device="cpu") against the JAX package:
the learn_linear_regression / learn_regressor / learn_classifier
aggregates (ops/mlreg.py's normal-equation accumulators, grouped and
global), regress and classify, through both packages' Session.query over
the same seeded tables, and ops/mlreg.py's functions against
presto_tpu/ops/mlreg.py's on the same arrays. Doubles within
presto_tpu/testing/oracle.py's tolerance (chip_smoke.row_diff); the
weights are also held to the generating coefficients and to numpy's least
squares. The cases are those of tests/test_mlreg.py, less the streaming
one (the port has no streaming executor).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.connectors.memory import MemoryCatalog as RMemoryCatalog
from presto_tpu.ops import mlreg as rmlreg
from presto_tpu.page import Page as RPage
from presto_tpu.session import Session as RSession
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.memory import MemoryCatalog
from presto_tpu_torch.ops import mlreg
from presto_tpu_torch.page import Page
from presto_tpu_torch.session import Session
from test_torch_collections import same_rows, sessions_over

# one torch thread: the suite runs in parallel worker processes
# (pytest-xdist), and a thread per core in each oversubscribes the host
torch.set_num_threads(1)


def _data(n=2000, seed=0):
    """y = 3*x1 - 2*x2 + 5 + 10*g + small noise."""
    rng = np.random.default_rng(seed)
    x1 = rng.normal(0, 1, n)
    x2 = rng.normal(0, 1, n)
    g = rng.integers(0, 2, n)
    y = 3 * x1 - 2 * x2 + 5 + 10 * g + rng.normal(0, 0.01, n)
    return {"x1": x1, "x2": x2, "g": g.astype(np.int64), "y": y}


@pytest.fixture(scope="module")
def sessions():
    return sessions_over(_data(), "obs")


SQL = {
    "global": "select learn_linear_regression(y, array[x1, x2]) m from obs",
    "grouped": "select g, learn_linear_regression(y, array[x1, x2]) m from obs group by g "
               "order by g",
    "learn_regressor": "select g, learn_regressor(y, array[x1, x2, x1 * x2]) from obs "
                       "group by g order by g",
    "nulls_excluded": "select learn_linear_regression(case when x1 > 1 then null else y end, "
                      "array[x1, x2]) from obs",
    "empty_group": "select learn_linear_regression(y, array[x1, x2]) from obs where x1 > 1e9",
    "regress_literal": "select avg(abs(y - regress(array[x1, x2], array[3.0, -2.0, 10.0]))) "
                       "from obs",
    "regress_learned": "with m as (select g mg, learn_linear_regression(y, array[x1, x2]) "
                       "model from obs group by g) select g, sum(regress(array[x1, x2], model)) "
                       "from obs join m on g = mg group by g order by g",
    "classify": "with m as (select learn_classifier(g, array[x1, y]) model from obs) "
                "select count_if(classify(array[x1, y], model) = g), count(*) from obs, m",
}


@pytest.mark.parametrize("name", list(SQL))
def test_equals_reference(name, sessions):
    port, ref = sessions
    same_rows(port.query(SQL[name]).rows(), ref.query(SQL[name]).rows())


def test_weights_match_generator_and_numpy(sessions):
    port, _ref = sessions
    rows = port.query(SQL["grouped"]).rows()
    d = _data()
    for g, model in rows:
        assert len(model) == mlreg.MODEL_WIDTH
        m = d["g"] == g
        x = np.stack([d["x1"][m], d["x2"][m], np.ones(m.sum())], axis=1)
        want = np.linalg.lstsq(x, d["y"][m], rcond=None)[0]
        got = [model[0], model[1], model[mlreg.K_MAX]]
        assert np.allclose(got, want, rtol=1e-7, atol=1e-7)
        assert abs(model[0] - 3) < 0.05 and abs(model[1] + 2) < 0.05
        assert abs(model[mlreg.K_MAX] - (5 + 10 * g)) < 0.05
        assert all(abs(v) < 1e-6 for v in model[2:mlreg.K_MAX])  # unused lanes ~0


def test_decimal_inputs_descale():
    n = 500
    rng = np.random.default_rng(7)
    x = rng.integers(-500, 500, n)  # decimal(6,2) storage: the value is x / 100
    y = 4.0 * (x / 100.0) + 2.0
    port = Session(MemoryCatalog({"d": Page.from_dict(
        {"x": (x, T.DecimalType(6, 2)), "y": y}, device="cpu")}), device="cpu")
    ref = RSession(RMemoryCatalog({"d": RPage.from_dict(
        {"x": (x, RT.DecimalType(6, 2)), "y": y})}), plan_cache=False, result_cache=False)
    sql = "select learn_linear_regression(y, array[x]) from d"
    got = port.query(sql).rows()
    same_rows(got, ref.query(sql).rows())
    assert abs(got[0][0][0] - 4.0) < 1e-6 and abs(got[0][0][mlreg.K_MAX] - 2.0) < 1e-6


def test_regress_honors_model_length():
    port, ref = sessions_over({"x": np.array([1.0, 1.0]), "w": np.array([2.0, 5.0])}, "p")
    for sql, want in (("select regress(array[x], array[2.0, 10.0]) from p limit 1", 12.0),
                      ("select regress(array[x], array[5.0]) from p limit 1", 5.0)):
        got = port.query(sql).rows()
        assert got == [(want,)]
        same_rows(got, ref.query(sql).rows())


def test_classify_labels_always_in_trained_set():
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.random(200) * 6, [50.0]])
    port, ref = sessions_over({"x": x, "y": (x > 3).astype(np.int64)})
    sql = ("with m as (select learn_classifier(y, array[x]) model from t) "
           "select classify(array[x], model) from t, m")
    got = port.query(sql).rows()
    assert {r[0] for r in got} <= {0, 1}
    same_rows(got, ref.query(sql).rows())


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


def test_mlreg_functions_equal_reference():
    """group_accumulate, merge_accumulators, solve_weights and predict on
    the same arrays (sorted group ids, as the aggregates give them)."""
    rng = np.random.default_rng(3)
    n, k, G = 3000, 4, 5
    feats = rng.normal(0, 2, (n, k))
    lens = rng.integers(1, k + 1, n).astype(np.int32)
    label = feats[:, 0] * 2 - feats[:, 1] + rng.normal(0, 0.1, n)
    contrib = rng.random(n) > 0.1
    gid = np.sort(rng.integers(0, G, n)).astype(np.int32)
    racc = rmlreg.group_accumulate(*(_both(a)[0] for a in (feats, lens, label, contrib, gid)),
                                   G)
    tacc = mlreg.group_accumulate(*(_both(a)[1] for a in (feats, lens, label, contrib, gid)),
                                  G)
    assert np.allclose(np.asarray(racc), tacc.numpy(), rtol=1e-12, atol=1e-9)
    # merge partials of two halves, sorted by group
    mg = np.array([0, 1, 2, 0, 3], np.int32)
    order = np.argsort(mg, kind="stable")
    accs = np.asarray(racc)[order]
    mc = np.array([True, True, False, True, True])[order]
    rm = rmlreg.merge_accumulators(jnp.asarray(accs), jnp.asarray(mc), jnp.asarray(mg[order]), 4)
    tm = mlreg.merge_accumulators(torch.from_numpy(accs), torch.from_numpy(mc),
                                  torch.from_numpy(mg[order]), 4)
    assert np.allclose(np.asarray(rm), tm.numpy(), rtol=1e-12, atol=1e-9)
    rw, rh = rmlreg.solve_weights(racc)
    tw, th = mlreg.solve_weights(tacc)
    assert np.allclose(np.asarray(rw), tw.numpy(), rtol=1e-7, atol=1e-9)
    assert np.array_equal(np.asarray(rh), th.numpy())
    mlens = np.full(G, mlreg.MODEL_WIDTH - 2, np.int32)
    rp = rmlreg.predict(jnp.asarray(feats[:G]), jnp.asarray(lens[:G]),
                        jnp.asarray(np.asarray(rw)[:, :-2]), jnp.asarray(mlens))
    tp = mlreg.predict(torch.from_numpy(feats[:G]), torch.from_numpy(lens[:G]),
                       tw[:, :-2].contiguous(), torch.from_numpy(mlens))
    assert np.allclose(np.asarray(rp), tp.numpy(), rtol=1e-9, atol=1e-9)


def test_segmented_sums_cross_chunks():
    """The accumulation runs in row chunks and two-level segmented sums:
    the same totals as one index_add_ when groups straddle chunks."""
    rng = np.random.default_rng(5)
    n = mlreg.CHUNK_ROWS * 2 + 777
    feats = torch.from_numpy(rng.normal(0, 1, (n, 2)))
    lens = torch.full((n,), 2, dtype=torch.int32)
    label = torch.from_numpy(rng.normal(0, 1, n))
    contrib = torch.ones(n, dtype=torch.bool)
    gid = torch.from_numpy(np.sort(rng.integers(0, 3, n)))
    acc = mlreg.group_accumulate(feats, lens, label, contrib, gid, 4)
    x = torch.cat([feats, torch.zeros(n, mlreg.K_MAX - 2, dtype=torch.float64),
                   torch.ones(n, 1, dtype=torch.float64)], dim=1)
    want = torch.zeros(4, x.shape[1], x.shape[1], dtype=torch.float64).index_add_(
        0, gid, x[:, :, None] * x[:, None, :])
    got = acc[:, 1 + x.shape[1]:1 + x.shape[1] + x.shape[1] ** 2].reshape(4, x.shape[1], -1)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-8)
    assert acc[3, 0] == 0 and acc[:3, 0].sum() == n
