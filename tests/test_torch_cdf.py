"""The statistical *_cdf family of presto_tpu_torch (device="cpu"): each of
the 11 functions against the JAX package's (jax.scipy) through both
packages' `apply_function` on the same seeded columns with NULLs, and
against scipy.special / scipy.stats as an independent value; a few texts
through both packages' Session.query. Doubles within
presto_tpu/testing/oracle.py's tolerance (absolute 1e-6 or relative
1e-9); NULL positions exact. The port computes beta_cdf, binomial_cdf
and inverse_beta_cdf with its own regularized incomplete beta (torch has
none), the rest with torch.special or closed forms.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sp
import scipy.stats as st
import torch

import chip_smoke
from presto_tpu import types as RT
from presto_tpu.expr import functions as RF
from presto_tpu_torch import types as T
from presto_tpu_torch.expr import functions as F
from presto_tpu_torch.expr.functions_ext import betainc
from test_torch_collections import same_rows, sessions_over

# one torch thread: the suite runs in parallel worker processes
# (pytest-xdist), and a thread per core in each oversubscribes the host
torch.set_num_threads(1)

N = 64
_rng = np.random.default_rng(17)


def _col(lo, hi, integral=False, nulls=True):
    x = _rng.uniform(lo, hi, N)
    if integral:
        x = np.floor(x)
    valid = (_rng.random(N) > 0.1) if nulls else None
    return x, valid


def _pos(lo, hi):
    return _col(lo, hi, nulls=False)


# name: (argument columns, scipy's value of the same arguments)
CASES = {
    "normal_cdf": ((_col(-3, 3), _pos(0.5, 4), _col(-10, 10)),
                   lambda m, sd, x: st.norm.cdf(x, loc=m, scale=sd)),
    "inverse_normal_cdf": ((_col(-3, 3), _pos(0.5, 4), _pos(0.001, 0.999)),
                           lambda m, sd, p: st.norm.ppf(p, loc=m, scale=sd)),
    "beta_cdf": ((_pos(0.5, 8), _pos(0.5, 8), _col(-0.1, 1.1)),
                 lambda a, b, x: sp.betainc(a, b, x)),
    "cauchy_cdf": ((_col(-2, 2), _pos(0.1, 3), _col(-20, 20)),
                   lambda m, g, x: st.cauchy.cdf(x, loc=m, scale=g)),
    "gamma_cdf": ((_pos(0.5, 6), _pos(0.5, 5), _col(0, 30)),
                  lambda a, s, x: st.gamma.cdf(x, a, scale=s)),
    "laplace_cdf": ((_col(-2, 2), _pos(0.2, 3), _col(-10, 10)),
                    lambda m, b, x: st.laplace.cdf(x, loc=m, scale=b)),
    "weibull_cdf": ((_pos(0.5, 4), _pos(0.5, 5), _col(-1, 15)),
                    lambda a, b, x: st.weibull_min.cdf(x, a, scale=b)),
    "chi_squared_cdf": ((_pos(1, 12), _col(0, 30)), lambda df, x: st.chi2.cdf(x, df)),
    "poisson_cdf": ((_pos(0.5, 20), _col(0, 40, integral=True)),
                    lambda lam, k: st.poisson.cdf(k, lam)),
    "binomial_cdf": ((_col(1, 60, integral=True), _pos(0.05, 0.95), _col(0, 60, integral=True)),
                     lambda n, p, k: st.binom.cdf(np.minimum(k, n), n, p)),
    "inverse_beta_cdf": ((_pos(0.5, 6), _pos(0.5, 6), _pos(0.01, 0.99)),
                         lambda a, b, p: sp.betaincinv(a, b, p)),
}


def _vals(cols):
    r, t = [], []
    for x, valid in cols:
        r.append(RF.Val(jnp.asarray(x), None if valid is None else jnp.asarray(valid), RT.DOUBLE))
        t.append(F.Val(torch.from_numpy(x.copy()),
                       None if valid is None else torch.from_numpy(valid.copy()), T.DOUBLE))
    return r, t


def _rows(v):
    data = np.asarray(v.data) if not isinstance(v.data, torch.Tensor) else v.data.numpy()
    valid = None if v.valid is None else (
        np.asarray(v.valid) if not isinstance(v.valid, torch.Tensor) else v.valid.numpy())
    return [(None if valid is not None and not valid[i] else float(data[i]),) for i in range(N)]


@pytest.mark.parametrize("name", list(CASES))
def test_cdf_equals_reference_and_scipy(name):
    cols, scipy_fn = CASES[name]
    rvals, tvals = _vals(cols)
    got = F.apply_function(name, tvals, T.DOUBLE)
    same_rows(_rows(got), _rows(RF.apply_function(name, rvals, RT.DOUBLE)))
    want = scipy_fn(*(x for x, _ in cols))
    for (g,), w in zip(_rows(got), want):
        if g is not None:
            assert chip_smoke.same_value(g, float(w)), (name, g, w)


def test_betainc_edges_and_symmetry():
    a = torch.tensor([0.5, 2.0, 5.0, 30.0, 200.0, 1.0, 3.0], dtype=torch.float64)
    b = torch.tensor([0.5, 3.0, 1.0, 40.0, 150.0, 1.0, 2.0], dtype=torch.float64)
    for x in (0.0, 1e-12, 0.3, 0.57, 0.999, 1.0):
        xx = torch.full_like(a, x)
        got = betainc(a, b, xx)
        want = sp.betainc(a.numpy(), b.numpy(), xx.numpy())
        assert np.allclose(got.numpy(), want, rtol=1e-10, atol=1e-12), (x, got, want)
        # I_x(a, b) = 1 - I_{1-x}(b, a)
        assert np.allclose((got + betainc(b, a, 1.0 - xx)).numpy(), 1.0, atol=1e-12)


@pytest.fixture(scope="module")
def sessions():
    rng = np.random.default_rng(23)
    return sessions_over({"q": rng.integers(1, 51, 200).astype(np.int64),
                          "d": np.round(rng.uniform(0, 0.1, 200), 2)})


SQL = {
    "closed_forms": "select sum(normal_cdf(25, 10, q)), sum(cauchy_cdf(25, 5, q)), "
                    "sum(laplace_cdf(25, 8, q)), sum(weibull_cdf(1.5, 20, q)) from t",
    "special": "select sum(gamma_cdf(2, 10, q)), sum(chi_squared_cdf(5, d * 100)), "
               "sum(poisson_cdf(25, q)), sum(inverse_normal_cdf(0, 1, d * 9 + 0.05)) from t",
    "incomplete_beta": "select sum(beta_cdf(2, 5, d * 8)), sum(binomial_cdf(50, 0.5, q)), "
                       "sum(inverse_beta_cdf(2, 5, d * 8 + 0.05)) from t",
}


@pytest.mark.parametrize("name", list(SQL))
def test_texts_equal_reference(name, sessions):
    port, ref = sessions
    got = port.query(SQL[name]).rows()
    same_rows(got, ref.query(SQL[name]).rows())
    assert all(isinstance(v, float) and math.isfinite(v) for v in got[0])
