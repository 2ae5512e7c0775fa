"""Parity: presto_tpu_torch's expression evaluator and scalar functions
against presto_tpu's, over one small page with NULLs, dictionaries, dates,
short and long decimals and doubles (numpy inputs, fixed seed; device="cpu").

Values and validity must be equal; doubles agree within 1e-12 relative.
Functions not ported yet must raise "not ported yet" when planned.
"""

import decimal

import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.expr import compiler as rcomp
from presto_tpu.expr import ir as rir
from presto_tpu.page import Block as RBlock
from presto_tpu.page import Page as RPage
from presto_tpu_torch import types as T
from presto_tpu_torch.expr import compiler as comp
from presto_tpu_torch.expr import functions as F
from presto_tpu_torch.expr import ir
from presto_tpu_torch.page import Block, Page

# one torch thread: the suite runs in parallel worker processes
# (pytest-xdist), and a thread per core in each oversubscribes the host
torch.set_num_threads(1)

N = 64
_rng = np.random.default_rng(31)
COLS = {
    "i": (_rng.integers(-50, 50, N), _rng.random(N) < 0.85, "bigint", None),
    "j": (_rng.integers(-5, 6, N), None, "bigint", None),
    "n": (_rng.integers(-9, 9, N).astype(np.int32), None, "integer", None),
    "x": (_rng.normal(0, 10, N), None, "double", None),
    "p": (_rng.integers(-10**6, 10**6, N), None, "decimal(12,2)", None),
    "q": (_rng.integers(0, 11, N), _rng.random(N) < 0.9, "decimal(4,2)", None),
    "l": (np.stack([_rng.integers(-(1 << 30), 1 << 30, N), _rng.integers(0, 1 << 32, N)], -1),
          None, "decimal(38,3)", None),
    "d": (_rng.integers(-800, 20000, N).astype(np.int32), None, "date", None),
    "s": (_rng.integers(0, 5, N).astype(np.int32), _rng.random(N) < 0.9, "varchar",
          ("alpha", "Beta", "gamma ray", "delta", "PROMO tin")),
    "b": (_rng.random(N) < 0.5, _rng.random(N) < 0.8, "boolean", None),
}


def _pages():
    rb = [RBlock.from_numpy(a, RT.parse_type(t), valid=v, dictionary=d) for a, v, t, d in COLS.values()]
    tb = [Block.from_numpy(a, T.parse_type(t), valid=v, dictionary=d, device="cpu")
          for a, v, t, d in COLS.values()]
    return RPage.from_blocks(rb, list(COLS)), Page.from_blocks(tb, list(COLS))


RPAGE, TPAGE = _pages()


def both(build):
    """build(ir_module, types_module) -> RowExpression, run for both packages."""
    return build(rir, RT), build(ir, T)


def c(m, t, name):
    return m.col(name, t.parse_type(COLS[name][2]))


EXPRS = {
    "arith_int": lambda m, t: m.binary("add", m.binary("multiply", c(m, t, "i"), c(m, t, "j")), c(m, t, "n")),
    "div_mod_int": lambda m, t: m.binary("modulus", m.binary("divide", c(m, t, "i"), c(m, t, "j")), c(m, t, "n")),
    "dec_mul_sub": lambda m, t: m.binary("multiply", c(m, t, "p"), m.binary("subtract", m.lit(1), c(m, t, "q"))),
    "dec_div": lambda m, t: m.binary("divide", c(m, t, "p"), c(m, t, "q")),
    "dec_plus_double": lambda m, t: m.binary("add", c(m, t, "p"), c(m, t, "x")),
    "long_dec_add": lambda m, t: m.binary("add", c(m, t, "l"), c(m, t, "p")),
    "long_dec_cmp": lambda m, t: m.comparison("lt", c(m, t, "l"), c(m, t, "p")),
    "negate": lambda m, t: m.call("negate", [c(m, t, "p")], t.parse_type("decimal(12,2)")),
    "cmp_mixed": lambda m, t: m.comparison("ge", c(m, t, "q"), c(m, t, "n")),
    "kleene": lambda m, t: m.or_(m.and_(c(m, t, "b"), m.comparison("gt", c(m, t, "i"), m.lit(0))),
                                 m.not_(m.is_null(c(m, t, "q")))),
    "between_in": lambda m, t: m.and_(m.between(c(m, t, "j"), m.lit(-2), m.lit(3)),
                                      m.in_list(c(m, t, "n"), [m.lit(1), m.lit(-3)])),
    "case_if": lambda m, t: m.if_(c(m, t, "b"), c(m, t, "p"), c(m, t, "q")),
    "coalesce": lambda m, t: m.call("coalesce", [c(m, t, "i"), c(m, t, "j")], t.BIGINT),
    "nullif": lambda m, t: m.call("nullif", [c(m, t, "j"), m.lit(0)], t.BIGINT),
    "cast_double": lambda m, t: m.cast(c(m, t, "p"), t.DOUBLE),
    "cast_dec": lambda m, t: m.cast(c(m, t, "x"), t.decimal(10, 1)),
    "cast_int": lambda m, t: m.cast(c(m, t, "p"), t.BIGINT),
    "date_arith": lambda m, t: m.binary("subtract", c(m, t, "d"), m.Literal(40, t.INTERVAL_YEAR_MONTH)),
    "date_literal_cmp": lambda m, t: m.comparison("le", c(m, t, "d"), m.Literal("1995-03-15", t.DATE)),
    "year": lambda m, t: m.call("year", [c(m, t, "d")], t.BIGINT),
    "quarter": lambda m, t: m.call("quarter", [c(m, t, "d")], t.BIGINT),
    "day_of_year": lambda m, t: m.call("day_of_year", [c(m, t, "d")], t.BIGINT),
    "like": lambda m, t: m.like(c(m, t, "s"), "%a%"),
    "substr": lambda m, t: m.call("substr", [c(m, t, "s"), m.lit(2), m.lit(3)], t.VARCHAR),
    "upper_length": lambda m, t: m.call("length", [m.call("upper", [c(m, t, "s")], t.VARCHAR)], t.BIGINT),
    "varchar_literal_cmp": lambda m, t: m.comparison("gt", c(m, t, "s"), m.lit("beta")),
    "concat": lambda m, t: m.call("concat", [c(m, t, "s"), m.lit("!")], t.VARCHAR),
    "math": lambda m, t: m.call("round", [m.call("sqrt", [m.call("abs", [c(m, t, "x")], t.DOUBLE)],
                                                 t.DOUBLE), m.lit(2)], t.DOUBLE),
    "floor_ceil_dec": lambda m, t: m.binary("add", m.call("floor", [c(m, t, "p")], t.parse_type("decimal(12,2)")),
                                            m.call("ceil", [c(m, t, "p")], t.parse_type("decimal(12,2)"))),
}


def _values(page, v, typ):
    n = int(page.count)
    data = np.asarray(v.data[:n]) if not hasattr(v.data, "numpy") else v.data[:n].numpy()
    valid = np.ones(n, bool) if v.valid is None else np.asarray(
        v.valid[:n] if not hasattr(v.valid, "numpy") else v.valid[:n].numpy())
    out = []
    for k in range(n):
        if not valid[k]:
            out.append(None)
        elif v.dictionary is not None:
            out.append(v.dictionary[int(data[k])])
        else:
            out.append(typ.to_python(data[k]))
    return out


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_expression_matches_reference(name):
    rexpr, texpr = both(EXPRS[name])
    assert str(texpr.type) == str(rexpr.type)
    want = _values(RPAGE, rcomp.evaluate(rexpr, RPAGE), rexpr.type)
    got = _values(TPAGE, comp.evaluate(texpr, TPAGE), texpr.type)
    for g, w in zip(got, want):
        if isinstance(w, float):
            assert abs(g - w) <= 1e-12 * max(abs(w), 1.0), (g, w)
        elif isinstance(w, np.datetime64):
            assert g == w
        else:
            assert g == w and type(g) is type(w) or (
                isinstance(w, decimal.Decimal) and g == w), (g, w)


def test_unported_functions_raise_clearly():
    """Every name of the JAX package's registry is known here and none is
    left unported: normal_cdf, the last family taken out of NOT_PORTED,
    now infers and evaluates; an unknown name still raises clearly."""
    from presto_tpu.expr.functions import FUNCTIONS as RFUNCTIONS

    missing = set(RFUNCTIONS) - set(F.FUNCTIONS)
    assert not missing, sorted(missing)
    assert F.NOT_PORTED == ()
    assert F.infer_call_type("normal_cdf", (T.DOUBLE, T.DOUBLE, T.DOUBLE)) == T.DOUBLE
    x = F.Val(torch.tensor([0.0, 1.0], dtype=torch.float64), None, T.DOUBLE)
    one = F.Val(torch.ones(2, dtype=torch.float64), None, T.DOUBLE)
    zero = F.Val(torch.zeros(2, dtype=torch.float64), None, T.DOUBLE)
    got = F.apply_function("normal_cdf", [zero, one, x], T.DOUBLE).data.tolist()
    assert abs(got[0] - 0.5) < 1e-15 and abs(got[1] - 0.8413447460685429) < 1e-15
    with pytest.raises(KeyError, match="unknown function"):
        F.infer_call_type("no_such_function", (T.DOUBLE,))
