"""The lambda forms of presto_tpu_torch's expression compiler
(transform, filter, reduce, zip_with, map_zip_with, any_match, all_match,
none_match, map_filter, transform_values, transform_keys; device="cpu")
against the JAX package, through both packages' Session.query over the same
seeded table and through both packages' `evaluate` on the same page.
Integers, strings and NULLs exact, doubles within
presto_tpu/testing/oracle.py's tolerance. The cases are those of
tests/test_collections.py's lambda and map tests, over columns with NULLs.
"""

import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.expr import compiler as rcompiler
from presto_tpu.expr import ir as rir
from presto_tpu_torch import types as T
from presto_tpu_torch.expr import compiler
from presto_tpu_torch.expr import ir
from presto_tpu_torch.page import page_from_reference
from test_torch_collections import same_rows, sessions_over, table_columns

# one torch thread: the suite runs in parallel worker processes
# (pytest-xdist), and a thread per core in each oversubscribes the host
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sessions():
    return sessions_over(table_columns(seed=12))


SQL = {
    "transform_literal": "select element_at(transform(array[1, 2, 3], x -> x * x), 3) from t "
                         "limit 1",
    "transform_outer_column": "select v, element_at(transform(array[100], x -> x + v), 1), "
                              "transform(array[g, v], x -> x * g) from t order by v, g",
    "transform_nulls": "select g, transform(array_agg(k), e -> concat(e, '!')), "
                       "transform(array_agg(v), e -> case when e > 0 then e end) "
                       "from t group by g order by g",
    "filter": "select cardinality(filter(array[1, 2, 3, 4, 5, 6], x -> x % 3 = 0)), "
              "element_at(filter(array[5, 1, 8, 2], x -> x > 1), 2) from t limit 1",
    "filter_grouped": "select g, filter(array_agg(v), e -> e > g * 5), "
                      "filter(array_agg(k), e -> e <> 'ab') from t group by g order by g",
    "reduce": "select reduce(array[1, 2, 3, 4], 0, (s, x) -> s + x, s -> s), "
              "reduce(array[2, 3, 4], 1, (s, x) -> s * x, s -> s * 10) from t limit 1",
    "reduce_grouped": "select g, reduce(array_agg(v), 0, (s, x) -> s + x, s -> s * 2), "
                      "reduce(array_agg(x), 0.0, (s, e) -> greatest(s, e), s -> s) "
                      "from t group by g order by g",
    "matches": "select any_match(array[1, 2, 3], x -> x > 2), all_match(array[1, 2, 3], "
               "x -> x > 0), none_match(array[1, 2, 3], x -> x > 9), any_match(array[1, 2, 3], "
               "x -> x > 9) from t limit 1",
    "matches_grouped": "select g, any_match(array_agg(v), e -> e > 50), "
                       "all_match(array_agg(v), e -> e > -25), none_match(array_agg(s), "
                       "e -> e = 'gh') from t group by g order by g",
    "zip_with": "select reduce(zip_with(array[1, 2, 3], array[10, 20, 30], (a, b) -> a * b), "
                "0, (s, x) -> s + x, s -> s) from t limit 1",
    "zip_with_unequal": "select g, zip_with(array_agg(v), array[1, 2], (a, b) -> "
                        "coalesce(a, 0) + coalesce(b, 100)) from t group by g order by g",
    "lambda_over_strings": "select reduce(transform(split('x,yy,zzz', ','), e -> length(e)), "
                           "0, (s, x) -> s + x, s -> s) from t limit 1",
    "map_filter": "select g, map_filter(histogram(s), (k, c) -> c > 1), "
                  "map_filter(map_agg(v, x), (k, e) -> k > 0) from t group by g order by g",
    "transform_values": "select g, transform_values(histogram(s), (k, c) -> c * 10), "
                        "transform_values(map_agg(s, v), (k, e) -> concat(k, '#')) "
                        "from t group by g order by g",
    "transform_keys": "select g, transform_keys(histogram(s), (k, c) -> upper(k)), "
                      "transform_keys(map_agg(v, s), (k, e) -> k * 2) from t group by g order by g",
    "map_zip_with": "select g, map_zip_with(histogram(s), map(array['ab', 'zz'], array[5, 7]), "
                    "(k, a, b) -> coalesce(a, 0) + coalesce(b, 0)) from t group by g order by g",
    "nested": "select g, transform(filter(array_agg(v), e -> e > 0), e -> reduce(array[e, g], "
              "0, (s, y) -> s + y, s -> s)) from t group by g order by g",
}


@pytest.mark.parametrize("name", list(SQL))
def test_equals_reference(name, sessions):
    port, ref = sessions
    got = port.query(SQL[name]).rows()
    assert got
    same_rows(got, ref.query(SQL[name]).rows())


def test_transform_uses_outer_column(sessions):
    port, _ref = sessions
    rows = port.query("select v, element_at(transform(array[100], x -> x + v), 1) e from t "
                      "order by v").rows()
    assert [e for _v, e in rows] == [v + 100 for v, _e in rows]


def _forms():
    """The 11 forms as IR in both packages over the page's column v and an
    array-valued column a (the same tree built twice)."""
    out = {}
    for mod, TT in ((rir, RT), (ir, T)):
        B = TT.BIGINT
        arr = mod.ColumnRef("a", TT.ArrayType(B))
        mp = mod.ColumnRef("m", TT.MapType(TT.VARCHAR, B))
        x = mod.ColumnRef("$x", B)
        y = mod.ColumnRef("$y", B)
        k = mod.ColumnRef("$k", TT.VARCHAR)
        v = mod.ColumnRef("v", B)

        def call(name, *args, typ):
            return mod.Call(name, tuple(args), typ)

        gt = lambda a, b: call("gt", a, b, typ=TT.BOOLEAN)  # noqa: E731
        add = lambda a, b: call("add", a, b, typ=B)  # noqa: E731
        lam1 = lambda body: mod.Lambda(("$x",), body, (B,))  # noqa: E731
        forms = {
            "transform": call("transform", arr, lam1(add(x, v)), typ=TT.ArrayType(B)),
            "filter": call("filter", arr, lam1(gt(x, v)), typ=TT.ArrayType(B)),
            "any_match": call("any_match", arr, lam1(gt(x, v)), typ=TT.BOOLEAN),
            "all_match": call("all_match", arr, lam1(gt(x, v)), typ=TT.BOOLEAN),
            "none_match": call("none_match", arr, lam1(gt(x, v)), typ=TT.BOOLEAN),
            "reduce": call("reduce", arr, mod.Literal(0, B),
                           mod.Lambda(("$x", "$y"), add(x, y), (B, B)),
                           mod.Lambda(("$x",), add(x, v), (B,)), typ=B),
            "zip_with": call("zip_with", arr, arr, mod.Lambda(("$x", "$y"), add(x, y), (B, B)),
                             typ=TT.ArrayType(B)),
            "map_filter": call("map_filter", mp, mod.Lambda(("$k", "$x"), gt(x, v),
                                                            (TT.VARCHAR, B)),
                               typ=TT.MapType(TT.VARCHAR, B)),
            "transform_values": call("transform_values", mp,
                                     mod.Lambda(("$k", "$x"), add(x, v), (TT.VARCHAR, B)),
                                     typ=TT.MapType(TT.VARCHAR, B)),
            "transform_keys": call("transform_keys", mp,
                                   mod.Lambda(("$k", "$x"), call("upper", k, typ=TT.VARCHAR),
                                              (TT.VARCHAR, B)),
                                   typ=TT.MapType(TT.VARCHAR, B)),
            "map_zip_with": call("map_zip_with", mp, mp,
                                 mod.Lambda(("$k", "$x", "$y"), add(x, y), (TT.VARCHAR, B, B)),
                                 typ=TT.MapType(TT.VARCHAR, B)),
        }
        out[mod] = forms
    return out[rir], out[ir]


def test_every_lambda_form_through_evaluate(sessions):
    """Each of the 11 forms evaluated by both packages' compiler on the same
    page (the reference page carried over by page_from_reference, collection
    blocks included)."""
    _port, ref = sessions
    page = ref.query("select g, max(v) v, array_agg(v) a, map_agg(s, v) m from t group by g").page
    tpage = page_from_reference(page, device="cpu")
    rforms, tforms = _forms()
    assert set(tforms) == compiler.LAMBDA_FORMS == rcompiler.LAMBDA_FORMS
    for name in sorted(tforms):
        want = rcompiler.project_page(page, [rforms[name]], ["c"]).to_pylist()
        got = compiler.project_page(tpage, [tforms[name]], ["c"]).to_pylist()
        same_rows(got, want)
