"""ARRAY and MAP values in presto_tpu_torch (device="cpu") against the JAX
package: the collection aggregates (array_agg, map_agg, histogram,
map_union, multimap_agg, numeric_histogram; grouped and global, and the
`$collect_need` width retry), the map functions, the array tail of the
function library, `page_from_reference` over collection blocks, DISTINCT
and UNION over collection columns, sketch states as rows, and the
`collections` texts of chip_smoke.py at TPC-H SF 0.01.

Each case runs the same SQL over the same seeded numpy table through both
packages' Session.query (and the array functions also through both
packages' `apply_function` on the same element tensors): integers,
strings and NULLs exact, doubles within presto_tpu/testing/oracle.py's
tolerance (chip_smoke.row_diff, which compares lists element by element
in order and maps key by key).

Where the JAX package is wrong (ROADMAP.md queue 3), the port is held to
Presto's documented result instead: NULL elements in array_sort,
array_distinct, array_max/min, array_remove and arrays_overlap; DISTINCT
and UNION over array columns, and sketch states as rows (the JAX package
cannot return them); the `collections` texts C2, C4, C6 and C7s (the
JAX package's UNNEST and joins drop the companions of collection columns,
and it cannot materialize sketch rows), held to numpy where chip_smoke
does (C6) and otherwise to their rows on the port alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from presto_tpu import types as RT
from presto_tpu.connectors.memory import MemoryCatalog as RMemoryCatalog
from presto_tpu.connectors.tpch import TpchCatalog as RTpchCatalog
from presto_tpu.expr import functions as RF
from presto_tpu.page import Block as RBlock
from presto_tpu.page import Page as RPage
from presto_tpu.page import intern_dictionary as r_intern
from presto_tpu.session import Session as RSession
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.memory import MemoryCatalog
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.expr import functions as F
from presto_tpu_torch.page import Block, Page, page_from_reference
from presto_tpu_torch.page import intern_dictionary as t_intern
from presto_tpu_torch.session import Session

# one torch thread: the suite runs in parallel worker processes
# (pytest-xdist), and a thread per core in each oversubscribes the host
torch.set_num_threads(1)

WORDS = ("ab", "cd", "ef", "gh", "a,b", "x y z", "m=1,n=2")


def table_columns(n=96, seed=9):
    """A seeded table: small group key g, bigint v (with a NULL-free twin
    w), double x, varchar s, varchar k with NULLs."""
    rng = np.random.default_rng(seed)
    s = [WORDS[i] for i in rng.integers(0, len(WORDS), n)]
    k = [None if rng.random() < 0.15 else WORDS[i] for i in rng.integers(0, 4, n)]
    return {
        "g": rng.integers(0, 6, n).astype(np.int64),
        "v": rng.integers(-30, 60, n).astype(np.int64),
        "x": np.round(rng.normal(0, 4, n), 3),
        "s": s,
        "k": k,
    }


def sessions_over(columns, name="t"):
    """(port session, reference session) over one memory table built from
    the same numpy columns."""
    port = Session(MemoryCatalog({name: Page.from_dict(columns, device="cpu")}), device="cpu",
                   result_cache=False)
    ref = RSession(RMemoryCatalog({name: RPage.from_dict(columns)}), plan_cache=False,
                   result_cache=False)
    return port, ref


def same_rows(got, want, ordered=True):
    diff = chip_smoke.row_diff(got, want, ordered)
    assert diff is None, diff


@pytest.fixture(scope="module")
def sessions():
    return sessions_over(table_columns())


SQL = {
    # the collection aggregates, grouped and global
    "array_agg": "select g, array_agg(v), array_agg(s), array_agg(k) from t group by g order by g",
    "array_agg_global": "select array_agg(x), array_agg(k) from t",
    "histogram": "select g, histogram(s), histogram(v % 5) from t group by g order by g",
    "histogram_global": "select histogram(s) from t",
    "map_agg": "select g, map_agg(s, v), map_agg(v % 7, x) from t group by g order by g",
    "map_agg_global": "select map_agg(s, x) from t",
    "multimap_agg": "select g, multimap_agg(s, v) from t group by g order by g",
    "multimap_agg_global": "select multimap_agg(v % 3, s) from t",
    "map_union": "select g, map_union(m) from (select g, s, map_agg(s, v) m from t "
                 "group by g, s) q group by g order by g",
    "numeric_histogram": "select g, numeric_histogram(4, x), numeric_histogram(3, v) from t "
                         "group by g order by g",
    "numeric_histogram_global": "select numeric_histogram(5, x) from t",
    "mixed_with_scalars": "select g, count(*), sum(v), array_agg(v), max(x) from t "
                          "where v > 0 group by g order by g",
    # the maps read back
    "map_functions": "select g, map_keys(histogram(s)), map_values(histogram(s)), "
                     "element_at(histogram(s), 'ab'), cardinality(histogram(s)), "
                     "element_at(map_agg(v, s), 5) from t group by g order by g",
    "map_constructor": "select v, map(array[s, 'zz'], array[v, g]), "
                       "element_at(map(array['p', 'q'], array[x, v]), 'q') from t "
                       "order by v, s, x",
    "map_concat": "select g, map_concat(histogram(s), map(array['ab', 'new'], array[100, 7])) "
                  "from t group by g order by g",
    "split_to_map": "select s, split_to_map(s, ',', '=') from t order by s, v",
    "cosine_similarity": "select g, cosine_similarity(map_agg(s, x), map(array['ab', 'cd'], "
                         "array[1.5, -2.0])) from t group by g order by g",
    # the array tail over arrays without NULL elements
    "array_tail": "select g, array_sort(array_agg(v)), array_distinct(array_agg(v)), "
                  "array_max(array_agg(v)), array_min(array_agg(x)), "
                  "slice(array_agg(v), 2, 3), slice(array_agg(v), -2, 5), "
                  "reverse(array_agg(s)), array_position(array_agg(v), 7), "
                  "contains(array_agg(s), 'ef') from t group by g order by g",
    "array_sets": "select g, array_intersect(array_agg(v), sequence(0, 20)), "
                  "array_except(array_agg(v), sequence(-10, 10)), "
                  "array_union(array_agg(v % 4), array[1, 9]), "
                  "arrays_overlap(array_agg(v), array[3, 4, 5]), "
                  "array_remove(array_agg(v % 3), 0) from t group by g order by g",
    "array_concat": "select g, array_agg(v) || array[1, 2], concat(array[s], array['q']) "
                    "from t group by g, s order by g, s",
    "strings_to_arrays": "select s, split(s, ','), split(s, ' ', 2), regexp_split(s, '[ ,=]'), "
                         "regexp_extract_all(s, '[a-z]+'), cardinality(split(s, ',')) "
                         "from t order by s, v",
    "cosine_distance": "select v, cosine_distance(array[x, v], array[1.0, 2.0]) from t "
                       "order by v, x",
    "subscript": "select v, split(s, ',')[1], array[v, g, 3][2], element_at(array[x], -1) "
                 "from t order by v, s",
    "sequence": "select sequence(1, 5), sequence(10, 2, -4), sequence(5, 1), "
                "sequence(-2, 2, 2) from t limit 1",
    "repeat": "select repeat(s, 2), repeat(v, 3) from t order by s, v limit 5",
}


@pytest.mark.parametrize("name", list(SQL))
def test_equals_reference(name, sessions):
    port, ref = sessions
    got = port.query(SQL[name]).rows()
    same_rows(got, ref.query(SQL[name]).rows())
    assert got


def test_array_agg_width_overflow_adapts():
    """Groups wider than the first 128-element width take the retry (the
    `$collect_need` column), grouped and global, with the rows' order."""
    n = 3000
    cols = {"g": (np.arange(n) % 3).astype(np.int64), "v": np.arange(n, dtype=np.int64)}
    port, ref = sessions_over(cols, "big")
    sql = "select g, cardinality(array_agg(v)), array_agg(v) from big group by g order by g"
    got = port.query(sql).rows()
    assert [r[:2] for r in got] == [(0, 1000), (1, 1000), (2, 1000)]
    assert got[0][2] == list(range(0, n, 3))
    same_rows(got, ref.query(sql).rows())
    assert port.executor.width_retries[-1] == (128, 1024)
    got = port.query("select cardinality(array_agg(v)), histogram(g) from big").rows()
    assert got == [(3000, {0: 1000, 1: 1000, 2: 1000})]
    assert port.executor.width_retries[-1] == (128, 4096)
    assert not any(n.startswith("$") for n in port.query(sql).page.names)


def test_page_from_reference_carries_collection_blocks(sessions):
    """Reference result pages with array, map and array-valued map blocks
    (lengths, element masks, key blocks, element dictionaries) carry over
    and decode to the same rows."""
    _port, ref = sessions
    for sql in ("select g, array_agg(k), histogram(s), map_agg(v, k) from t group by g",
                "select g, multimap_agg(s, x), numeric_histogram(3, x) from t group by g",
                "select learn_linear_regression(x, array[v, g]) from t"):
        res = ref.query(sql)
        page = page_from_reference(res.page, device="cpu")
        same_rows(page.to_pylist(), res.rows())
        assert page.blocks[-1].lengths is not None


def test_distinct_and_union_over_collections(sessions):
    """Presto's DISTINCT and UNION over array and map columns (the JAX
    package cannot return array rows from them): equal values are one row,
    padding and element NULLs compare as values do."""
    port, _ref = sessions
    got = port.query("select distinct a from (select array[g % 2, 1] a from t) q").rows()
    assert sorted(got) == [([0, 1],), ([1, 1],)]
    got = port.query("select distinct a, b from (select array[g % 2] a, "
                     "map(array['k'], array[g % 2]) b from t union all select array[0, 0], "
                     "map(array['k'], array[0]) from t) q").rows()
    assert sorted(got, key=str) == [([0, 0], {"k": 0}), ([0], {"k": 0}), ([1], {"k": 1})]
    got = port.query("select a from (select array[g] a from t where g = 1) q union "
                     "select a from (select array[g, null] a from t where g = 2) r").rows()
    assert sorted(got, key=str) == [([1],), ([2, None],)]
    got = port.query("select a from (select array[s] a from t where s = 'ab') q union all "
                     "select a from (select split('p,q,r', ',') a from t limit 2) r").rows()
    assert sorted(got, key=str)[-2:] == [(["p", "q", "r"],), (["p", "q", "r"],)]
    assert {tuple(r[0]) for r in got} == {("ab",), ("p", "q", "r")}


def test_sketch_states_come_back_as_rows(sessions):
    """approx_set (HLL registers), qdigest_agg (sketch bins) and merge are
    lists of every lane; the JAX package's page holds the same lanes (its
    rows() cannot decode them)."""
    port, ref = sessions
    sql = "select approx_set(v), qdigest_agg(x) from t"
    got = port.query(sql).rows()
    rpage = ref.query(sql).page
    assert got == [(np.asarray(rpage.blocks[0].data[0]).tolist(),
                     np.asarray(rpage.blocks[1].data[0]).tolist())]
    sql = ("select g, cardinality(merge(h)) from (select g, approx_set(v) h from t group by g) "
           "q group by g order by g")
    same_rows(port.query(sql).rows(), ref.query(sql).rows())
    sql = ("select value_at_quantile(qdigest_agg(x), 0.5), quantile_at_value(qdigest_agg(v), 10), "
           "cardinality(approx_set(s)) from t")
    same_rows(port.query(sql).rows(), ref.query(sql).rows())


def test_presto_null_element_semantics(sessions):
    """Where NULL elements are involved the port follows Presto's documented
    results (the JAX package drops or ignores them, ROADMAP queue 3)."""
    port, _ref = sessions
    row = port.query(
        "select array_sort(array[3, null, 1, 2]), array_distinct(array[1, 1, null, 2, null]), "
        "array_max(array[1, null]), array_min(array[4, 2]), "
        "array_remove(array[1, null, 2, 1], 1), arrays_overlap(array[1, null], array[3]), "
        "arrays_overlap(array[1, null], array[1]), array_union(array[1, null], array[null, 2]), "
        "array_intersect(array[1, null], array[null]), array_except(array[1, null], array[1]) "
        "from t limit 1").rows()[0]
    assert row == ([1, 2, 3, None], [1, 2, None], None, 2, [None, 2], None, True,
                   [1, 2, None], [None], [None])
    row = port.query("select contains(array[1, null], 2), contains(array[1, null], 1), "
                     "array_position(array[5, 6, 7], 7), array_position(array[5, 6], 9) "
                     "from t limit 1").rows()[0]
    assert row == (None, True, 3, 0)


# -- the function layer: both packages' apply_function on the same elements --

_rng = np.random.default_rng(31)
N, W = 40, 6


def _array_case(dtype="bigint", nulls=False, dictionary=None, null_rows=True):
    lens = _rng.integers(0, W + 1, N).astype(np.int32)
    if dictionary is not None:
        data = _rng.integers(0, len(dictionary), (N, W)).astype(np.int32)
    elif dtype == "double":
        data = np.round(_rng.normal(0, 5, (N, W)), 2)
    else:
        data = _rng.integers(-4, 8, (N, W)).astype(np.int64)
    ev = (_rng.random((N, W)) > 0.2) if nulls else None
    valid = (_rng.random(N) > 0.1) if null_rows else np.ones(N, bool)
    return "array", (data, lens, ev, valid, dtype, dictionary)


def _vals(case):
    """The same array value as a reference Val and a port Val."""
    data, lens, ev, valid, dtype, dictionary = case[1]
    rt = RT.ArrayType(RT.parse_type(dtype))
    tt = T.ArrayType(T.parse_type(dtype))
    rd = None if dictionary is None else r_intern(dictionary)
    td = None if dictionary is None else t_intern(dictionary)
    rv = RF.Val(jnp.asarray(data), jnp.asarray(valid), rt, rd, lengths=jnp.asarray(lens),
                elem_valid=None if ev is None else jnp.asarray(ev))
    tv = F.Val(torch.from_numpy(data.copy()), torch.from_numpy(valid.copy()), tt, td,
               lengths=torch.from_numpy(lens.copy()),
               elem_valid=None if ev is None else torch.from_numpy(ev.copy()))
    return rv, tv


def _scalar_vals(values, dtype="bigint"):
    arr = np.asarray(values)
    rt, tt = RT.parse_type(dtype), T.parse_type(dtype)
    return (RF.Val(jnp.asarray(arr), None, rt, literal=None),
            F.Val(torch.from_numpy(arr.copy()), None, tt))


def _literal_vals(value, dtype):
    if dtype == "varchar":
        return (RF.Val(jnp.zeros(N, jnp.int32), None, RT.VARCHAR, r_intern((value,)),
                       literal=value),
                F.Val(torch.zeros(N, dtype=torch.int32), None, T.VARCHAR, t_intern((value,)),
                      literal=value))
    rt, tt = RT.parse_type(dtype), T.parse_type(dtype)
    return (RF.Val(jnp.full(N, value), None, rt, literal=value),
            F.Val(torch.full((N,), value), None, tt, literal=value))


def _decode_ref(v):
    kb = None
    if v.keys is not None:
        kb = RBlock(v.keys.data, v.type.key, None, v.keys.dict_id, lengths=v.keys.lengths,
                    elem_valid=v.keys.elem_valid)
    blk = RBlock(v.data, v.type, v.valid, v.dict_id, lengths=v.lengths,
                 elem_valid=v.elem_valid, key_block=kb)
    return RPage((blk,), ("c",), jnp.asarray(v.data.shape[0], jnp.int32)).to_pylist()


def _decode_port(v):
    kb = None
    if v.keys is not None:
        kb = Block(v.keys.data, v.type.key, None, v.keys.dict_id, lengths=v.keys.lengths,
                   elem_valid=v.keys.elem_valid)
    blk = Block(v.data, v.type, v.valid, v.dict_id, lengths=v.lengths,
                elem_valid=v.elem_valid, key_block=kb)
    return Page((blk,), ("c",), torch.tensor(v.data.shape[0], dtype=torch.int32)).to_pylist()


DICT = ("apple", "kiwi", "lime", "pear", "plum")
FUNCTION_CASES = {
    # name: (function, arguments as builders, output type)
    "cardinality": ("cardinality", [_array_case(nulls=True)], "bigint"),
    "element_at": ("element_at", [_array_case(nulls=True), ("scalar", [2] * N)], "bigint"),
    "element_at_neg": ("element_at", [_array_case(nulls=True), ("scalar", [-1] * N)], "bigint"),
    "contains": ("contains", [_array_case(), ("scalar", list(range(-2, N - 2)))], "boolean"),
    "contains_varchar": ("contains", [_array_case(dictionary=DICT), ("lit", "lime", "varchar")],
                         "boolean"),
    "array_position": ("array_position", [_array_case(nulls=True), ("lit", 3, "bigint")],
                       "bigint"),
    "reverse": ("reverse", [_array_case(nulls=True)], "array(bigint)"),
    "slice": ("slice", [_array_case(nulls=True), ("lit", 2, "bigint"), ("lit", 3, "bigint")],
              "array(bigint)"),
    "array_sort": ("array_sort", [_array_case("double")], "array(double)"),
    "array_sort_varchar": ("array_sort", [_array_case(dictionary=DICT)], "array(varchar)"),
    "array_distinct": ("array_distinct", [_array_case()], "array(bigint)"),
    "array_max": ("array_max", [_array_case("double")], "double"),
    "array_min": ("array_min", [_array_case()], "bigint"),
    # a NULL second array gives NULL in Presto; the JAX package ignores it
    # (ROADMAP queue 3), so the second arrays here are never NULL
    "array_intersect": ("array_intersect", [_array_case(), _array_case(null_rows=False)],
                        "array(bigint)"),
    "array_except": ("array_except", [_array_case(), _array_case(null_rows=False)],
                     "array(bigint)"),
    "array_union": ("array_union", [_array_case(), _array_case()], "array(bigint)"),
    "arrays_overlap": ("arrays_overlap", [_array_case(), _array_case()], "boolean"),
    "array_concat": ("array_concat", [_array_case(nulls=True), _array_case(nulls=True)],
                     "array(bigint)"),
    "cosine_distance": ("cosine_distance", [_array_case("double"), _array_case("double")],
                        "double"),
}


@pytest.mark.parametrize("name", list(FUNCTION_CASES))
def test_function_layer_equals_reference(name):
    fn, args, out = FUNCTION_CASES[name]
    rvals, tvals = [], []
    for a in args:
        if a[0] == "scalar":
            rv, tv = _scalar_vals(a[1])
        elif a[0] == "lit":
            rv, tv = _literal_vals(a[1], a[2])
        else:
            rv, tv = _vals(a)
        rvals.append(rv)
        tvals.append(tv)
    want = _decode_ref(RF.apply_function(fn, rvals, RT.parse_type(out)))
    got = _decode_port(F.apply_function(fn, tvals, T.parse_type(out)))
    same_rows(got, want)


def test_no_name_left_not_ported():
    from presto_tpu.expr.compiler import LAMBDA_FORMS as R_LAMBDA
    from presto_tpu.sql.planner import AGG_FUNCS
    from presto_tpu_torch.expr.compiler import LAMBDA_FORMS
    from presto_tpu_torch.ops.aggregate import COLLECTION_AGGS, PORTED

    assert F.NOT_PORTED == ()
    assert set(R_LAMBDA) == set(LAMBDA_FORMS)
    from presto_tpu.ops.aggregate import COLLECTION_AGGS as R_COLLECTION

    assert set(R_COLLECTION) == set(COLLECTION_AGGS) <= set(PORTED)
    assert {"linreg", "linreg_acc", "linreg_merge"} <= set(PORTED)
    assert len(AGG_FUNCS) == 22


# -- the chip_smoke `collections` texts at TPC-H SF 0.01 ----------------------


@pytest.fixture(scope="module")
def tpch():
    port = Session(TpchCatalog(0.01, device="cpu"), device="cpu", result_cache=False)
    ref = RSession(RTpchCatalog(0.01), plan_cache=False, result_cache=False)
    ref.executor.dynamic_filtering = False
    tables = {n: port.catalog.host_table(n) for n in chip_smoke.TPCH_TABLES}
    return port, ref, tables


# texts the JAX package also answers (its joins drop a map's keys, so C2
# fails there; C7b's 64-step bisection takes it ~10 s here, and
# test_torch_cdf.py holds the CDFs against scipy instead)
REF_TEXTS = ("C1", "C3", "C5", "C5r", "C7", "C7m")


@pytest.mark.parametrize("label", list(chip_smoke.COLLECTION_SQL))
def test_collection_texts(label, tpch):
    port, ref, tables = tpch
    got = port.query(chip_smoke.COLLECTION_SQL[label]).rows()
    assert got
    checks = chip_smoke.collection_checks(tables)
    if label in checks:
        assert checks[label](got) is None, checks[label](got)
    if label in REF_TEXTS:
        same_rows(got, ref.query(chip_smoke.COLLECTION_SQL[label]).rows())
