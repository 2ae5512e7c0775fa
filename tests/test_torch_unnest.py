"""UNNEST in presto_tpu_torch (device="cpu") against the JAX package:
literal arrays, split columns, several arrays zipped (the shorter ones
NULL-padded), WITH ORDINALITY, NULL arrays giving no rows, NULL elements,
sequence(), and aggregates over the unnested rows, through both packages'
Session.query over the same seeded table, and ops/unnest.py's
`unnest_page` against presto_tpu/ops/unnest.py's on the same page. The
cases are those of tests/test_arrays_unnest.py, less the distributed and
streaming ones (the port has neither executor); the port's table is built
from pages since its memory connector has no CREATE TABLE / INSERT.
"""

import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.expr import ir as rir
from presto_tpu.ops.unnest import unnest_page as r_unnest_page
from presto_tpu_torch import types as T
from presto_tpu_torch.expr import ir
from presto_tpu_torch.ops.unnest import unnest_page
from presto_tpu_torch.page import page_from_reference
from test_torch_collections import same_rows, sessions_over

# one torch thread: the suite runs in parallel worker processes
# (pytest-xdist), and a thread per core in each oversubscribes the host
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sessions():
    """t(id, csv): 'a,b', 'c', '', NULL and seeded comma lists."""
    rng = np.random.default_rng(4)
    csv = ["a,b", "c", "", None] + [",".join(rng.choice(list("pqrs"), rng.integers(1, 5)))
                                    for _ in range(28)]
    return sessions_over({"id": np.arange(1, len(csv) + 1, dtype=np.int64), "csv": csv})


SQL = {
    "literal": "select x from unnest(array[10, 20, 30]) u(x) order by 1",
    "ordinality": "select x, o from unnest(array[5, 6]) with ordinality u(x, o) order by o desc",
    "cross_join_split": "select id, part from t cross join unnest(split(csv, ',')) u(part) "
                        "order by 1, 2",
    "cross_join_ordinality": "select id, part, o from t cross join unnest(split(csv, ',')) "
                             "with ordinality u(part, o) order by 1, 3",
    "zip_two": "select a, b from unnest(array[1, 2, 3], array[10, 20]) u(a, b) order by 1",
    "zip_columns": "select id, a, b from t cross join unnest(split(csv, ','), "
                   "sequence(1, 3)) u(a, b) order by id, b, a",
    "cardinality_element_at": "select id, cardinality(split(csv, ',')), "
                              "element_at(split(csv, ','), 1), contains(split(csv, ','), 'b'), "
                              "array_position(split(csv, ','), 'b') from t order by id",
    "subscript_position": "select array[1, 2, 3][2], array_position(array[5, 6, 7], 7), "
                          "array_position(array[5, 6, 7], 9), element_at(array[7, 8], -1), "
                          "element_at(array[7, 8], 9) from t limit 1",
    "sequence_filter": "select n from unnest(sequence(1, 5)) u(n) where n % 2 = 1 order by 1",
    "sequence_step": "select n from unnest(sequence(10, 2, -4)) u(n) order by 1",
    "sequence_descending": "select n from unnest(sequence(5, 1)) u(n) order by 1",
    "null_elements": "select x from unnest(array[1, null, 3]) u(x) order by 1",
    "aggregate_over_unnest": "select part, count(*) c from t cross join "
                             "unnest(split(csv, ',')) u(part) group by part order by part",
    "varchar_literals": "select x from unnest(array['a', 'b']) u(x) order by 1",
    "three_valued_contains": "select contains(array[1, null], 2), contains(array[1, null], 1) "
                             "from t limit 1",
    "array_rows": "select id, split(csv, ',') from t order by id",
    "unnest_of_aggregate": "select k, count(*) from (select id % 3 g, array_agg(id) a from t "
                           "group by id % 3) q cross join unnest(a) u(k) group by k order by k",
}


@pytest.mark.parametrize("name", list(SQL))
def test_equals_reference(name, sessions):
    port, ref = sessions
    got = port.query(SQL[name]).rows()
    assert got
    same_rows(got, ref.query(SQL[name]).rows())


def test_semantics(sessions):
    port, _ref = sessions
    assert port.query(SQL["cross_join_split"]).rows()[:4] == [(1, "a"), (1, "b"), (2, "c"),
                                                              (3, "")]
    assert port.query(SQL["zip_two"]).rows() == [(1, 10), (2, 20), (3, None)]
    assert port.query(SQL["null_elements"]).rows() == [(1,), (3,), (None,)]
    with pytest.raises(Exception, match="sequence step"):
        port.query("select n from unnest(sequence(1, 5, -1)) u(n)")


def test_replicated_collection_columns_keep_their_elements(sessions):
    """An array column replicated by the unnest keeps its elements (the JAX
    package's UNNEST drops their lengths, ROADMAP queue 3)."""
    port, _ref = sessions
    got = port.query("select id, p, cardinality(parts), element_at(parts, -1) from "
                     "(select id, split(csv, ',') parts from t where id < 3) q "
                     "cross join unnest(parts) u(p) order by id, p").rows()
    assert got == [(1, "a", 2, "b"), (1, "b", 2, "b"), (2, "c", 1, "c")]


def test_unnest_page_equals_reference(sessions):
    """ops/unnest.py on the same page as presto_tpu's, zipping two arrays
    with ordinality (the replicated columns plain, as the reference keeps
    them)."""
    _port, ref = sessions
    page = ref.query("select id, split(csv, ',') a, sequence(1, 2) b from t").page
    tpage = page_from_reference(page, device="cpu")
    exprs = {}
    for mod, TT in ((rir, RT), (ir, T)):
        exprs[mod] = (mod.ColumnRef("a", TT.ArrayType(TT.VARCHAR)),
                      mod.ColumnRef("b", TT.ArrayType(TT.BIGINT)))
    want = r_unnest_page(page, exprs[rir], ("ea", "eb"), "o").select(["id", "ea", "eb", "o"])
    got = unnest_page(tpage, exprs[ir], ("ea", "eb"), "o").select(["id", "ea", "eb", "o"])
    same_rows(got.to_pylist(), want.to_pylist())
    kept = unnest_page(tpage, exprs[ir], ("ea", "eb"), None, replicate=("id",))
    assert kept.names == ("id", "ea", "eb")
