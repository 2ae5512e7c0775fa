"""NOT IN (subquery) with SQL's three-valued logic in presto_tpu_torch,
through the materializing and the streaming session, held to a
three-valued evaluation written here in Python (the JAX package keeps the
NULL rows, ROADMAP queue 3, so it cannot be the reference):

    v NOT IN (S) is TRUE when S is empty; else NULL when v is NULL; else
    FALSE when v is in S; else NULL when S holds a NULL; else TRUE.

A row is kept only where it is TRUE. NOT EXISTS is two-valued and keeps
its NULL rows. The mark form of IN and EXISTS (`_subquery_mark`, planned
under OR) serves positive IN and EXISTS only, and NOT IN under OR is
refused at planning (sql/planner.py); both are left as they are."""

import numpy as np
import pytest
import torch

from presto_tpu_torch.connectors.memory import MemoryCatalog
from presto_tpu_torch.exec import spillspace
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.session import Session

torch.set_num_threads(1)


def not_in(v, values):
    """Python's three-valued `v NOT IN (values)`: True, False or None."""
    if not values:
        return True
    if v is None:
        return None
    if v in values:
        return False
    if any(x is None for x in values):
        return None
    return True


def sessions(tables):
    """A materializing and a streaming session (small batches, a budget
    that offloads the larger probe) over the same memory tables
    {name: [values]} of one bigint column each: t(a), the others (u)."""
    s = Session(MemoryCatalog({}, device="cpu"), device="cpu", result_cache=False)
    for name, values in tables.items():
        col = "a" if name == "t" else "u"
        s.query(f"create table {name} ({col} bigint)")
        if values:
            rows = ", ".join(f"({'null' if v is None else int(v)})" for v in values)
            s.query(f"insert into {name} values {rows}")
    streaming = Session(s.catalog, device="cpu", result_cache=False, streaming=True,
                        batch_rows=64, memory_budget=16 << 10)
    return s, streaming


T_A = [1, 2, None, 5]
SUBQUERIES = {
    "plain": [1, 3],
    "with_null": [1, None],
    "empty": [],
    "only_null": [None],
    "no_match": [7, 8],
}


@pytest.fixture(scope="module")
def small():
    return sessions({"t": T_A, **{f"u_{k}": v for k, v in SUBQUERIES.items()}})


@pytest.mark.parametrize("engine", ["materializing", "streaming"])
@pytest.mark.parametrize("sub", sorted(SUBQUERIES))
def test_not_in_is_three_valued(small, engine, sub):
    sess = small[0] if engine == "materializing" else small[1]
    got = sess.query(f"select a from t where a not in (select u from u_{sub})").rows()
    want = [(v,) for v in T_A if not_in(v, SUBQUERIES[sub]) is True]
    assert sorted(got, key=repr) == sorted(want, key=repr)
    assert spillspace.all_active_bytes() == 0


def test_issue_cases(small):
    """The cases as reported: [2, 5], no rows, all four rows."""
    for sess in small:
        q = "select a from t where a not in (select u from {}) order by a nulls last"
        assert sess.query(q.format("u_plain")).rows() == [(2,), (5,)]
        assert sess.query(q.format("u_with_null")).rows() == []
        assert sess.query(q.format("u_empty")).rows() == [(1,), (2,), (5,), (None,)]
        # the literal list was already right, and stays so
        assert sess.query("select a from t where a not in (1, 3) order by a").rows() == [
            (2,), (5,)]
        assert sess.query("select a from t where a not in (1, null)").rows() == []


@pytest.mark.parametrize("engine", ["materializing", "streaming"])
def test_not_exists_keeps_null_rows(small, engine):
    sess = small[0] if engine == "materializing" else small[1]
    got = sess.query("select a from t where not exists "
                     "(select 1 from u_plain where u = a)").rows()
    assert sorted(got, key=repr) == sorted([(2,), (5,), (None,)], key=repr)


@pytest.mark.parametrize("with_null", [False, True])
def test_not_in_many_batches(with_null):
    """2,000 probe rows with 10% NULLs over 32-row batches of the
    streaming session, against the Python evaluation."""
    rng = np.random.default_rng(12 + with_null)
    probe = [None if rng.random() < 0.1 else int(x) for x in rng.integers(0, 300, 2_000)]
    sub = [int(x) for x in rng.integers(0, 300, 120)] + ([None] if with_null else [])
    mat, stream = sessions({"t": probe, "u": sub})
    stream = Session(mat.catalog, device="cpu", result_cache=False, streaming=True,
                     batch_rows=32, memory_budget=64 << 10)
    want = sorted(((v,) for v in probe if not_in(v, sub) is True), key=repr)
    for sess in (mat, stream):
        got = sess.query("select a from t where a not in (select u from u)").rows()
        assert sorted(got, key=repr) == want
    assert (len(want) == 0) == with_null
    node = mat.plan("select a from t where a not in (select u from u)")
    while not isinstance(node, N.SemiJoin):
        node = node.children[0]
    assert node.anti and node.null_aware
    node = mat.plan("select a from t where not exists (select 1 from u where u = a)")
    while not isinstance(node, N.SemiJoin):
        node = node.children[0]
    assert node.anti and not node.null_aware
