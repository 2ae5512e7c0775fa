"""The statement layer of presto_tpu_torch.Session (device="cpu") against
presto_tpu.Session: DDL and DML on the memory connector, VALUES, views,
schemas, PREPARE/EXECUTE/DESCRIBE, SET/RESET/SHOW SESSION, ALTER TABLE,
GRANT/REVOKE, SHOW, ANALYZE, TABLESAMPLE and EXPLAIN (TYPE ...). Every
statement runs through both packages over the same numpy-made tables and
must give the same rows (doubles within presto_tpu/testing/oracle.py's
tolerance) or fail the same way; the expected values of the JAX package's
own statement tests are asserted as well. Where the JAX package departs
from Presto (ROADMAP queue 3) the port is held to Presto's value."""

import re

import numpy as np
import pytest
import torch

import chip_smoke
from presto_tpu.connectors.memory import MemoryCatalog as RMemoryCatalog
from presto_tpu.connectors.tpch import TpchCatalog as RTpchCatalog
from presto_tpu.page import Page as RPage
from presto_tpu import security as rsecurity
from presto_tpu.session import Session as RSession
from presto_tpu_torch import security
from presto_tpu_torch.connectors.memory import MemoryCatalog
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.expr.functions import NotPortedError
from presto_tpu_torch.page import Page
from presto_tpu_torch.session import Session

# one torch thread: the suite runs in parallel worker processes
# (pytest-xdist), and a thread per core in each oversubscribes the host
torch.set_num_threads(1)


class Pair:
    """One port session (device="cpu") and one presto_tpu session over the
    same tables: {name: {column: numpy array | list of str}}. `rules`
    installs each package's RuleBasedAccessControl over the same rules."""

    def __init__(self, tables=None, rules=None, user="user", port_catalog=None,
                 ref_catalog=None, **kw):
        tables = tables or {}
        if port_catalog is None:
            port_catalog = MemoryCatalog(
                {n: Page.from_dict(c, device="cpu") for n, c in tables.items()}, device="cpu")
            ref_catalog = RMemoryCatalog({n: RPage.from_dict(c) for n, c in tables.items()})
        pac = rac = None
        if rules is not None:
            pac = security.RuleBasedAccessControl(rules)
            rac = rsecurity.RuleBasedAccessControl(rules)
        self.port = Session(port_catalog, device="cpu", access_control=pac, user=user, **kw)
        self.ref = RSession(ref_catalog, access_control=rac, user=user, **kw)

    def q(self, sql, user=None, ordered=True):
        """The port's rows, asserted equal to the JAX package's."""
        got = self.port.query(sql, user=user).rows()
        want = self.ref.query(sql, user=user).rows()
        diff = chip_smoke.row_diff(got, want, ordered)
        assert diff is None, (sql, diff)
        return got

    def fails(self, sql, name="ValueError", match=None, user=None):
        """Both packages raise an exception of class `name` (the same
        class in each package's own module), matching `match`."""
        for sess in (self.port, self.ref):
            with pytest.raises(Exception) as err:
                sess.query(sql, user=user)
            assert name in [c.__name__ for c in type(err.value).__mro__], (sql, err.value)
            if match is not None:
                assert re.search(match, str(err.value)), (sql, err.value)


def one_table():
    return {"t": {"g": np.array([1, 1, 2], dtype=np.int64),
                  "v": np.array([10, 20, 30], dtype=np.int64)}}


def two_tables():
    return {"t": {"v": np.array([1, 2], dtype=np.int64)},
            "secret": {"s": np.array([42], dtype=np.int64)}}


DENY_BOB_SECRET = [{"privileges": "none", "user": "bob", "table": "secret"},
                   {"privileges": "all"}]


@pytest.fixture()
def empty():
    return Pair()


@pytest.fixture()
def pair():
    return Pair(one_table())


# -- DDL / DML (the JAX package's tests/test_ddl.py) -------------------------


def test_create_insert_select(empty):
    assert empty.q("create table t (a bigint, b varchar)") == [(0,)]
    assert empty.q("insert into t values (1, 'x'), (2, 'y')") == [(2,)]
    assert empty.q("select a, b from t order by a") == [(1, "x"), (2, "y")]


def test_insert_append_and_nulls(empty):
    empty.q("create table t (a bigint, b double, c varchar)")
    empty.q("insert into t values (1, 1.5, 'x')")
    empty.q("insert into t (a) values (7)")
    assert empty.q("select a, b, c from t order by a") == [(1, 1.5, "x"), (7, None, None)]


def test_insert_select_from_table(empty):
    empty.q("create table src (a bigint)")
    empty.q("insert into src values (1), (2), (3)")
    empty.q("create table dst (a bigint)")
    assert empty.q("insert into dst select a * 10 from src where a < 3") == [(2,)]
    assert empty.q("select a from dst order by a") == [(10,), (20,)]


def test_ctas(empty):
    empty.q("create table t (a bigint)")
    empty.q("insert into t values (1), (2), (3)")
    assert empty.q("create table t2 as select a, a * a as sq from t where a > 1") == [(2,)]
    assert empty.q("select sq from t2 order by sq") == [(4,), (9,)]


def test_delete(empty):
    empty.q("create table t (a bigint, b varchar)")
    empty.q("insert into t values (1, 'x'), (2, null), (3, 'z')")
    # delete where predicate is NULL must NOT delete the row
    assert empty.q("delete from t where b = 'x'") == [(1,)]
    assert empty.q("select a from t order by a") == [(2,), (3,)]
    assert empty.q("delete from t") == [(2,)]
    assert empty.q("select count(*) from t") == [(0,)]


def test_drop_and_if_exists(empty):
    empty.q("create table t (a bigint)")
    empty.q("drop table t")
    assert "t" not in empty.port.catalog.table_names()
    assert empty.q("drop table if exists t") == [(0,)]
    empty.fails("drop table t")
    empty.q("create table if not exists t (a bigint)")
    assert empty.q("create table if not exists t (a bigint)") == [(0,)]
    empty.fails("create table t (a bigint)")


@pytest.mark.parametrize("sql,want", [
    ("values (1, 'a'), (2, 'b')", [(1, "a"), (2, "b")]),
    ("select x + 1 from (values (1), (2), (3)) as v(x) order by 1 desc", [(4,), (3,), (2,)]),
    ("values (1, null), (2.5, 'b')", [(1.0, None), (2.5, "b")]),
])
def test_values_queries(empty, sql, want):
    assert empty.q(sql) == want


def test_values_union_select(empty):
    empty.q("create table t (a bigint)")
    empty.q("insert into t values (5)")
    got = empty.q("select a from t union all select * from (values (9)) w(a) order by 1")
    assert got == [(5,), (9,)]


def test_show_tables_and_columns(empty):
    empty.q("create table zebra (a bigint, b varchar)")
    assert ("zebra",) in empty.q("show tables")
    cols = empty.q("show columns from zebra")
    assert ("a", "bigint") in cols and ("b", "varchar") in cols


def test_insert_type_coercion(empty):
    empty.q("create table t (a double, d decimal(12,2))")
    empty.q("insert into t values (1, 2.5)")
    assert empty.q("select a, d from t") == [(1.0, pytest.approx(2.5))]


def test_delete_survives_empty_result(empty):
    empty.q("create table t (a bigint)")
    assert empty.q("delete from t where a = 1") == [(0,)]
    empty.q("insert into t values (1)")
    assert empty.q("select a from t") == [(1,)]


@pytest.mark.parametrize("where,same,left", [
    ("a in (select b from u)", "a in (1, 2, 0, 9)", [(None,), (3,), (4,)]),
    ("exists (select 1 from u where u.b = t.a)", "a in (1, 2, 0, 9)", [(None,), (3,), (4,)]),
    ("a in (select b from u) and a > 1", "a in (1, 2, 0, 9) and a > 1",
     [(None,), (1,), (3,), (4,)]),
    # NOT IN is three-valued: NULL NOT IN a non-empty set is NULL, so the
    # NULL row stays
    ("a not in (select b from u)", "a not in (1, 2, 0, 9)", [(None,), (1,), (2,)]),
])
def test_delete_with_subquery(where, same, left):
    """DELETE whose predicate holds an IN or EXISTS subquery removes the
    rows where it is TRUE (NULL keeps the row). The JAX package's CASE
    rewrite puts the subquery where its planner refuses it (ROADMAP queue
    3); the port is held to the JAX package's DELETE with the same
    predicate written over the subquery's values."""
    p = Pair({"t": {"a": np.array([1, 2, 3, 4, 0], dtype=np.int64)},
              "u": {"b": np.array([1, 2, 0, 9], dtype=np.int64)}})
    p.q("delete from t where a = 0")
    p.q("insert into t values (null)")
    got = p.port.query(f"delete from t where {where}").rows()
    assert got == p.ref.query(f"delete from t where {same}").rows() == [(5 - len(left),)]
    assert p.q("select a from t order by a nulls first") == left
    with pytest.raises(Exception, match="only supported as a top-level"):
        p.ref.query(f"delete from t where {where}")


def test_insert_unifies_dictionaries_and_rescales_decimals():
    """INSERT ... SELECT from a table with its own varchar dictionary and a
    decimal of another scale: the appended page is cast to the target
    types and its dictionary merged with the table's."""
    p = Pair({"src": {"s": ["kiwi", "apple", None, "fig"],
                      "d": np.array([125, 2, 999, 10], np.int64)}})
    # d as decimal(10,3) through a cast of the bigint thousandths
    p.q("create table dst as select s, cast(d as decimal(12,3)) / 1000 d from src where d < 100")
    p.q("insert into dst select s, cast(d as decimal(12,3)) / 1000 from src where d >= 100")
    p.q("create table tgt (s varchar, d decimal(12,1))")
    p.q("insert into tgt values ('pear', 1.25)")
    p.q("insert into tgt select s, d from dst")
    got = p.q("select s, d, count(*) from tgt group by s, d order by s, d")
    assert [r[0] for r in got] == ["apple", "fig", "kiwi", "pear", None]
    assert p.q("select s from tgt where s >= 'kiwi' order by s") == [("kiwi",), ("pear",)]
    tbl = p.port.catalog.page("tgt")
    assert str(tbl.block("d").type) == "decimal(12,1)" and tbl.device.type == "cpu"


# -- views, schemas (tests/test_statements.py) -------------------------------


def test_view_roundtrip(pair):
    pair.q("create view v1 as select g, sum(v) sv from t group by g")
    assert sorted(pair.q("select * from v1", ordered=False)) == [(1, 30), (2, 30)]
    assert pair.q("select count(*) from v1, t where v1.g = t.g") == [(3,)]
    pair.q("create view v2 as select sv from v1 where sv > 0")
    assert sorted(pair.q("select * from v2", ordered=False)) == [(30,), (30,)]
    assert ("v1",) in pair.q("show tables")
    txt = pair.q("show create view v1")[0][0]
    assert txt.startswith("CREATE VIEW v1 AS select")


def test_view_replace_and_drop(pair):
    pair.q("create view v as select g from t")
    pair.fails("create view v as select v from t")
    pair.q("create or replace view v as select v from t")
    assert sorted(pair.q("select * from v", ordered=False)) == [(10,), (20,), (30,)]
    pair.q("drop view v")
    pair.fails("drop view v")
    pair.q("drop view if exists v")


@pytest.mark.parametrize("sql,name", [
    ("create view t as select 1 from t", "ValueError"),
    ("create view bad as select nosuch from t", "Exception"),
])
def test_view_rejected_at_create(pair, sql, name):
    pair.fails(sql, name)
    assert ("bad",) not in pair.q("show tables")


def test_schema_lifecycle(pair):
    pair.q("create schema s1")
    assert ("s1",) in pair.q("show schemas")
    pair.fails("create schema s1")
    pair.q("create schema if not exists s1")
    pair.q("drop schema s1")
    pair.fails("drop schema s1")
    pair.q("drop schema if exists s1")
    pair.fails("drop schema default")


def test_create_table_rejects_view_name(pair):
    pair.q("create view vv as select 1 x from t")
    pair.fails("create table vv (x bigint)")
    pair.fails("create table vv as select 1 from t")


def test_or_replace_view_cannot_self_reference(pair):
    pair.q("create view v as select v from t")
    pair.fails("create or replace view v as select * from v", "Exception")
    # the old definition must survive the failed replace
    assert len(pair.q("select * from v", ordered=False)) == 3


# -- prepared statements ------------------------------------------------------


def test_prepare_execute_roundtrip(pair):
    pair.q("prepare p from select g, sum(v) s from t where v > ? group by g order by g")
    assert pair.q("describe input p") == [(0, "unknown")]
    assert pair.q("describe output p") == [("g", "bigint"), ("s", "bigint")]
    assert pair.q("execute p using 15") == [(1, 20), (2, 30)]
    assert pair.q("execute p using 25") == [(2, 30)]
    pair.q("deallocate prepare p")
    pair.fails("execute p using 15")


def test_execute_param_count_mismatch(pair):
    pair.q("prepare p2 from select * from t where v > ? and g = ?")
    pair.fails("execute p2 using 1")
    assert pair.q("execute p2 using 15, 2") == [(2, 30)]


def test_prepare_string_parameter(pair):
    pair.q("prepare p3 from select upper(?) u from t limit 1")
    assert pair.q("execute p3 using 'abc'") == [("ABC",)]


def test_describe_input_no_parameters(pair):
    pair.q("prepare q0 from select 1 from t")
    assert pair.q("describe input q0") == []


# -- session properties -------------------------------------------------------


def test_set_reset_session(pair):
    pair.q("set session batch_rows = 4096")
    assert dict(pair.q("show session"))["batch_rows"] == "4096"
    # queries still work through the derived session
    assert pair.q("select count(*) from t") == [(3,)]
    pair.q("reset session batch_rows")
    assert dict(pair.q("show session"))["batch_rows"] == ""


def test_set_session_unknown_property(pair):
    pair.fails("set session nope = 1")


def test_execute_respects_session_overrides(pair):
    pair.q("set session batch_rows = 2048")
    pair.q("prepare qq from select count(*) from t")
    assert pair.q("execute qq") == [(3,)]


@pytest.mark.parametrize("prop", ["streaming", "matmul_groupby"])
def test_unported_properties_raise(pair, prop):
    """The matmul group-by is not ported and raises; the streaming executor
    is (exec/stream.py): turning it on runs the query through it, with the
    JAX package's rows."""
    if prop == "streaming":
        pair.port.query("set session streaming = true")
        want = pair.ref.query("select count(*) from t").rows()
        assert pair.port.query("select count(*) from t").rows() == want == [(3,)]
        derived = pair.port.with_properties(pair.port._session_overrides)
        assert type(derived.executor).__name__ == "StreamingExecutor"
    else:
        with pytest.raises(NotPortedError, match=f"SET SESSION {prop} = true"):
            pair.port.query(f"set session {prop} = true")
    pair.port.query(f"set session {prop} = false")
    assert pair.port.query("select count(*) from t").rows() == [(3,)]


# -- ALTER TABLE ---------------------------------------------------------------


def test_alter_table_columns(pair):
    pair.q("alter table t add column z bigint")
    assert [c for c, _ in pair.q("show columns from t")] == ["g", "v", "z"]
    assert pair.q("select count(z) from t") == [(0,)]  # the added column is NULL
    pair.q("alter table t rename column z to zz")
    assert [c for c, _ in pair.q("show columns from t")][-1] == "zz"
    pair.q("alter table t drop column zz")
    assert [c for c, _ in pair.q("show columns from t")] == ["g", "v"]
    pair.fails("alter table t drop column nope")


def test_alter_table_rename(pair):
    pair.q("alter table t rename to t2")
    assert pair.q("select count(*) from t2") == [(3,)]
    pair.fails("select count(*) from t", "Exception")
    pair.q("alter table t2 rename to t")


def test_add_column_then_insert_varchar(pair):
    pair.q("alter table t add column s varchar")
    pair.q("insert into t values (3, 40, 'new')")
    assert pair.q("select s, count(*) from t group by s order by s") == [("new", 1), (None, 3)]


def test_add_long_decimal_column_then_insert(pair):
    """ADD COLUMN of a long decimal: the port builds both lanes, so a later
    INSERT appends; the JAX package's 1-D zeros make that INSERT fail
    (ROADMAP queue 3)."""
    for sess in (pair.port, pair.ref):
        sess.query("alter table t add column w decimal(30,2)")
    pair.port.query("insert into t values (3, 40, 12345678901234567890.25)")
    got = pair.port.query("select g, w from t order by v").rows()
    assert [str(w) for _g, w in got] == ["None", "None", "None", "12345678901234567890.25"]
    with pytest.raises(TypeError, match="different numbers of dimensions"):
        pair.ref.query("insert into t values (3, 40, 12345678901234567890.25)")


# -- GRANT / REVOKE and enforcement -------------------------------------------


def test_grant_revoke_cycle():
    p = Pair({"t": {"v": np.array([1], dtype=np.int64)}}, rules=[{"privileges": "all"}],
             user="admin")
    p.q("revoke select on t from bob")
    p.fails("select * from t", "AccessDeniedError", user="bob")
    p.q("grant select on table t to bob")
    assert p.q("select * from t", user="bob") == [(1,)]
    p.fails("delete from t", "AccessDeniedError", user="bob")  # select is not write
    p.q("grant all on table t to bob")
    p.q("delete from t where v = 0", user="bob")


def test_grant_requires_mutable_access_control(pair):
    pair.fails("grant select on t to bob")


@pytest.mark.parametrize("sql", [
    "execute p", "describe output p", "show create table secret", "show stats for secret",
])
def test_bob_denied_on_secret(sql):
    p = Pair(two_tables(), rules=DENY_BOB_SECRET, user="admin")
    p.q("prepare p from select * from secret")
    p.q(sql)  # admin may
    p.fails(sql, "AccessDeniedError", user="bob")


def test_grant_requires_all_privilege():
    p = Pair(two_tables(), rules=DENY_BOB_SECRET, user="admin")
    p.fails("grant all on secret to bob", "AccessDeniedError", user="bob")


@pytest.mark.parametrize("sql", [
    "alter table t drop column v", "alter table t add column z bigint", "alter table t rename to t9",
    "create view vv as select * from t", "create schema s9",
])
def test_alter_requires_write_privilege(sql):
    p = Pair(two_tables(), rules=[{"privileges": "select"}], user="bob")
    p.fails(sql, "AccessDeniedError")


def test_view_does_not_launder_access():
    p = Pair(two_tables(), rules=DENY_BOB_SECRET, user="alice")
    p.q("create view v as select * from secret")
    assert p.q("select * from v") == [(42,)]
    p.fails("select * from v", "AccessDeniedError", user="bob")


def test_revoke_all_leaves_nothing():
    p = Pair(two_tables(), rules=[{"privileges": "all"}], user="admin")
    p.q("revoke all on t from alice")
    p.fails("insert into t values (9)", "AccessDeniedError", user="alice")
    p.fails("select * from t", "AccessDeniedError", user="alice")


def test_session_override_sees_transaction_writes():
    """A derived property session reads the transaction's overlay (the
    port derives one for dynamic_filtering; broadcast_threshold is shown
    by SHOW SESSION but no executor of the port reads it)."""
    p = Pair(two_tables())
    p.q("set session broadcast_threshold = 999")
    p.q("set session dynamic_filtering = false")
    p.q("begin")
    p.q("insert into t values (3)")
    assert p.q("select count(*) from t") == [(3,)]
    p.q("rollback")
    assert p.q("select count(*) from t") == [(2,)]


# -- SHOW, DESCRIBE, ANALYZE, EXPLAIN (tests/test_statements2.py) -------------


@pytest.fixture()
def tu():
    return Pair({"t": {"x": np.arange(5, dtype=np.int64)},
                 "u": {"y": np.arange(3, dtype=np.int64)}})


def test_show_functions_catalogs_create_table(pair):
    fns = pair.q("show functions")
    names = {r[0] for r in fns}
    assert len(fns) > 300
    assert {"abs", "approx_percentile", "transform", "row_number"} <= names
    kinds = dict(fns)
    assert kinds["approx_percentile"] == "aggregate" and kinds["transform"] == "lambda"
    assert pair.q("show catalogs") == [("memory",)]
    (txt,) = pair.q("show create table t")[0]
    assert txt.startswith("CREATE TABLE t") and "g bigint" in txt


def test_show_create_table_redirects_views(pair):
    pair.q("create view vv as select * from t")
    pair.fails("show create table vv", match="is a view")


def test_describe_is_show_columns(tu):
    assert tu.q("describe t") == tu.q("show columns from t")
    assert tu.q("desc t")[0][0] == "x"


def test_table_shorthand(tu):
    assert tu.q("table t") == tu.q("select * from t")
    assert len(tu.q("table t union all table t", ordered=False)) == 10


def test_explain_type_validate_and_io(tu):
    assert tu.q("explain (type validate) select * from t") == [(True,)]
    tu.fails("explain (type validate) select nope from t", "Exception")
    assert tu.q("explain (type io) select x from t where x > 1") == [("t [x]",)]


def test_explain_type_distributed_not_ported(tu):
    """Both packages fragment the plan (plan/fragment.py, ported since the
    distributed slice) and print the same text."""
    txt = "\n".join(r[0] for r in tu.q("explain (type distributed) select count(*) from t"))
    assert "Aggregate" in txt and "Exchange [gather]" in txt


def test_analyze_returns_row_count(tu):
    assert tu.q("analyze t") == [(5,)]
    tu.fails("analyze missing", "Exception")


def test_show_like_patterns(tu):
    assert tu.q("show tables like 't%'") == [("t",)]
    assert tu.q("show tables like '%'") == [("t",), ("u",)]
    assert ("array_sort", "scalar") in tu.q("show functions like 'array_s%'")


def test_use_schema(tu):
    """USE of a schema; USE catalog.schema of a catalog the session does
    not have raises ValueError in both packages (USE over a CatalogStore:
    tests/test_torch_catalog_store.py)."""
    tu.q("create schema s2")
    assert tu.q("use s2") == [(0,)]
    tu.fails("use nothere")
    tu.fails("use memory.s2", match="catalog 'memory' does not exist")


def test_show_grants():
    rules = [{"user": "admin", "privileges": "all"},
             {"user": ".*", "table": "secret.*", "privileges": "none"},
             {"user": ".*", "privileges": "select"}]
    p = Pair({"t": {"x": np.arange(3, dtype=np.int64)}}, rules=rules, user="admin")
    assert p.q("show grants") == [("admin", ".*", "all"), (".*", "secret.*", "none"),
                                  (".*", ".*", "select")]
    assert p.q("show grants on table t") == [("admin", ".*", "all"), (".*", ".*", "select")]
    # no access control installed: empty result, not an error
    assert Pair().q("show grants") == []


@pytest.fixture(scope="module")
def tpch():
    """The port and the JAX package over TPC-H SF 0.01 (bit-identical
    generators)."""
    return Pair(port_catalog=TpchCatalog(0.01, device="cpu"), ref_catalog=RTpchCatalog(0.01))


def test_show_stats_for_table(tpch):
    rows = tpch.q("show stats for nation")
    by_col = {r[0]: r for r in rows}
    assert by_col["n_nationkey"][1] == 25.0  # NDV
    assert by_col["n_nationkey"][4] == "0.0" and by_col["n_nationkey"][5] == "24.0"
    assert by_col[None][3] == 25.0  # row_count


def test_show_stats_follow_writes():
    """After an INSERT the port's SHOW STATS describes the new rows; the JAX
    package keeps the column stats it sampled before the write (ROADMAP
    queue 3), while its summary row counts the new rows."""
    p = Pair({"t": {"a": np.array([1, 2], dtype=np.int64)}})
    assert p.q("show stats for t")[0] == ("a", 2.0, 0.0, None, "1.0", "2.0")
    p.q("insert into t values (5), (9)")
    assert p.port.query("show stats for t").rows()[0] == ("a", 4.0, 0.0, None, "1.0", "9.0")
    assert p.ref.query("show stats for t").rows()[0] == ("a", 2.0, 0.0, None, "1.0", "2.0")


def test_tablesample_bernoulli_and_system(tpch):
    """TABLESAMPLE: a fresh plan-time seed per query (so the two packages
    draw different rows), proportionate counts, aliases still bind."""
    n = tpch.q("select count(*) from lineitem")[0][0]
    for sess in (tpch.port, tpch.ref):
        a, b = (sess.query("select count(*) from lineitem tablesample bernoulli (50)")
                .rows()[0][0] for _ in range(2))
        assert 0.4 * n < a < 0.6 * n and 0.4 * n < b < 0.6 * n and a != b
        c = sess.query("select count(*) from lineitem tablesample system (10)").rows()[0][0]
        assert 0.05 * n < c < 0.15 * n
        r = sess.query("select count(*) from lineitem tablesample bernoulli (20) l, "
                       "orders o where l.l_orderkey = o.o_orderkey").rows()[0][0]
        assert 0.1 * n < r < 0.3 * n
    assert tpch.q("select count(*) from lineitem tablesample bernoulli (0)") == [(0,)]
    assert tpch.q("select count(*) from lineitem tablesample bernoulli (100)") == [(n,)]


def test_result_pages_on_the_session_device(pair):
    """Row counts, SHOW, EXPLAIN and query results are built on the
    session's device; trace_id and phase_ms are set on a SELECT (traced
    by default) and None on every other statement."""
    for sql in ("create table w (a bigint)", "show tables", "show session",
                "explain select * from t", "explain analyze select * from t",
                "select g from t", "show stats for t"):
        res = pair.port.query(sql)
        traced = sql.startswith("select")
        assert res.page.device.type == "cpu"
        assert (res.trace_id is not None) == traced
        if traced:
            assert set(res.phase_ms) == {"plan", "execute"}
        else:
            assert res.phase_ms is None
        assert all(b.data.device.type == "cpu" for b in res.page.blocks)
    assert pair.port.catalog.page("w").device.type == "cpu"
