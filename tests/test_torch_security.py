"""Access control in presto_tpu_torch (security.py, the package's own copy
over its sql/ tree) against presto_tpu: the local cases of the JAX
package's tests/test_security.py (its REST, query-manager and wire-serde
cases need the server, not ported), each statement through both packages'
sessions under the same rules, and collect_tables on both parsers."""

import time

import pytest
import torch

from presto_tpu import security as rsecurity
from presto_tpu.sql.parser import parse as rparse
from presto_tpu_torch import security
from presto_tpu_torch.sql.parser import parse
from test_torch_statements import Pair

# one torch thread: the suite runs in parallel worker processes
# (pytest-xdist), and a thread per core in each oversubscribes the host
torch.set_num_threads(1)

RULES = [
    {"user": "admin", "privileges": "all"},
    {"user": ".*", "table": "secret.*", "privileges": "none"},
    {"user": "writer", "privileges": "write"},
    {"user": ".*", "privileges": "select"},
]


def _session(user):
    """Both packages' sessions as `user` under RULES over t = [1] and an
    empty secret_t, made by an unrestricted session on the same catalog."""
    boot = Pair()
    for sql in ("create table t (a bigint)", "insert into t values (1)",
                "create table secret_t (a bigint)"):
        boot.q(sql)
    return Pair(rules=RULES, user=user, port_catalog=boot.port.catalog,
                ref_catalog=boot.ref.catalog)


def test_select_allowed_write_denied():
    s = _session("alice")
    assert s.q("select a from t") == [(1,)]
    for sql in ("insert into t values (2)", "create table t2 (a bigint)", "delete from t"):
        s.fails(sql, "AccessDeniedError", match="cannot write")


@pytest.mark.parametrize("sql", [
    "select a from secret_t",
    # blocked even when buried in a join or subquery
    "select * from t join secret_t on t.a = secret_t.a",
    "select (select max(a) from secret_t) from t",
    # qualified names cannot bypass rules
    "select a from default.secret_t",
    "select a from memory.default.secret_t",
    # a CTE body does not see its own name: it reads the physical table
    "with secret_t as (select * from secret_t) select * from secret_t",
    # a CTE defined in a subquery does not shadow the table outside it
    "select * from secret_t cross join "
    "(with secret_t as (select 1 z) select z from secret_t) s",
    # mutually referencing CTEs bottom out at the physical table
    "with secret_t as (select * from b), b as (select * from secret_t) select * from secret_t",
    # metadata reveals schema: read privilege
    "show columns from secret_t",
])
def test_secret_denied(sql):
    _session("alice").fails(sql, "AccessDeniedError")


def test_writer_and_admin():
    w = _session("writer")
    w.q("insert into t values (5)")
    assert w.q("select count(*) from t") == [(2,)]
    a = _session("admin")
    a.q("select a from secret_t")
    a.q("drop table secret_t")


def test_unknown_user_cannot_query():
    p = Pair(rules=[{"user": "alice", "privileges": "select"}], user="mallory")
    p.fails("select 1 from (values (1)) v(d)", "AccessDeniedError", match="cannot execute")


def test_show_columns_requires_select():
    assert _session("alice").q("show columns from t")


@pytest.mark.parametrize("sql,want", [
    ("with v as (select a from t) select * from v", [(1,)]),
    # within scope a CTE legitimately shadows a denied table name
    ("with secret_t as (select a from t) select a from secret_t", [(1,)]),
])
def test_cte_names_in_scope_allowed(sql, want):
    assert _session("alice").q(sql) == want


def test_show_tables_filters_denied():
    names = [r[0] for r in _session("alice").q("show tables")]
    assert "t" in names and "secret_t" not in names
    assert "secret_t" in [r[0] for r in _session("admin").q("show tables")]


def test_empty_user_is_not_session_default():
    _session("admin").fails("select a from secret_t", "AccessDeniedError", user="")


def test_deep_cte_chain_is_fast():
    """A doubling chain of CTEs (each referencing the previous twice) must
    not make the pre-authorization walk exponential."""
    n = 25
    parts = ["c0 as (select a from t x, t y)"]
    for k in range(1, n):
        parts.append(f"c{k} as (select * from c{k-1} x, c{k-1} y)")
    sql = "with " + ", ".join(parts) + f" select * from c{n-1}"
    t0 = time.time()
    tables = security.collect_tables(parse(sql))
    assert time.time() - t0 < 2.0
    assert tables == ["t"] == rsecurity.collect_tables(rparse(sql))


@pytest.mark.parametrize("sql", [
    "select * from a join b on a.x = b.x where a.y in (select y from c)",
    "with q as (select * from d) select * from q, e",
    "insert into f select * from g",
    "delete from h where k in (select k from i)",
    "create table j as select * from k union all select * from l",
    "create view m as select * from n",
])
def test_collect_tables_equals_reference(sql):
    assert security.collect_tables(parse(sql)) == rsecurity.collect_tables(rparse(sql))


def test_grant_and_revoke_rules_equal_reference():
    """GRANT/REVOKE rewrite the first-match rules the same way in both."""
    port = security.RuleBasedAccessControl(RULES)
    ref = rsecurity.RuleBasedAccessControl(RULES)
    for ac in (port, ref):
        ac.grant("bob", "secret_t", "insert")
        ac.revoke("alice", "t", "select")
        ac.revoke("writer", "t", "delete")
    rules = lambda ac: [(r.user, r.table, r.privileges) for r in ac.rules]  # noqa: E731
    assert rules(port) == rules(ref)
    for user in ("bob", "alice", "writer", "admin"):
        for table in ("t", "secret_t"):
            assert port._privilege(user, table) == ref._privilege(user, table)
