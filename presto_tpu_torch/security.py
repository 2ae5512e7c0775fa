"""Access control: pluggable authorization checks on queries (the torch
package's own copy of presto_tpu/security.py, over its sql/ tree).

Re-designed equivalent of the reference's security stack
(presto-main/.../security/AccessControlManager.java, the
SystemAccessControl SPI in presto-spi, and the file-based rules of
presto-plugin-toolkit's access control helpers). Checks run in the
session layer before planning/execution, so every surface (in-process,
REST, DB-API) is covered by the same gate.

Rule-based implementation mirrors the reference's file-based access
control JSON: first-match-wins rules keyed by user regex, each granting
a privilege level per table regex.

    rules = [
        {"user": "admin", "privileges": "all"},
        {"user": ".*", "table": "secret.*", "privileges": "none"},
        {"user": ".*", "privileges": "select"},
    ]
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Sequence

SELECT = "select"
WRITE = "write"  # insert/delete/create/drop
ALL = "all"
NONE = "none"


class AccessDeniedError(RuntimeError):
    """Reference: AccessDeniedException (spi/security)."""


class AccessControl:
    """SPI: override the checks you enforce. Default allows everything
    (the reference's AllowAllAccessControl)."""

    def check_can_execute_query(self, user: str) -> None:  # noqa: B027
        pass

    def check_can_select_from_table(  # noqa: B027
        self, user: str, table: str
    ) -> None:
        pass

    def check_can_write_table(self, user: str, table: str) -> None:  # noqa: B027
        pass


@dataclasses.dataclass
class AccessRule:
    privileges: str  # all | select | none
    user: str = ".*"
    table: str = ".*"

    def matches(self, user: str, table: Optional[str]) -> bool:
        if not re.fullmatch(self.user, user or ""):
            return False
        if table is not None and not re.fullmatch(self.table, table):
            return False
        return True


class RuleBasedAccessControl(AccessControl):
    """First-match-wins rules (reference FileBasedSystemAccessControl)."""

    def __init__(self, rules: Sequence[dict]):
        self.rules = [AccessRule(**r) for r in rules]

    def _privilege(self, user: str, table: Optional[str]) -> str:
        for r in self.rules:
            if r.matches(user, table):
                return r.privileges
        return NONE

    def check_can_execute_query(self, user: str) -> None:
        # denied only when no rule grants the user anything at all
        if all(not r.matches(user, None) or r.privileges == NONE
               for r in self.rules):
            raise AccessDeniedError(f"user {user!r} cannot execute queries")

    def check_can_select_from_table(self, user: str, table: str) -> None:
        if self._privilege(user, table) not in (SELECT, WRITE, ALL):
            raise AccessDeniedError(
                f"user {user!r} cannot select from {table!r}"
            )

    def check_can_write_table(self, user: str, table: str) -> None:
        if self._privilege(user, table) not in (WRITE, ALL):
            raise AccessDeniedError(f"user {user!r} cannot write {table!r}")

    # -- GRANT / REVOKE (reference execution/GrantTask.java /
    # RevokeTask.java; grants become first-match rules, prepended so they
    # override broader defaults) --

    def check_can_grant(self, user: str, table: str) -> None:
        if self._privilege(user, table) != ALL:
            raise AccessDeniedError(
                f"user {user!r} cannot change grants on {table!r}"
            )

    def grant(self, user: str, table: str, privilege: str) -> None:
        priv = {"insert": WRITE, "update": WRITE, "delete": WRITE}.get(
            privilege, privilege
        )
        if priv not in (SELECT, WRITE, ALL):
            raise ValueError(f"unknown privilege {privilege!r}")
        self.rules.insert(
            0, AccessRule(priv, user=re.escape(user), table=re.escape(table))
        )

    def revoke(self, user: str, table: str, privilege: str) -> None:
        """Drop the user to the highest privilege BELOW the revoked one on
        the ladder none<select<write<all (write implies read here, as in
        check_can_select_from_table), expressed as an explicit first-match
        rule so a broader default cannot silently re-grant."""
        priv = {"insert": WRITE, "update": WRITE, "delete": WRITE}.get(
            privilege, privilege
        )
        eu, et = re.escape(user), re.escape(table)
        self.rules = [
            r for r in self.rules
            if not (r.user == eu and r.table == et)
        ]
        ladder = [NONE, SELECT, WRITE, ALL]
        cur = self._privilege(user, table)
        # revoking ALL or SELECT leaves nothing (write implies read here,
        # so removing read removes everything); revoking WRITE leaves read
        floor = NONE if priv in (ALL, SELECT) else SELECT
        new = ladder[min(ladder.index(cur), ladder.index(floor))]
        self.rules.insert(0, AccessRule(new, user=eu, table=et))


def collect_tables(ast) -> List[str]:
    """Storage-table names referenced anywhere in a statement AST. CTE
    aliases look like tables in FROM clauses but are derived relations and
    are excluded — with the SAME scoping the planner applies
    (sql/planner.py plan_query/plan_table): a CTE name is in scope only
    within the Query that defines it, and a CTE's own definition body does
    NOT see its own name (so `WITH t AS (SELECT * FROM t)` reads the
    physical t and is checked against it)."""
    from .sql import tree as t

    out: List[str] = []
    seen: set = set()
    # a CTE referenced N times re-expands N times (matching the planner),
    # which is exponential for chains that reference the previous CTE twice
    # — memoize on (definition, names-in-scope) and hard-cap expansions so a
    # few-KB statement cannot hang the gate before authorization runs
    expanded: set = set()
    expansions = [0]

    def walk(node, scope: dict):
        # scope: cte name -> WithItem, exactly the planner's `ctes` dict.
        # CTE bodies are expanded LAZILY at the reference site with the
        # referenced name stripped — the planner strips names transitively
        # along an expansion chain, so a mutually-referencing pair
        # (a -> b -> a) bottoms out at the physical table; eager per-item
        # walks would miss that.
        if isinstance(node, t.Table):
            name = node.name.lower()
            if name in scope:
                item = scope[name]
                inner = {k: v for k, v in scope.items() if k != name}
                memo_key = (id(item), frozenset(inner))
                if memo_key in expanded:
                    return
                expanded.add(memo_key)
                expansions[0] += 1
                if expansions[0] > 10_000:
                    raise ValueError(
                        "statement exceeds the CTE expansion limit"
                    )
                walk(item.query, inner)
            elif name not in seen:
                seen.add(name)
                out.append(name)
            return
        if isinstance(node, t.Query) and node.with_items:
            inner = dict(scope)
            for item in node.with_items:
                inner[item.name.lower()] = item
            walk(node.body, inner)
            for child in node.order_by:
                walk(child, inner)
            return
        if not dataclasses.is_dataclass(node):
            return
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, t.Node):
                walk(v, scope)
            elif isinstance(v, tuple):
                for x in v:
                    if isinstance(x, t.Node):
                        walk(x, scope)
                    elif isinstance(x, tuple):
                        for y in x:
                            if isinstance(y, t.Node):
                                walk(y, scope)

    walk(ast, {})
    return out


def _names_to_check(name: str) -> List[str]:
    """A table reference is checked under BOTH its written form and its
    bare resolved name, so `default.secret_t` cannot sidestep a rule
    written against `secret_t` (the planner resolves qualified names to
    the bare table; connectors here have one implicit schema).

    Rules must therefore target the BARE resolved name (`secret_t`), the
    canonical form the planner uses: a rule written only against a
    qualified pattern (`default\\.secret_t`) does not protect the bare
    reference, which never produces the qualified form."""
    bare = name.split(".")[-1]
    return [name] if bare == name else [name, bare]


# view SQL text -> underlying table list; enforce() runs per query, so
# the (pure) parse+collect of each referenced view is computed once
_VIEW_TABLES_CACHE: dict = {}


def _view_tables(view_sql: str) -> List[str]:
    tables = _VIEW_TABLES_CACHE.get(view_sql)
    if tables is None:
        from .sql.parser import parse as _parse

        tables = [x.lower() for x in collect_tables(_parse(view_sql))]
        if len(_VIEW_TABLES_CACHE) > 4096:  # bound server memory
            _VIEW_TABLES_CACHE.clear()
        _VIEW_TABLES_CACHE[view_sql] = tables
    return tables


def enforce(access_control: AccessControl, user: str, ast,
            views=None) -> None:
    """Run the checks a statement requires (reference: StatementAnalyzer
    calling AccessControl per relation + DDL tasks checking writes).

    `views` ({name: view SQL}) enables INVOKER-style expansion: a table
    reference that names a view is checked against the view's UNDERLYING
    tables too, so a view cannot launder access to a protected table."""
    from .sql import tree as t

    access_control.check_can_execute_query(user)

    def check_select_closure(tables, seen=None):
        seen = seen if seen is not None else set()
        for table in tables:
            for n in _names_to_check(table):
                access_control.check_can_select_from_table(user, n)
            bare = table.split(".")[-1]
            if views and bare in views and bare not in seen:
                seen.add(bare)
                check_select_closure(_view_tables(views[bare]), seen)

    check_select_closure([x.lower() for x in collect_tables(ast)])
    if isinstance(ast, t.ShowColumns):
        # metadata reveals schema: same privilege as reading the table
        for n in _names_to_check(ast.table.lower()):
            access_control.check_can_select_from_table(user, n)
    if isinstance(ast, t.ShowCreateTable):
        # same metadata surface as SHOW COLUMNS
        for n in _names_to_check(ast.name.lower()):
            access_control.check_can_select_from_table(user, n)
    if isinstance(ast, t.ShowStats):
        # statistics leak DATA values (min/max/NDV): read privilege
        for n in _names_to_check(ast.name.lower()):
            access_control.check_can_select_from_table(user, n)
    if isinstance(ast, (t.CreateTable, t.DropTable)):
        for n in _names_to_check(ast.name.lower()):
            access_control.check_can_write_table(user, n)
    elif isinstance(ast, t.Insert):
        for n in _names_to_check(ast.table.lower()):
            access_control.check_can_write_table(user, n)
    elif isinstance(ast, t.Delete):
        for n in _names_to_check(ast.table.lower()):
            access_control.check_can_write_table(user, n)
    elif isinstance(ast, (t.RenameTable, t.RenameColumn, t.AddColumn,
                          t.DropColumn)):
        target = ast.name if isinstance(ast, t.RenameTable) else ast.table
        for n in _names_to_check(target.lower()):
            access_control.check_can_write_table(user, n)
        if isinstance(ast, t.RenameTable):
            for n in _names_to_check(ast.new_name.lower()):
                access_control.check_can_write_table(user, n)
    elif isinstance(ast, t.CreateView):
        # creating a view is a catalog write on the view name, plus read
        # rights over everything it selects from (INVOKER model)
        for n in _names_to_check(ast.name.lower()):
            access_control.check_can_write_table(user, n)
        check_select_closure(_view_tables(ast.query_sql))
    elif isinstance(ast, t.DropView):
        for n in _names_to_check(ast.name.lower()):
            access_control.check_can_write_table(user, n)
    elif isinstance(ast, (t.CreateSchema, t.DropSchema)):
        for n in _names_to_check(ast.name.lower()):
            access_control.check_can_write_table(user, n)
    elif isinstance(ast, (t.Grant, t.Revoke)):
        # only a user holding ALL on the table may change its grants
        # (reference AccessControl.checkCanGrantTablePrivilege)
        check = getattr(access_control, "check_can_grant", None)
        if check is not None:
            check(user, ast.table.lower())
    elif isinstance(ast, t.ExecutePrepared):
        # the bound statement is enforced again at EXECUTE time in
        # Session (the prepared SQL is an opaque string here)
        pass
