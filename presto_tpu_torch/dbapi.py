"""PEP 249 (DB-API 2.0) client over the REST statement protocol (torch
counterpart of presto_tpu/dbapi.py).

Re-designed equivalent of presto-jdbc (presto-jdbc/src/main/java/com/
facebook/presto/jdbc/ — PrestoConnection/PrestoStatement/PrestoResultSet
over the same /v1/statement protocol). `qmark` parameters are bound
SERVER-SIDE: the statement text (with its `?` placeholders intact) is
PREPAREd once per connection and each execute sends
`EXECUTE <name> USING <literals>`, where the values appear only in the
USING list as typed literals the server parses and binds as constants —
never spliced into arbitrary SQL positions (the old client-side
substitution was both a quoting/injection hazard and a plan-cache key
leak: every distinct value produced a distinct statement text, so no two
executions could share a cached plan skeleton; see exec/qcache.py).

    import presto_tpu_torch.dbapi as dbapi
    conn = dbapi.connect("http://localhost:8080")
    cur = conn.cursor()
    cur.execute("select * from t where x > ?", (5,))
    print(cur.fetchall())
"""

from __future__ import annotations

import datetime
import decimal
from typing import List, Optional, Sequence, Tuple

apilevel = "2.0"
threadsafety = 1  # threads may share the module, not connections
paramstyle = "qmark"


class Error(Exception):
    pass


class InterfaceError(Error):
    pass


class DatabaseError(Error):
    pass


class ProgrammingError(DatabaseError):
    pass


def _escape(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float, decimal.Decimal)):
        return str(v)
    if isinstance(v, datetime.datetime):
        return f"timestamp '{v.isoformat(sep=' ')}'"
    if isinstance(v, datetime.date):
        return f"date '{v.isoformat()}'"
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    raise InterfaceError(f"cannot bind parameter of type {type(v).__name__}")


def _substitute(sql: str, params: Sequence) -> str:
    """Replace ? placeholders outside string literals, quoted identifiers,
    and comments. LEGACY: kept for callers that need a textualized
    statement (and for tests of the escaper); Cursor.execute now binds
    server-side via PREPARE/EXECUTE USING instead."""
    out = []
    it = iter(params)
    i = 0
    n = len(sql)
    while i < n:
        c = sql[i]
        if c in ("'", '"'):  # string literal / quoted ident ('' "" escapes)
            q = c
            j = i + 1
            while j < n:
                if sql[j] == q:
                    if j + 1 < n and sql[j + 1] == q:
                        j += 2
                        continue
                    break
                j += 1
            out.append(sql[i : j + 1])
            i = j + 1
            continue
        if c == "-" and i + 1 < n and sql[i + 1] == "-":  # -- line comment
            j = sql.find("\n", i)
            j = n if j < 0 else j
            out.append(sql[i:j])
            i = j
            continue
        if c == "/" and i + 1 < n and sql[i + 1] == "*":  # /* block */
            j = sql.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append(sql[i:j])
            i = j
            continue
        if c == "?":
            try:
                out.append(_escape(next(it)))
            except StopIteration:
                raise ProgrammingError("not enough parameters") from None
            i += 1
            continue
        out.append(c)
        i += 1
    try:
        next(it)
        raise ProgrammingError("too many parameters")
    except StopIteration:
        pass
    return "".join(out)


class Cursor:
    arraysize = 1

    def __init__(self, conn: "Connection"):
        self._conn = conn
        self.description: Optional[List[tuple]] = None
        self.rowcount = -1
        self._rows: List[tuple] = []
        self._pos = 0
        self._closed = False

    # -- execution --

    def execute(self, operation: str, parameters: Sequence = ()) -> "Cursor":
        self._check()
        try:
            if parameters:
                cols, rows = self._conn._execute_prepared(
                    operation, parameters
                )
            else:
                cols, rows = self._conn._client.execute(operation)
        except Error:
            raise
        except Exception as e:  # noqa: BLE001 - wrap in DB-API error
            msg = str(e)
            if "parameters" in msg and "expects" in msg:
                raise ProgrammingError(msg) from e
            raise DatabaseError(msg) from e
        self.description = [
            (c["name"], c["type"], None, None, None, None, None)
            for c in (cols or [])
        ]
        self._rows = [tuple(r) for r in rows]
        self._pos = 0
        self.rowcount = len(self._rows)
        return self

    def executemany(self, operation: str, seq_of_parameters) -> "Cursor":
        for p in seq_of_parameters:
            self.execute(operation, p)
        return self

    # -- fetching --

    def fetchone(self) -> Optional[tuple]:
        self._check()
        if self._pos >= len(self._rows):
            return None
        row = self._rows[self._pos]
        self._pos += 1
        return row

    def fetchmany(self, size: Optional[int] = None) -> List[tuple]:
        self._check()
        size = size or self.arraysize
        out = self._rows[self._pos : self._pos + size]
        self._pos += len(out)
        return out

    def fetchall(self) -> List[tuple]:
        self._check()
        out = self._rows[self._pos :]
        self._pos = len(self._rows)
        return out

    def __iter__(self):
        while True:
            row = self.fetchone()
            if row is None:
                return
            yield row

    # -- boilerplate --

    def setinputsizes(self, sizes):  # noqa: D102 - PEP 249 no-op
        pass

    def setoutputsize(self, size, column=None):  # noqa: D102 - PEP 249 no-op
        pass

    def close(self):
        self._closed = True

    def _check(self):
        if self._closed or self._conn._closed:
            raise InterfaceError("cursor is closed")


class Connection:
    def __init__(self, uri: str, timeout: float = 300.0):
        from .server.client import Client

        self._client = Client(uri, timeout=timeout)
        self._closed = False
        self._prepared: dict = {}  # statement text -> server-side name

    # -- server-side parameter binding --

    def _prepare(self, operation: str) -> str:
        """PREPARE `operation` once per connection under a deterministic
        content-hashed name (concurrent connections preparing the same
        text collide onto the identical statement — benign)."""
        name = self._prepared.get(operation)
        if name is None:
            import hashlib

            name = "dbapi_" + hashlib.sha1(
                operation.encode()
            ).hexdigest()[:16]
            self._client.execute(f"prepare {name} from {operation}")
            self._prepared[operation] = name
        return name

    def _execute_prepared(self, operation: str, parameters: Sequence):
        using = ", ".join(_escape(v) for v in parameters)
        name = self._prepare(operation)
        sql = f"execute {name} using {using}"
        try:
            return self._client.execute(sql)
        except Exception as e:  # noqa: BLE001
            # match the server's specific missing-statement error, not any
            # message containing "not found" (404s say that too)
            if "prepared statement" in str(e) and "not found" in str(e):
                # server restarted / session recycled: re-prepare once
                self._prepared.pop(operation, None)
                name = self._prepare(operation)
                return self._client.execute(f"execute {name} using {using}")
            raise

    def cursor(self) -> Cursor:
        if self._closed:
            raise InterfaceError("connection is closed")
        return Cursor(self)

    def commit(self):  # autocommit protocol; present per PEP 249
        pass

    def rollback(self):
        raise DatabaseError("transactions are not supported")

    def close(self):
        # DEALLOCATE this connection's server-side statements: the
        # coordinator session is shared, so leaked names would grow its
        # prepared map for the process lifetime. Best-effort — another
        # connection using the same content-hashed name simply re-PREPAREs.
        for name in self._prepared.values():
            try:
                self._client.execute(f"deallocate prepare {name}")
            except Exception:  # noqa: BLE001 — closing must not raise
                pass
        self._prepared.clear()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def connect(uri: str, timeout: float = 300.0) -> Connection:
    return Connection(uri, timeout=timeout)
