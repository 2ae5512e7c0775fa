"""Query verifier: replay a suite against two engines and diff results
(torch counterpart of presto_tpu/verifier.py, the same digest).

Re-designed equivalent of presto-verifier (presto-verifier/src/main/java/
com/facebook/presto/verifier/Verifier.java + Validator.java: run each
query on a control and a test cluster, compare row counts and checksums,
report mismatches). Targets are either REST coordinator URIs or
in-process Sessions; comparison uses an order-insensitive row digest
with type-aware float tolerance, like Validator's checksum queries.

CLI:  python -m presto_tpu_torch.verifier --control URI --test URI suite.sql
      (suite file: semicolon-separated statements; lines starting with
      -- are comments)
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import time
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass
class VerifyResult:
    query: str
    status: str  # MATCH | MISMATCH | CONTROL_FAILED | TEST_FAILED
    detail: str = ""
    control_ms: float = 0.0
    test_ms: float = 0.0
    control_rows: Optional[int] = None
    test_rows: Optional[int] = None


class SessionTarget:
    """In-process target (LocalQueryRunner analog)."""

    def __init__(self, session):
        self.session = session

    def execute(self, sql: str) -> List[tuple]:
        return self.session.query(sql).rows()


class RestTarget:
    """REST coordinator target (the verifier's JDBC analog)."""

    def __init__(self, uri: str):
        from .server.client import Client

        self.client = Client(uri)

    def execute(self, sql: str) -> List[tuple]:
        _cols, rows = self.client.execute(sql)
        return [tuple(r) for r in rows]


def _canon_value(v, float_digits: int = 6):
    if v is None:
        return "\x00null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        if math.isnan(v):
            return "nan"
        return f"{v:.{float_digits}e}"
    try:  # numpy scalars, Decimal, dates
        if isinstance(v, complex):
            raise TypeError(v)
        f = float(v)
        if not isinstance(v, int) and f != int(f):
            return f"{f:.{float_digits}e}"
    except (TypeError, ValueError):
        pass
    return str(v)


def row_digest(rows: Sequence[tuple]) -> Tuple[int, str]:
    """(count, order-insensitive content digest). Modular SUM of per-row
    hashes — order-free and mergeable like the reference's checksum
    aggregation, but unlike XOR it does not cancel rows that repeat an
    even number of times."""
    acc = 0
    for r in rows:
        h = hashlib.sha256(
            "\x01".join(_canon_value(v) for v in r).encode()
        ).digest()
        acc = (acc + int.from_bytes(h[:16], "big")) % (1 << 128)
    return len(rows), f"{acc:032x}"


def verify_query(control, test, sql: str) -> VerifyResult:
    t0 = time.perf_counter()
    try:
        c_rows = control.execute(sql)
    except Exception as e:  # noqa: BLE001 - reported, not raised
        return VerifyResult(
            sql, "CONTROL_FAILED", f"{type(e).__name__}: {e}"
        )
    t1 = time.perf_counter()
    try:
        t_rows = test.execute(sql)
    except Exception as e:  # noqa: BLE001 - reported, not raised
        return VerifyResult(
            sql, "TEST_FAILED", f"{type(e).__name__}: {e}",
            control_ms=(t1 - t0) * 1e3,
        )
    t2 = time.perf_counter()
    cn, cd = row_digest(c_rows)
    tn, td = row_digest(t_rows)
    if cn != tn:
        status, detail = "MISMATCH", f"row count {cn} != {tn}"
    elif cd != td:
        status, detail = "MISMATCH", "checksum differs"
    else:
        status, detail = "MATCH", ""
    return VerifyResult(
        sql, status, detail,
        control_ms=(t1 - t0) * 1e3, test_ms=(t2 - t1) * 1e3,
        control_rows=cn, test_rows=tn,
    )


def verify_suite(control, test, queries: Sequence[str]) -> List[VerifyResult]:
    return [verify_query(control, test, q) for q in queries]


def load_suite(path: str) -> List[str]:
    text = open(path).read()
    lines = [
        line for line in text.splitlines()
        if not line.strip().startswith("--")
    ]
    return [q.strip() for q in "\n".join(lines).split(";") if q.strip()]


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--control", required=True, help="control coordinator URI")
    p.add_argument("--test", required=True, help="test coordinator URI")
    p.add_argument("suite", help="semicolon-separated SQL file")
    args = p.parse_args(argv)
    results = verify_suite(
        RestTarget(args.control), RestTarget(args.test),
        load_suite(args.suite),
    )
    bad = 0
    for r in results:
        line = f"{r.status:16s} {r.control_ms:8.1f}ms {r.test_ms:8.1f}ms  "
        line += r.query.replace("\n", " ")[:80]
        if r.detail:
            line += f"  [{r.detail}]"
        print(line)
        bad += r.status != "MATCH"
    print(f"# {len(results) - bad}/{len(results)} matched")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
