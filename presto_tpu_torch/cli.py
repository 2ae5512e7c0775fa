"""Interactive SQL CLI (torch counterpart of presto_tpu/cli.py).

Equivalent of the reference's presto-cli (presto-cli/src/main/java/com/
facebook/presto/cli/: a REPL, table rendering, timing). Runs against an
in-process Session on the card by default (`--device cpu` for the CPU),
or, with `--server`, against a coordinator over HTTP.

Usage:
  python -m presto_tpu_torch.cli                 # REPL on tpch sf0.01
  python -m presto_tpu_torch.cli --sf 1 "SELECT ...;"
  python -m presto_tpu_torch.cli --server http://host:port "SELECT ...;"
  python -m presto_tpu_torch.cli --serve --port 8080   # start a coordinator
  python -m presto_tpu_torch.cli --serve --port 0 --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time


def _render(rows, titles, max_rows: int = 200) -> str:
    cells = [[_fmt(v) for v in r] for r in rows[:max_rows]]
    widths = [len(t) for t in titles]
    for r in cells:
        for i, c in enumerate(r):
            widths[i] = max(widths[i], len(c))
    sep = "-+-".join("-" * w for w in widths)
    out = [" | ".join(t.ljust(w) for t, w in zip(titles, widths)), sep]
    for r in cells:
        out.append(" | ".join(c.rjust(w) for c, w in zip(r, widths)))
    if len(rows) > max_rows:
        out.append(f"... ({len(rows) - max_rows} more rows)")
    return "\n".join(out)


def _fmt(v) -> str:
    if v is None:
        return "NULL"
    return str(v)


def split_statements(text: str):
    """Split a multi-statement string on top-level semicolons (respects
    single- and double-quoted spans: the reference CLI's --execute accepts
    'stmt; stmt; ...')."""
    out, buf, q = [], [], None
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if q:
            buf.append(c)
            if c == q:
                if i + 1 < n and text[i + 1] == q:  # escaped quote
                    buf.append(text[i + 1])
                    i += 1
                else:
                    q = None
        elif c in ("'", '"'):
            q = c
            buf.append(c)
        elif c == ";":
            if "".join(buf).strip():
                out.append("".join(buf).strip())
            buf = []
        else:
            buf.append(c)
        i += 1
    if "".join(buf).strip():
        out.append("".join(buf).strip())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="presto-tpu")
    ap.add_argument("query", nargs="?", help="SQL to run (REPL if omitted)")
    ap.add_argument("--sf", type=float, default=0.01, help="tpch/tpcds scale factor")
    ap.add_argument(
        "--catalog", default="tpch",
        help="tpch | tpcds | memory | a directory of csv/tsv/jsonl files",
    )
    ap.add_argument(
        "--catalog-dir",
        help="directory of <name>.properties catalog files (server-style "
        "bootstrap; tables reachable bare or as <name>.<table>)",
    )
    ap.add_argument("--server", help="coordinator URI (remote REST mode)")
    ap.add_argument("--serve", action="store_true",
                    help="start a coordinator server instead of a REPL")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--device", default="cuda",
                    help="device of the local Session and its catalog (cuda | cpu)")
    args = ap.parse_args(argv)

    import os

    from .session import Session

    def build_catalog():
        # only the --serve and local-REPL paths need one; remote mode
        # must not validate a path that exists only on the coordinator
        if args.catalog_dir:
            from .server.catalog_store import load_catalog_store

            return load_catalog_store(args.catalog_dir, device=args.device)
        if args.catalog == "tpch":
            from .connectors.tpch import TpchCatalog

            return TpchCatalog(sf=args.sf, device=args.device)
        if args.catalog == "tpcds":
            from .connectors.tpcds import TpcdsCatalog

            return TpcdsCatalog(sf=args.sf, device=args.device)
        if args.catalog == "memory":
            from .connectors.memory import MemoryCatalog

            return MemoryCatalog({}, device=args.device)
        if os.path.isdir(args.catalog):
            from .connectors.localfile import LocalFileCatalog

            return LocalFileCatalog(args.catalog, device=args.device)
        ap.error(
            f"unknown catalog {args.catalog!r} "
            "(tpch | tpcds | memory | directory path)"
        )

    def banner_name():
        if args.catalog in ("tpch", "tpcds"):
            return f"{args.catalog} sf{args.sf:g}"
        return args.catalog

    if args.serve:
        from .server import CoordinatorServer

        server = CoordinatorServer(
            Session(build_catalog(), device=args.device), port=args.port
        ).start()
        print(f"coordinator listening on {server.uri} ({banner_name()}, {args.device})",
              flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            server.stop()
        return

    if args.server:
        from .server import Client

        client = Client(args.server)

        def run_remote(sql: str):
            sql = sql.strip().rstrip(";")
            if not sql:
                return
            t0 = time.perf_counter()
            cols, rows = client.execute(sql)
            dt = time.perf_counter() - t0
            print(_render(rows, [c["name"] for c in cols]))
            print(f"({len(rows)} rows in {dt:.2f}s)")

        if args.query:
            for stmt in split_statements(args.query):
                run_remote(stmt)
            return
        print(f"presto-tpu CLI: remote {args.server}. End statements with ';'.")
        buf = []
        while True:
            try:
                line = input("presto> " if not buf else "     -> ")
            except (EOFError, KeyboardInterrupt):
                print()
                return
            if line.strip().lower() in ("quit", "exit"):
                return
            buf.append(line)
            if line.rstrip().endswith(";"):
                sql = "\n".join(buf)
                buf = []
                try:
                    run_remote(sql)
                except Exception as e:
                    print(f"error: {e}", file=sys.stderr)
        return

    session = Session(build_catalog(), device=args.device)

    def run_one(sql: str):
        sql = sql.strip().rstrip(";")
        if not sql:
            return
        low = sql.lower()
        t0 = time.perf_counter()
        if low.startswith("explain"):
            print(session.explain(sql))
            return
        if low == "show tables":
            for t in session.catalog.table_names():
                print(t)
            return
        if low.startswith("show columns from "):
            tname = sql.split()[-1]
            for c, ty in session.catalog.schema(tname).items():
                print(f"{c:24s} {ty}")
            return
        r = session.query(sql)
        dt = time.perf_counter() - t0
        print(_render(r.rows(), r.titles))
        print(f"({r.row_count()} rows in {dt:.2f}s)")

    if args.query:
        for stmt in split_statements(args.query):
            run_one(stmt)
        return

    print(f"presto-tpu CLI: {banner_name()} on {args.device}. End statements with ';'.")
    buf = []
    while True:
        try:
            prompt = "presto> " if not buf else "     -> "
            line = input(prompt)
        except (EOFError, KeyboardInterrupt):
            print()
            return
        if line.strip().lower() in ("quit", "exit"):
            return
        buf.append(line)
        if line.rstrip().endswith(";"):
            sql = "\n".join(buf)
            buf = []
            try:
                run_one(sql)
            except Exception as e:  # keep the REPL alive
                print(f"error: {e}", file=sys.stderr)


if __name__ == "__main__":
    main()
