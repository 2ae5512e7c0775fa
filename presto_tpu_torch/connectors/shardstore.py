"""Shard-organized native storage engine — the raptor analog (torch
counterpart of presto_tpu/connectors/shardstore.py).

Re-designed equivalent of presto-raptor (RaptorMetadata +
storage/StorageManager + storage/organization/ShardCompactor /
ShardOrganizer + a MySQL shard-metadata DB): the proof that the
connector SPI carries a FULL storage engine, not just file readers.

Design (the JAX package's, file for file, so either package opens the
other's store):
  * a table = a set of immutable parquet SHARD files under one directory,
    read and written through connectors/parquet.py's whole-buffer bridge;
    pages land on the catalog's device
  * shard metadata lives in SQLite (`metadata.db`): table schemas, shard
    row counts, and per-column min/max statistics captured at WRITE time
    (reference ShardStats/ColumnStats persisted to the shards table) —
    scans prune whole shards against predicate hints without opening
    files, and the pruned/read counts surface in EXPLAIN ANALYZE via the
    `last_scan_files_*` counters (same contract as the hive connector)
  * INSERT appends a new shard — never rewrites existing data
  * `organize()` merges runs of small shards into compaction-target-sized
    ones (reference ShardCompactor.compact + ShardOrganizer background
    jobs; `start_organizer()` runs it on a daemon thread)
  * `table_version`, `delta_token` and `scan_delta` give the plan and
    result caches a snapshot version and materialized views an append
    cursor (DeltaUnavailable when a shard straddles the range)
  * DROP deletes metadata transactionally, then garbage-collects files
"""

from __future__ import annotations

import datetime as pydt
import json
import logging
import os
import sqlite3
import threading
import uuid
import zlib
from typing import Dict, List, Optional

import numpy as np

from .. import types as T
from ..page import Page, to_numpy
from .parquet import arrow_table_to_page, build_sorted_dictionary, page_to_arrow
from .spi import DeltaUnavailable, Predicate, WritableConnector, WriteError

# compaction target: merge small shards until ~this many rows
DEFAULT_COMPACT_ROWS = 1 << 20
# rows per Parquet row group of a shard file: a scan of a row range reads
# only the groups that hold it (the column-stats sample reads 8 strided
# ranges; with one group a shard it read every column 8 times whole)
SHARD_ROW_GROUP = 1 << 17


def _decode_stat(kind: str, txt: str):
    if kind == "str":
        return txt
    if kind == "date":
        return pydt.date.fromisoformat(txt)
    return float(txt)


def _combine_stats(dicts) -> dict:
    """Combine per-shard column stats dicts: min of mins, max of maxes
    per column, ignoring shards with no stats for a column."""
    out: Dict = {}
    for st in dicts:
        for col, (kind, mn, mx) in st.items():
            if kind is None or mn is None:
                out.setdefault(col, (None, None, None))
                continue
            cur = out.get(col)
            if cur is None or cur[0] is None:
                out[col] = (kind, mn, mx)
                continue
            cmn = min(_decode_stat(kind, cur[1]), _decode_stat(kind, mn))
            cmx = max(_decode_stat(kind, cur[2]), _decode_stat(kind, mx))
            enc = (
                (lambda v: v.isoformat()) if kind == "date"
                else (str if kind == "str" else (lambda v: repr(float(v))))
            )
            out[col] = (kind, enc(cmn), enc(cmx))
    return out


def _coerce_hint(value):
    """Predicate-hint python value -> the comparison domain of the stored
    stats (dates stay dates, strings stay strings, numbers -> float)."""
    if isinstance(value, (pydt.date, str)):
        return value
    try:
        return float(value)
    except (TypeError, ValueError):
        return None


class ShardStoreCatalog(WritableConnector):
    """Local shard storage engine implementing the full Catalog + write
    SPI (usable anywhere the memory/hive catalogs are); pages land on
    `device`."""

    name = "shardstore"

    def __init__(self, directory: str,
                 compact_rows: int = DEFAULT_COMPACT_ROWS, device="cuda"):
        import torch

        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.device = torch.device(device)
        self.compact_rows = compact_rows
        self.db = sqlite3.connect(
            os.path.join(directory, "metadata.db"), check_same_thread=False
        )
        self._db_lock = threading.Lock()
        self.db.executescript(
            """
            CREATE TABLE IF NOT EXISTS tables (
                name TEXT PRIMARY KEY, schema_json TEXT NOT NULL);
            CREATE TABLE IF NOT EXISTS shards (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                table_name TEXT NOT NULL, path TEXT NOT NULL,
                rows INTEGER NOT NULL,
                seq REAL NOT NULL,
                max_seq REAL);
            CREATE TABLE IF NOT EXISTS shard_stats (
                shard_id INTEGER NOT NULL, column_name TEXT NOT NULL,
                kind TEXT, min_v TEXT, max_v TEXT,
                PRIMARY KEY (shard_id, column_name));
            CREATE TABLE IF NOT EXISTS table_meta (
                name TEXT PRIMARY KEY,
                created_id INTEGER NOT NULL,
                data_version INTEGER NOT NULL DEFAULT 0,
                nonappend_version INTEGER NOT NULL DEFAULT 0,
                unique_cols TEXT);
            CREATE TABLE IF NOT EXISTS table_ids (
                id INTEGER PRIMARY KEY AUTOINCREMENT, name TEXT);
            CREATE INDEX IF NOT EXISTS idx_shards_table
                ON shards(table_name);
            """
        )
        try:
            # databases created before the delta-scan work lack the
            # max_seq column (CREATE IF NOT EXISTS above is a no-op there)
            self.db.execute("ALTER TABLE shards ADD COLUMN max_seq REAL")
            self.db.commit()
        except sqlite3.OperationalError:
            pass  # column already present (fresh database)
        self.last_scan_files_read = 0
        self.last_scan_files_skipped = 0
        self._dict_cache: Dict = {}  # (table, column, version) -> dict
        self._organizer: Optional[threading.Thread] = None
        self._organizer_stop = threading.Event()
        self.organize_events: List[dict] = []

    # -- metadata ----------------------------------------------------------

    def table_names(self) -> List[str]:
        with self._db_lock:
            rows = self.db.execute("SELECT name FROM tables").fetchall()
        return sorted(r[0] for r in rows)

    def schema(self, table: str) -> Dict[str, T.Type]:
        with self._db_lock:
            row = self.db.execute(
                "SELECT schema_json FROM tables WHERE name = ?", (table,)
            ).fetchone()
        if row is None:
            raise KeyError(f"table {table!r} does not exist")
        return {
            c: T.parse_type(tn) for c, tn in json.loads(row[0]).items()
        }

    def row_count(self, table: str) -> int:
        with self._db_lock:
            row = self.db.execute(
                "SELECT COALESCE(SUM(rows), 0) FROM shards "
                "WHERE table_name = ?",
                (table,),
            ).fetchone()
        return int(row[0])

    def exact_row_count(self, table: str) -> int:
        return self.row_count(table)

    def unique_columns(self, table: str):
        with self._db_lock:
            row = self.db.execute(
                "SELECT unique_cols FROM table_meta WHERE name = ?",
                (table,),
            ).fetchone()
        if row is None or row[0] is None:
            return []
        return [tuple(json.loads(row[0]))]

    def shard_count(self, table: str) -> int:
        with self._db_lock:
            return int(
                self.db.execute(
                    "SELECT COUNT(*) FROM shards WHERE table_name = ?",
                    (table,),
                ).fetchone()[0]
            )

    def _shards(self, table: str):
        """Shards in GLOBAL ROW ORDER. Ordering is by `seq`, not id: a
        compacted shard inherits the seq of the first shard it merged, so
        row offsets stay stable across organize() — a streaming query
        paginating by offset sees the same rows before and after a
        concurrent compaction."""
        with self._db_lock:
            return self.db.execute(
                "SELECT id, path, rows FROM shards WHERE table_name = ? "
                "ORDER BY seq",
                (table,),
            ).fetchall()

    def _version(self, table: str) -> int:
        """Monotone shard-set version for cache invalidation."""
        with self._db_lock:
            row = self.db.execute(
                "SELECT COALESCE(MAX(id), 0), COUNT(*) FROM shards "
                "WHERE table_name = ?",
                (table,),
            ).fetchone()
        return int(row[0]) * 1_000_003 + int(row[1])

    def _ensure_meta_locked(self, table: str):
        """(created_id, data_version, nonappend_version, unique_cols) for
        `table`, creating the row for databases that predate table_meta.
        Caller holds `_db_lock` and owns the transaction/commit."""
        row = self.db.execute(
            "SELECT created_id, data_version, nonappend_version, "
            "unique_cols FROM table_meta WHERE name = ?",
            (table,),
        ).fetchone()
        if row is not None:
            return row
        cid = self.db.execute(
            "INSERT INTO table_ids (name) VALUES (?)", (table,)
        ).lastrowid
        # adopted mid-life (legacy database): seed at 1 so version 0
        # stays the "freshly created, never written" value
        self.db.execute(
            "INSERT INTO table_meta VALUES (?, ?, 1, 1, NULL)",
            (table, cid),
        )
        return (cid, 1, 1, None)

    def _bump_meta_locked(self, table: str, nonappend: bool) -> None:
        """Advance the per-table write counter; `nonappend` marks
        rewrites (replace/upsert) that invalidate old delta cursors."""
        self._ensure_meta_locked(table)
        self.db.execute(
            "UPDATE table_meta SET data_version = data_version + 1, "
            "nonappend_version = CASE WHEN ? THEN data_version + 1 "
            "ELSE nonappend_version END WHERE name = ?",
            (1 if nonappend else 0, table),
        )

    def table_version(self, table: str) -> int:
        """Connector snapshot version (exec/qcache.py): a per-table WRITE
        counter — bumped by append/replace/upsert, NOT by organize(),
        which rewrites shard files without changing data, so compaction
        never invalidates warm caches or forces spurious matview
        refreshes — mixed with a never-reused creation id (DROP +
        re-CREATE cannot resume an old version sequence) and the schema
        hash so a re-CREATE under a different schema can never alias the
        empty-table version."""
        with self._db_lock:
            row = self.db.execute(
                "SELECT schema_json FROM tables WHERE name = ?", (table,)
            ).fetchone()
            if row is None:
                raise KeyError(f"table {table!r} does not exist")
            cid, dv, _nv, _uc = self._ensure_meta_locked(table)
            self.db.commit()
        return ((cid * 1_000_003 + dv) << 32) ^ zlib.crc32(row[0].encode())

    def delta_token(self, table: str):
        """Append-cursor for scan_delta(): (high_seq, data_version,
        nonappend_version). Every row appended after this token lands in
        a shard with seq > high_seq; a later token with a DIFFERENT
        nonappend_version means the table was rewritten in between and
        deltas against this token are meaningless."""
        with self._db_lock:
            if self.db.execute(
                "SELECT 1 FROM tables WHERE name = ?", (table,)
            ).fetchone() is None:
                raise KeyError(f"table {table!r} does not exist")
            row = self.db.execute(
                "SELECT MAX(COALESCE(max_seq, seq)) FROM shards "
                "WHERE table_name = ?",
                (table,),
            ).fetchone()
            _cid, dv, nv, _uc = self._ensure_meta_locked(table)
            self.db.commit()
        return (float(row[0] or 0.0), dv, nv)

    def scan_delta(self, table: str, from_seq: float, to_seq: float,
                   columns=None, _retries: int = 2) -> Page:
        """Rows appended in the seq interval (from_seq, to_seq] — the
        delta between two delta_token() cursors. Raises DeltaUnavailable
        when a shard STRADDLES an endpoint; organize() only merges whole
        seq-adjacent runs and a merged shard keeps the run's [first seq,
        max seq] interval, so compaction of shards that are entirely
        inside (or entirely outside) the range is invisible here."""
        import pyarrow as pa

        schema = self.schema(table)
        names = list(columns) if columns is not None else list(schema)
        with self._db_lock:
            shards = self.db.execute(
                "SELECT id, path, seq, COALESCE(max_seq, seq) FROM shards "
                "WHERE table_name = ? ORDER BY seq",
                (table,),
            ).fetchall()
        kept = []
        for _sid, path, lo, hi in shards:
            if hi <= from_seq or lo > to_seq:
                continue  # fully consumed / fully beyond the range
            if lo <= from_seq or hi > to_seq:
                raise DeltaUnavailable(
                    f"shard seq [{lo}, {hi}] of {table!r} straddles the "
                    f"delta range ({from_seq}, {to_seq}]"
                )
            kept.append(path)
        try:
            pieces = [self._read_shard(p, names) for p in kept]
        except FileNotFoundError:
            # concurrent organize() GC'd a file between listing and read;
            # retry against fresh metadata (same contract as scan())
            if _retries <= 0:
                raise
            return self.scan_delta(
                table, from_seq, to_seq, columns=columns,
                _retries=_retries - 1,
            )
        if pieces:
            tb = pa.concat_tables(pieces)
        else:
            from .parquet import _type_to_arrow

            tb = pa.table(
                {n: pa.array([], type=_type_to_arrow(schema[n]))
                 for n in names}
            )
        # a zero-row page keeps one slot (ops/union.empty_page's rule): the
        # operators take capacity 0 for no input at all
        return arrow_table_to_page(
            tb, names, tb.num_rows, 1,
            lambda name: self._dictionary(table, name), self.device,
        )

    # -- writes ------------------------------------------------------------

    def create_table(self, table: str, schema: Dict[str, T.Type],
                     unique_columns=None) -> None:
        with self._db_lock:
            if self.db.execute(
                "SELECT 1 FROM tables WHERE name = ?", (table,)
            ).fetchone():
                raise WriteError(f"table {table!r} already exists")
            self.db.execute(
                "INSERT INTO tables VALUES (?, ?)",
                (table, json.dumps({c: str(t) for c, t in schema.items()})),
            )
            # table_ids is never garbage-collected: created_id must not
            # be reused by a DROP + re-CREATE (version aliasing)
            cid = self.db.execute(
                "INSERT INTO table_ids (name) VALUES (?)", (table,)
            ).lastrowid
            self.db.execute(
                "INSERT INTO table_meta VALUES (?, ?, 0, 0, ?)",
                (table, cid,
                 json.dumps([str(c) for c in unique_columns])
                 if unique_columns else None),
            )
            self.db.commit()

    def create_table_from_page(self, table: str, page: Page) -> None:
        self.create_table(
            table, {c: b.type for c, b in zip(page.names, page.blocks)}
        )
        if int(page.count):
            self.append(table, page)

    def _page_stats(self, page: Page):
        """Per-column (kind, min, max) captured at write time."""
        n = int(page.count)
        out = {}
        for name, b in zip(page.names, page.blocks):
            data = to_numpy(b.data[:n])
            valid = None if b.valid is None else to_numpy(b.valid[:n])
            if valid is not None:
                data = data[valid]
            if data.size == 0 or data.ndim != 1:
                out[name] = (None, None, None)
                continue
            if isinstance(b.type, T.VarcharType):
                d = b.dictionary or ()
                codes = data[(data >= 0) & (data < len(d))]
                if codes.size == 0 or not d:
                    out[name] = (None, None, None)
                    continue
                if getattr(d, "is_sorted", True):
                    out[name] = ("str", d[int(codes.min())], d[int(codes.max())])
                else:
                    # an unsorted (lazy) dictionary: code order is not
                    # string order, so compare the strings themselves
                    used = [d[int(c)] for c in np.unique(codes)]
                    out[name] = ("str", min(used), max(used))
            elif isinstance(b.type, T.DateType):
                epoch = pydt.date(1970, 1, 1)
                out[name] = (
                    "date",
                    (epoch + pydt.timedelta(days=int(data.min()))).isoformat(),
                    (epoch + pydt.timedelta(days=int(data.max()))).isoformat(),
                )
            elif isinstance(b.type, T.DecimalType) and not b.type.is_long:
                sc = 10.0 ** b.type.scale
                out[name] = (
                    "num", repr(float(data.min()) / sc),
                    repr(float(data.max()) / sc),
                )
            elif np.issubdtype(data.dtype, np.number):
                out[name] = (
                    "num", repr(float(data.min())), repr(float(data.max()))
                )
            else:
                out[name] = (None, None, None)
        return out

    def _write_file(self, table: str, arrow_table) -> str:
        import pyarrow.parquet as pq

        path = os.path.join(
            self.directory, f"{table}.{uuid.uuid4().hex}.parquet"
        )
        pq.write_table(arrow_table, path, row_group_size=SHARD_ROW_GROUP)
        return path

    def _insert_shard_meta(self, table, path, rows, stats, seq=None,
                           max_seq=None, drop_ids=(),
                           drop_table_shards=False, bump=True,
                           nonappend=False) -> None:
        """ONE metadata transaction: optionally drop old shards, insert
        the new one, and (unless `bump` is False — compaction rewrites
        files without changing data) advance the table's write counter.
        seq defaults to the new id (append at the end); `max_seq` records
        the top of a merged shard's seq interval."""
        with self._db_lock:
            if drop_table_shards:
                self.db.execute(
                    "DELETE FROM shard_stats WHERE shard_id IN "
                    "(SELECT id FROM shards WHERE table_name = ?)",
                    (table,),
                )
                self.db.execute(
                    "DELETE FROM shards WHERE table_name = ?", (table,)
                )
            if drop_ids:
                qmarks = ",".join("?" * len(drop_ids))
                self.db.execute(
                    f"DELETE FROM shard_stats WHERE shard_id IN ({qmarks})",
                    tuple(drop_ids),
                )
                self.db.execute(
                    f"DELETE FROM shards WHERE id IN ({qmarks})",
                    tuple(drop_ids),
                )
            cur = self.db.execute(
                "INSERT INTO shards (table_name, path, rows, seq, max_seq)"
                " VALUES (?,?,?,0,?)",
                (table, path, rows,
                 float(max_seq) if max_seq is not None else None),
            )
            sid = cur.lastrowid
            self.db.execute(
                "UPDATE shards SET seq = ? WHERE id = ?",
                (float(seq) if seq is not None else float(sid), sid),
            )
            for col, (kind, mn, mx) in stats.items():
                self.db.execute(
                    "INSERT INTO shard_stats VALUES (?,?,?,?,?)",
                    (sid, col, kind, mn, mx),
                )
            if bump:
                self._bump_meta_locked(table, nonappend)
            self.db.commit()
        if bump:
            self.forget_column_stats(table)

    def _write_shard(self, table: str, arrow_table, stats) -> None:
        path = self._write_file(table, arrow_table)
        self._insert_shard_meta(table, path, arrow_table.num_rows, stats)

    def append(self, table: str, page: Page) -> None:
        self.schema(table)  # existence check
        if int(page.count) == 0:
            return
        self._write_shard(table, page_to_arrow(page), self._page_stats(page))

    def append_batch(self, table: str, pages) -> int:
        """High-rate ingest: concatenate many small pages into ONE shard
        with ONE metadata transaction and ONE version bump — the
        table's snapshot version moves at ingest-batch rate, not
        per-page. Returns the number of rows appended."""
        import pyarrow as pa

        self.schema(table)  # existence check
        pages = [p for p in pages if int(p.count)]
        if not pages:
            return 0
        if len(pages) == 1:
            self.append(table, pages[0])
            return int(pages[0].count)
        tb = pa.concat_tables([page_to_arrow(p) for p in pages])
        stats = _combine_stats([self._page_stats(p) for p in pages])
        self._write_shard(table, tb, stats)
        return tb.num_rows

    def upsert(self, table: str, page: Page) -> dict:
        """INSERT-or-REPLACE keyed on the table's declared unique
        columns. Fast path: when no incoming key exists yet this is a
        plain append — the table stays append-only and delta cursors
        survive. Slow path: a rewrite — rows matching an incoming key
        are dropped, the shard set swaps in one metadata transaction,
        and the nonappend version bump tells delta consumers their old
        cursors are void. Returns {"appended": n, "updated": m}."""
        import pyarrow as pa

        keys = self.unique_columns(table)
        if not keys:
            raise WriteError(
                f"upsert on {table!r} requires unique columns declared "
                f"at CREATE TABLE time"
            )
        if int(page.count) == 0:
            return {"appended": 0, "updated": 0}
        kcols = list(keys[0])
        missing = [c for c in kcols if c not in page.names]
        if missing:
            raise WriteError(
                f"upsert page for {table!r} lacks key column(s) {missing}"
            )
        tb_new = page_to_arrow(page)
        new_keys = set(
            zip(*[tb_new.column(c).to_pylist() for c in kcols])
        )
        with self._db_lock:
            shards = self.db.execute(
                "SELECT id, path, rows FROM shards WHERE table_name = ? "
                "ORDER BY seq",
                (table,),
            ).fetchall()
        old_tables, hit = [], False
        for _sid, path, _rows in shards:
            t = self._read_shard(path)
            old_tables.append(t)
            if not hit:
                hit = any(
                    k in new_keys
                    for k in zip(*[t.column(c).to_pylist() for c in kcols])
                )
        if not hit:
            self._write_shard(table, tb_new, self._page_stats(page))
            return {"appended": tb_new.num_rows, "updated": 0}
        merged = pa.concat_tables(old_tables)
        keep = [
            k not in new_keys
            for k in zip(*[merged.column(c).to_pylist() for c in kcols])
        ]
        kept_tb = merged.filter(pa.array(keep, type=pa.bool_()))
        if not kept_tb.schema.equals(tb_new.schema):
            tb_new = tb_new.cast(kept_tb.schema)
        final = pa.concat_tables([kept_tb, tb_new])
        path = self._write_file(table, final)
        # drop only the snapshotted shard ids (not drop_table_shards): a
        # shard appended concurrently with this rewrite must survive
        self._insert_shard_meta(
            table, path, final.num_rows, {},
            drop_ids=[sid for sid, _p, _r in shards],
            nonappend=True,
        )
        self._gc([p for _sid, p, _r in shards])
        updated = merged.num_rows - kept_tb.num_rows
        return {"appended": tb_new.num_rows - updated, "updated": updated}

    def replace(self, table: str, page: Page) -> None:
        """Write-new-then-swap in ONE metadata transaction — a crash (or
        concurrent reader) never observes the table without its data."""
        old = self._shards(table)
        self.forget_column_stats(table)
        arrow = page_to_arrow(page)
        if arrow.num_rows:
            path = self._write_file(table, arrow)
            self._insert_shard_meta(
                table, path, arrow.num_rows, self._page_stats(page),
                drop_table_shards=True, nonappend=True,
            )
        else:
            with self._db_lock:
                self.db.execute(
                    "DELETE FROM shard_stats WHERE shard_id IN "
                    "(SELECT id FROM shards WHERE table_name = ?)",
                    (table,),
                )
                self.db.execute(
                    "DELETE FROM shards WHERE table_name = ?", (table,)
                )
                self._bump_meta_locked(table, nonappend=True)
                self.db.commit()
        self._gc([p for _id, p, _r in old])

    def drop_table(self, table: str) -> None:
        old = self._shards(table)
        self.forget_column_stats(table)
        with self._db_lock:
            self.db.execute(
                "DELETE FROM shard_stats WHERE shard_id IN "
                "(SELECT id FROM shards WHERE table_name = ?)",
                (table,),
            )
            self.db.execute(
                "DELETE FROM shards WHERE table_name = ?", (table,)
            )
            self.db.execute("DELETE FROM tables WHERE name = ?", (table,))
            # table_ids row intentionally kept: created ids never recycle
            self.db.execute(
                "DELETE FROM table_meta WHERE name = ?", (table,)
            )
            self.db.commit()
        self._gc([p for _id, p, _r in old])

    @staticmethod
    def _gc(paths) -> None:
        for p in paths:
            try:
                os.remove(p)
            except OSError:
                pass

    # -- reads -------------------------------------------------------------

    def _read_shard(self, path: str, columns=None):
        """A shard file as an arrow table (only `columns`, when given)."""
        import pyarrow.parquet as pq

        return pq.read_table(path, columns=columns)

    def _read_rows(self, path: str, columns, lo: int, hi: int, rows: int):
        """Rows [lo, hi) of a shard file of `rows` rows: a whole-shard range
        reads the file, a part reads only the row groups that hold it."""
        import pyarrow.parquet as pq

        if lo == 0 and hi == rows:
            return self._read_shard(path, columns)
        f = pq.ParquetFile(path)
        groups, start, first = [], 0, 0
        for g in range(f.metadata.num_row_groups):
            n = f.metadata.row_group(g).num_rows
            if start < hi and start + n > lo:
                if not groups:
                    first = start
                groups.append(g)
            start += n
        return f.read_row_groups(groups, columns=columns).slice(lo - first, hi - lo)

    def _dictionary(self, table: str, column: str):
        key = (table, column, self._version(table))
        got = self._dict_cache.get(key)
        if got is None:
            import pyarrow as pa

            cols = [
                self._read_shard(p, [column]).column(column)
                for _id, p, _r in self._shards(table)
            ]
            if cols:
                merged = pa.chunked_array(
                    [c for col in cols for c in col.chunks]
                )
                got = build_sorted_dictionary(merged)
            else:
                got = ((), pa.array([], pa.string()))
            if len(self._dict_cache) > 256:
                self._dict_cache.clear()
            self._dict_cache[key] = got
        return got

    def _refuted(self, sid: int, predicate: Predicate) -> bool:
        """True when the shard's stored min/max refute ANY conjunct
        (reference ShardPredicate.create against the shards table)."""
        with self._db_lock:
            rows = self.db.execute(
                "SELECT column_name, kind, min_v, max_v FROM shard_stats "
                "WHERE shard_id = ?",
                (sid,),
            ).fetchall()
        stats = {
            c: (_decode_stat(k, mn), _decode_stat(k, mx))
            for c, k, mn, mx in rows
            if k is not None and mn is not None
        }
        for col, op, value in predicate:
            st = stats.get(col)
            if st is None:
                continue
            if op == "in":
                if not value:
                    return True  # empty IN-list matches nothing
                mn, mx = st
                try:
                    vals = [_coerce_hint(v) for v in value]
                    vals = [v for v in vals if v is not None]
                    if vals and all(v < mn or v > mx for v in vals):
                        return True
                except TypeError:
                    pass  # incomparable: keep the shard
                continue
            v = _coerce_hint(value)
            if v is None:
                continue
            mn, mx = st
            try:
                if op == "eq" and (v < mn or v > mx):
                    return True
                if op == "lt" and mn >= v:
                    return True
                if op == "le" and mn > v:
                    return True
                if op == "gt" and mx <= v:
                    return True
                if op == "ge" and mx < v:
                    return True
            except TypeError:
                continue  # incomparable: keep the shard
        return False

    def page(self, table: str) -> Page:
        return self.scan(table, 0, self.row_count(table))

    def page_columns(self, table: str, columns) -> Page:
        return self.scan(table, 0, self.row_count(table), columns=columns)

    def scan(self, table: str, start: int, stop: int, pad_to=None,
             columns=None, predicate=None, _retries: int = 2) -> Page:
        import pyarrow as pa

        schema = self.schema(table)
        names = list(columns) if columns is not None else list(schema)
        stop = min(stop, self.row_count(table))
        kept, skipped = [], 0
        offset = 0
        for sid, path, rows in self._shards(table):
            s0, s1 = offset, offset + rows
            offset = s1
            if s1 <= start or s0 >= stop:
                continue
            if predicate and self._refuted(sid, predicate):
                skipped += 1
                continue
            kept.append((path, max(start - s0, 0), min(stop, s1) - s0, rows))
        self.last_scan_files_read = len(kept)
        self.last_scan_files_skipped = skipped
        try:
            pieces = [self._read_rows(p, names, lo, hi, rows) for p, lo, hi, rows in kept]
        except FileNotFoundError:
            # a concurrent organize() GC'd a file between listing and
            # read; seq-stable offsets make a retry against fresh
            # metadata return the identical rows. Bounded: a PERMANENTLY
            # missing file (external deletion) must surface, not recurse
            if _retries <= 0:
                raise
            return self.scan(
                table, start, stop, pad_to=pad_to, columns=columns,
                predicate=predicate, _retries=_retries - 1,
            )
        if pieces:
            tb = pa.concat_tables(pieces)
        else:
            from .parquet import _type_to_arrow

            tb = pa.table(
                {n: pa.array([], type=_type_to_arrow(schema[n]))
                 for n in names}
            )
        return arrow_table_to_page(
            tb, names, tb.num_rows, max(pad_to or 0, 1),
            lambda name: self._dictionary(table, name), self.device,
        )

    # -- organization (reference storage/organization/ShardCompactor) -----

    def _merged_stats(self, shard_ids) -> dict:
        """Combine the stored stats of `shard_ids`: min of mins, max of
        maxes per column (ignoring shards with no stats for a column)."""
        qmarks = ",".join("?" * len(shard_ids))
        with self._db_lock:
            rows = self.db.execute(
                f"SELECT column_name, kind, min_v, max_v FROM shard_stats "
                f"WHERE shard_id IN ({qmarks})",
                tuple(shard_ids),
            ).fetchall()
        return _combine_stats(
            [{c: (k, mn, mx)} for c, k, mn, mx in rows]
        )

    def organize(self, table: Optional[str] = None) -> dict:
        """Merge CONTIGUOUS runs of small shards into compaction-target-
        sized shards (reference ShardCompactor.compact). The merged shard
        inherits the run's first `seq`, and only seq-adjacent shards
        merge, so the table's global row order — and therefore any
        streaming query's offset pagination — is unchanged by
        compaction. Swap is one metadata transaction; old files are GC'd
        after (a reader mid-swap retries against fresh metadata).
        Returns {table: shards_merged}."""
        import pyarrow as pa

        report = {}
        tables = [table] if table else self.table_names()
        for t in tables:
            with self._db_lock:
                shards = self.db.execute(
                    "SELECT id, path, rows, seq, COALESCE(max_seq, seq) "
                    "FROM shards WHERE table_name = ? ORDER BY seq",
                    (t,),
                ).fetchall()
            merged = 0
            run: List = []
            acc = 0

            def flush(run, _t=t):
                if len(run) < 2:
                    return 0
                tb = pa.concat_tables(
                    [self._read_shard(p) for _i, p, _r, _q, _m in run]
                )
                # the merged shard's stats are the combine of the stored
                # per-shard stats — no dictionary rebuild, no device
                # round-trip (reference ShardCompactor merges ColumnStats
                # the same way)
                stats = self._merged_stats([i for i, *_rest in run])
                path = self._write_file(_t, tb)
                # seq interval [first seq, max covered seq] keeps both
                # offset pagination AND scan_delta() exact across the
                # merge; bump=False because the data is unchanged —
                # compaction must never invalidate caches or matviews
                self._insert_shard_meta(
                    _t, path, tb.num_rows, stats,
                    seq=run[0][3],
                    max_seq=max(m for *_x, m in run),
                    drop_ids=[i for i, *_rest in run],
                    bump=False,
                )
                self._gc([p for _i, p, _r, _q, _m in run])
                return len(run)

            for sid, path, rows, seq, mseq in shards:
                if rows < self.compact_rows and acc + rows <= max(
                    self.compact_rows, rows
                ):
                    run.append((sid, path, rows, seq, mseq))
                    acc += rows
                    if acc >= self.compact_rows:
                        merged += flush(run)
                        run, acc = [], 0
                else:
                    # a large shard (or target reached) ends the
                    # contiguous run — never merge across it
                    merged += flush(run)
                    run, acc = [], 0
                    if rows < self.compact_rows:
                        run.append((sid, path, rows, seq, mseq))
                        acc = rows
            merged += flush(run)
            if merged:
                report[t] = merged
                self.organize_events.append({"table": t, "merged": merged})
        return report

    def start_organizer(self, interval_s: float = 30.0) -> None:
        """Background compaction loop (reference ShardOrganizer's
        periodic organization jobs)."""
        if self._organizer is not None:
            return
        self._organizer_stop.clear()

        def loop():
            while not self._organizer_stop.wait(interval_s):
                try:
                    self.organize()
                except Exception:  # noqa: BLE001 - keep the daemon alive, say why
                    logging.getLogger(__name__).exception("shard organizer pass failed")

        self._organizer = threading.Thread(target=loop, daemon=True)
        self._organizer.start()

    def stop_organizer(self) -> None:
        if self._organizer is not None:
            self._organizer_stop.set()
            self._organizer.join(timeout=5)
            self._organizer = None
