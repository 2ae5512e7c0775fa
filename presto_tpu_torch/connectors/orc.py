"""ORC connector: stripe-batched reads -> device Pages (torch counterpart
of presto_tpu/connectors/orc.py).

Re-designed equivalent of the reference's ORC reader stack (presto-orc/
OrcReader + StripeReader + per-column StreamReaders) collapsed the same
way as the parquet connector: pyarrow.orc decodes stripes on the host,
connectors/parquet.py's whole-buffer bridge maps them onto the engine's
Block layout on the catalog's device.

Stripe statistics + pruning (reference TupleDomainOrcPredicate +
StripeReader's row-group index): pyarrow's Python API exposes stripe
COUNTS but not their column statistics, so the connector keeps a
`<file>.stats.json` SIDECAR — per-stripe row counts and column min/max,
written beside the files this catalog writes and derived once (then
cached) for foreign files; the JAX package's layout, so each package
reads the other's. scan() uses it twice: stripe offsets come from the
sidecar (no decode of stripes before the range), and stripes whose
min/max refute a predicate hint are skipped.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from .. import types as T
from ..page import Page
from .parquet import (FileWriteMixin, _arrow_to_type, arrow_table_to_page,
                      build_sorted_dictionary, page_to_arrow)
from .spi import Predicate, WritableConnector


class OrcCatalog(FileWriteMixin, WritableConnector):
    """tables: {name: orc file path}. With `directory` set, the catalog is
    WRITABLE: CREATE TABLE / CTAS / INSERT / DELETE produce ORC files
    under it (reference: presto-orc writer — pyarrow is the bootstrap
    encoder, matching the read path). Pages land on `device`."""

    name = "orc"
    _ext = "orc"

    def __init__(self, tables: Dict[str, str], unique: Optional[Dict[str, list]] = None,
                 directory: Optional[str] = None, device="cuda"):
        import torch
        from pyarrow import orc

        self.paths = dict(tables)
        self.unique = unique or {}
        self.directory = directory
        self.device = torch.device(device)
        self._files: Dict[str, object] = {}
        self._dicts: Dict[Tuple[str, str], tuple] = {}
        self._stripe_stats_cache: Dict[str, List[dict]] = {}
        self._orc = orc
        self.last_scan_files_read = 0
        self.last_scan_files_skipped = 0

    def _file(self, table: str):
        f = self._files.get(table)
        if f is None:
            f = self._orc.ORCFile(self.paths[table])
            self._files[table] = f
        return f

    def _invalidate(self, table: str) -> None:
        super()._invalidate(table)
        self._stripe_stats_cache.pop(table, None)

    def _encode_write(self, arrow_table, path: str) -> None:
        self._orc.write_table(arrow_table, path)
        # the stripe-statistics sidecar goes with the file, so readers
        # never pay the derive-by-reading pass for files written here
        try:
            stats = _derive_stripe_stats(self._orc.ORCFile(path))
            with open(path + ".stats.json", "w") as fh:
                json.dump(stats, fh)
        except OSError:
            pass  # read-only location: readers derive the stats again

    def _read_all(self, table: str):
        return self._file(table).read()

    # -- metadata --

    def table_names(self) -> List[str]:
        return list(self.paths)

    def schema(self, table: str) -> Dict[str, T.Type]:
        return {f.name: _arrow_to_type(f.type) for f in self._file(table).schema}

    def row_count(self, table: str) -> int:
        return self._file(table).nrows

    def exact_row_count(self, table: str) -> int:
        return self._file(table).nrows

    def unique_columns(self, table: str):
        return self.unique.get(table, [])

    # -- dictionaries (file-level, sorted, cached) --

    def _dictionary(self, table: str, column: str):
        key = (table, column)
        d = self._dicts.get(key)
        if d is None:
            d = build_sorted_dictionary(self._file(table).read(columns=[column]).column(0))
            self._dicts[key] = d
        return d

    # -- data --

    def _stats_path(self, table: str) -> str:
        return self.paths[table] + ".stats.json"

    def stripe_stats(self, table: str) -> List[dict]:
        """[{rows, min: {col: v}, max: {col: v}}, ...] per stripe, from
        the sidecar (written by the writer / derived once for foreign
        files). Values are JSON-native; dates serialize as ISO strings,
        which order correctly under string comparison."""
        got = self._stripe_stats_cache.get(table)
        if got is not None:
            return got
        path = self.paths[table]
        side = self._stats_path(table)
        if os.path.exists(side) and os.path.getmtime(side) >= os.path.getmtime(path):
            with open(side) as fh:
                got = json.load(fh)
        else:
            got = _derive_stripe_stats(self._orc.ORCFile(path))
            try:
                with open(side, "w") as fh:
                    json.dump(got, fh)
            except OSError:
                pass  # read-only location: keep in memory only
        self._stripe_stats_cache[table] = got
        return got

    @staticmethod
    def _stripe_refuted(st: dict, predicate: Predicate) -> bool:
        """True when the stripe's min/max refute ANY conjunct (reference
        TupleDomainOrcPredicate.matches)."""
        import decimal as _dec

        def numeric_bound(b, v):
            # decimal bounds are stored as exact strings; re-parse them
            # when compared against a numeric hint value
            if isinstance(b, str) and isinstance(v, (int, float, _dec.Decimal)):
                try:
                    return _dec.Decimal(b)
                except _dec.InvalidOperation:
                    return b
            return b

        def canon(v):
            if hasattr(v, "isoformat"):
                return v.isoformat()
            if isinstance(v, bool):
                return int(v)
            return v

        for col, op, value in predicate:
            mn = st["min"].get(col)
            mx = st["max"].get(col)
            if mn is None or mx is None:
                continue
            if op == "in":
                if not value:
                    return True  # empty IN-list matches nothing
                try:
                    vals = [canon(v) for v in value]
                    if vals and all(v < numeric_bound(mn, v) or v > numeric_bound(mx, v)
                                    for v in vals):
                        return True
                except TypeError:
                    pass  # incomparable: keep the stripe
                continue
            value = canon(value)
            mn = numeric_bound(mn, value)
            mx = numeric_bound(mx, value)
            try:
                if op == "eq" and (value < mn or value > mx):
                    return True
                if op == "lt" and mn >= value:
                    return True
                if op == "le" and mn > value:
                    return True
                if op == "gt" and mx <= value:
                    return True
                if op == "ge" and mx < value:
                    return True
            except TypeError:
                continue  # incomparable: keep the stripe
        return False

    def scan(self, table: str, start: int, stop: int, pad_to: Optional[int] = None,
             columns: Optional[List[str]] = None,
             predicate: Optional[Predicate] = None) -> Page:
        import pyarrow as pa

        f = self._file(table)
        stop = min(stop, f.nrows)
        names = columns or [fld.name for fld in f.schema]
        pieces = []
        if start < stop:  # an out-of-range split decodes nothing
            offset = 0
            read = skipped = 0
            for s, st in enumerate(self.stripe_stats(table)):
                s_start, s_stop = offset, offset + st["rows"]
                offset = s_stop
                if s_stop <= start or s_start >= stop:
                    continue
                if predicate and self._stripe_refuted(st, predicate):
                    skipped += 1
                    continue
                read += 1
                tbl = f.read_stripe(s, columns=names)
                lo = max(start - s_start, 0)
                hi = min(stop - s_start, tbl.num_rows)
                if hi > lo:
                    pieces.append(tbl.slice(lo, hi - lo))
            # pruning observability (the streaming executor surfaces these
            # in EXPLAIN ANALYZE; the units here are STRIPES)
            self.last_scan_files_read = read
            self.last_scan_files_skipped = skipped
        if pieces:
            tb = pa.Table.from_batches(pieces)
        else:
            # out of range, or every overlapping stripe pruned
            tb = f.schema.empty_table().select(names)
        return arrow_table_to_page(tb, names, tb.num_rows, pad_to,
                                   lambda name: self._dictionary(table, name), self.device)


def _derive_stripe_stats(f) -> List[dict]:
    """Read each stripe once and record rows + per-column min/max for
    primitive columns (the sidecar payload)."""
    import pyarrow as pa
    import pyarrow.compute as pc

    out = []
    for s in range(f.nstripes):
        tbl = f.read_stripe(s)
        mins: Dict[str, object] = {}
        maxs: Dict[str, object] = {}
        for name in tbl.schema.names:
            try:
                mm = pc.min_max(tbl.column(name))
            except pa.ArrowNotImplementedError:  # a column with no order
                continue
            for label, v in (("min", mm["min"].as_py()), ("max", mm["max"].as_py())):
                if v is None:
                    continue
                if hasattr(v, "isoformat"):
                    v = v.isoformat()
                elif type(v).__name__ == "Decimal":
                    # a float would round the bound and could prune stripes
                    # holding boundary rows: keep decimals exact (the
                    # comparator re-parses; hints carry Decimal values)
                    v = str(v)
                elif isinstance(v, (bytes, bytearray)):
                    continue
                (mins if label == "min" else maxs)[name] = v
        out.append({"rows": tbl.num_rows, "min": mins, "max": maxs})
    return out


def write_table_orc(page, path: str, stripe_size: int = 1 << 16):
    """Engine Page -> ORC file (test fixture / writer seed)."""
    from pyarrow import orc

    orc.write_table(page_to_arrow(page), path, stripe_size=stripe_size)
