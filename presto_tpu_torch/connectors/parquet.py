"""Parquet connector: columnar files -> device Pages (torch counterpart of
presto_tpu/connectors/parquet.py).

Re-designed equivalent of the reference's Parquet reader stack
(presto-parquet/ ParquetReader + column readers, wired through
presto-hive's HivePageSourceProvider): pyarrow does the host-side decode
(decompression, encodings) and this module maps whole arrow buffers onto
the engine's Block layout on the catalog's device ("cuda" unless the
caller passes "cpu"):

  int/float/bool/date/timestamp -> storage arrays; validity -> bool masks
  decimal(p<=18)  -> int64 scaled units (the low word of decimal128)
  decimal(p>18)   -> two int64 lanes (ops/decimal128.py layout)
  string          -> int32 codes over a sorted dictionary (one
                     vectorised lookup per column, no per-value Python)

Every conversion works on whole columns: decimals from arrow's decimal128
words (two's complement, so the sign rides along), strings through
`pc.index_in` against the sorted dictionary, dates through one cast. The
writer (`page_to_arrow`) is the inverse and writes the JAX package's
logical schema: `string`, `decimal128(p, s)`, `date32`, so either package
reads the other's files.

Pushdown (reference TupleDomain row-group pruning): `scan(...)` maps a row
range onto parquet row groups, skips groups whose min/max statistics
refute the predicate hint, and reads only the requested columns.

pyarrow is imported inside the functions that use it, never when the
module is imported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import types as T
from ..page import Block, Page, _pad_block, to_numpy
from .spi import Predicate, WritableConnector, WriteError


def _type_to_arrow(typ: T.Type):
    """Engine type -> arrow type (writer-side inverse of _arrow_to_type)."""
    import pyarrow as pa

    if isinstance(typ, T.VarcharType):
        return pa.string()
    if isinstance(typ, T.DecimalType):
        return pa.decimal128(typ.precision, typ.scale)
    if isinstance(typ, T.DateType):
        return pa.date32()
    if isinstance(typ, T.TimestampType):
        return pa.timestamp("us")
    if isinstance(typ, T.BooleanType):
        return pa.bool_()
    if isinstance(typ, T.DoubleType):
        return pa.float64()
    if isinstance(typ, T.RealType):
        return pa.float32()
    if isinstance(typ, T.IntegerType):
        return pa.int32()
    if isinstance(typ, T.SmallintType):
        return pa.int16()
    if isinstance(typ, T.TinyintType):
        return pa.int8()
    return pa.int64()


def _arrow_to_type(at) -> T.Type:
    import pyarrow as pa

    if pa.types.is_dictionary(at):
        at = at.value_type
    if pa.types.is_int64(at):
        return T.BIGINT
    if pa.types.is_int32(at):
        return T.INTEGER
    if pa.types.is_int16(at):
        return T.SMALLINT
    if pa.types.is_int8(at):
        return T.TINYINT
    if pa.types.is_float64(at):
        return T.DOUBLE
    if pa.types.is_float32(at):
        return T.REAL
    if pa.types.is_boolean(at):
        return T.BOOLEAN
    if pa.types.is_date32(at):
        return T.DATE
    if pa.types.is_timestamp(at):
        return T.TIMESTAMP
    if pa.types.is_decimal(at):
        return T.DecimalType(at.precision, at.scale)
    if pa.types.is_string(at) or pa.types.is_large_string(at):
        return T.VARCHAR
    raise NotImplementedError(f"unsupported parquet type {at}")


def _decimal_ints(arr) -> Tuple[np.ndarray, np.ndarray]:
    """Arrow decimal128 column -> (hi int64, lo uint64): the two words of
    each value's 2^64-radix little-endian two's-complement storage."""
    import pyarrow as pa

    parts = arr.chunks if isinstance(arr, pa.ChunkedArray) else [arr]
    his, los = [], []
    for chunk in parts:
        raw = np.frombuffer(chunk.buffers()[1], dtype=np.uint64)
        off = chunk.offset
        los.append(raw[0::2][off: off + len(chunk)])
        his.append(raw[1::2][off: off + len(chunk)].view(np.int64))
    if not parts:
        return np.empty(0, np.int64), np.empty(0, np.uint64)
    return np.concatenate(his), np.concatenate(los)


def _plain_strings(col):
    """A string column as plain (not dictionary, not large) strings."""
    import pyarrow as pa

    if pa.types.is_dictionary(col.type):
        col = col.cast(col.type.value_type)
    if pa.types.is_large_string(col.type):
        col = col.cast(pa.string())
    return col


def build_sorted_dictionary(col):
    """Distinct non-null strings of an arrow column, sorted:
    (tuple, arrow string array of the same entries) — shared by the
    parquet, ORC, Hive and shard-store readers. Arrow sorts strings by
    their UTF-8 bytes, which is code-point order, Python's order."""
    import pyarrow.compute as pc

    uniq = pc.unique(_plain_strings(col)).drop_null()
    uniq = uniq.take(pc.array_sort_indices(uniq))
    return tuple(uniq.to_pylist()), uniq


def _filled(arr, value):
    """`arr` with its nulls replaced by `value` (storage of a NULL slot)."""
    import pyarrow.compute as pc

    return pc.fill_null(arr, value) if arr.null_count else arr


def arrow_column_to_block(col, typ: T.Type, dictionary_provider, device) -> Block:
    """One arrow column (Array or ChunkedArray) as a Block of `typ` on
    `device`, converted as whole buffers. dictionary_provider() ->
    (sorted tuple, sorted arrow array) for a varchar column."""
    import pyarrow as pa
    import pyarrow.compute as pc

    valid = None
    if col.null_count:
        valid = np.asarray(pc.is_valid(col).to_numpy(zero_copy_only=False), np.bool_)
    if isinstance(typ, T.VarcharType):
        d, d_arr = dictionary_provider()
        codes = pc.index_in(_plain_strings(col), value_set=d_arr)
        data = np.asarray(_filled(codes, 0).to_numpy(zero_copy_only=False), np.int32)
        return Block.from_numpy(data, typ, valid, dictionary=d, device=device)
    if isinstance(typ, T.DecimalType):
        hi64, lo64 = _decimal_ints(col)
        if typ.is_long:
            # 2^64-radix -> the engine's 2^32-radix lanes
            our_hi = (hi64 << 32) | (lo64 >> np.uint64(32)).astype(np.int64)
            our_lo = (lo64 & np.uint64(0xFFFFFFFF)).astype(np.int64)
            data = np.stack([our_hi, our_lo], axis=-1)
        else:
            data = lo64.view(np.int64)
        if valid is not None:
            data = np.where(valid if data.ndim == 1 else valid[:, None], data, 0)
        return Block.from_numpy(data, typ, valid, device=device)
    if isinstance(typ, T.TimestampType):
        col = col.cast(pa.timestamp("us")).cast(pa.int64())
    elif isinstance(typ, T.DateType):
        col = col.cast(pa.int32())
    elif pa.types.is_dictionary(col.type):
        col = col.cast(col.type.value_type)
    fill = False if isinstance(typ, T.BooleanType) else 0
    data = _filled(col, fill).to_numpy(zero_copy_only=False)
    return Block.from_numpy(np.asarray(data), typ, valid, device=device)


def arrow_table_to_page(tb, names, count, pad_to, dictionary_provider,
                        device="cuda", types=None) -> Page:
    """Arrow table -> engine Page on `device` (shared by the parquet, ORC,
    Hive and shard-store readers). dictionary_provider(column) -> (sorted
    tuple, sorted arrow array); `types` ({column: Type}) overrides the
    types read off the arrow schema."""
    blocks = []
    for name in names:
        col = tb.column(name)
        typ = types[name] if types is not None else _arrow_to_type(col.type)
        blk = arrow_column_to_block(col, typ, lambda n=name: dictionary_provider(n), device)
        if pad_to is not None and pad_to > count:
            blk = _pad_block(blk, pad_to)
        blocks.append(blk)
    return Page.from_blocks(blocks, names, count=count, device=device)


def _validity_buffer(valid: Optional[np.ndarray]):
    import pyarrow as pa

    if valid is None:
        return None
    return pa.py_buffer(np.packbits(valid, bitorder="little").tobytes())


def block_to_arrow(b: Block, n: int):
    """The first `n` rows of a Block as one arrow array of the JAX
    package's logical type, whole buffers at a time."""
    import pyarrow as pa

    data = to_numpy(b.data[:n])
    valid = None if b.valid is None else to_numpy(b.valid[:n])
    if valid is not None and valid.all():
        valid = None
    mask = None if valid is None else ~valid
    typ = b.type
    if isinstance(typ, T.VarcharType):
        d = b.dictionary or ()
        entries = pa.array(d if isinstance(d, tuple) else list(d), pa.string())
        if len(entries) == 0:
            return pa.nulls(n, pa.string())
        codes = data.astype(np.int32)
        if mask is not None:
            codes = np.where(mask, 0, codes)
        return entries.take(pa.array(codes, mask=mask))
    if isinstance(typ, T.DecimalType):
        words = np.empty((n, 2), np.uint64)
        if typ.is_long:
            hi32, lo32 = data[:, 0].astype(np.int64), data[:, 1].astype(np.int64)
            words[:, 0] = ((hi32 << 32) | lo32).view(np.uint64)
            words[:, 1] = (hi32 >> 32).view(np.uint64)
        else:
            v = data.astype(np.int64)
            words[:, 0] = v.view(np.uint64)
            words[:, 1] = (v >> 63).view(np.uint64)
        return pa.Array.from_buffers(
            pa.decimal128(typ.precision, typ.scale), n,
            [_validity_buffer(valid), pa.py_buffer(words.tobytes())],
            null_count=-1 if valid is None else int(n - valid.sum()))
    if isinstance(typ, T.DateType):
        return pa.array(data.astype(np.int32), type=pa.date32(), mask=mask)
    if isinstance(typ, T.TimestampType):
        return pa.array(data.astype(np.int64), type=pa.timestamp("us"), mask=mask)
    return pa.array(data, type=_type_to_arrow(typ), mask=mask)


def page_to_arrow(page):
    """Engine Page -> in-memory pyarrow Table (shared by file writers)."""
    import pyarrow as pa

    n = int(page.count)
    return pa.table({name: block_to_arrow(b, n) for name, b in zip(page.names, page.blocks)})


def write_table_parquet(page_or_table, path: str, row_group_size: int = 1 << 17):
    """Write engine data to parquet (test fixture + the seed of a writer
    path; reference presto-hive ParquetPageSink analog)."""
    import pyarrow.parquet as pq

    pq.write_table(page_to_arrow(page_or_table), path, row_group_size=row_group_size)


class FileWriteMixin:
    """Shared write protocol for single-file-per-table catalogs
    (reference ConnectorPageSink; INSERT rewrites table = existing +
    appended rows). Subclasses define `_ext`, `_encode_write(arrow_table,
    path)`, and `_read_all(table) -> arrow Table`."""

    def _write_path(self, table: str) -> str:
        if table in self.paths:
            return self.paths[table]
        if self.directory is None:
            raise WriteError(f"{self.name} catalog is read-only (no directory configured)")
        import os

        return os.path.join(self.directory, f"{table}.{self._ext}")

    def _invalidate(self, table: str) -> None:
        self._files.pop(table, None)
        for key in [k for k in self._dicts if k[0] == table]:
            self._dicts.pop(key)
        self.forget_column_stats(table)

    def _write(self, table: str, arrow_table) -> None:
        path = self._write_path(table)
        self._encode_write(arrow_table, path)
        self.paths[table] = path
        self._invalidate(table)

    def create_table(self, table: str, schema: Dict[str, T.Type]) -> None:
        import pyarrow as pa

        self._write(table, pa.table({name: pa.array([], type=_type_to_arrow(typ))
                                     for name, typ in schema.items()}))

    def create_table_from_page(self, table: str, page: Page) -> None:
        self._write(table, page_to_arrow(page))

    def append(self, table: str, page: Page) -> None:
        import pyarrow as pa

        existing = self._read_all(table)
        # unify: cast appended columns to the file schema's types
        new = page_to_arrow(page).select(existing.column_names).cast(existing.schema)
        self._write(table, pa.concat_tables([existing, new]))

    def replace(self, table: str, page: Page) -> None:
        self._write(table, page_to_arrow(page))

    def drop_table(self, table: str) -> None:
        import os

        path = self.paths.pop(table)
        self._invalidate(table)
        if os.path.exists(path):
            os.remove(path)

    def page(self, table: str) -> Page:
        return self.scan(table, 0, self.row_count(table))

    def page_columns(self, table: str, columns: List[str]) -> Page:
        return self.scan(table, 0, self.row_count(table), columns=columns)


class ParquetCatalog(FileWriteMixin, WritableConnector):
    """tables: {name: parquet file path}. With `directory` set, the
    catalog is WRITABLE: CREATE TABLE / CTAS / INSERT / DELETE produce
    parquet files under it (reference: HivePageSink + ParquetWriter —
    pyarrow is the bootstrap encoder, matching the read path). Pages land
    on `device`."""

    name = "parquet"
    _ext = "parquet"

    def __init__(self, tables: Dict[str, str], unique: Optional[Dict[str, list]] = None,
                 directory: Optional[str] = None, device="cuda"):
        import pyarrow.parquet as pq
        import torch

        self.paths = dict(tables)
        self.unique = unique or {}
        self.directory = directory
        self.device = torch.device(device)
        self._files: Dict[str, object] = {}
        self._dicts: Dict[Tuple[str, str], tuple] = {}
        self._pq = pq

    def _encode_write(self, arrow_table, path: str) -> None:
        self._pq.write_table(arrow_table, path, row_group_size=1 << 17)

    def _read_all(self, table: str):
        return self._file(table).read()

    # -- metadata --

    def _file(self, table: str):
        f = self._files.get(table)
        if f is None:
            f = self._pq.ParquetFile(self.paths[table])
            self._files[table] = f
        return f

    def table_names(self) -> List[str]:
        return list(self.paths)

    def schema(self, table: str) -> Dict[str, T.Type]:
        return {f.name: _arrow_to_type(f.type) for f in self._file(table).schema_arrow}

    def row_count(self, table: str) -> int:
        return self._file(table).metadata.num_rows

    def exact_row_count(self, table: str) -> int:
        return self._file(table).metadata.num_rows

    def unique_columns(self, table: str):
        return self.unique.get(table, [])

    # -- string dictionaries (file-level, sorted, cached) --

    def _dictionary(self, table: str, column: str):
        key = (table, column)
        d = self._dicts.get(key)
        if d is None:
            d = build_sorted_dictionary(self._file(table).read(columns=[column]).column(0))
            self._dicts[key] = d
        return d

    # -- data --

    def scan(self, table: str, start: int, stop: int, pad_to: Optional[int] = None,
             columns: Optional[List[str]] = None,
             predicate: Optional[Predicate] = None) -> Page:
        import pyarrow as pa

        pf = self._file(table)
        md = pf.metadata
        stop = min(stop, md.num_rows)
        names = columns or [f.name for f in pf.schema_arrow]

        # map [start, stop) onto row groups; prune by statistics
        groups = []
        offset = 0
        for g in range(md.num_row_groups):
            rg = md.row_group(g)
            g_start, g_stop = offset, offset + rg.num_rows
            offset = g_stop
            if g_stop <= start or g_start >= stop:
                continue
            if predicate and self._refuted(rg, pf, predicate):
                continue
            groups.append((g, g_start))

        if not groups:
            tb = pf.schema_arrow.empty_table().select(names)
            return self._to_page(table, tb, names, 0, pad_to)

        tb = pf.read_row_groups([g for g, _ in groups], columns=names)
        # with pruning, skipped groups shift positions: deliver the kept
        # rows that fall in [start, stop) of the ORIGINAL coordinates by
        # assembling per-group slices
        pieces = []
        pos = 0
        for g, g_start in groups:
            g_rows = md.row_group(g).num_rows
            lo = max(start - g_start, 0)
            hi = min(stop - g_start, g_rows)
            if hi > lo:
                pieces.append(tb.slice(pos + lo, hi - lo))
            pos += g_rows
        tb = pa.concat_tables(pieces) if pieces else tb.slice(0, 0)
        return self._to_page(table, tb, names, tb.num_rows, pad_to)

    @staticmethod
    def _refuted(rg, pf, predicate: Predicate) -> bool:
        """True if the row group's min/max statistics refute ANY conjunct
        (reference TupleDomainParquetPredicate.matches)."""
        stats_by_col = {}
        for i in range(rg.num_columns):
            c = rg.column(i)
            if c.statistics is not None and c.statistics.has_min_max:
                stats_by_col[c.path_in_schema] = c.statistics
        for col, op, value in predicate:
            st = stats_by_col.get(col)
            if st is None:
                continue
            mn, mx = st.min, st.max
            try:
                if op == "in":
                    # refuted when NO candidate value can be in the group
                    if all(v < mn or v > mx for v in value):
                        return True
                    continue
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
                continue  # incomparable statistics: keep the group
        return False

    def _to_page(self, table, tb, names, count, pad_to) -> Page:
        return arrow_table_to_page(tb, names, count, pad_to,
                                   lambda name: self._dictionary(table, name), self.device)
