"""RCFile connector: row-columnar files -> device Pages (torch counterpart
of presto_tpu/connectors/rcfile.py).

Re-designed equivalent of presto-rcfile (RcFileReader/Writer with text
and binary column encodings). RCFile's layout — row groups holding
column-major chunks, a sync marker between groups, per-chunk lengths —
is written and read here directly, byte for byte the JAX package's
layout (magic, a JSON header with the schema, sync-delimited row groups
of length-prefixed column chunks), so either package reads the other's
files. The reader maps row ranges onto row groups by their stored row
counts and decodes only the requested columns (the columnar skip the
reference's RcFileReader exploits). It needs no library beyond numpy.

Encodings: fixed-width little-endian storage (int64/int32/int16/int8,
float64/float32, bool bytes, dates as int32 days, short decimals as
scaled int64; a long decimal as its two int64 lanes), varchar as u32
offsets + utf-8 bytes, NULLs as a packed validity bitmap after the
payload. Both directions work on whole columns: strings are gathered and
split with index arithmetic, never a Python loop over rows.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import types as T
from ..page import _NP_DTYPE, Block, Page, _pad_block, to_numpy
from .spi import WritableConnector, WriteError

_MAGIC = b"RCF\x01tpu"
_SYNC = b"\xde\xad\xbe\xef\xf0\x0d\xca\xfe" * 2  # 16-byte sync marker
_ROWS_PER_GROUP = 1 << 16


def _type_name(t: T.Type) -> str:
    return str(t)


def _np_dtype(typ: T.Type):
    return np.dtype(_NP_DTYPE[typ.storage_dtype])


def _gather_bytes(blob: np.ndarray, starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """blob[starts[i]: starts[i] + lengths[i]] of every i, concatenated."""
    total = int(lengths.sum())
    if total == 0:
        return np.empty(0, np.uint8)
    out_starts = np.cumsum(lengths) - lengths
    src = np.repeat(starts - out_starts, lengths) + np.arange(total)
    return blob[src]


def _encode_column(data: np.ndarray, valid: Optional[np.ndarray]) -> bytes:
    """One column chunk: (payload length, bitmap length), payload, bitmap."""
    payload = np.ascontiguousarray(data).tobytes()
    vbits = np.packbits(valid).tobytes() if valid is not None else b""
    return struct.pack("<II", len(payload), len(vbits)) + payload + vbits


def _encode_strings(entries: List[bytes], codes: np.ndarray) -> np.ndarray:
    """u32 offsets + utf-8 bytes of the rows' strings (rows given as codes
    into `entries`, the encoded dictionary; -1 is the empty NULL slot)."""
    lens = np.array([len(e) for e in entries] + [0], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    dict_blob = np.frombuffer(b"".join(entries), np.uint8)
    row_lens = lens[codes]
    offs = np.zeros(len(codes) + 1, np.uint32)
    np.cumsum(row_lens, out=offs[1:])
    blob = _gather_bytes(dict_blob, starts[codes], row_lens)
    return np.concatenate([offs.view(np.uint8), blob])


def _decode_strings(payload: bytes, n: int) -> np.ndarray:
    """The chunk's n strings as a numpy bytes array ('S' dtype)."""
    offs = np.frombuffer(payload[: 4 * (n + 1)], np.uint32).astype(np.int64)
    blob = np.frombuffer(payload[4 * (n + 1):], np.uint8)
    lens = np.diff(offs)
    width = max(int(lens.max()) if n else 0, 1)
    if np.any(blob == 0):
        # a NUL inside a value: the fixed-width 'S' form would drop
        # trailing NULs, so slice these chunks value by value
        return np.array([bytes(blob[offs[i]:offs[i + 1]]) for i in range(n)], object)
    mat = np.zeros((n, width), np.uint8)
    rows = np.repeat(np.arange(n), lens)
    cols = np.arange(len(rows)) - np.repeat(offs[:-1] - offs[0], lens)
    mat[rows, cols] = _gather_bytes(blob, offs[:-1] - offs[0], lens)
    return mat.view(f"S{width}").reshape(n)


def _decode_column(buf: bytes, off: int, typ: T.Type,
                   n: int) -> Tuple[np.ndarray, Optional[np.ndarray], int]:
    plen, vlen = struct.unpack_from("<II", buf, off)
    off += 8
    payload = buf[off: off + plen]
    off += plen
    valid = None
    if vlen:
        bits = np.frombuffer(buf[off: off + vlen], np.uint8)
        valid = np.unpackbits(bits)[:n].astype(bool)
        off += vlen
    if isinstance(typ, T.VarcharType):
        return _decode_strings(payload, n), valid, off
    lanes = getattr(typ, "lanes", 1)
    data = np.frombuffer(payload, _np_dtype(typ), count=n * lanes)
    return (data.reshape(n, lanes) if lanes > 1 else data), valid, off


def _strings_block(pieces: List[np.ndarray], valid: np.ndarray, device) -> Block:
    """A varchar Block from the scanned strings: codes over the sorted
    distinct non-NULL values (the JAX package's Block.from_strings
    dictionary), found by one np.unique over the bytes (UTF-8 byte order
    is code-point order, Python's string order)."""
    n = len(valid)
    if any(p.dtype == object for p in pieces):
        strs = np.concatenate([p.astype(object) for p in pieces]) if pieces else np.empty(0, object)
    else:
        strs = np.concatenate(pieces) if pieces else np.empty(0, "S1")
    codes = np.zeros(n, np.int32)
    uniq, inv = np.unique(strs[valid], return_inverse=True)
    codes[valid] = inv.reshape(-1)
    dictionary = tuple(bytes(u).decode("utf-8") for u in uniq)
    return Block.from_numpy(codes, T.VARCHAR, None if valid.all() else valid,
                            dictionary, device)


class RcFileCatalog(WritableConnector):
    """tables: {name: rcfile path}; with `directory` set the catalog is
    writable (CTAS/INSERT/DELETE produce .rcf files). Pages land on
    `device`."""

    name = "rcfile"
    _ext = "rcf"

    def __init__(self, tables: Dict[str, str], directory: Optional[str] = None,
                 device="cuda"):
        import torch

        self.paths = dict(tables)
        self.directory = directory
        self.device = torch.device(device)
        self._meta_cache: Dict[str, dict] = {}

    # -- file structure --

    def _read_header(self, table: str) -> dict:
        got = self._meta_cache.get(table)
        if got is not None:
            return got
        path = self.paths[table]
        with open(path, "rb") as f:
            if f.read(len(_MAGIC)) != _MAGIC:
                raise WriteError(f"{path}: not an rcfile")
            (hlen,) = struct.unpack("<I", f.read(4))
            header = json.loads(f.read(hlen))
            # group directory: walk the sync markers (each group's row
            # count and byte length follow its marker), seeking past bodies
            groups = []
            size = os.fstat(f.fileno()).st_size
            pos = f.tell()
            while pos < size:
                head = f.read(len(_SYNC) + 8)
                if head[:len(_SYNC)] != _SYNC:
                    raise WriteError(f"{path}: lost sync at {pos}")
                n, glen = struct.unpack_from("<II", head, len(_SYNC))
                pos += len(head)
                groups.append({"rows": n, "offset": pos, "length": glen})
                pos += glen
                f.seek(pos)
        header["groups"] = groups
        self._meta_cache[table] = header
        return header

    # -- metadata --

    def table_names(self) -> List[str]:
        return list(self.paths)

    def schema(self, table: str) -> Dict[str, T.Type]:
        return {c: T.parse_type(s) for c, s in self._read_header(table)["schema"].items()}

    def row_count(self, table: str) -> int:
        return sum(g["rows"] for g in self._read_header(table)["groups"])

    def exact_row_count(self, table: str) -> int:
        return self.row_count(table)

    def unique_columns(self, table: str):
        return []

    # -- reads --

    def page(self, table: str) -> Page:
        return self.scan(table, 0, self.row_count(table))

    def page_columns(self, table: str, columns: List[str]) -> Page:
        return self.scan(table, 0, self.row_count(table), columns=columns)

    def scan(self, table: str, start: int, stop: int, pad_to=None, columns=None,
             predicate=None) -> Page:
        h = self._read_header(table)
        schema = self.schema(table)
        names = list(columns) if columns is not None else list(schema)
        stop = min(stop, self.row_count(table))
        count = max(stop - start, 0)
        pieces: Dict[str, list] = {c: [] for c in names}
        vpieces: Dict[str, list] = {c: [] for c in names}
        with open(self.paths[table], "rb") as f:
            offset = 0
            for g in h["groups"]:
                g_start, g_stop = offset, offset + g["rows"]
                offset = g_stop
                lo, hi = max(start, g_start), min(stop, g_stop)
                if lo >= hi:
                    continue
                pos = g["offset"]
                for c in schema:
                    # column chunks are length-prefixed: seek past the
                    # unrequested ones WITHOUT reading them (the
                    # row-columnar win)
                    f.seek(pos)
                    head = f.read(8)
                    plen, vlen = struct.unpack("<II", head)
                    pos += 8 + plen + vlen
                    if c not in pieces:
                        continue
                    vals, valid, _ = _decode_column(head + f.read(plen + vlen), 0, schema[c],
                                                    g["rows"])
                    sl = slice(lo - g_start, hi - g_start)
                    pieces[c].append(vals[sl])
                    vpieces[c].append(valid[sl] if valid is not None else np.ones(hi - lo, bool))
        blocks = []
        for c in names:
            typ = schema[c]
            valid = np.concatenate(vpieces[c]) if vpieces[c] else np.ones(0, bool)
            if isinstance(typ, T.VarcharType):
                blk = _strings_block(pieces[c], valid, self.device)
            else:
                lanes = getattr(typ, "lanes", 1)
                empty = np.empty((0, lanes) if lanes > 1 else 0, _np_dtype(typ))
                data = np.concatenate(pieces[c]) if pieces[c] else empty
                blk = Block.from_numpy(data, typ, None if valid.all() else valid,
                                       device=self.device)
            if pad_to is not None and pad_to > count:
                blk = _pad_block(blk, pad_to)
            blocks.append(blk)
        return Page.from_blocks(blocks, names, count=count, device=self.device)

    # -- writes --

    def _write_path(self, table: str) -> str:
        if table in self.paths:
            return self.paths[table]
        if self.directory is None:
            raise WriteError("rcfile catalog is read-only (no directory)")
        path = os.path.join(self.directory, f"{table}.{self._ext}")
        self.paths[table] = path
        return path

    @staticmethod
    def _host_columns(page: Page, n: int):
        """{name: (storage or string codes, valid or None, encoded
        dictionary)} of the page's live rows; NULL slots hold zeros (and
        the empty string), as the JAX package writes them."""
        cols = {}
        for name, b in zip(page.names, page.blocks):
            data = to_numpy(b.data[:n])
            valid = None if b.valid is None else to_numpy(b.valid[:n]).astype(bool)
            if valid is not None and valid.all():
                valid = None
            entries = None
            if isinstance(b.type, T.VarcharType):
                d = b.dictionary or ()
                entries = [s.encode("utf-8") for s in d]
                data = data.astype(np.int64)
                if valid is not None:
                    data = np.where(valid, data, len(entries))  # the empty slot
            elif valid is not None:
                data = np.where(valid if data.ndim == 1 else valid[:, None], data,
                                np.zeros((), data.dtype))
            cols[name] = (data, valid, entries)
        return cols

    def write_pages(self, table: str, page: Page) -> None:
        path = self._write_path(table)
        schema = {n: b.type for n, b in zip(page.names, page.blocks)}
        n = int(page.count)
        cols = self._host_columns(page, n)
        hjson = json.dumps({"schema": {c: _type_name(t) for c, t in schema.items()}}).encode()
        with open(path, "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<I", len(hjson)))
            f.write(hjson)
            for g0 in range(0, max(n, 1), _ROWS_PER_GROUP):
                g1 = min(g0 + _ROWS_PER_GROUP, n)
                chunks = []
                for c, t in schema.items():
                    data, valid, entries = cols[c]
                    gvalid = None if valid is None else valid[g0:g1]
                    if entries is not None:
                        enc = _encode_strings(entries, data[g0:g1])
                    else:
                        enc = data[g0:g1].astype(_np_dtype(t), copy=False)
                    chunks.append(_encode_column(enc, gvalid))
                body = b"".join(chunks)
                f.write(_SYNC)
                f.write(struct.pack("<II", g1 - g0, len(body)))
                f.write(body)
        self._meta_cache.pop(table, None)
        self.forget_column_stats(table)

    def create_table(self, table: str, schema: Dict[str, T.Type]) -> None:
        from ..ops.union import empty_page

        if table in self.paths:
            raise WriteError(f"table {table} exists")
        self.write_pages(table, empty_page(schema, self.device))

    def create_table_from_page(self, table: str, page: Page) -> None:
        if table in self.paths:
            raise WriteError(f"table {table} exists")
        self.write_pages(table, page)

    def append(self, table: str, page: Page) -> None:
        from ..ops.union import concat_pages

        cur = self.page(table)
        page = page.to(self.device)
        self.write_pages(table, page if int(cur.count) == 0 else concat_pages([cur, page]))

    def replace(self, table: str, page: Page) -> None:
        self.write_pages(table, page)

    def drop_table(self, table: str) -> None:
        path = self.paths.pop(table, None)
        if path is None:
            raise WriteError(f"unknown table {table}")
        self._meta_cache.pop(table, None)
        self.forget_column_stats(table)
        if os.path.exists(path):
            os.remove(path)
