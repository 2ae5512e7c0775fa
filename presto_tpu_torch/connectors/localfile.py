"""Local-file connector: query CSV / TSV / JSONL / Avro / raw files as
tables (torch counterpart of presto_tpu/connectors/localfile.py).

Re-designed equivalent of presto-local-file combined with the row
decoders of presto-record-decoder (csv/json/avro/raw decoders shared by
the kafka/redis connectors). A directory is a catalog: every *.csv /
*.tsv / *.jsonl / *.avro / *.raw file is a table named after the file
stem. Schemas are inferred from the data (or supplied explicitly); each
table is decoded once into a Page on the catalog's device and cached, so
repeated queries scan device-resident data like every other connector.
Typed columns convert as whole numpy arrays (one parse per column, one
np.unique for a varchar dictionary); needs no library beyond numpy.
"""

from __future__ import annotations

import csv
import datetime
import json
import os
import struct as _st
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import types as T
from ..page import Block, Page
from .spi import Connector

_EPOCH = datetime.date(1970, 1, 1)


def _infer_type(values: Sequence[Optional[str]]) -> T.Type:
    """Widest type that parses every non-null sample."""
    seen = [v for v in values if v is not None and v != ""]
    if not seen:
        return T.VARCHAR

    def all_match(fn) -> bool:
        try:
            for v in seen:
                fn(v)
            return True
        except (ValueError, TypeError):
            return False

    if all_match(int):
        return T.BIGINT
    if all_match(float):
        return T.DOUBLE
    if all_match(datetime.date.fromisoformat):
        return T.DATE
    lowered = {str(v).lower() for v in seen}
    if lowered <= {"true", "false"}:
        return T.BOOLEAN
    return T.VARCHAR


def _dates(strs: np.ndarray) -> np.ndarray:
    """ISO dates -> int32 days since 1970-01-01 (numpy's parser; any form
    it refuses goes through date.fromisoformat, as the JAX package's)."""
    try:
        return np.array(strs, "datetime64[D]").astype(np.int64).astype(np.int32)
    except ValueError:
        return np.array([(datetime.date.fromisoformat(str(v)) - _EPOCH).days for v in strs],
                        np.int32)


def _to_block(values: List, typ: T.Type, device) -> Block:
    """A column of strings (None or "" = NULL) as a Block of `typ`,
    parsed as one array."""
    strs = np.array(["" if v is None else str(v) for v in values], dtype=str)
    valid = strs != ""
    v = None if valid.all() else valid
    if isinstance(typ, T.VarcharType):
        codes = np.zeros(len(strs), np.int32)
        uniq, inv = np.unique(strs[valid], return_inverse=True)
        codes[valid] = inv.reshape(-1)
        return Block.from_numpy(codes, T.VARCHAR, v, tuple(str(u) for u in uniq), device)
    if isinstance(typ, T.DateType):
        data = np.zeros(len(strs), np.int32)
        data[valid] = _dates(strs[valid])
    elif isinstance(typ, T.BooleanType):
        data = np.char.lower(strs) == "true"
    elif T.is_floating(typ):
        data = np.zeros(len(strs), np.float64)
        data[valid] = strs[valid].astype(np.float64)
    else:
        data = np.zeros(len(strs), np.int64)
        data[valid] = [int(s) for s in strs[valid]]
    return Block.from_numpy(data, typ, v, device=device)


def read_csv(path: str, delimiter: Optional[str] = None) -> Tuple[List[str], List[List]]:
    if delimiter is None:
        delimiter = "\t" if path.endswith(".tsv") else ","
    with open(path, newline="") as f:
        rows = list(csv.reader(f, delimiter=delimiter))
    if not rows:
        return [], []
    header, data = rows[0], rows[1:]
    cols = [[r[i] if i < len(r) else None for r in data] for i in range(len(header))]
    return header, cols


def read_jsonl(path: str) -> Tuple[List[str], List[List]]:
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    names: List[str] = []
    for r in records:
        for k in r:
            if k not in names:
                names.append(k)
    return names, [[r.get(k) for r in records] for k in names]


# ---------------------------------------------------------------------------
# Avro object-container files (reference presto-record-decoder
# AvroRowDecoder / avro-tools): a binary codec written here — zigzag
# varints, [null, T] unions, null/deflate block codecs — with no avro
# library, the JAX package's codec
# ---------------------------------------------------------------------------

_AVRO_MAGIC = b"Obj\x01"


def _zz_encode(n: int) -> bytes:
    u = (n << 1) ^ (n >> 63)
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


class _AvroReader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def long(self) -> int:
        u = shift = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            u |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        return (u >> 1) ^ -(u & 1)

    def raw(self, n: int) -> bytes:
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def string(self) -> str:
        return self.raw(self.long()).decode()

    def map(self) -> dict:
        out = {}
        while True:
            n = self.long()
            if n == 0:
                return out
            if n < 0:
                self.long()  # block byte size (unused)
                n = -n
            for _ in range(n):
                k = self.string()
                out[k] = self.raw(self.long())


def _avro_read_value(r: "_AvroReader", typ):
    if isinstance(typ, list):  # union: [null, T] nullable convention
        idx = r.long()
        branch = typ[idx]
        if branch == "null":
            return None
        return _avro_read_value(r, branch)
    if isinstance(typ, dict):
        typ = typ.get("type", typ)
        return _avro_read_value(r, typ)
    if typ == "null":
        return None
    if typ == "boolean":
        return r.raw(1) != b"\x00"
    if typ in ("int", "long"):
        return r.long()
    if typ == "float":
        return _st.unpack("<f", r.raw(4))[0]
    if typ == "double":
        return _st.unpack("<d", r.raw(8))[0]
    if typ == "bytes":
        # binary rides the string layer as hex (engine-wide policy)
        return r.raw(r.long()).hex()
    if typ == "string":
        return r.string()
    raise ValueError(f"unsupported avro type {typ!r}")


def read_avro(path: str) -> Tuple[List[str], List[List]]:
    """Avro OCF -> (names, columns). Primitive record fields + nullable
    unions; null/deflate codecs."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != _AVRO_MAGIC:
        raise ValueError(f"{path}: not an avro object container file")
    r = _AvroReader(buf)
    r.pos = 4
    meta = r.map()
    sync = r.raw(16)
    schema = json.loads(meta["avro.schema"].decode())
    codec = meta.get("avro.codec", b"null").decode()
    if schema.get("type") != "record":
        raise ValueError("avro schema must be a record")
    fields = schema["fields"]
    names = [f["name"] for f in fields]
    cols: List[List] = [[] for _ in names]
    while r.pos < len(buf):
        count = r.long()
        size = r.long()
        block = r.raw(size)
        if r.raw(16) != sync:
            raise ValueError(f"{path}: bad avro sync marker")
        if codec == "deflate":
            block = zlib.decompress(block, -15)
        elif codec != "null":
            raise ValueError(f"unsupported avro codec {codec!r}")
        br = _AvroReader(block)
        for _ in range(count):
            for i, fd in enumerate(fields):
                cols[i].append(_avro_read_value(br, fd["type"]))
    return names, cols


def write_avro(path: str, names: Sequence[str], cols: Sequence[List],
               codec: str = "deflate") -> None:
    """Columns -> Avro OCF (the writer twin; nullable primitive fields,
    types inferred from python values)."""
    def typ_of(values):
        for v in values:
            if v is None:
                continue
            if isinstance(v, bool):
                return "boolean"
            if isinstance(v, int):
                return "long"
            if isinstance(v, float):
                return "double"
            if isinstance(v, bytes):
                return "bytes"
            return "string"
        return "string"

    types = [typ_of(c) for c in cols]
    schema = {
        "type": "record",
        "name": "row",
        "fields": [
            {"name": n, "type": ["null", t]}
            for n, t in zip(names, types)
        ],
    }

    def enc_value(v, t) -> bytes:
        if v is None:
            return _zz_encode(0)
        out = _zz_encode(1)
        if t == "boolean":
            return out + (b"\x01" if v else b"\x00")
        if t == "long":
            return out + _zz_encode(int(v))
        if t == "double":
            return out + _st.pack("<d", float(v))
        if t == "bytes":
            return out + _zz_encode(len(v)) + v
        b = str(v).encode()
        return out + _zz_encode(len(b)) + b

    n_rows = len(cols[0]) if cols else 0
    body = b"".join(
        enc_value(cols[i][row], types[i])
        for row in range(n_rows)
        for i in range(len(names))
    )
    if codec == "deflate":
        comp = zlib.compressobj(wbits=-15)
        body = comp.compress(body) + comp.flush()
    sync = b"\x07" * 16
    meta_entries = {
        b"avro.schema": json.dumps(schema).encode(),
        b"avro.codec": codec.encode(),
    }
    out = bytearray(_AVRO_MAGIC)
    out += _zz_encode(len(meta_entries))
    for k, v in meta_entries.items():
        out += _zz_encode(len(k)) + k + _zz_encode(len(v)) + v
    out += _zz_encode(0)
    out += sync
    if n_rows:
        out += _zz_encode(n_rows) + _zz_encode(len(body)) + body + sync
    with open(path, "wb") as f:
        f.write(bytes(out))


def read_raw(path: str, fields: Sequence[dict]) -> Tuple[List[str], List[List]]:
    """Fixed-width binary records (reference presto-record-decoder
    RawRowDecoder): `fields` = [{name, type, start, end}] byte slices per
    record; big-endian ints/doubles, space-padded varchar. The field
    spec lives in a sidecar `<table>.rawschema` JSON."""

    rec_size = max(int(f["end"]) for f in fields)
    names = [f["name"] for f in fields]
    cols: List[List] = [[] for _ in fields]
    with open(path, "rb") as fh:
        data = fh.read()
    if len(data) % rec_size:
        raise ValueError(
            f"{path}: size {len(data)} is not a multiple of the "
            f"record size {rec_size}"
        )
    for off in range(0, len(data), rec_size):
        rec = data[off:off + rec_size]
        for i, fd in enumerate(fields):
            chunk = rec[int(fd["start"]):int(fd["end"])]
            t = fd["type"].lower()
            if t in ("bigint", "long"):
                cols[i].append(_st.unpack(">q", chunk)[0])
            elif t in ("integer", "int"):
                cols[i].append(_st.unpack(">i", chunk)[0])
            elif t == "smallint":
                cols[i].append(_st.unpack(">h", chunk)[0])
            elif t == "tinyint":
                cols[i].append(_st.unpack(">b", chunk)[0])
            elif t == "double":
                cols[i].append(_st.unpack(">d", chunk)[0])
            elif t == "boolean":
                cols[i].append(chunk[0] != 0)
            else:  # varchar: space-padded bytes
                cols[i].append(chunk.decode().rstrip(" \x00"))
    return names, cols


class LocalFileCatalog(Connector):
    """tables: file stem -> path; schemas inferred at first load and
    overridable via `schemas={'table': {'col': Type}}`. Pages land on
    `device`."""

    name = "localfile"

    def __init__(self, directory: str, schemas: Optional[Dict] = None, device="cuda"):
        import torch

        self.directory = directory
        self.device = torch.device(device)
        self.schemas_override = schemas or {}
        self._paths: Dict[str, str] = {}
        for fname in sorted(os.listdir(directory)):
            stem, ext = os.path.splitext(fname)
            if ext.lower() in (".csv", ".tsv", ".jsonl", ".avro", ".raw"):
                key = stem.lower()
                if key in self._paths:
                    raise ValueError(f"duplicate table name {key!r}: "
                                     f"{os.path.basename(self._paths[key])} and {fname}")
                self._paths[key] = os.path.join(directory, fname)
        self._pages: Dict[str, Page] = {}

    def table_names(self) -> List[str]:
        return list(self._paths)

    def _load(self, table: str) -> Page:
        pg = self._pages.get(table)
        if pg is not None:
            return pg
        path = self._paths[table]
        low = path.lower()  # registration is case-insensitive; match it
        if low.endswith(".jsonl"):
            names, cols = read_jsonl(path)
        elif low.endswith(".avro"):
            names, cols = read_avro(path)
        elif low.endswith(".raw"):
            with open(path[:-4] + ".rawschema") as f:
                names, cols = read_raw(path, json.load(f))
        else:
            names, cols = read_csv(path)
        override = self.schemas_override.get(table, {})
        blocks = []
        lowered = [n.lower() for n in names]
        for n, c in zip(lowered, cols):
            # values normalize to strings here; JSONL values arrive typed
            strs = [None if v is None else str(v) for v in c]
            typ = override.get(n)
            if typ is None:
                typ = _infer_type(strs[:1000])
            try:
                blocks.append(_to_block(strs, typ, self.device))
            except (ValueError, TypeError):
                if n in override:
                    raise  # explicit schema: surface the bad value
                # inference sampled a clean prefix; fall back to varchar
                blocks.append(_to_block(strs, T.VARCHAR, self.device))
        pg = Page.from_blocks(blocks, lowered, count=len(cols[0]) if cols else 0,
                              device=self.device)
        self._pages[table] = pg
        return pg

    def schema(self, table: str) -> Dict[str, T.Type]:
        pg = self._load(table)
        return {n: b.type for n, b in zip(pg.names, pg.blocks)}

    def row_count(self, table: str) -> int:
        return int(self._load(table).count)

    def unique_columns(self, table: str):
        return []

    def page(self, table: str) -> Page:
        return self._load(table)
