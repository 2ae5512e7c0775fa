"""Disk spill tier: quota-managed, CRC-checked spill files (torch
counterpart of presto_tpu/exec/spillspace.py, which is numpy and os only;
the port keeps its own copy, as it imports nothing of the JAX package).

Re-designed equivalent of the reference's spill-space management
(spiller/FileSingleStreamSpillerFactory LocalSpillManager + the
`experimental.max-spill-per-node` / `query-max-spill-per-node` quotas,
and SpillSpaceTracker): a per-process SpillSpaceManager hands out
per-query SpillSpaces under a node-wide and a per-query byte quota, and
every byte written to disk is CRC-checked on the way back in — a corrupt
or truncated spill file fails the query with a structured error
(SpillCorruptionError), never returns wrong rows.

This is the tier BELOW exec/spill.py's pinned host-memory offload:
SpilledRows migrates to a DiskRows record store once its host footprint
crosses
PRESTO_TPU_HOST_SPILL_BYTES. Records are column-chunk payloads (numpy
arrays + schema via pickle) framed as

    magic "PTS1" | uint64 payload length | uint32 crc32 | payload

so a torn write (crash mid-record) or bit rot is detected by length or
CRC mismatch before any row is produced.

Cleanup is guaranteed per query: QuerySpillSpace.release() unlinks every
file it created and returns its bytes to both quotas; the worker calls it
in the task's `finally` (so kills and failures clean up too), and the
streaming session calls it at `run()` end. `all_active_bytes()` sums the
live spill bytes of every manager in the process — the leak oracle the
tests assert is zero after every query.

Env knobs, the JAX package's names (docs/tuning.md applies to both):
* PRESTO_TPU_SPILL_DIR          spill directory (default: a per-process
                                tempdir, removed at interpreter exit)
* PRESTO_TPU_SPILL_NODE_QUOTA   max spill bytes per node/process
* PRESTO_TPU_SPILL_QUERY_QUOTA  max spill bytes per query
"""

from __future__ import annotations

import os
import pickle
import struct
import threading
import weakref
import zlib
from typing import Dict, List, Optional

_MAGIC = b"PTS1"
_HEADER = struct.Struct("<4sQI")  # magic, payload length, payload crc32

# every manager in the process, for the suite-wide leak oracle
_MANAGERS: "weakref.WeakSet[SpillSpaceManager]" = weakref.WeakSet()


class SpillError(RuntimeError):
    """Structured spill-tier failure. Fatal to the query (retrying on
    another worker would hit the same quota / the file is gone)."""


class SpillQuotaExceededError(SpillError):
    """Per-query or per-node spill quota exhausted (reference
    ExceededSpillLimitException)."""


class SpillCorruptionError(SpillError):
    """A spill file failed its CRC / framing check: the query must fail
    with this structured error, never produce wrong rows."""


def _env_bytes(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


class SpillSpaceManager:
    """Node-level spill accounting: hands out per-query spaces, enforces
    the per-node and per-query byte quotas, tracks lifetime counters."""

    def __init__(self, directory: Optional[str] = None,
                 node_quota: Optional[int] = None,
                 query_quota: Optional[int] = None):
        self._dir = directory
        self.node_quota = (
            node_quota if node_quota is not None
            else _env_bytes("PRESTO_TPU_SPILL_NODE_QUOTA")
        )
        self.query_quota = (
            query_quota if query_quota is not None
            else _env_bytes("PRESTO_TPU_SPILL_QUERY_QUOTA")
        )
        self._lock = threading.Lock()
        self.active_bytes = 0
        self.by_query: Dict[str, int] = {}
        self.total_written = 0  # lifetime bytes spilled to disk
        self.files_created = 0
        self.active_files = 0
        self.quota_rejections = 0
        _MANAGERS.add(self)

    # -- directory (lazy: importing this module must not touch disk) --

    def directory(self) -> str:
        with self._lock:
            if self._dir is None:
                import tempfile

                base = os.environ.get("PRESTO_TPU_SPILL_DIR")
                if base:
                    os.makedirs(base, exist_ok=True)
                    self._dir = tempfile.mkdtemp(prefix="spill_", dir=base)
                else:
                    self._dir = tempfile.mkdtemp(prefix="presto_tpu_spill_")
                # the directory this manager made goes at interpreter exit
                import atexit
                import shutil

                atexit.register(shutil.rmtree, self._dir, True)
            else:
                os.makedirs(self._dir, exist_ok=True)
            return self._dir

    # -- quota ledger (called by SpillFile) --

    def _charge(self, query_id: str, nbytes: int) -> None:
        with self._lock:
            held = self.by_query.get(query_id, 0)
            if (
                self.query_quota is not None
                and held + nbytes > self.query_quota
            ):
                self.quota_rejections += 1
                raise SpillQuotaExceededError(
                    f"spill quota exceeded for query {query_id!r}: "
                    f"writing {nbytes:,}B past {held:,}B held would exceed "
                    f"the per-query quota of {self.query_quota:,}B"
                )
            if (
                self.node_quota is not None
                and self.active_bytes + nbytes > self.node_quota
            ):
                self.quota_rejections += 1
                raise SpillQuotaExceededError(
                    f"spill quota exceeded on this node: {nbytes:,}B past "
                    f"{self.active_bytes:,}B held would exceed the "
                    f"per-node quota of {self.node_quota:,}B"
                )
            self.by_query[query_id] = held + nbytes
            self.active_bytes += nbytes

    def _note_written(self, nbytes: int) -> None:
        """Lifetime spilled-bytes counter, bumped only AFTER a record
        actually reached the file, so failed writes never inflate it."""
        with self._lock:
            self.total_written += nbytes

    def _credit(self, query_id: str, nbytes: int) -> None:
        with self._lock:
            self.active_bytes = max(0, self.active_bytes - nbytes)
            left = self.by_query.get(query_id, 0) - nbytes
            if left > 0:
                self.by_query[query_id] = left
            else:
                self.by_query.pop(query_id, None)

    # -- spaces --

    def open(self, query_id: str) -> "QuerySpillSpace":
        return QuerySpillSpace(self, query_id)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "active_bytes": self.active_bytes,
                "active_files": self.active_files,
                "by_query": dict(self.by_query),
                "total_written": self.total_written,
                "files_created": self.files_created,
                "quota_rejections": self.quota_rejections,
                "node_quota": self.node_quota,
                "query_quota": self.query_quota,
            }


class QuerySpillSpace:
    """One query's (or one task's) handle on the manager: creates files,
    tracks them for guaranteed release."""

    def __init__(self, manager: SpillSpaceManager, query_id: str):
        self.manager = manager
        self.query_id = query_id
        self._files: List["SpillFile"] = []
        self._seq = 0
        self.written = 0  # lifetime bytes this space wrote

    def new_file(self, tag: str) -> "SpillFile":
        self._seq += 1
        safe_q = "".join(
            c if c.isalnum() or c in "._-" else "_" for c in self.query_id
        )
        safe_t = "".join(
            c if c.isalnum() or c in "._-" else "_" for c in tag
        )
        path = os.path.join(
            self.manager.directory(),
            f"{safe_q}.{safe_t}.{self._seq}.{id(self):x}.spill",
        )
        f = SpillFile(self, path)
        self._files.append(f)
        with self.manager._lock:
            self.manager.files_created += 1
            self.manager.active_files += 1
        return f

    def release(self) -> None:
        """Unlink every file this space created and return its quota
        bytes. Idempotent — the guaranteed-cleanup hook for query end,
        kill, and failure paths alike."""
        files, self._files = self._files, []
        for f in files:
            f.delete()

    @property
    def active_bytes(self) -> int:
        return sum(f.nbytes for f in self._files)


class SpillFile:
    """Append-only record file with per-record CRC framing."""

    def __init__(self, space: QuerySpillSpace, path: str):
        self.space = space
        self.path = path
        self._fh = open(path, "w+b")
        self._records: List[tuple] = []  # (offset, payload_len)
        self.nbytes = 0
        self._lock = threading.Lock()
        self._deleted = False

    def __len__(self) -> int:
        return len(self._records)

    def append(self, payload: bytes) -> int:
        """Write one CRC-framed record; returns its index. Charges the
        quotas BEFORE writing so an over-quota record never hits disk."""
        total = _HEADER.size + len(payload)
        self.space.manager._charge(self.space.query_id, total)
        try:
            with self._lock:
                if self._deleted:
                    raise SpillError(
                        f"spill file {self.path} used after release"
                    )
                off = self._fh.seek(0, os.SEEK_END)
                crc = zlib.crc32(payload) & 0xFFFFFFFF
                self._fh.write(_HEADER.pack(_MAGIC, len(payload), crc))
                self._fh.write(payload)
                self._fh.flush()  # records are visible to any handle
                self._records.append((off, len(payload)))
                self.nbytes += total
                self.space.written += total
            self.space.manager._note_written(total)
            return len(self._records) - 1
        except SpillError:
            self.space.manager._credit(self.space.query_id, total)
            raise
        except OSError as e:
            self.space.manager._credit(self.space.query_id, total)
            raise SpillError(
                f"spill write to {self.path} failed: {e}"
            ) from e

    def read(self, index: int) -> bytes:
        """Read + verify one record. Any framing/CRC mismatch raises
        SpillCorruptionError — the structured never-wrong-rows contract."""
        off, plen = self._records[index]
        with self._lock:
            if self._deleted:
                raise SpillError(
                    f"spill file {self.path} read after release"
                )
            self._fh.seek(off)
            header = self._fh.read(_HEADER.size)
            if len(header) != _HEADER.size:
                raise SpillCorruptionError(
                    f"spill file corrupt: {self.path} record {index} "
                    f"truncated header ({len(header)}B of {_HEADER.size}B)"
                )
            magic, length, crc = _HEADER.unpack(header)
            if magic != _MAGIC or length != plen:
                raise SpillCorruptionError(
                    f"spill file corrupt: {self.path} record {index} bad "
                    f"framing (magic={magic!r}, length {length} != {plen})"
                )
            payload = self._fh.read(plen)
        if len(payload) != plen:
            raise SpillCorruptionError(
                f"spill file corrupt: {self.path} record {index} truncated "
                f"payload ({len(payload)}B of {plen}B)"
            )
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            raise SpillCorruptionError(
                f"spill file corrupt: {self.path} record {index} CRC "
                "mismatch (torn write or bit rot)"
            )
        return payload

    def delete(self) -> None:
        with self._lock:
            if self._deleted:
                return
            self._deleted = True
            nbytes = self.nbytes
            try:
                self._fh.close()
            except OSError:
                pass
            try:
                os.unlink(self.path)
            except OSError:
                pass
        self.space.manager._credit(self.space.query_id, nbytes)
        with self.space.manager._lock:
            self.space.manager.active_files -= 1


class DiskRows:
    """Disk-backed row store: a sequence of column-chunk records (numpy
    arrays) over one SpillFile (the GenericPartitioningSpiller file
    layout, one tier down from exec/spill.py's host store). Access is
    sequential-pass, the shape every external algorithm here needs."""

    # rows per record: bounds the host memory any single read touches
    MAX_RECORD_ROWS = 1 << 16

    def __init__(self, space: QuerySpillSpace, tag: str, names, types):
        self.file = space.new_file(tag)
        self.names = tuple(names)
        self.types = tuple(types)
        self.row_counts: List[int] = []
        self.num_rows = 0
        self._data_bytes = 0

    @property
    def row_bytes(self) -> int:
        if not self.num_rows:
            return 0
        return max(self._data_bytes // self.num_rows, 1)

    def append_chunk(self, columns, valids, dict_ids, rows: int) -> None:
        """Write one (columns, valids, dict_ids) chunk; splits chunks
        larger than MAX_RECORD_ROWS so no read re-materializes more."""
        if rows == 0:
            return
        step = self.MAX_RECORD_ROWS
        for start in range(0, rows, step):
            stop = min(start + step, rows)
            cols = [c[start:stop] for c in columns]
            vals = [None if v is None else v[start:stop] for v in valids]
            payload = pickle.dumps(
                (cols, vals, tuple(dict_ids)), protocol=4
            )
            self.file.append(payload)
            n = stop - start
            self.row_counts.append(n)
            self.num_rows += n
            self._data_bytes += sum(
                c.dtype.itemsize * c.size for c in cols
            ) + sum(1 for v in vals if v is not None) * n

    def read_chunk(self, index: int):
        """(columns, valids, dict_ids, rows) of one record, CRC-verified."""
        payload = self.file.read(index)
        try:
            cols, vals, dict_ids = pickle.loads(payload)
        except Exception as e:  # noqa: BLE001 - unpicklable = corrupt
            raise SpillCorruptionError(
                f"spill file corrupt: {self.file.path} record {index} "
                f"payload undecodable: {e!r}"
            ) from e
        rows = self.row_counts[index]
        if cols and len(cols[0]) != rows:
            raise SpillCorruptionError(
                f"spill file corrupt: {self.file.path} record {index} row "
                f"count mismatch ({len(cols[0])} != {rows})"
            )
        return cols, vals, dict_ids, rows

    def iter_chunks(self):
        for i in range(len(self.row_counts)):
            yield self.read_chunk(i)

    def delete(self) -> None:
        self.file.delete()


def all_active_bytes() -> int:
    """Live spill bytes across every manager in the process — the leak
    oracle: zero whenever no query is mid-flight."""
    return sum(m.active_bytes for m in list(_MANAGERS))


def all_active_files() -> int:
    return sum(m.active_files for m in list(_MANAGERS))


# default manager for in-process sessions (a caller may make its own
# quota-configured instance; all register in _MANAGERS for the oracle)
SPILL_MANAGER = SpillSpaceManager()
