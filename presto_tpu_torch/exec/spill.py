"""Host-offload ("spill") execution for sort, window, joins and final
aggregation (torch counterpart of presto_tpu/exec/spill.py).

Re-designed equivalent of the reference's spill machinery:
OrderByOperator spill + MergeHashSort, SpillableHashAggregationBuilder
(SpillableHashAggregationBuilder.java:209
`spillToDisk`), GenericPartitioningSpiller (spiller/) and the
revocable-memory scheduler (execution/MemoryRevokingScheduler.java:46).

Card memory is the scarce resource and pinned host memory the first spill
target; the disk tier (exec/spillspace.py) takes over past
PRESTO_TPU_HOST_SPILL_BYTES. The heavy compute stays on the card:

* External sort is RANGE-PARTITIONED, not run-merge: offload the input,
  choose first-key value boundaries from a sample, then upload one
  key-range at a time and sort it on the card with ALL keys. Chunks come
  back in range order, so no k-way merge loop runs on the host. Ties on
  the first key stay inside one chunk (boundaries are values, not
  positions); an oversized all-tie chunk recurses on the remaining keys.
* Aggregation spill = hash-partitioned partial states: each partition
  holds a disjoint set of groups, so final aggregation runs per partition
  on the card and the results concatenate.
* Window spill = partition-chunked execution on the PARTITION BY keys.

Offloaded rows live in HostTable columns: CPU tensors, pinned when they
came from the card. A batch's columns are copied into pinned buffers with
non_blocking=True and ONE synchronise per batch (`_download`), not one
per column. Uploads are budget-sized and accounted in the caller's
MemoryPool; processed chunks come back to the host at once. Results
assemble into a HOST-backed Page (CPU tensors): the streaming executor
hands it to Output as is, and uploads it again only where a card
operator consumes it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import types as T
from ..expr.functions import NotPortedError
from ..ops.sort import SortKey, asc_normalized_scalar_key, sort_page
from ..page import Block, Page, _pad_block, dictionary_by_id, intern_dictionary, round_capacity
from .stats import page_device_bytes


def _live_blocks(page: Page) -> Tuple[List[Block], int]:
    """The page's blocks (collection blocks refused) and its live count."""
    for b in page.blocks:
        if b.lengths is not None or b.key_block is not None:
            raise NotPortedError("not ported yet: offloading a collection column "
                                 "(ARRAY/MAP) to the host spill tier")
    return list(page.blocks), int(page.count)


def _download(tensors: Sequence[Optional[torch.Tensor]], n: int) -> List[Optional[torch.Tensor]]:
    """The first n rows of each device tensor in CPU memory. From the card:
    pinned buffers filled with non_blocking copies and ONE synchronise for
    the whole batch."""
    live = [t for t in tensors if t is not None]
    if not live or live[0].device.type == "cpu":
        return [None if t is None else t[:n] for t in tensors]
    out = []
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        buf = torch.empty((n,) + tuple(t.shape[1:]), dtype=t.dtype, pin_memory=True)
        buf.copy_(t[:n], non_blocking=True)
        out.append(buf)
    torch.cuda.current_stream(live[0].device).synchronize()
    return out


def _concat(parts: List[torch.Tensor], pinned: bool) -> torch.Tensor:
    """Row-wise concatenation into one (pinned, where the parts came from
    the card) host tensor."""
    if len(parts) == 1:
        return parts[0]
    rows = sum(p.shape[0] for p in parts)
    out = torch.empty((rows,) + tuple(parts[0].shape[1:]), dtype=parts[0].dtype,
                      pin_memory=pinned)
    torch.cat(parts, out=out)
    return out


def _upload(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    if device.type == "cpu":
        return x
    return x.to(device, non_blocking=x.is_pinned())


@dataclasses.dataclass
class HostTable:
    """Host-offloaded rows (the spill-file analog): CPU tensor columns +
    schema, uploadable chunk by chunk."""

    names: Tuple[str, ...]
    types: tuple
    dict_ids: tuple
    columns: List[torch.Tensor]
    valids: List[Optional[torch.Tensor]]

    @property
    def num_rows(self) -> int:
        return int(self.columns[0].shape[0]) if self.columns else 0

    @property
    def row_bytes(self) -> int:
        if not self.num_rows:
            return 0
        per = sum(c.element_size() * (c.numel() // max(c.shape[0], 1)) for c in self.columns)
        per += sum(1 for v in self.valids if v is not None)
        return per

    def slice_page(self, start: int, stop: int, device, pad_to=None) -> Page:
        device = torch.device(device)
        blocks = []
        for c, v, t2, d in zip(self.columns, self.valids, self.types, self.dict_ids):
            blk = Block(_upload(c[start:stop], device), t2,
                        None if v is None else _upload(v[start:stop], device), d)
            if pad_to is not None and pad_to > stop - start:
                blk = _pad_block(blk, pad_to)
            blocks.append(blk)
        return Page.from_blocks(blocks, self.names, count=stop - start, device=device)

    def take(self, indices: torch.Tensor) -> "HostTable":
        """The rows at `indices` (a CPU int64 tensor), in that order."""
        return HostTable(self.names, self.types, self.dict_ids,
                         [c.index_select(0, indices) for c in self.columns],
                         [None if v is None else v.index_select(0, indices)
                          for v in self.valids])

    @staticmethod
    def from_pages(pages: List[Page]) -> "HostTable":
        from ..ops.union import unify_block_dictionaries

        first = pages[0]
        per_page = [_live_blocks(p) for p in pages]
        cols: List[torch.Tensor] = []
        valids: List[Optional[torch.Tensor]] = []
        dict_ids: List[Optional[int]] = []
        pinned = first.device.type == "cuda"
        downloaded = []
        for i in range(len(first.blocks)):
            # unify per-batch dictionaries BEFORE concatenating codes (the
            # same invariant as concat_pages)
            blocks, did = unify_block_dictionaries([bl[i] for bl, _n in per_page])
            dict_ids.append(did)
            any_valid = any(b.valid is not None for b in blocks)
            downloaded.append((blocks, any_valid))
        # one download (and one synchronise) per page
        host = []
        for j, (_bl, n) in enumerate(per_page):
            ts = []
            for blocks, any_valid in downloaded:
                b = blocks[j]
                ts.append(b.data)
                ts.append(b.valid_mask() if any_valid else None)
            host.append(_download(ts, n))
        for i in range(len(first.blocks)):
            cols.append(_concat([h[2 * i] for h in host], pinned))
            vparts = [h[2 * i + 1] for h in host]
            valids.append(None if vparts[0] is None else _concat(vparts, pinned))
        return HostTable(first.names, tuple(b.type for b in first.blocks), tuple(dict_ids),
                         cols, valids)

    @staticmethod
    def from_numpy(names, types, dict_ids, cols, vals) -> "HostTable":
        return HostTable(tuple(names), tuple(types), tuple(dict_ids),
                         [torch.from_numpy(np.ascontiguousarray(c)) for c in cols],
                         [None if v is None else torch.from_numpy(np.ascontiguousarray(v))
                          for v in vals])

    def numpy_columns(self):
        return ([c.numpy() for c in self.columns],
                [None if v is None else v.numpy() for v in self.valids])


def to_host_page(page: Page) -> Page:
    """A device page's live rows as a page of CPU tensors (pinned, with one
    synchronise, when it comes from the card)."""
    blocks, n = _live_blocks(page)
    ts = []
    for b in blocks:
        ts += [b.data, b.valid]
    host = _download(ts, n)
    out = [Block(host[2 * i], b.type, host[2 * i + 1], b.dict_id) for i, b in enumerate(blocks)]
    return Page(tuple(out), page.names, torch.tensor(n, dtype=torch.int32))


def host_concat_pages(pages: Sequence[Page]) -> Page:
    """Concatenate host-backed pages column-wise into one host Page."""
    ht = HostTable.from_pages([p for p in pages])
    blocks = [Block(c, t, v, d) for c, v, t, d in
              zip(ht.columns, ht.valids, ht.types, ht.dict_ids)]
    return Page(tuple(blocks), pages[0].names, torch.tensor(ht.num_rows, dtype=torch.int32))


def _default_host_spill_bytes() -> int:
    """Host bytes one offloaded store may hold before migrating to the disk
    spill tier (exec/spillspace.py). 0 forces everything to disk."""
    return int(os.environ.get("PRESTO_TPU_HOST_SPILL_BYTES", str(64 << 20)))


def _host_table_concat(tables: List[HostTable]) -> HostTable:
    """Concatenate host tables in one pass per column, remapping codes of
    differing string dictionaries onto their merged sorted dictionary (the
    host mirror of concat_pages)."""
    first = tables[0]
    cols, valids, dict_ids = [], [], []
    for i in range(len(first.columns)):
        parts = [t.columns[i] for t in tables]
        did = first.dict_ids[i]
        ids = {t.dict_ids[i] for t in tables}
        if len(ids) > 1:
            merged = tuple(sorted({s for d in ids if d is not None for s in dictionary_by_id(d)}))
            index = {s: j for j, s in enumerate(merged)}
            for k, t in enumerate(tables):
                entries = dictionary_by_id(t.dict_ids[i]) if t.dict_ids[i] is not None else ()
                if len(entries):
                    remap = torch.tensor([index[s] for s in entries], dtype=torch.int32)
                    parts[k] = remap[parts[k].to(torch.int64)]
            did = intern_dictionary(merged)
        cols.append(torch.cat(parts))
        vs = [t.valids[i] for t in tables]
        valids.append(None if all(v is None for v in vs) else torch.cat(
            [torch.ones(t.num_rows, dtype=torch.bool) if v is None else v
             for t, v in zip(tables, vs)]))
        dict_ids.append(did)
    return HostTable(first.names, first.types, tuple(dict_ids), cols, valids)


class SpilledRows:
    """Offloaded rows: host chunks (HostTables, as they were appended, so an
    append never copies what is already stored) that migrate to the
    CRC-checked disk tier (spillspace.DiskRows) once they outgrow
    PRESTO_TPU_HOST_SPILL_BYTES. Every read is one sequential pass over the
    chunks: `split` partitions the store in one pass, where a gather per
    partition would read it once per partition. `device` is where pages
    are uploaded."""

    def __init__(self, space=None, tag: str = "spill", device="cpu"):
        self._chunks: List[HostTable] = []
        self._host_bytes = 0
        self._space = space  # spillspace.QuerySpillSpace (None = host-only)
        self._tag = tag
        self._disk = None  # spillspace.DiskRows once migrated
        self._host_limit = _default_host_spill_bytes()
        self.device = torch.device(device)

    def append(self, page: Page) -> None:
        self.append_host(HostTable.from_pages([page]))

    def append_host(self, chunk: HostTable) -> None:
        if self._disk is not None:
            if chunk.num_rows:
                cols, vals = chunk.numpy_columns()
                self._disk.append_chunk(cols, vals, chunk.dict_ids, chunk.num_rows)
            return
        if chunk.num_rows == 0 and self._chunks:
            return
        self._chunks.append(chunk)
        self._host_bytes += chunk.num_rows * max(chunk.row_bytes, 1)
        self._maybe_migrate()

    def _maybe_migrate(self) -> None:
        """The host chunks crossed their ceiling: stream them into a disk
        record store and drop them (the second rung of the ladder: card ->
        host -> disk)."""
        if self._space is None or self._host_bytes <= self._host_limit:
            return
        from .spillspace import DiskRows

        first = self._chunks[0]
        self._disk = DiskRows(self._space, self._tag, first.names, first.types)
        chunks, self._chunks, self._host_bytes = self._chunks, [], 0
        for ch in chunks:
            if ch.num_rows:
                cols, vals = ch.numpy_columns()
                self._disk.append_chunk(cols, vals, ch.dict_ids, ch.num_rows)

    @property
    def num_rows(self) -> int:
        if self._disk is not None:
            return self._disk.num_rows
        return sum(c.num_rows for c in self._chunks)

    @property
    def row_bytes(self) -> int:
        if self._disk is not None:
            return max(self._disk.row_bytes, 1)
        return max([c.row_bytes for c in self._chunks] + [1]) if self._chunks else 0

    def _schema_chunk(self) -> HostTable:
        """A 0-row chunk with the store's true dtypes and dictionaries."""
        if self._disk is None:
            c = self._chunks[0]
            return c.take(torch.zeros(0, dtype=torch.int64))
        cols, vals, dict_ids, _rows = self._disk.read_chunk(0)
        return HostTable.from_numpy(self._disk.names, self._disk.types, dict_ids,
                                    [c[:0] for c in cols],
                                    [None if v is None else v[:0] for v in vals])

    def iter_host_chunks(self):
        """HostTable chunks of the whole store, in order (the host chunks,
        or one per CRC-verified disk record)."""
        if self._disk is not None:
            for cols, vals, dict_ids, _rows in self._disk.iter_chunks():
                yield HostTable.from_numpy(self._disk.names, self._disk.types, dict_ids,
                                           cols, vals)
        else:
            yield from self._chunks

    def _coalesced(self, rows: int):
        """Host tables of about `rows` rows each, in order: small chunks
        (disk records) concatenated, large ones sliced."""
        held: List[HostTable] = []
        n = 0
        for ch in self.iter_host_chunks():
            start = 0
            while start < ch.num_rows:
                take = min(rows - n, ch.num_rows - start)
                piece = ch if (start == 0 and take == ch.num_rows) else ch.take(
                    torch.arange(start, start + take))
                held.append(piece)
                n += take
                start += take
                if n >= rows:
                    yield held[0] if len(held) == 1 else _host_table_concat(held)
                    held, n = [], 0
        if held:
            yield held[0] if len(held) == 1 else _host_table_concat(held)

    def _gather_host(self, indices: np.ndarray) -> HostTable:
        """HostTable of the rows at `indices` (in `indices` order), one
        sequential pass over the chunks."""
        indices = np.asarray(indices, np.int64)
        if self._disk is None and len(self._chunks) == 1:
            return self._chunks[0].take(torch.from_numpy(indices))
        order = np.argsort(indices, kind="stable")
        sorted_idx = indices[order]
        parts = []
        off = pos = 0
        for ch in self.iter_host_chunks():
            hi = np.searchsorted(sorted_idx, off + ch.num_rows, side="left")
            if hi > pos:
                parts.append(ch.take(torch.from_numpy(sorted_idx[pos:hi] - off)))
                pos = hi
            off += ch.num_rows
            if pos == len(sorted_idx):
                break
        if not parts:
            return self._schema_chunk()
        ht = _host_table_concat(parts)
        inverse = np.empty(len(order), np.int64)
        inverse[order] = np.arange(len(order))
        return ht.take(torch.from_numpy(inverse))

    def split(self, index_lists: Sequence[np.ndarray]) -> List["SpilledRows"]:
        """One store per list of row positions (each in ascending order),
        filled in ONE pass over this store (the GenericPartitioningSpiller
        layout); a store past the host ceiling goes to disk on its own."""
        lists = [np.sort(np.asarray(ix, np.int64)) for ix in index_lists]
        outs = [SpilledRows(space=self._space, tag=self._tag, device=self.device)
                for _ in lists]
        pos = [0] * len(lists)
        off = 0
        for ch in self.iter_host_chunks():
            end = off + ch.num_rows
            for p, ix in enumerate(lists):
                hi = np.searchsorted(ix, end, side="left")
                if hi > pos[p]:
                    outs[p].append_host(ch.take(torch.from_numpy(ix[pos[p]:hi] - off)))
                    pos[p] = hi
            off = end
        for p, out in enumerate(outs):
            if out.num_rows == 0 and not out._chunks and out._disk is None:
                out._chunks.append(self._schema_chunk())  # keeps the schema
        return outs

    def subset(self, indices: np.ndarray) -> "SpilledRows":
        return self.split([indices])[0]

    def take_page(self, indices: np.ndarray) -> Page:
        """Gather rows by position into a page on `device`, padded to its
        capacity bucket."""
        h = self._gather_host(indices)
        n = h.num_rows
        return h.slice_page(0, n, self.device, pad_to=round_capacity(max(n, 1)))

    def iter_pages(self, rows: int):
        """Device pages of the whole store, about `rows` rows each, in order."""
        for ht in self._coalesced(max(rows, 1)):
            n = ht.num_rows
            yield ht.slice_page(0, n, self.device, pad_to=round_capacity(max(n, 1)))

    def column_eval(self, eval_fn: Callable[[Page], torch.Tensor], chunk_rows: int) -> np.ndarray:
        """Evaluate a device function over the stored rows chunk by chunk,
        returning the concatenated host result (sort-key normalization,
        partition hashing)."""
        outs = []
        for ht in self._coalesced(max(chunk_rows, 1)):
            n = ht.num_rows
            page = ht.slice_page(0, n, self.device, pad_to=round_capacity(max(n, 1)))
            outs.append(eval_fn(page)[:n].cpu().numpy())
        return np.concatenate(outs) if outs else np.empty((0,))


def choose_boundaries(norm: np.ndarray, num_chunks: int, sample: int = 1 << 20) -> np.ndarray:
    """Pick <= num_chunks-1 first-key VALUES splitting `norm` into roughly
    equal chunks. Value (not position) boundaries keep equal keys in one
    chunk, as multi-key sorts need."""
    if num_chunks <= 1 or len(norm) == 0:
        return np.empty((0,), norm.dtype)
    if len(norm) > sample:
        idx = np.linspace(0, len(norm) - 1, sample).astype(np.int64)
        s = np.sort(norm[idx])
    else:
        s = np.sort(norm)
    qs = [s[int(len(s) * k / num_chunks)] for k in range(1, num_chunks)]
    return np.unique(np.asarray(qs, norm.dtype))


def external_sort_chunks(spilled: SpilledRows, keys: Sequence[SortKey], chunk_rows: int,
                         pool) -> List[Page]:
    """Sort spilled rows: range-partition on the first key, sort each range
    on the card with ALL keys, download, return host chunks in global
    order. Each chunk's card residency is reserved against `pool`."""
    from ..expr.compiler import evaluate
    from ..expr.functions import require_sorted_dict

    first = keys[0]
    # exact: equal norm == equal first key (scalar keys). Long-decimal
    # lanes use a monotone float64 approximation (hi*2^32 + lo): right for
    # range BOUNDARIES, but its ties are not key ties, so tie chunks then
    # sort with the FULL key list instead of recursing on the rest
    norm_exact = True

    def eval_norm(page: Page) -> torch.Tensor:
        nonlocal norm_exact
        v = evaluate(first.expr, page)
        if isinstance(v.type, T.VarcharType):
            require_sorted_dict(v, "ORDER BY")
        norm = asc_normalized_scalar_key(v.data, first.ascending)
        if norm is None:
            norm_exact = False
            approx = v.data[:, 0].to(torch.float64) * float(1 << 32) + \
                v.data[:, 1].to(torch.float64)
            norm = approx if first.ascending else -approx
        return norm

    def eval_nulls(page: Page) -> torch.Tensor:
        v = evaluate(first.expr, page)
        if v.valid is None:
            return torch.ones(page.capacity, dtype=torch.bool, device=page.device)
        return v.valid

    n = spilled.num_rows
    norm = spilled.column_eval(eval_norm, chunk_rows)
    valid = spilled.column_eval(eval_nulls, chunk_rows).astype(np.bool_)
    has_nulls = not valid.all()
    null_idx = np.nonzero(~valid)[0] if has_nulls else np.empty(0, np.int64)
    live_idx = np.nonzero(valid)[0] if has_nulls else np.arange(n)

    chunks: List[Page] = []

    def device_sort(indices: np.ndarray, sub_keys) -> None:
        page = spilled.take_page(indices)
        nb = page_device_bytes(page)
        pool.reserve(nb, "external sort chunk")
        try:
            chunks.append(to_host_page(sort_page(page, sub_keys)))
        finally:
            pool.free(nb)

    def emit(indices: np.ndarray, sub_keys) -> None:
        if len(indices) == 0:
            return
        if len(indices) <= max(chunk_rows, 1):
            device_sort(indices, sub_keys)
            return
        sub_norm = norm[indices]
        uniq = np.unique(sub_norm)
        if len(uniq) > 1:
            bounds = choose_boundaries(sub_norm, -(-len(indices) // max(chunk_rows, 1)))
            part = np.searchsorted(bounds, sub_norm, side="right")
            sizes = np.bincount(part, minlength=len(bounds) + 1)
            if sizes.max() == len(indices):
                # quantile boundaries made no progress (one dominant value
                # swallowed every cut): split at the middle DISTINCT value,
                # strictly inside the range
                mid = uniq[len(uniq) // 2]
                emit(indices[sub_norm < mid], sub_keys)
                emit(indices[sub_norm >= mid], sub_keys)
                return
            for p in range(len(bounds) + 1):
                sel = indices[part == p]
                if len(sel) <= max(chunk_rows, 1) or len(np.unique(norm[sel])) > 1:
                    emit(sel, sub_keys)
                else:
                    emit_ties(sel, sub_keys)
            return
        emit_ties(indices, sub_keys)

    def emit_ties(indices: np.ndarray, sub_keys) -> None:
        """All first-key values equal: order falls to the remaining keys;
        with none, any order is valid (budget-sized slices). With an
        approximate norm, equal norm does NOT mean equal key: sort the whole
        tie chunk with every key."""
        if not norm_exact and sub_keys is keys:
            device_sort(indices, sub_keys)
            return
        rest = list(sub_keys)[1:]
        if rest:
            chunks.extend(external_sort_chunks(spilled.subset(indices), rest, chunk_rows, pool))
            return
        step = max(chunk_rows, 1)
        for s in range(0, len(indices), step):
            page = spilled.take_page(indices[s: s + step])
            nb = page_device_bytes(page)
            pool.reserve(nb, "external sort tie slice")
            try:
                chunks.append(to_host_page(page))
            finally:
                pool.free(nb)

    # NULL first-key rows are all EQUAL on the first key: the remaining
    # keys order them, never the garbage norm values in invalid slots
    if has_nulls and first.effective_nulls_first:
        emit_ties(null_idx, keys)
        emit(live_idx, keys)
    elif has_nulls:
        emit(live_idx, keys)
        emit_ties(null_idx, keys)
    else:
        emit(live_idx, keys)
    return chunks


def partition_of(h: torch.Tensor, num_parts: int, salt: int = 0) -> torch.Tensor:
    """Partition number in [0, num_parts) of int64 hash bits, after a
    logical shift by `salt` (fresh bits for each recursion level)."""
    from ..ops.hashing import _srl

    if salt:
        h = _srl(h, salt)
    return torch.remainder(h, num_parts)


def hash_partition_indices(spilled: SpilledRows, key_exprs, num_parts: int, chunk_rows: int,
                           salt: int = 0, value_safe: bool = False) -> List[np.ndarray]:
    """Partition spilled row indices by card-computed key hash (the
    GenericPartitioningSpiller layout): rows with equal keys land in the
    same partition. `value_safe=True` hashes varchar keys by dictionary
    VALUE (ops/hashing.hash_rows_values), so the two sides of a join
    partition identically even when their dictionaries differ."""
    from ..expr.compiler import evaluate
    from ..ops.hashing import hash_rows, hash_rows_values

    def eval_part(page: Page) -> torch.Tensor:
        keys = [evaluate(e, page) for e in key_exprs]
        h = hash_rows_values(keys) if value_safe else hash_rows(keys)
        return partition_of(h, num_parts, salt).to(torch.int32)

    # int16 partition ids: numpy's stable sort of a 16-bit key is a radix
    # sort, linear in the rows
    part = spilled.column_eval(eval_part, chunk_rows).astype(np.int16)
    order = np.argsort(part, kind="stable")
    sizes = np.bincount(part, minlength=num_parts)
    return np.split(order, np.cumsum(sizes)[:-1])
