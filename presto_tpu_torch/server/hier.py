"""Hierarchical exchange producer: one device regroup per output batch,
ragged paged partitions on the PTP2 wire (torch counterpart of
presto_tpu/server/hier.py).

The flat producer of partitioned task output (`worker._hash_partition`)
compacts the page once per partition: nparts full-page passes for each
batch. Here the rows regroup by destination partition in ONE device step:

* **one device** (the card a worker drives, or the CPU): the stable sort
  by destination of parallel/exchange.py's `shuffle_write_parts`, the
  port's replacement for the JAX package's fused jitted regroup, and one
  host read of the per-partition counts;
* **several devices** (a host with at least
  `PRESTO_TPU_HIER_EXCHANGE_MIN_DEVICES` cards, a batch of at least
  `PRESTO_TPU_HIER_EXCHANGE_MIN_ROWS` rows, no collection blocks): the
  batch is sharded over the devices, each shard writes its rows toward
  owner device `part % n` and parallel/exchange.py's `all_to_all_page`
  swaps them; each device then sorts what it received by partition.

The regrouped live rows come to the host in one packed copy per device
(serde's page transfer), and each partition ships as ragged pages:
chunks of at most WIRE_PAGE_ROWS live rows, only the last one partial,
with no pad row on the wire.

The path is capability-negotiated (`serde.local_capabilities` advertises
``"hier"``) and switched by `knobs.hier_exchange_enabled`. A fault here
fails the task: there is no breaker that degrades to the flat loop.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import types as T
from ..page import Block, Page
from ..parallel.exchange import (
    all_to_all_page,
    host_counts,
    route,
    shuffle_write_parts,
)
from ..parallel.mesh import Mesh, default_mesh, shard_rows
from . import knobs
from .serde import page_to_host, serialize_page

# live rows a ragged wire page holds at most. The JAX package cuts its
# wire pages at the ragged layout's 2,048 rows; a page costs the port about
# a millisecond of host time to encode and as much to decode, under one
# interpreter lock per process (PERF.md, `http22`), so its pages are larger.
WIRE_PAGE_ROWS = 1 << 16


class HierExchangeStats:
    """Thread-safe accounting of one task's hierarchical exchange output,
    shipped in the task status under ``exchangeStats["hier"]`` and summed
    by the coordinator."""

    def __init__(self):
        self._lock = threading.Lock()
        self.exchanges = 0  # output batches regrouped
        self.collective_exchanges = 0  # of those, over several devices
        self.rows = 0
        self.collective_s = 0.0  # regroup wall: device step + host reads
        self.wire_pages = 0  # ragged pages put on the wire
        self.wire_bytes = 0  # their serialized bytes
        self.d2h_copies = 0  # device-to-host transfers of the regroup

    def record_batch(self, rows: int, seconds: float, collective: bool,
                     pages: int, wire_bytes: int, copies: int = 0) -> None:
        with self._lock:
            self.exchanges += 1
            if collective:
                self.collective_exchanges += 1
            self.rows += int(rows)
            self.collective_s += float(seconds)
            self.wire_pages += int(pages)
            self.wire_bytes += int(wire_bytes)
            self.d2h_copies += int(copies)

    def merge_snapshot(self, snap: Optional[dict]) -> None:
        """Fold a remote snapshot (a task status) into this one."""
        if not snap:
            return
        with self._lock:
            self.exchanges += int(snap.get("exchanges", 0))
            self.collective_exchanges += int(snap.get("collective_exchanges", 0))
            self.rows += int(snap.get("rows", 0))
            self.collective_s += (snap.get("collective_ms") or 0) / 1e3
            self.wire_pages += int(snap.get("wire_pages", 0))
            self.wire_bytes += int(snap.get("wire_bytes", 0))
            self.d2h_copies += int(snap.get("d2h_copies", 0))

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "exchanges": self.exchanges,
                "collective_exchanges": self.collective_exchanges,
                "rows": self.rows,
                "collective_ms": round(self.collective_s * 1e3, 2),
                "wire_pages": self.wire_pages,
                "wire_bytes": self.wire_bytes,
                "d2h_copies": self.d2h_copies,
            }


def hier_negotiated(caps: Optional[dict]) -> bool:
    """Did the fleet's wire negotiation keep the hierarchical capability?"""
    return bool(isinstance(caps, dict) and (caps.get("hier") or {}).get("ragged"))


def _collective_eligible(page: Page, n_dev: int, rows: int) -> bool:
    if n_dev < knobs.hier_exchange_min_devices():
        return False
    if rows < knobs.hier_exchange_min_rows():
        return False
    # collection companions take the single-device sort, as in the JAX
    # package
    return all(b.lengths is None and b.elem_valid is None and b.key_block is None
               for b in page.blocks)


def _regroup_local(page: Page, part: torch.Tensor, nparts: int):
    """One device: [(host page of the regrouped live rows, {p: (lo, hi)})]
    and the device-to-host copies it took."""
    buf, counts = shuffle_write_parts(page, part, nparts)
    counts = host_counts([counts])[0]
    copies = 0 if page.device.type == "cpu" else 1
    total = sum(counts)
    host, fetched = page_to_host(buf, total)
    starts = np.concatenate([[0], np.cumsum(counts)]).tolist()
    regions = {p: (starts[p], starts[p + 1]) for p in range(nparts)}
    return [(host, regions)], copies + fetched


def _regroup_collective(page: Page, part: torch.Tensor, nparts: int, mesh: Mesh):
    """Several devices: shard the batch, route each row to owner device
    `part % n`, swap with all_to_all_page, sort each receiver's rows by
    partition. Returns the per-device host pages with their partition
    regions, and the copies."""
    n = mesh.size
    part_col = "$hier_part"
    carrying = Page(page.blocks + (Block(part.to(torch.int32), T.INTEGER),),
                    page.names + (part_col,), page.count)
    shards = shard_rows(carrying, mesh)
    bufs, counts_t = [], []
    for shard in shards:
        p = shard.blocks[-1].data.to(torch.int64)
        p = torch.where(shard.live_mask() & (p < nparts), p, nparts)
        dest = torch.where(p < nparts, p % n, n)
        buf, counts = shuffle_write_parts(shard, dest, n)
        bufs.append(buf)
        counts_t.append(counts)
    counts = host_counts(counts_t)
    received = all_to_all_page(bufs, counts, mesh)
    totals = [sum(counts[i][j] for i in range(n)) for j in range(n)]
    out = []
    copies = sum(1 for d in mesh.devices if d.type != "cpu")  # the count reads
    for j, recv in enumerate(received):
        p = recv.blocks[-1].data.to(torch.int64)
        p = torch.where(recv.live_mask(), p, nparts)
        buf, pcounts = shuffle_write_parts(recv, p, nparts)
        pc = host_counts([pcounts])[0]
        copies += 0 if recv.device.type == "cpu" else 1
        stripped = Page(buf.blocks[:-1], buf.names[:-1], buf.count)
        host, fetched = page_to_host(stripped, totals[j])
        copies += fetched
        starts = np.concatenate([[0], np.cumsum(pc)]).tolist()
        out.append((host, {p_: (starts[p_], starts[p_ + 1]) for p_ in range(nparts)
                           if p_ % n == j}))
    return out, copies


def hier_partition(
    page: Page,
    key_exprs,
    nparts: int,
    caps: Optional[dict] = None,
    stats=None,
    hier: Optional[HierExchangeStats] = None,
    page_rows: Optional[int] = None,
    mesh: Optional[Mesh] = None,
    caches=None,
) -> Dict[int, List[bytes]]:
    """Partition live rows by key hash into serialized ragged wire pages:
    the hierarchical replacement for the flat `_hash_partition` loop. Every
    partition gets at least one page (possibly empty), and the rows of a
    partition are the flat path's. `mesh` names the devices a collective
    regroup may span;
    `caches` a DictionaryCache per partition's buffer, or None."""
    pr = page_rows or WIRE_PAGE_ROWS
    t0 = time.perf_counter()
    part = route(page, key_exprs, nparts)  # dead rows carry nparts
    # by default one device a visible card (the CPU alone for a CPU page)
    mesh = mesh or default_mesh(device=page.device.type)
    n = int(page.count)
    collective = _collective_eligible(page, mesh.size, n)
    if collective:
        groups, copies = _regroup_collective(page, part, nparts, mesh)
    else:
        groups, copies = _regroup_local(page, part, nparts)
    regroup_s = time.perf_counter() - t0

    spans: Dict[int, List[tuple]] = {p: [] for p in range(nparts)}
    for g, (_, regions) in enumerate(groups):
        for p, (lo, hi) in regions.items():
            if hi > lo:
                spans[p].append((g, lo, hi))
    out: Dict[int, List[bytes]] = {}
    pages_emitted = wire_bytes = 0
    for p in range(nparts):
        datas: List[bytes] = []
        for g, lo, hi in spans[p]:
            host = groups[g][0]
            for start in range(lo, hi, pr):
                stop = min(start + pr, hi)
                chunk = Page(tuple(b.take_rows(slice(start, stop)) for b in host.blocks),
                             host.names, torch.tensor(stop - start, dtype=torch.int32))
                datas.append(serialize_page(chunk, cache=caches and caches[p], caps=caps,
                                            stats=stats))
        if not datas:
            # an empty partition still ships one empty page, as the flat
            # loop does
            host = groups[0][0]
            empty = Page(tuple(b.take_rows(slice(0, 0)) for b in host.blocks), host.names,
                         torch.tensor(0, dtype=torch.int32))
            datas.append(serialize_page(empty, cache=caches and caches[p], caps=caps,
                                        stats=stats))
        pages_emitted += len(datas)
        wire_bytes += sum(len(d) for d in datas)
        out[p] = datas
    if hier is not None:
        hier.record_batch(n, regroup_s, collective, pages_emitted, wire_bytes, copies)
    return out
