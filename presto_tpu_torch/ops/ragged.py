"""Ragged paged partition layout for hash-relational kernels (torch
counterpart of presto_tpu/ops/ragged.py; host-side numpy metadata, as
there).

The TPU idiom behind Ragged Paged Attention (arXiv:2604.15464) applied
to relational partitions: when the hybrid hash join (exec/stream.py) or
the hash group-by hands SKEWED partitions to kernels, padding every
partition to the largest one wastes memory and compute quadratically
with skew. Instead, rows live in fixed-size PAGES (page_rows each) and a
per-partition PAGE TABLE maps partition p to the pages it owns — a
partition of 1 row costs one page, a partition of 1M rows costs
ceil(1M / page_rows) pages, and a kernel grid walks pages (uniform
blocks) while the page table tells each grid step which partition it is
accumulating into.

The structures here are host-side (numpy): partitions are born on the
host (exec/spill.hash_partition_indices over offloaded rows), and the
page table is small metadata a kernel launch would take as an argument.
No kernel reads the layout yet (nor in the JAX package): the hybrid hash
join uses it to hold its deferred partitions' row ids. `lane(...)`
gathers a host column into the (num_pages, page_rows) layout a kernel
would block over.

Occupancy — the fraction of allocated page slots holding live rows — is
the layout's quality metric (1.0 = no skew waste) and is surfaced per
join in EXPLAIN ANALYZE via exec/stream.py's spill stats.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

# Default rows per page: 2048 rows x 8B key lane = 16KB per lane page,
# small enough that a 1-row partition wastes little, large enough that
# page-table overhead stays negligible. PRESTO_TPU_RAGGED_PAGE_ROWS
# overrides (docs/tuning.md).
DEFAULT_PAGE_ROWS = 2048


def page_rows_default() -> int:
    import os

    try:
        v = int(os.environ.get("PRESTO_TPU_RAGGED_PAGE_ROWS", "0"))
    except ValueError:
        v = 0
    return v if v > 0 else DEFAULT_PAGE_ROWS


@dataclasses.dataclass
class RaggedPages:
    """Fixed-size pages + per-partition page table over host row ids.

    Invariants:
    * partition p owns pages ``page_ids[page_start[p] : page_start[p+1]]``
      (``page_start`` has P+1 entries, monotonically non-decreasing);
    * ``rows_in_page[g]`` live rows occupy slots [0, rows_in_page[g]) of
      page g; only a partition's LAST page may be partial;
    * ``row_index[g, s]`` is the source row id of slot s of page g, -1 in
      dead slots (the kernel-side liveness mask).
    """

    page_rows: int
    page_start: np.ndarray  # (P+1,) int32 offsets into page_ids
    page_ids: np.ndarray  # (num_pages,) int32, identity order by build
    part_of_page: np.ndarray  # (num_pages,) int32 owning partition
    rows_in_page: np.ndarray  # (num_pages,) int32 live rows per page
    row_index: np.ndarray  # (num_pages, page_rows) int64 source rows, -1 dead

    @property
    def num_parts(self) -> int:
        return len(self.page_start) - 1

    @property
    def num_pages(self) -> int:
        return len(self.page_ids)

    @property
    def total_rows(self) -> int:
        return int(self.rows_in_page.sum())

    def part_rows(self, p: int) -> np.ndarray:
        """Source row ids of partition p (concatenated page slots)."""
        lo, hi = int(self.page_start[p]), int(self.page_start[p + 1])
        if lo == hi:
            return np.empty(0, np.int64)
        pages = self.page_ids[lo:hi]
        idx = self.row_index[pages].reshape(-1)
        n = int(self.rows_in_page[pages].sum())
        return idx[:n]

    def part_num_rows(self, p: int) -> int:
        lo, hi = int(self.page_start[p]), int(self.page_start[p + 1])
        return int(self.rows_in_page[self.page_ids[lo:hi]].sum())

    def occupancy(self) -> float:
        """Live-slot fraction of the allocated pages (1.0 = zero skew
        waste; a max-padded layout at the same skew would report
        total_rows / (P * max_part_rows))."""
        alloc = self.num_pages * self.page_rows
        return (self.total_rows / alloc) if alloc else 1.0

    def padded_waste_ratio(self) -> float:
        """How much a pad-to-max layout would over-allocate vs this one
        (>= 1.0; EXPLAIN ANALYZE shows it as the skew the layout saved)."""
        if not self.num_pages:
            return 1.0
        per_part = [self.part_num_rows(p) for p in range(self.num_parts)]
        mx = max(per_part) if per_part else 0
        live_parts = sum(1 for r in per_part if r)
        padded = live_parts * mx
        alloc = self.num_pages * self.page_rows
        return (padded / alloc) if alloc else 1.0

    def lane(self, column: np.ndarray, fill=0) -> np.ndarray:
        """Gather a host column into the (num_pages, page_rows) paged
        layout (dead slots get `fill`) — the array shape kernels block
        over."""
        idx = np.maximum(self.row_index, 0)
        out = np.asarray(column)[idx.reshape(-1)].reshape(idx.shape)
        if fill is not None:
            out = np.where(self.row_index >= 0, out, fill)
        return out


def from_partitions(
    parts: Sequence[np.ndarray], page_rows: Optional[int] = None
) -> RaggedPages:
    """Build the ragged paged layout from per-partition row-id arrays
    (the output shape of exec/spill.hash_partition_indices). Unequal
    partitions allocate unequal page counts — nothing pads to the max."""
    pr = page_rows or page_rows_default()
    page_start = np.zeros(len(parts) + 1, np.int32)
    pages_per = [max(-(-len(p) // pr), 0) for p in parts]
    np.cumsum(pages_per, out=page_start[1:])
    num_pages = int(page_start[-1])
    page_ids = np.arange(num_pages, dtype=np.int32)
    part_of_page = np.zeros(num_pages, np.int32)
    rows_in_page = np.zeros(num_pages, np.int32)
    row_index = np.full((num_pages, pr), -1, np.int64)
    for p, rows in enumerate(parts):
        lo = int(page_start[p])
        n = len(rows)
        if not n:
            continue
        npages = pages_per[p]
        part_of_page[lo : lo + npages] = p
        flat = row_index[lo : lo + npages].reshape(-1)
        flat[:n] = np.asarray(rows, dtype=np.int64)
        row_index[lo : lo + npages] = flat.reshape(npages, pr)
        full, rem = divmod(n, pr)
        rows_in_page[lo : lo + full] = pr
        if rem:
            rows_in_page[lo + full] = rem
    return RaggedPages(
        pr, page_start, page_ids, part_of_page, rows_in_page, row_index
    )


def wire_padding(
    counts: Sequence[int], page_rows: Optional[int] = None
) -> dict:
    """Padding accounting for shipping these partition sizes as a wire
    unit (the JAX package's server/hier.py): the RAGGED paged layout allocates
    ceil(rows/page_rows) pages per non-empty partition (only the last
    page partial), while the FIXED layout a dense collective output
    buffer carries pads every live partition to the largest one. Returns
    row counts so the hierarchical exchange stats (and the skew tests)
    can assert the ragged unit beats pad-to-max under skew."""
    pr = page_rows or page_rows_default()
    live = [int(c) for c in counts if int(c) > 0]
    rows = sum(live)
    ragged_alloc = sum(-(-c // pr) * pr for c in live)
    fixed_alloc = len(live) * (max(live) if live else 0)
    return {
        "rows": rows,
        "ragged_pad_rows": max(ragged_alloc - rows, 0),
        "fixed_pad_rows": max(fixed_alloc - rows, 0),
    }


def occupancy_stats(rp: RaggedPages) -> dict:
    """The EXPLAIN ANALYZE payload for one layout instance."""
    return {
        "pages": rp.num_pages,
        "page_rows": rp.page_rows,
        "rows": rp.total_rows,
        "occupancy_pct": round(rp.occupancy() * 100.0, 1),
        "padded_waste_x": round(rp.padded_waste_ratio(), 2),
    }
