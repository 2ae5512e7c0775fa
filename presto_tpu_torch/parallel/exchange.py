"""Hash-repartition exchange between the mesh's workers (torch counterpart
of presto_tpu/parallel/exchange.py).

Re-designed equivalent of the reference's shuffle: producer side
PartitionedOutputOperator.partitionPage (presto-main/.../operator/
PartitionedOutputOperator.java:276: row -> partition hash, per-partition
PageBuilders) and consumer side ExchangeClient/ExchangeOperator
(operator/ExchangeClient.java:55) pulling serialized pages over HTTP.

Here pages never leave device memory and are never serialized. Each sender
orders its rows by destination worker (`shuffle_write`, a stable sort, so
rows keep their order within a destination) and counts them; ONE host read
of the n x n counts sizes every receiver exactly; each receiver then takes
its slice of every sender, in sender order, moved with
`Tensor.to(device, non_blocking=True)` (no copy between workers that share
a device). So worker j receives sender 0's rows for j, then sender 1's, and
so on, each in the sender's row order: the rows and order the JAX
package's `all_to_all` + `compact` gives. Routing is
`hash_rows(keys) % n` on the uint64 hash, bit-identical to the JAX
package's. The JAX package's static send buffers, dropped-row counters and
retries have no counterpart: sizes come from the exact counts.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence, Tuple

import torch

from ..expr.compiler import evaluate
from ..ops.hashing import _srl, hash_rows
from ..ops.union import concat_blocks
from ..page import Page, _pad_block, round_capacity
from .mesh import Mesh


def u64_divmod(h: torch.Tensor, n: int):
    """(u // n, u % n) of the uint64 values whose int64 bits are `h`,
    both as int64 (the quotient wraps for n == 1)."""
    hi = _srl(h, 32)
    lo = h & 0xFFFFFFFF
    rem_hi = torch.remainder(hi, n)
    mid = rem_hi * (1 << 32) + lo
    q = torch.div(hi, n, rounding_mode="floor") * (1 << 32) + torch.div(
        mid, n, rounding_mode="floor")
    return q, torch.remainder(mid, n)


def route(page: Page, key_exprs, n: int) -> torch.Tensor:
    """Destination worker of every row, hash(keys) % n; dead rows get n."""
    keys = [evaluate(e, page) for e in key_exprs]
    _q, part = u64_divmod(hash_rows(keys), n)
    return torch.where(page.live_mask(), part, n)


def shuffle_write(page: Page, key_exprs, n: int) -> Tuple[Page, torch.Tensor]:
    """(rows ordered by destination, live rows per destination) of one
    sender."""
    return shuffle_write_parts(page, route(page, key_exprs, n), n)


def shuffle_write_parts(page: Page, part: torch.Tensor, n: int) -> Tuple[Page, torch.Tensor]:
    """shuffle_write over precomputed destinations: `part[i]` in [0, n)
    routes row i, n or more drops it. The stable sort keeps each
    destination's rows in row order."""
    part = torch.clamp(part.to(torch.int64), max=n)
    order = torch.argsort(part, stable=True)
    counts = torch.bincount(part, minlength=n + 1)[:n]
    buf = Page(tuple(b.take_rows(order) for b in page.blocks), page.names, page.count)
    return buf, counts


def host_counts(tensors: Sequence[torch.Tensor]) -> List[List[int]]:
    """Python ints of count vectors (or 0-d counts) held on any devices:
    one host transfer per device."""
    by_device: dict = {}
    for i, x in enumerate(tensors):
        by_device.setdefault(x.device, []).append(i)
    out: List[List[int]] = [[] for _ in tensors]
    for idx in by_device.values():
        rows = torch.stack([tensors[i].reshape(-1).to(torch.int64) for i in idx]).tolist()
        for i, r in zip(idx, rows):
            out[i] = r
    return out


def stack_pieces(pieces: Sequence[Page], names, count: int, capacity: int, device) -> Page:
    """Row-wise concatenation of pages whose rows are all live, on
    `device`, padded with dead rows to `capacity` (one merged dictionary
    per varchar column, collection companions included)."""
    moved = [[b.to(device, non_blocking=True) for b in p.blocks] for p in pieces]
    blocks = []
    for col in zip(*moved):
        b = concat_blocks(col)
        if b.capacity < capacity:
            b = _pad_block(b, capacity)
        blocks.append(b)
    return Page(tuple(blocks), tuple(names),
                torch.tensor(count, dtype=torch.int32, device=device))


def row_range(page: Page, lo: int, hi: int) -> Page:
    """Rows [lo, hi) of `page` (views; the count is the caller's)."""
    return Page(tuple(b.take_rows(slice(lo, hi)) for b in page.blocks), page.names, page.count)


def all_to_all_page(bufs: Sequence[Page], counts: Sequence[Sequence[int]],
                    mesh: Mesh) -> Tuple[Page, ...]:
    """Swap the senders' destination-ordered rows: `counts[i][j]` rows of
    sender i go to worker j. Every receiver gets the capacity of the
    fullest, rounded up to a power of two."""
    n = mesh.size
    starts = [[sum(c[:j]) for j in range(n)] for c in counts]
    totals = [sum(counts[i][j] for i in range(n)) for j in range(n)]
    cap = round_capacity(max(max(totals), 1))
    out = []
    for j, dev in enumerate(mesh.devices):
        pieces = [row_range(bufs[i], starts[i][j], starts[i][j] + counts[i][j]) for i in range(n)]
        out.append(stack_pieces(pieces, bufs[0].names, totals[j], cap, dev))
    return tuple(out)


def exchange_by_hash(pages: Sequence[Page], key_exprs, mesh: Mesh):
    """Full repartition: every row lands on worker hash(keys) % n, so rows
    with equal keys are co-resident (the invariant FIXED_HASH_DISTRIBUTION
    gives the reference's aggregations and joins). Returns (received
    pages, the n x n counts)."""
    n = mesh.size
    written = []
    for page, dev in zip(pages, mesh.devices):
        with device_scope(dev):
            written.append(shuffle_write(page, key_exprs, n))
    counts = host_counts([c for _b, c in written])
    return all_to_all_page([b for b, _c in written], counts, mesh), counts


def gather_page(pages: Sequence[Page], device, counts: Sequence[int] = None) -> Page:
    """Every worker's live rows, in worker order, as one page on `device`
    (the reference's root-stage output buffer). One host read of the
    counts unless the caller has them."""
    if counts is None:
        counts = [c[0] for c in host_counts([p.count for p in pages])]
    total = sum(counts)
    pieces = [row_range(p, 0, c) for p, c in zip(pages, counts)]
    return stack_pieces(pieces, pages[0].names, total, round_capacity(max(total, 1)), device)


def all_gather_page(pages: Sequence[Page], mesh: Mesh) -> Tuple[Page, ...]:
    """Every worker's live rows replicated on every worker (broadcast join
    build sides: the reference's BroadcastOutputBuffer)."""
    whole = gather_page(pages, mesh.devices[0])
    return tuple(whole.to(dev) for dev in mesh.devices)


def device_scope(dev):
    """The CUDA device context of a worker (kernel launches go to the
    current device), a no-op for CPU workers."""
    if torch.device(dev).type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()

