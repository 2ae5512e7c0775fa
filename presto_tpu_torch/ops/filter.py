"""Filter + compaction (torch counterpart of presto_tpu/ops/filter.py).

Equivalent of the reference's FilterAndProjectOperator /
ScanFilterAndProjectOperator (presto-main/.../operator/
ScanFilterAndProjectOperator.java:55). A filter evaluates the predicate and
*compacts*: surviving rows move to the front so the page keeps its
"live rows in [0, count)" invariant. Compaction is a stable argsort on the
drop flag plus gathers, as in the JAX package; it needs no host sync.
"""

from __future__ import annotations

import torch

from ..expr.compiler import evaluate
from ..page import Page


def compact(page: Page, keep: torch.Tensor) -> Page:
    """Keep rows where `keep & live`, moved to the front, count updated."""
    keep = keep & page.live_mask()
    count = keep.sum(dtype=torch.int32)
    perm = torch.argsort((~keep).to(torch.uint8), stable=True)  # kept first
    blocks = [b.take_rows(perm) for b in page.blocks]
    return Page(tuple(blocks), page.names, count)


def filter_page(page: Page, predicate) -> Page:
    """Evaluate a predicate RowExpression and compact survivors."""
    v = evaluate(predicate, page)
    keep = v.data
    if v.valid is not None:
        keep = keep & v.valid  # NULL predicate == not selected
    return compact(page, keep)


def sample_page(page: Page, fraction: float, seed: int, offset: int = 0) -> Page:
    """TABLESAMPLE BERNOULLI(p): keep each live row independently with
    probability `fraction`, decided by a splitmix64 hash of (global row
    position, seed), deterministic within one plan (the seed is drawn at
    plan time) and stateless across batches (reference SampleNode).

    `offset` is the global position of this page's row 0 (the executor's
    running offset plus its salt). The uint64 arithmetic runs on int64 bit
    patterns: products and sums wrap mod 2^64 alike, and the logical right
    shifts are masked by hand."""
    from .hashing import _GOLDEN, _signed, _srl, mix64

    base = _signed((int(offset) + int(seed)) & 0xFFFFFFFFFFFFFFFF)
    idx = torch.arange(page.capacity, dtype=torch.int64, device=page.device)
    z = mix64((idx + base) * _GOLDEN)
    u = _srl(z, 11).to(torch.float64) * (1.0 / (1 << 53))
    return compact(page, u < fraction)
