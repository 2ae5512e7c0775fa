"""Page concatenation and null extension (torch counterpart of the part of
presto_tpu/ops/union.py that joins need).

The page-level machinery behind outer-join null extension (the reference
LookupJoinOperator's probe-side rows with NULL build channels): stack pages
row-wise over one merged dictionary per varchar column, and add all-NULL
columns.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import types as T
from ..page import Block, Page, intern_dictionary
from .filter import compact


def unify_block_dictionaries(blocks):
    """Remap same-column blocks of different inputs onto one merged sorted
    dictionary. Returns (blocks, dict_id)."""
    dict_ids = {b.dict_id for b in blocks}
    if len(dict_ids) == 1:
        return blocks, blocks[0].dict_id
    merged = tuple(sorted({s for b in blocks for s in (b.dictionary or ())}))
    index = {s: i for i, s in enumerate(merged)}
    did = intern_dictionary(merged)
    out = []
    for b in blocks:
        d = b.dictionary or ()
        data = b.data
        if len(d):
            mapping = torch.from_numpy(np.array([index[s] for s in d], np.int32)).to(b.device)
            data = mapping[b.data.to(torch.int64)]
        out.append(Block(data, b.type, b.valid, did))
    return out, did


def concat_pages(pages: Sequence[Page]) -> Page:
    """Stack pages row-wise (same schema), live rows compacted to the
    front. Output capacity = the sum of the input capacities."""
    first = pages[0]
    total_cap = sum(p.capacity for p in pages)
    blocks = []
    for i in range(len(first.names)):
        col_blocks = [p.blocks[i] for p in pages]
        if any(b.lengths is not None for b in col_blocks):
            raise NotImplementedError("not ported yet: concatenating collection columns")
        col_blocks, dict_id = unify_block_dictionaries(col_blocks)
        dtype = first.blocks[i].data.dtype
        data = torch.cat([b.data.to(dtype) for b in col_blocks])
        valid = None
        if any(b.valid is not None for b in col_blocks):
            valid = torch.cat([b.valid_mask() for b in col_blocks])
        blocks.append(Block(data, first.blocks[i].type, valid, dict_id))
    occ = torch.cat([p.live_mask() for p in pages])
    out = Page(tuple(blocks), first.names,
               torch.tensor(total_cap, dtype=torch.int32, device=first.device))
    return compact(out, occ)


def null_block(typ: T.Type, capacity: int, dict_id: Optional[int] = None,
               device="cuda") -> Block:
    """An all-NULL column of `typ` (outer-join null extension)."""
    lanes = getattr(typ, "lanes", 1)
    shape = (capacity,) if lanes == 1 else (capacity, lanes)
    return Block(torch.zeros(shape, dtype=typ.storage_dtype, device=device), typ,
                 torch.zeros(capacity, dtype=torch.bool, device=device), dict_id)


def extend_with_nulls(page: Page, names, types, dict_ids, prepend: bool = False) -> Page:
    """Add all-NULL columns (the missing side of an outer join)."""
    extra = tuple(null_block(t, page.capacity, d, page.device) for t, d in zip(types, dict_ids))
    if prepend:
        return Page(extra + tuple(page.blocks), tuple(names) + page.names, page.count)
    return Page(tuple(page.blocks) + extra, page.names + tuple(names), page.count)
