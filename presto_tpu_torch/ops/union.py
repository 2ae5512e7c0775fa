"""Page concatenation and null extension (torch counterpart of
presto_tpu/ops/union.py).

The page-level machinery behind UNION (reference UnionNode) and outer-join
null extension (the reference LookupJoinOperator's probe-side rows with
NULL build channels): stack pages row-wise over one merged dictionary per
varchar column, and add all-NULL columns.
"""

from __future__ import annotations

import dataclasses
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
        out.append(dataclasses.replace(b, data=data, dict_id=did))
    return out, did


def concat_blocks(col_blocks) -> Block:
    """One column of several inputs stacked row-wise: one merged dictionary,
    the first input's dtype; collection columns padded to the widest, their
    lengths, element masks and map keys stacked alike."""
    col_blocks, dict_id = unify_block_dictionaries(list(col_blocks))
    first = col_blocks[0]
    dtype = first.data.dtype
    valid = None
    if any(b.valid is not None for b in col_blocks):
        valid = torch.cat([b.valid_mask() for b in col_blocks])
    if not any(b.lengths is not None or b.key_block is not None for b in col_blocks):
        data = torch.cat([b.data.to(dtype) for b in col_blocks])
        return Block(data, first.type, valid, dict_id)
    from ..expr.functions import widen_lanes

    width = max(b.data.shape[1] for b in col_blocks)
    deep = max(b.data.shape[2] if b.data.ndim == 3 else 0 for b in col_blocks)

    def fit(x):
        x = widen_lanes(x, width)
        if deep and x.shape[2] < deep:  # multimap values: pad the third axis
            x = torch.cat([x, torch.zeros(x.shape[:2] + (deep - x.shape[2],), dtype=x.dtype,
                                          device=x.device)], dim=2)
        return x

    data = torch.cat([fit(b.data.to(dtype)) for b in col_blocks])
    lengths = torch.cat([b.lengths if b.lengths is not None else torch.full(
        (b.capacity,), b.data.shape[1], dtype=torch.int32, device=b.device)
        for b in col_blocks])
    elem_valid = None
    if any(b.elem_valid is not None for b in col_blocks):
        elem_valid = torch.cat([fit(b.elem_valid if b.elem_valid is not None
                                    else torch.ones(b.data.shape, dtype=torch.bool,
                                                    device=b.device))
                                for b in col_blocks])
    key_block = None
    if first.key_block is not None:
        key_block = concat_blocks([b.key_block for b in col_blocks])
        key_block.data = widen_lanes(key_block.data, width)
    return Block(data, first.type, valid, dict_id, lengths=lengths, elem_valid=elem_valid,
                 key_block=key_block)


def concat_pages(pages: Sequence[Page], distinct: bool = False) -> Page:
    """Stack pages row-wise (same schema), live rows compacted to the
    front. Output capacity = the sum of the input capacities; `distinct`
    keeps one row of each distinct row (UNION without ALL)."""
    first = pages[0]
    total_cap = sum(p.capacity for p in pages)
    blocks = []
    for i in range(len(first.names)):
        blocks.append(concat_blocks([p.blocks[i] for p in pages]))
    occ = torch.cat([p.live_mask() for p in pages])
    out = Page(tuple(blocks), first.names,
               torch.tensor(total_cap, dtype=torch.int32, device=first.device))
    out = compact(out, occ)
    if distinct:
        from .sort import distinct_page

        out = distinct_page(out, out.capacity)
    return out


def null_block(typ: T.Type, capacity: int, dict_id: Optional[int] = None,
               device="cuda") -> Block:
    """An all-NULL column of `typ` (outer-join null extension)."""
    lanes = getattr(typ, "lanes", 1)
    shape = (capacity,) if lanes == 1 else (capacity, lanes)
    null = torch.zeros(capacity, dtype=torch.bool, device=device)
    if isinstance(typ, (T.ArrayType, T.MapType)):
        # an empty one-lane collection under the NULL mask
        zeros = torch.zeros(capacity, dtype=torch.int32, device=device)
        key_block = None
        if isinstance(typ, T.MapType):
            key_block = null_block(T.ArrayType(typ.key), capacity, None, device)
        return Block(torch.zeros((capacity, 1), dtype=typ.storage_dtype, device=device), typ,
                     null, dict_id, lengths=zeros, key_block=key_block)
    return Block(torch.zeros(shape, dtype=typ.storage_dtype, device=device), typ, null,
                 dict_id)


def extend_with_nulls(page: Page, names, types, dict_ids, prepend: bool = False) -> Page:
    """Add all-NULL columns (the missing side of an outer join)."""
    extra = tuple(null_block(t, page.capacity, d, page.device) for t, d in zip(types, dict_ids))
    if prepend:
        return Page(extra + tuple(page.blocks), tuple(names) + page.names, page.count)
    return Page(tuple(page.blocks) + extra, page.names + tuple(names), page.count)


def empty_page(schema, device="cuda") -> Page:
    """A zero-row page for `{name: Type}` with a 1-slot capacity per column;
    varchar columns get an empty interned dictionary."""
    blocks = []
    for typ in schema.values():
        did = intern_dictionary(()) if isinstance(typ, T.VarcharType) else None
        blocks.append(null_block(typ, 1, did, device))
    return Page.from_blocks(blocks, list(schema), count=0, device=device)
