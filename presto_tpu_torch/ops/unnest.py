"""UNNEST: expand array-valued expressions into rows (torch counterpart of
presto_tpu/ops/unnest.py).

Re-designed equivalent of the reference's UnnestOperator
(presto-main/.../operator/UnnestOperator.java + UnnestNode planning): each
input row repeats once per array position up to the row's longest array
(arrays zip; shorter ones null-pad), then the page compacts. A NULL array
gives no rows.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .. import types as T
from ..expr.compiler import evaluate
from ..page import Block, Page
from .filter import compact


def unnest_page(page: Page, array_exprs: Sequence, elem_channels: Sequence[str],
                ordinality_channel: Optional[str] = None,
                replicate: Optional[Sequence[str]] = None) -> Page:
    """The unnested page: the `replicate` columns of the input (all of them
    when None) repeated per element, one element column per array, and the
    1-based ordinality column when asked for."""
    cap = page.capacity
    dev = page.device
    vals = [evaluate(e, page) for e in array_exprs]
    for v in vals:
        if v.lengths is None:
            raise TypeError("UNNEST argument is not an array")
    width = max(max(v.data.shape[1] for v in vals), 1)

    # effective per-row element count: the longest array, 0 for NULL arrays
    total_len = torch.zeros(cap, dtype=torch.int32, device=dev)
    for v in vals:
        ln = torch.clamp(v.lengths, min=0).to(torch.int32)
        if v.valid is not None:
            ln = torch.where(v.valid, ln, 0)
        total_len = torch.maximum(total_len, ln)

    row_idx = torch.arange(cap, device=dev).repeat_interleave(width)
    pos = torch.arange(width, device=dev).repeat(cap)
    keep = page.live_mask()[row_idx] & (pos < total_len[row_idx])

    blocks, names = [], []
    for name, b in zip(page.names, page.blocks):
        if replicate is None or name in replicate:
            blocks.append(b.take_rows(row_idx))
            names.append(name)
    for v, ch in zip(vals, elem_channels):
        w = v.data.shape[1]
        safe = torch.clamp(pos, max=w - 1)
        in_len = (pos < torch.clamp(v.lengths, min=0)[row_idx]) & (pos < w)
        if v.valid is not None:
            in_len = in_len & v.valid[row_idx]
        valid = in_len
        if v.elem_valid is not None:
            valid = valid & v.elem_valid[row_idx, safe]
        blocks.append(Block(v.data[row_idx, safe], v.type.element, valid, v.dict_id))
        names.append(ch)
    if ordinality_channel is not None:
        blocks.append(Block(pos + 1, T.BIGINT))
        names.append(ordinality_channel)
    expanded = Page(tuple(blocks), tuple(names),
                    torch.tensor(cap * width, dtype=torch.int32, device=dev))
    return compact(expanded, keep)
