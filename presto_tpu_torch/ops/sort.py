"""Sort / TopN / Limit / Distinct (torch counterpart of presto_tpu/ops/sort.py).

Equivalents of the reference's OrderByOperator (PagesIndex sort),
TopNOperator, LimitOperator and DistinctLimitOperator/MarkDistinctOperator
(presto-main/.../operator/). Multi-key ORDER BY is a chain of stable
argsorts over the same key operands the JAX package's variadic sort
compares — (dead-flag, [null-flag_i, key_i...]) — least significant first,
which gives the same permutation: ties keep the original row order.
NULLS FIRST/LAST is a validity-aware key transform; TopN is sort + static
truncation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from .. import types as T
from ..expr.compiler import evaluate
from ..page import Page


@dataclasses.dataclass(frozen=True)
class SortKey:
    expr: object  # RowExpression
    ascending: bool = True
    nulls_first: Optional[bool] = None  # SQL default: NULLS LAST for ASC, FIRST for DESC

    @property
    def effective_nulls_first(self) -> bool:
        if self.nulls_first is not None:
            return self.nulls_first
        return not self.ascending


def asc_normalized_scalar_key(data, ascending: bool):
    """One 1-D key tensor normalized so ascending numeric order is the
    requested order (bool widened, negated for DESC). None for multi-lane
    (long-decimal) data, which has no single scalar."""
    if data.ndim == 2:
        return None
    if data.dtype == torch.bool:
        data = data.to(torch.int32)
    if not ascending:
        # bitwise NOT reverses integer order and, unlike negation, cannot
        # overflow on INT64_MIN
        data = -data if data.is_floating_point() else ~data.to(torch.int64)
    return data


def _float_total_order(x):
    """Total-order integer key for a float tensor: -0.0 ties +0.0 and NaNs
    compare ABOVE +inf (they land last in ascending order)."""
    wide = x.dtype == torch.float64
    it = torch.int64 if wide else torch.int32
    x = torch.where(x == 0, torch.zeros_like(x), x)  # -0.0 ties +0.0
    bits = x.view(it)
    top = -(1 << 63) if wide else -(1 << 31)  # INT_MIN bit pattern
    # signed-comparison total order: positive floats keep their bit
    # pattern, negative floats map to ~bits ^ top = -1 - magnitude
    key = torch.where(bits < 0, (~bits) ^ top, bits)
    return torch.where(torch.isnan(x), torch.iinfo(it).max, key)


def _key_operands(page: Page, keys: Sequence[SortKey]):
    ops = []
    for k in keys:
        v = evaluate(k.expr, page)
        if isinstance(v.type, T.VarcharType):
            from ..expr.functions import require_sorted_dict

            require_sorted_dict(v, "ORDER BY")
        data = v.data
        if v.valid is not None:
            # nulls to the requested end: leading per-key flag operand
            flag = v.valid if k.effective_nulls_first else ~v.valid
            ops.append(flag.to(torch.int8))
            # canonicalize NULL slots: their storage is garbage and must
            # not order null-tied rows ahead of the NEXT sort key
            mask = v.valid if data.ndim == 1 else v.valid[:, None]
            data = torch.where(mask, data, torch.zeros_like(data))
        if data.ndim == 2:
            # long-decimal lanes: (hi, lo) lexicographic == numeric
            hi, lo = data[:, 0], data[:, 1]
            if not k.ascending:
                hi, lo = ~hi, ~lo
            ops.extend([hi, lo])
            continue
        if data.is_floating_point():
            raw = data
            data = _float_total_order(raw)
            if not k.ascending:
                data = ~data
            # NaNs sort LAST in both directions
            data = torch.where(torch.isnan(raw), torch.iinfo(data.dtype).max, data)
            ops.append(data)
            continue
        if data.dtype == torch.bool:
            data = data.to(torch.int8)
        if not k.ascending:
            data = ~data
        ops.append(data)
    return ops


def _sort_operands(page: Page, keys: Sequence[SortKey]):
    """(dead-flag, [null-flag_i, key_i...]) — dead rows last."""
    ops = _key_operands(page, keys)
    ops.insert(0, (~page.live_mask()).to(torch.int8))
    return ops


def lexsort_permutation(ops) -> torch.Tensor:
    """Stable permutation ordering rows lexicographically by `ops` (most
    significant first): one stable argsort per operand, least significant
    first."""
    cap = ops[0].shape[0]
    perm = torch.arange(cap, dtype=torch.int64, device=ops[0].device)
    for op in reversed(ops):
        perm = perm[torch.argsort(op[perm], stable=True)]
    return perm


def sort_permutation(page: Page, keys: Sequence[SortKey]) -> torch.Tensor:
    """Permutation that orders live rows by the sort keys; dead rows last."""
    return lexsort_permutation(_sort_operands(page, keys))


def apply_permutation(page: Page, perm: torch.Tensor) -> Page:
    return Page(tuple(b.take_rows(perm) for b in page.blocks), page.names, page.count)


def sort_page(page: Page, keys: Sequence[SortKey]) -> Page:
    return apply_permutation(page, sort_permutation(page, keys))


def top_n(page: Page, keys: Sequence[SortKey], n: int) -> Page:
    """ORDER BY + LIMIT n with static output capacity n (TopNOperator).
    The stable full sort gives the JAX package's tie order exactly."""
    cap = min(n, page.capacity)
    s = sort_page(page, keys)
    blocks = [b.take_rows(slice(0, cap)) for b in s.blocks]
    count = torch.clamp(s.count, max=cap).to(torch.int32)
    return Page(tuple(blocks), s.names, count)


def limit_page(page: Page, n: int) -> Page:
    """LIMIT without ORDER BY: keep the first n live rows."""
    return Page(page.blocks, page.names, torch.clamp(page.count, max=n).to(torch.int32))


def distinct_page(page: Page, max_groups: int) -> Page:
    """SELECT DISTINCT via the grouped-aggregation machinery (reference
    MarkDistinctOperator uses the same GroupByHash)."""
    from ..expr.ir import ColumnRef
    from .aggregate import grouped_aggregate_sorted

    exprs = [ColumnRef(n, b.type) for n, b in zip(page.names, page.blocks)]
    return grouped_aggregate_sorted(page, exprs, page.names, (), max_groups)


# ---------------------------------------------------------------------------
# packed composite-key paths (ops/keypack.py): ONE sort on ONE key
# ---------------------------------------------------------------------------


def _packed_lanes(page: Page, keys, plan):
    from .keypack import pack_keys

    return pack_keys([evaluate(k.expr, page) for k in keys], plan, page.live_mask())


def sort_page_packed(page: Page, keys: Sequence[SortKey], plan):
    """Multi-key ORDER BY as ONE stable sort per packed lane. Returns
    (sorted page, ok): a False `ok` means a key fell outside the planned
    range and the caller must run the legacy path."""
    lanes, ok = _packed_lanes(page, keys, plan)
    return apply_permutation(page, lexsort_permutation(lanes)), ok


def top_n_packed(page: Page, keys: Sequence[SortKey], n: int, plan):
    """TopN on the packed key; ties break by the lower row index, matching
    the legacy stable order. Returns (page, ok) like sort_page_packed."""
    out, ok = sort_page_packed(page, keys, plan)
    cap = min(n, page.capacity)
    blocks = [b.take_rows(slice(0, cap)) for b in out.blocks]
    return Page(tuple(blocks), out.names, torch.clamp(out.count, max=cap).to(torch.int32)), ok


def distinct_packed(page: Page, plan):
    """SELECT DISTINCT as sorted-adjacent-unique on the packed key.

    bitpack/two_lane plans are exact (distinct packed keys == distinct
    rows); the hashed plan compares the raw key columns across every
    adjacent equal-hash pair and flips `ok` on a collision so the caller
    takes the legacy grouped-aggregation path."""
    from .aggregate import _neq_adjacent, _neq_adjacent_nullaware
    from .filter import compact
    from .hashing import hash_rows, unsigned_order_key
    from .keypack import pack_keys

    live = page.live_mask()
    first = torch.zeros(page.capacity, dtype=torch.bool, device=page.device)
    if page.capacity:
        first[0] = True
    if plan.strategy == "hashed":
        h = unsigned_order_key(hash_rows(page.blocks))
        h = torch.where(live, h, torch.iinfo(torch.int64).max)
        perm = torch.argsort(h, stable=True)
        h_s, live_s = h[perm], live[perm]
        boundary = (first | _neq_adjacent(h_s)) & live_s
        # an adjacent pair with EQUAL hash but UNEQUAL key values means 64
        # bits were not enough for this batch
        same_hash = (~_neq_adjacent(h_s)) & live_s
        differs = torch.zeros_like(same_hash)
        for b in page.blocks:
            differs = differs | _neq_adjacent_nullaware(
                b.data[perm], None if b.valid is None else b.valid[perm]
            )
        ok = ~torch.any(same_hash & differs)
        return compact(apply_permutation(page, perm), boundary), ok
    lanes, ok = pack_keys(page.blocks, plan, live)
    perm = lexsort_permutation(lanes)
    boundary = first
    for lane in lanes:
        boundary = boundary | _neq_adjacent(lane[perm])
    boundary = boundary & live[perm]
    return compact(apply_permutation(page, perm), boundary), ok
